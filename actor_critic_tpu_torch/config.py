"""Named presets and `key=value` overrides (counterpart of
`actor_critic_tpu/config.py`).

The presets ported so far: `a2c_cartpole`, `ppo_cartpole`, the
IMPALA/A3C trio on the Pong-like pixel env, `impala_pong`,
`impala_pong_learn` and `a3c_pong`, and `a2c_mixture` on the four-type
scenario fleet. Their values are held equal to the JAX presets' by a
test. `resolve` turns the CLI's `--preset`, `--algo`, `--env`, `--set`
and `--env-set` into a `Preset`, as the JAX function does (a test holds
the two against each other); the algorithms the port has no trainer for
yet (`UNPORTED_ALGOS`) are refused there.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Optional, Union

from actor_critic_tpu_torch.algos import a2c, impala, ppo


@dataclasses.dataclass(frozen=True)
class Preset:
    """A runnable training setup: algorithm + environment + config."""

    algo: str        # a2c | ppo | impala | a3c
    env: str         # "jax:<name>" or a bare name of train.ENVS, or "mixture:<members>"
    config: Any      # the algorithm's frozen config dataclass
    iterations: int  # default --iterations
    description: str
    # Keyword arguments for the env maker: the difficulty and shape knobs
    # that define a runnable result, e.g. pong's opp_skill / frame_skip.
    env_kwargs: dict = dataclasses.field(default_factory=dict)


PRESETS: dict[str, Preset] = {
    # The JAX package's flagship preset: E=4096, T=64, lr 3e-3 and the
    # entropy bonus both annealed to 0 over 400 iterations.
    "a2c_cartpole": Preset(
        algo="a2c",
        env="cartpole",
        config=a2c.A2CConfig(
            num_envs=4096, rollout_steps=64, lr=3e-3,
            anneal_iters=400, lr_final=0.0,
            entropy_coef=0.01, entropy_coef_final=0.0,
        ),
        iterations=400,
        description="A2C on batched CartPole-v1, GAE through the CUDA kernel",
    ),
    # The JAX package's CartPole solver: E=256, T=128, 4 epochs × 8
    # minibatches, lr 2.5e-4 and the entropy bonus 0.01 annealed to 0 over
    # 100 iterations (lr per optimizer step); clip-ε is not annealed.
    "ppo_cartpole": Preset(
        algo="ppo",
        env="cartpole",
        config=ppo.PPOConfig(
            num_envs=256, rollout_steps=128, epochs=4, num_minibatches=8,
            lr=2.5e-4, entropy_coef=0.01, gae_lambda=0.95, gamma=0.99,
            anneal_iters=100, lr_final=0.0, entropy_coef_final=0.0,
        ),
        iterations=100,
        description="PPO on batched CartPole-v1, GAE through the CUDA kernel",
    ),
    # IMPALA with 64 actors, unroll 20 and a 4-step actor lag, Nature CNN
    # on 84×84×2 uint8 Pong frames.
    "impala_pong": Preset(
        algo="impala",
        env="pong",
        config=impala.ImpalaConfig(num_envs=64, rollout_steps=20, actor_refresh_every=4),
        iterations=2000,
        description="IMPALA on the Pong-like pixel env, V-trace through the CUDA kernel",
    ),
    # The same learner at the difficulty where it learns in the JAX
    # package's runs: opponent at half speed, frame_skip 4, 36 px frames.
    "impala_pong_learn": Preset(
        algo="impala",
        env="pong",
        config=impala.ImpalaConfig(num_envs=64, rollout_steps=20, actor_refresh_every=4),
        iterations=40_000,
        description="IMPALA on the Pong-like pixel env at the learnable difficulty "
        "(opp_skill=0.5, frame_skip=4, 36px)",
        env_kwargs={"opp_skill": 0.5, "frame_skip": 4, "size": 36},
    ),
    # The scenario universe: A2C on a fleet of four env types (CartPole,
    # Pendulum, Acrobot, the procedural maze), each instance's physics
    # drawn within ±20% of its defaults at every episode, behind the padded
    # obs and the shared 5-action interface (envs/mixture.py). Pair with
    # `--curriculum "200:1,2,2,2;400:0,1,2,4" --eval-every 25` to shift the
    # type draw toward the harder members as the eval return crosses the
    # thresholds.
    "a2c_mixture": Preset(
        algo="a2c",
        env="mixture:cartpole,pendulum,acrobot,maze",
        config=a2c.A2CConfig(
            num_envs=1024, rollout_steps=32, lr=1e-3,
            anneal_iters=400, lr_final=0.0,
            entropy_coef=0.01, entropy_coef_final=0.0,
        ),
        iterations=400,
        description="A2C on the 4-type scenario-mixture fleet, GAE through the CUDA kernel",
        env_kwargs={"randomize": 0.2},
    ),
    # The same trainer with no importance correction (the A3C rule): GAE
    # through the CUDA kernel.
    "a3c_pong": Preset(
        algo="a3c",
        env="pong",
        config=impala.ImpalaConfig(
            num_envs=64, rollout_steps=20, actor_refresh_every=4,
            correction="none", lam=0.95,
        ),
        iterations=2000,
        description="A3C-style (no importance correction) on the Pong-like pixel env",
    ),
}

# Algorithm name → config dataclass type, for --algo without --preset.
ALGO_CONFIGS: dict[str, Any] = {
    "a2c": a2c.A2CConfig,
    "ppo": ppo.PPOConfig,
    "impala": impala.ImpalaConfig,
    "a3c": impala.ImpalaConfig,
}
# The JAX package's off-policy trainers, which come with a later slice.
UNPORTED_ALGOS = ("ddpg", "td3", "sac")


def _coerce(raw: str, typ: Any) -> Any:
    """Parse a CLI string into the annotated field type."""
    origin = typing.get_origin(typ)
    if origin is Union:  # Optional[T]
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if raw.lower() in ("none", "null"):
            return None
        return _coerce(raw, args[0])
    if origin is tuple:
        elem = typing.get_args(typ)[0]
        if raw.strip() == "":
            return ()
        return tuple(_coerce(p.strip(), elem) for p in raw.split(","))
    if typ is bool:
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a bool: {raw!r}")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    if typ is str:
        return raw
    raise ValueError(f"unsupported field type {typ} for value {raw!r}")


def apply_overrides(config: Any, overrides: dict[str, str]) -> Any:
    """`dataclasses.replace` with string values coerced to the field types;
    an unknown key raises with the list of valid fields."""
    if not overrides:
        return config
    hints = typing.get_type_hints(type(config))
    fields = {f.name for f in dataclasses.fields(config)}
    updates = {}
    for key, raw in overrides.items():
        if key not in fields:
            raise KeyError(
                f"{type(config).__name__} has no field {key!r}; valid: {sorted(fields)}")
        updates[key] = _coerce(raw, hints[key])
    return dataclasses.replace(config, **updates)


def parse_set_args(pairs: list[str]) -> dict[str, str]:
    """['lr=1e-3', 'hidden=64,64'] → {'lr': '1e-3', 'hidden': '64,64'}."""
    out: dict[str, str] = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--set expects key=value, got {pair!r}")
        key, _, value = pair.partition("=")
        out[key.strip()] = value.strip()
    return out


def coerce_env_value(raw: str) -> Any:
    """An `--env-set` value (env-maker kwargs have no annotation): bools
    and None by keyword, then int, then float, else the string."""
    low = raw.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("none", "null"):
        return None
    for typ in (int, float):
        try:
            return typ(raw)
        except ValueError:
            pass
    return raw


def parse_env_set_args(pairs: list[str]) -> dict[str, Any]:
    """['opp_skill=0.5', 'frame_skip=4'] → {'opp_skill': 0.5, 'frame_skip': 4}."""
    return {k: coerce_env_value(v) for k, v in parse_set_args(pairs).items()}


def default_config(algo: str) -> Any:
    """The algorithm's default config (a3c: no importance correction)."""
    if algo in UNPORTED_ALGOS:
        raise NotImplementedError(
            f"--algo {algo} is not ported yet (the off-policy trainers come later); "
            f"ported: {sorted(ALGO_CONFIGS)}")
    if algo not in ALGO_CONFIGS:
        raise KeyError(f"unknown algo {algo!r}; valid: {sorted(ALGO_CONFIGS)}")
    cfg = ALGO_CONFIGS[algo]()
    if algo == "a3c":
        cfg = dataclasses.replace(cfg, correction="none")
    return cfg


def resolve(
    preset: Optional[str],
    algo: Optional[str],
    env: Optional[str],
    overrides: dict[str, str],
    env_overrides: Optional[dict[str, Any]] = None,
) -> Preset:
    """`--preset name` (optionally overridden by --algo/--env), or `--algo`
    and `--env` from scratch with that algorithm's default config.
    `env_overrides` (--env-set) merge over the preset's env_kwargs;
    changing the env drops the preset's env_kwargs, and changing the algo
    drops the preset's config for the new algo's defaults. A preset's bare
    env name and its `jax:` spelling are the same env."""
    env_overrides = env_overrides or {}
    if preset is not None:
        if preset not in PRESETS:
            raise KeyError(f"unknown preset {preset!r}; valid: {sorted(PRESETS)}")
        base = PRESETS[preset]
        algo = algo or base.algo
        same_env = env is None or env.removeprefix("jax:") == base.env.removeprefix("jax:")
        base_env_kwargs = base.env_kwargs if same_env else {}
        env = env or base.env
        cfg = base.config if algo == base.algo else default_config(algo)
        return Preset(
            algo=algo, env=env, config=apply_overrides(cfg, overrides),
            iterations=base.iterations, description=base.description,
            env_kwargs={**base_env_kwargs, **env_overrides},
        )
    if algo is None or env is None:
        raise ValueError("need --preset, or both --algo and --env")
    cfg = default_config(algo)
    return Preset(
        algo=algo, env=env, config=apply_overrides(cfg, overrides),
        iterations=1000, description=f"{algo} on {env}",
        env_kwargs=dict(env_overrides),
    )
