"""The port's warm-up registry against JAX's (`utils/compile_cache.py` of
each package), and the port's registry lint (`utils/warmup_lint.py`, the
counterpart of JAX's `scripts/check_warmup_registry.py`):

- plan parity: for every preset of the port's `config.py`, crossed with
  the fused and host paths, the async actor-learner on both data planes,
  `--eval-every` on and off, `--chunk`/`--resume` and the serving side,
  the port plans JAX's entries by JAX's names. The only entries JAX plans
  and the port does not are those the port has nothing to capture for
  (`NOTHING_TO_CAPTURE`: acts the port runs eagerly, and the ring's
  enqueue, a few plain copies);
- the lint covers every capture site of `algos/`, `envs/`, `data_plane/`
  and `serving/`, and names an unregistered one in a temporary module.
"""

import dataclasses

import pytest

import actor_critic_tpu.config as jax_config
import actor_critic_tpu.data_plane  # noqa: F401 — JAX's device-plane planners
import actor_critic_tpu.serving  # noqa: F401 — JAX's serving planner
from actor_critic_tpu import envs as jax_envs
from actor_critic_tpu.envs.jax_env import EnvSpec as JaxSpec
from actor_critic_tpu.utils import compile_cache as jax_cc
from actor_critic_tpu_torch import config as port_config
from actor_critic_tpu_torch import train
from actor_critic_tpu_torch.utils import compile_cache, warmup_lint

# JAX entries the port plans as None, each with nothing to capture.
NOTHING_TO_CAPTURE = frozenset({
    "ppo.make_policy_step",     # the host loop's device act, eager each env step
    "ppo.make_greedy_act",      # the host eval's act, eager (or the numpy mirror)
    "ddpg.make_host_act_fn", "sac.make_host_act_fn",      # the same, off-policy
    "ddpg.make_greedy_act", "sac.make_greedy_act",
    "ring.make_enqueue",        # DeviceTrajRing.put: plain copies on a slot stream
})

# The host envs the presets name, as specs (JAX's planners read shapes).
HOST_SPECS = {
    "host:HalfCheetah-v5": JaxSpec((17,), 6, False),
    "host:Walker2d-v5": JaxSpec((17,), 6, False),
    "host:Humanoid-v5": JaxSpec((348,), 17, False),
    "native:CartPole-v1": JaxSpec((4,), 2, True),
}
JAX_MAKERS = {"cartpole": jax_envs.make_cartpole, "pendulum": jax_envs.make_pendulum,
              "pong": jax_envs.make_pong}


def _jax_env(env: str, env_kwargs: dict):
    kind, _, name = env.partition(":")
    if kind == "mixture":
        return jax_envs.make_mixture(name, **env_kwargs)
    return JAX_MAKERS[name](**env_kwargs)


def _presets(preset: str, env: str = None):
    """(JAX preset, port preset) of `preset`, on `env` where given."""
    jax_env = None if env is None else (env if ":" in env else f"jax:{env}")
    return (jax_config.resolve(preset, None, jax_env, {}),
            port_config.resolve(preset, None, env, {}))


def _names(plan) -> set:
    return {name for name, _ in plan}


def _check(jax_ctx, port_ctx) -> None:
    want = _names(jax_cc.plan_warmup(jax_ctx))
    got = _names(compile_cache.plan_warmup(port_ctx))
    assert got == want - NOTHING_TO_CAPTURE, (jax_ctx.algo, want, got)


FUSED = [(p, None) for p in ("a2c_cartpole", "ppo_cartpole", "impala_pong", "impala_pong_learn",
                             "a2c_mixture", "a3c_pong")] + [
    (p, "jax:pendulum") for p in ("ppo_halfcheetah", "ddpg_walker2d", "td3_walker2d",
                                  "sac_humanoid")]
HOST = [(p, None) for p in ("ppo_halfcheetah", "ddpg_walker2d", "td3_walker2d",
                            "sac_humanoid")] + [("ppo_cartpole", "native:CartPole-v1")]


@pytest.mark.parametrize("preset,env", FUSED)
def test_fused_plans_equal_jax(preset, env):
    jp, pp = _presets(preset, env)
    jenv = _jax_env(jp.env, jp.env_kwargs)
    penv = train.make_env(pp.env, pp.env_kwargs)
    for eval_every in (0, 5):
        for chunk, iterations, resume in ((1, 7, False), (3, 7, False), (3, 6, True),
                                          (4, 2, False)):
            kw = dict(algo=jp.algo, fused=True, chunk=chunk, iterations=iterations,
                      resume=resume, eval_every=eval_every)
            _check(jax_cc.WarmupContext(spec=jenv.spec, cfg=jp.config, env=jenv, **kw),
                   compile_cache.WarmupContext(spec=penv.spec, cfg=pp.config, env=penv,
                                               device="cpu", **kw))


@pytest.mark.parametrize("preset,env", HOST)
@pytest.mark.parametrize("overlap", [True, False])
def test_host_lockstep_plans_equal_jax(preset, env, overlap):
    jp, pp = _presets(preset, env)
    for eval_every in (0, 5):
        kw = dict(algo=jp.algo, fused=False, eval_every=eval_every, overlap=overlap,
                  iterations=10)
        _check(jax_cc.WarmupContext(spec=HOST_SPECS[jp.env], cfg=jp.config, **kw),
               compile_cache.WarmupContext(spec=None, cfg=pp.config, device="cpu", **kw))


@pytest.mark.parametrize("preset,env", HOST)
@pytest.mark.parametrize("data_plane", ["host", "device"])
def test_async_plans_equal_jax(preset, env, data_plane):
    jp, pp = _presets(preset, env)
    corrections = ("vtrace", "none") if jp.algo == "ppo" else ("vtrace",)
    for correction in corrections:
        for codec in ("fp32", "int8"):
            for eval_every in (0, 5):
                kw = dict(algo=jp.algo, fused=False, eval_every=eval_every, async_actors=2,
                          async_correction=correction, data_plane=data_plane,
                          plane_codec=codec, queue_depth=3, iterations=10)
                _check(jax_cc.WarmupContext(spec=HOST_SPECS[jp.env], cfg=jp.config, **kw),
                       compile_cache.WarmupContext(spec=None, cfg=pp.config, device="cpu",
                                                   native=True, **kw))


@pytest.mark.parametrize("preset", ["ppo_cartpole", "ppo_halfcheetah", "td3_walker2d",
                                    "sac_humanoid"])
def test_serving_plans_equal_jax(preset):
    jp, pp = _presets(preset, "native:CartPole-v1" if preset == "ppo_cartpole" else None)
    spec = HOST_SPECS[jp.env]
    for sample in ((False, True) if jp.algo == "ppo" else (False,)):
        kw = dict(algo=jp.algo, fused=False, serving_buckets=(1, 4, 16), serving_sample=sample)
        _check(jax_cc.WarmupContext(spec=spec, cfg=jp.config, **kw),
               compile_cache.WarmupContext(spec=None, cfg=pp.config, device="cpu", **kw))


def test_registry_has_jax_names():
    """The port registers every one of JAX's 25 entries under its name,
    and nothing else; the serving side is the same one entry."""
    jax_cc.registered_warmups()
    assert compile_cache.registered_warmups() == jax_cc.registered_warmups()
    assert len(compile_cache.registered_warmups()) == 25
    assert compile_cache._SERVING_PLANNERS == jax_cc._SERVING_PLANNERS


def test_context_has_jax_fields():
    jax_fields = {f.name: f.default for f in dataclasses.fields(jax_cc.WarmupContext)}
    port_fields = {f.name: f.default for f in dataclasses.fields(compile_cache.WarmupContext)}
    assert {k: port_fields[k] for k in jax_fields} == jax_fields
    assert set(port_fields) - set(jax_fields) == {"device", "native"}


# ------------------------------------------------------------------ lint

def test_registry_covers_every_capture_site(capsys):
    assert warmup_lint.main([]) == 0, capsys.readouterr().err
    sites = warmup_lint.collect_sites()
    # The sites the port has: the fused loop, the host update and its four
    # trainers, the blocked evals, the serving engine's lanes, and IMPALA's
    # sequence-parallel learner (exempt, as JAX's).
    assert {"loop.fused_train_loop", "loop.warm_up", "host_loop.HostUpdate", "ppo.train_host",
            "ppo.train_host_async", "host_loop.off_policy_train_host",
            "host_loop.off_policy_train_host_async", "common.BlockedEval",
            "common.make_net_eval", "engine._Lane", "impala.make_sp_update",
            "impala.make_sp_train_step"} == set(sites)
    assert set(compile_cache.EXEMPT) == {"impala.make_sp_update", "impala.make_sp_train_step"}
    assert set(compile_cache.EXEMPT) <= set(jax_cc.EXEMPT)


def test_lint_flags_unregistered_sites(tmp_path):
    """The scanner sees each form of a capture site, keyed by its enclosing
    top-level function or class, and the lint names the site no entry
    owns; a stale key is named too."""
    src = (
        "from actor_critic_tpu_torch.algos import loop\n"
        "from actor_critic_tpu_torch.algos.host_loop import HostUpdate\n"
        "def make_thing(body, gen):\n"
        "    return HostUpdate(body, gen)\n"
        "def run_graph(g):\n"
        "    with loop.capture(g):\n"
        "        pass\n"
        "class Lane:\n"
        "    def _capture(self, b):\n"
        "        return loop.CapturedStep(None, None)\n"
        "def untouched():\n"
        "    return 1\n"
    )
    (tmp_path / "algos").mkdir()
    path = tmp_path / "algos" / "newalgo.py"
    path.write_text(src)
    assert [fn for fn, _ in warmup_lint.capture_sites(path)] == [
        "make_thing", "run_graph", "Lane", "Lane"]
    sites = warmup_lint.collect_sites(tmp_path, ("algos",))
    assert set(sites) == {"newalgo.make_thing", "newalgo.run_graph", "newalgo.Lane"}
    registered = compile_cache.registered_warmups()
    found = warmup_lint.findings(
        sites, registered, {"newalgo.Lane": ("a2c.make_train_step",),
                            "newalgo.gone": ("a2c.make_train_step",)},
        {"newalgo.run_graph": "a test's reason"})
    assert len(found) == 2, found
    assert "unregistered capture site 'newalgo.make_thing'" in found[0]
    assert "algos/newalgo.py:4" in found[0]
    assert "stale compile_cache key 'newalgo.gone'" in found[1]
    # An entry name that is not registered is named as well.
    found = warmup_lint.findings(sites, registered, {
        "newalgo.make_thing": ("newalgo.make_thing_program",),
        "newalgo.Lane": ("a2c.make_train_step",),
        "newalgo.run_graph": ("a2c.make_eval_fn",)}, {}, check_stale=False)
    assert found == [f"algos/newalgo.py:4: capture site 'newalgo.make_thing' belongs to "
                     f"unregistered entries ['newalgo.make_thing_program']"]
