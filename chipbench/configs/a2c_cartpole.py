"""`a2c_cartpole`'s arithmetic and layout for the harness: the weight
leaves the benchmark draws, the model FLOPs of one iteration, the bytes
of the GAE kernel, and what the program's state after the first steps
holds for the check."""

from __future__ import annotations

import math

import torch

# optax's Adam b1: after one step the first moment is (1 - b1)·g.
ADAM_B1 = 0.9


def leaves(conf: dict) -> list[tuple[str, tuple[int, ...], float]]:
    """(name, shape, init gain) of every parameter, torch's [out, in] layout."""
    net = conf["network"]
    out, d = [], net["obs_dim"]
    for i, h in enumerate(net["hidden"]):
        out += [(f"torso.dense_{i}.weight", (h, d), math.sqrt(2.0)), (f"torso.dense_{i}.bias", (h,), 0.0)]
        d = h
    out += [("policy.weight", (net["num_actions"], d), 0.01), ("policy.bias", (net["num_actions"],), 0.0),
            ("value.weight", (1, d), 1.0), ("value.bias", (1,), 0.0)]
    return out


def forward_macs(conf: dict) -> int:
    """Multiply-adds of one forward of one observation: 4,544 at (64, 64)."""
    return sum(math.prod(shape) for _, shape, _ in leaves(conf) if len(shape) == 2)


def model_flops(conf: dict, num_envs: int, steps: int) -> int:
    """FLOPs the algorithm needs in one iteration: the actors' forward at
    each of the T·E env steps, the learner's forward over the T·E frames
    and the E bootstrap frames, and its backward (twice a forward) over
    the T·E frames. The forward over the pre-reset frames, which only
    truncated steps need, is not counted."""
    te = num_envs * steps
    return 2 * forward_macs(conf) * (te + te + num_envs + 2 * te)


def kernel_bytes(conf: dict, kernel: str, num_envs: int, steps: int) -> int | None:
    """Bytes the GAE kernel must move: rewards, values and dones [T, E] and
    the bootstrap [E] read once, advantages and returns [T, E] written once."""
    if kernel != "gae":
        return None
    return (5 * steps * num_envs + num_envs) * 4


def first_grad_norms(conf: dict, opt_state) -> dict[str, float]:
    """The clipped first gradient's norm by leaf, from Adam's first moment
    after one step."""
    return {k: math.sqrt(float((m.double() ** 2).sum())) / (1.0 - ADAM_B1)
            for k, m in opt_state.mu.items()}


def _copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32, copy=True)


def program_state(state) -> dict[str, torch.Tensor]:
    """The env and episode state the program carries, as the reference names it."""
    return {"obs": _copy(state.rollout.obs), "ep_return": _copy(state.ep_return),
            "ep_length": _copy(state.ep_length)}
