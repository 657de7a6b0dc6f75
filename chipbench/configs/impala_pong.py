"""`impala_pong`'s arithmetic and layout for the harness: the weight
leaves the benchmark draws, the model FLOPs of one iteration, the bytes
of the V-trace kernel, and what the program's state after the first
steps holds for the check."""

from __future__ import annotations

import math

import torch


def leaves(conf: dict) -> list[tuple[str, tuple[int, ...], float]]:
    """(name, shape, init gain) of every parameter, torch's layouts: conv
    [out, in, kh, kw], dense [out, in] over the conv output flattened in
    (H, W, C) order."""
    net = conf["network"]
    h, w, c = net["obs_shape"]
    out = []
    for i, (ch, k, s) in enumerate(zip(net["channels"], net["kernels"], net["strides"])):
        out += [(f"torso.conv_{i}.weight", (ch, c, k, k), math.sqrt(2.0)),
                (f"torso.conv_{i}.bias", (ch,), 0.0)]
        h, w, c = (h - k) // s + 1, (w - k) // s + 1, ch
    d = net["dense"]
    out += [("torso.Dense_0.weight", (d, h * w * c), math.sqrt(2.0)), ("torso.Dense_0.bias", (d,), 0.0),
            ("policy.weight", (net["num_actions"], d), 0.01), ("policy.bias", (net["num_actions"],), 0.0),
            ("value.weight", (1, d), 1.0), ("value.bias", (1,), 0.0)]
    return out


def forward_macs(conf: dict) -> int:
    """Multiply-adds of one forward of one frame pair: 7,706,624 at 84×84×2
    (convolutions 1,638,400 + 2,654,208 + 1,806,336, dense 1,605,632,
    heads 2,048)."""
    net = conf["network"]
    h, w, c = net["obs_shape"]
    macs = 0
    for ch, k, s in zip(net["channels"], net["kernels"], net["strides"]):
        h, w = (h - k) // s + 1, (w - k) // s + 1
        macs += h * w * ch * k * k * c
        c = ch
    return macs + h * w * c * net["dense"] + net["dense"] * (net["num_actions"] + 1)


def model_flops(conf: dict, num_envs: int, steps: int) -> int:
    """FLOPs the algorithm needs in one iteration: the actors' forward at
    each of the T·E env steps, the learner's forward over the T·E frames
    and the E bootstrap frames, and its backward (twice a forward) over
    the T·E frames. The learner's forward over the pre-reset frames, which
    only truncated steps need, is not counted."""
    te = num_envs * steps
    return 2 * forward_macs(conf) * (te + te + num_envs + 2 * te)


def kernel_bytes(conf: dict, kernel: str, num_envs: int, steps: int) -> int | None:
    """Bytes the V-trace kernel must move: target and behaviour log-probs,
    rewards, values and dones [T, E] and the bootstrap [E] read once, vs,
    the policy-gradient advantages and the clipped ρ [T, E] written once."""
    if kernel != "vtrace":
        return None
    return (8 * steps * num_envs + num_envs) * 4


def first_grad_norms(conf: dict, opt_state) -> dict[str, float]:
    """The clipped first gradient's norm by leaf, from RMSProp's ν after one
    step from zero: ν = (1 − decay)·g²."""
    decay = conf["config"]["rms_decay"]
    return {k: math.sqrt(float(n.double().sum()) / (1.0 - decay)) for k, n in opt_state.nu.items()}


def _copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32, copy=True)


def program_state(state) -> dict[str, torch.Tensor]:
    """The env and episode state the program carries, as the reference
    names it (the actors' parameters are compared by their change,
    `actor_gap`)."""
    return {"obs": _copy(state.rollout.obs), "ep_return": _copy(state.ep_return),
            "ep_length": _copy(state.ep_length)}
