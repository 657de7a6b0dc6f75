"""GAE on the card through the hand-written CUDA kernel `csrc/gae.cu`.

Replaces `actor_critic_tpu/ops/pallas_scan.py::_gae_kernel` (reached there
through `gae`, `lambda_returns`, `gae_auto` and `lambda_returns_auto`; the
λ-returns are the second output here).
The kernel is bound by memory (5·T·E·4 + 4·E bytes, each input read once
and each output written once), and at the trainer's shape by its launch;
one thread per env column walks T in reverse with the carry in registers,
so every row access is coalesced across E (see the note in the source).

`gae` takes the plain version (`ops/returns.py`) only for CPU tensors; for
CUDA tensors it launches the kernel or raises, with no fall back. Inputs
are detached first, as `pallas_scan._detach` does: advantage targets are
gradient constants and the kernel is forward only.
"""

from __future__ import annotations

import ctypes

import torch

from actor_critic_tpu_torch.ops import returns as _returns

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last `reset_launch_count()` (the counterpart
    of `pallas_scan.kernel_block`'s engagement query): lets a run show that
    its main path went through the kernel."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _bind():
    from actor_critic_tpu_torch import _build

    lib = _build.load("gae")
    fn = lib.gae_launch
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    return fn


def _check(rewards, values, dones, bootstrap_value) -> None:
    if rewards.dim() != 2:
        raise ValueError(f"rewards must be [T, E], got shape {tuple(rewards.shape)}")
    T, E = rewards.shape
    for name, x, shape in (
        ("rewards", rewards, (T, E)),
        ("values", values, (T, E)),
        ("dones", dones, (T, E)),
        ("bootstrap_value", bootstrap_value, (E,)),
    ):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != rewards.device:
            raise ValueError(f"{name} is on {x.device}, rewards on {rewards.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rewards.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rewards.device}")


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
    lam: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(advantages, returns), each [T, E] float32, from [T, E] float32
    rewards/values/dones and an [E] bootstrap value."""
    rewards, values, dones, bootstrap_value = (
        x.detach() for x in (rewards, values, dones, bootstrap_value)
    )
    _check(rewards, values, dones, bootstrap_value)
    if rewards.device.type == "cpu":
        return _returns.gae(rewards, values, dones, bootstrap_value, gamma, lam)

    global _launches
    T, E = rewards.shape
    adv = torch.empty_like(rewards)
    ret = torch.empty_like(rewards)
    launch = _bind()
    with torch.cuda.device(rewards.device):
        stream = torch.cuda.current_stream(rewards.device).cuda_stream
        err = launch(
            rewards.data_ptr(), values.data_ptr(), dones.data_ptr(),
            bootstrap_value.data_ptr(), adv.data_ptr(), ret.data_ptr(),
            T, E, float(gamma), float(gamma * lam), stream,
        )
    if err != 0:
        raise RuntimeError(f"gae kernel launch failed: cudaError {err}")
    _launches += 1
    return adv, ret

