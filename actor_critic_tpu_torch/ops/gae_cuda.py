"""GAE on the card through the hand-written CUDA kernel `csrc/gae.cu`.

Replaces `actor_critic_tpu/ops/pallas_scan.py::_gae_kernel` (reached there
through `gae`, `lambda_returns`, `gae_auto` and `lambda_returns_auto`; the
λ-returns are the second output here).
The kernel is bound by memory (5·T·E·4 + 4·E bytes, each input read once
and each output written once). A block takes a strip of env columns over
all T rows (`_scan_args.scan_geometry`): it copies the strip's rows into
shared memory with every copy in flight before one wait, computes δ and
the carry's coefficient in parallel, and runs only the one-FMA carry per
column serially (see the note in the source).

`gae` takes the plain version (`ops/returns.py`) only for CPU tensors; for
CUDA tensors it launches the kernel or raises, with no fall back. Inputs
are detached first, as `pallas_scan._detach` does: advantage targets are
gradient constants and the kernel is forward only.
"""

from __future__ import annotations

import ctypes

import torch

from actor_critic_tpu_torch.ops import returns as _returns
from actor_critic_tpu_torch.ops._scan_args import check_scan_inputs, scan_geometry, scan_outputs

# The devices the wrapper launched the kernel on; the kernel counts its
# launches there itself.
_devices: set[int] = set()


def launch_count() -> int:
    """Kernel launches that ran since the last `reset_launch_count()` (the
    counterpart of `pallas_scan.kernel_block`'s engagement query): lets a
    run show that its main path went through the kernel. The kernel counts
    them on the card, so a replay of a CUDA graph that captured it counts
    and the capture does not. Waits for the devices' work."""
    from actor_critic_tpu_torch import _build

    return _build.device_launches("gae", sorted(_devices))


def reset_launch_count() -> None:
    from actor_critic_tpu_torch import _build

    _build.device_launches("gae", sorted(_devices), reset=True)


def _bind():
    from actor_critic_tpu_torch import _build

    lib = _build.load("gae")
    fn = lib.gae_launch
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = ([ptr] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 6 + [ptr])
        fn.restype = ctypes.c_int
    return fn


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
    lam: float,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(advantages, returns), each [T, E] float32, from [T, E] float32
    rewards/values/dones and an [E] bootstrap value; written into `out`
    (two [T, E] float32 tensors) when given."""
    rewards, values, dones, bootstrap_value = (
        x.detach() for x in (rewards, values, dones, bootstrap_value)
    )
    T, E = check_scan_inputs(
        {"rewards": rewards, "values": values, "dones": dones}, bootstrap_value
    )
    adv, ret = scan_outputs(out, 2, rewards)
    if rewards.device.type == "cpu":
        plain = _returns.gae(rewards, values, dones, bootstrap_value, gamma, lam)
        if out is None:
            return plain
        adv.copy_(plain[0])
        ret.copy_(plain[1])
        return adv, ret

    planes = (rewards, values, dones)
    geometry = scan_geometry(T, E, len(planes), aligned=all(x.data_ptr() % 16 == 0 for x in planes))
    launch = _bind()
    with torch.cuda.device(rewards.device):
        stream = torch.cuda.current_stream(rewards.device).cuda_stream
        err = launch(
            *(x.data_ptr() for x in planes), bootstrap_value.data_ptr(),
            adv.data_ptr(), ret.data_ptr(),
            T, E, float(gamma), float(gamma * lam), *geometry, stream,
        )
    if err != 0:
        raise RuntimeError(f"gae kernel launch failed: cudaError {err}")
    _devices.add(rewards.device.index)
    return adv, ret

