"""V-trace on the card through the hand-written CUDA kernel `csrc/vtrace.cu`.

Replaces `actor_critic_tpu/ops/pallas_scan.py::_vtrace_kernel` (reached
there through `vtrace` and `vtrace_auto`).
The kernel is bound by memory ((8·T·E + E)·4 bytes, each input read once
and each output written once), and at the trainer's shape (E = 64) by its
launch. A block takes a strip of env columns over all T rows
(`_scan_args.scan_geometry`): it copies the strip's rows into shared
memory with every copy in flight before one wait, computes the ratios, δ
and the carry's coefficient in parallel, runs only the one-FMA trace
carry per column serially, then computes pg in parallel (see the note in
the source).

`vtrace` takes the plain version (`ops/returns.py`) only for CPU tensors;
for CUDA tensors it launches the kernel or raises, with no fall back.
Inputs are detached first, as `pallas_scan._detach` does: V-trace targets
are gradient constants and the kernel is forward only.
"""

from __future__ import annotations

import ctypes

import torch

from actor_critic_tpu_torch.ops import returns as _returns
from actor_critic_tpu_torch.ops._scan_args import check_scan_inputs, scan_geometry

# The devices the wrapper launched the kernel on; the kernel counts its
# launches there itself.
_devices: set[int] = set()


def launch_count() -> int:
    """Kernel launches that ran since the last `reset_launch_count()`: lets
    a run show that its main path went through the kernel. The kernel
    counts them on the card, so a replay of a CUDA graph that captured it
    counts and the capture does not. Waits for the devices' work."""
    from actor_critic_tpu_torch import _build

    return _build.device_launches("vtrace", sorted(_devices))


def reset_launch_count() -> None:
    from actor_critic_tpu_torch import _build

    _build.device_launches("vtrace", sorted(_devices), reset=True)


def _bind():
    from actor_critic_tpu_torch import _build

    lib = _build.load("vtrace")
    fn = lib.vtrace_launch
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 9 + [ctypes.c_int] * 2 + [ctypes.c_float] * 4 + [ctypes.c_int] * 6 + [ptr]
        fn.restype = ctypes.c_int
    return fn


def vtrace(
    target_log_probs: torch.Tensor,
    behaviour_log_probs: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
    lam: float = 1.0,
) -> _returns.VTraceOutput:
    """(vs, pg_advantages, clipped_rhos), each [T, E] float32, from [T, E]
    float32 log-probs/rewards/values/dones and an [E] bootstrap value."""
    args = [x.detach() for x in (target_log_probs, behaviour_log_probs, rewards, values, dones)]
    bootstrap_value = bootstrap_value.detach()
    T, E = check_scan_inputs(
        dict(zip(("target_log_probs", "behaviour_log_probs", "rewards", "values", "dones"), args)),
        bootstrap_value,
    )
    if rewards.device.type == "cpu":
        return _returns.vtrace(*args, bootstrap_value, gamma, rho_bar, c_bar, lam)

    # One scratch plane in shared memory: the chunk's δ.
    geometry = scan_geometry(T, E, len(args), scratch_planes=1,
                             aligned=all(x.data_ptr() % 16 == 0 for x in args))
    vs, pg, rho = (torch.empty_like(args[2]) for _ in range(3))
    launch = _bind()
    with torch.cuda.device(rewards.device):
        stream = torch.cuda.current_stream(rewards.device).cuda_stream
        err = launch(
            *(x.data_ptr() for x in args), bootstrap_value.data_ptr(),
            vs.data_ptr(), pg.data_ptr(), rho.data_ptr(),
            T, E, float(gamma), float(rho_bar), float(c_bar), float(lam), *geometry, stream,
        )
    if err != 0:
        raise RuntimeError(f"vtrace kernel launch failed: cudaError {err}")
    _devices.add(rewards.device.index)
    return _returns.VTraceOutput(vs=vs, pg_advantages=pg, clipped_rhos=rho)
