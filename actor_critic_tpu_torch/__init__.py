"""PyTorch/CUDA port of `actor_critic_tpu`, for NVIDIA Hopper (H100).

The JAX package beside it is the reference; every module here keeps the
name of its JAX counterpart where one exists, and the tests hold the two
against each other on the same inputs. Nothing here imports JAX or the
JAX package.

Entry points run on the card by default (`device="cuda"`) and raise when
no card is present; only an explicit `device="cpu"` runs on the CPU.
"""

from __future__ import annotations

import torch


def pin_precision() -> None:
    """Pin the card's rounding to the JAX reference's ("bf16 compute, fp32
    accumulation"): float32 matrix products and cuDNN convolutions in full
    float32, never TF32 (torch's default runs float32 convolutions in TF32),
    and bf16 matrix products reduced in float32 (torch's default lets cuBLAS
    reduce them in bf16). cuDNN is also held to deterministic algorithms:
    without TF32 its heuristics pick float32 weight-gradient kernels that sum
    with atomics, and a graph replay, an eager step and a resumed run would
    then differ in the last bits. The flags are process-global; every entry
    point sets them through `resolve_device` before its first kernel, never
    per call, since serving lanes run forwards on other threads while a
    learner captures."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a `torch.device`; raises if CUDA is asked for and no card
    is present (never a silent fall back to the CPU). On the card the
    precision is pinned (`pin_precision`)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        pin_precision()
    return dev
