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


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a `torch.device`; raises if CUDA is asked for and no card
    is present (never a silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
