"""Argument checks shared by the reverse-scan kernel wrappers
(`gae_cuda`, `vtrace_cuda`): what the kernels take is [T, E] float32
contiguous columns and an [E] bootstrap, all on one CPU or CUDA device."""

from __future__ import annotations

import torch


def check_scan_inputs(
    columns: dict[str, torch.Tensor], bootstrap_value: torch.Tensor
) -> tuple[int, int]:
    """Raise on anything the kernels do not take; returns (T, E)."""
    first_name, first = next(iter(columns.items()))
    if first.dim() != 2:
        raise ValueError(f"{first_name} must be [T, E], got shape {tuple(first.shape)}")
    T, E = first.shape
    for name, x, shape in (
        *((n, x, (T, E)) for n, x in columns.items()),
        ("bootstrap_value", bootstrap_value, (E,)),
    ):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != first.device:
            raise ValueError(f"{name} is on {x.device}, {first_name} on {first.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")
    return T, E
