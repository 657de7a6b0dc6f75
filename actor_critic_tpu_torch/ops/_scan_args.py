"""Argument checks and launch geometry shared by the reverse-scan kernel
wrappers (`gae_cuda`, `vtrace_cuda`): what the kernels take is [T, E]
float32 contiguous columns and an [E] bootstrap, all on one CPU or CUDA
device, and how `csrc/gae.cu` and `csrc/vtrace.cu` tile them."""

from __future__ import annotations

from typing import NamedTuple

import torch

# One block owns a strip of SCAN_COLUMNS env columns (a 64-byte row segment)
# over all T rows, walked in reverse in chunks of at most SCAN_CHUNK rows
# held in shared memory. At E = 4096 that is 256 blocks, so every SM of an
# H100 has work; on the card 16 columns measured as fast as 32 at
# [64, 4096] and faster at [20, 64]. The kernels are compiled for these
# three numbers (`csrc/scan_tile.cuh`: kColumns, kChunk, kThreads) and
# their launchers refuse any other.
SCAN_COLUMNS = 16
SCAN_CHUNK = 64
SCAN_THREADS = 256
# What one block may take of an H100 SM's shared memory (227 KB), and what
# the kernels hold there besides the dynamic tiles: the carry's output for a
# chunk and at most three boundary rows.
SHARED_BYTES_LIMIT = 232_448
STATIC_SHARED_BYTES = (SCAN_CHUNK + 3) * SCAN_COLUMNS * 4


class ScanGeometry(NamedTuple):
    """A kernel's launch geometry, fields in the order its launcher takes them."""

    blocks: int      # column strips, one block each
    threads: int     # threads of a block
    columns: int     # env columns of a strip
    chunk: int       # rows of T in shared memory at a time
    smem_bytes: int  # dynamic shared memory of a block
    copy_bytes: int  # 16 (cp.async.cg, four floats) or 4 (cp.async.ca, one float)


def scan_geometry(
    T: int, E: int, n_planes: int, scratch_planes: int = 0, aligned: bool = True
) -> ScanGeometry:
    """Geometry for `n_planes` [T, E] inputs, plus `scratch_planes` chunks
    of working space: one chunk buffer per input plane, two where T takes
    more than one chunk (the next one is copied while this one is
    computed). 16-byte copies need E % 4 == 0 (so every row of a strip
    starts on 16 bytes) and 16-byte-aligned bases (`aligned`)."""
    chunk = min(T, SCAN_CHUNK)
    buffers = 2 if T > chunk else 1
    smem = (buffers * n_planes + scratch_planes) * chunk * SCAN_COLUMNS * 4
    if smem + STATIC_SHARED_BYTES > SHARED_BYTES_LIMIT:
        raise ValueError(f"{smem} B of shared memory for {n_planes} planes exceeds {SHARED_BYTES_LIMIT}")
    return ScanGeometry(
        blocks=-(-E // SCAN_COLUMNS),
        threads=SCAN_THREADS,
        columns=SCAN_COLUMNS,
        chunk=chunk,
        smem_bytes=smem,
        copy_bytes=16 if aligned and E % 4 == 0 else 4,
    )


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


def scan_outputs(out, n: int, like: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The `n` [T, E] float32 output planes of a scan: the caller's `out`
    (checked: contiguous, `like`'s shape and device; the kernel writes every
    element and nothing beyond) or fresh ones when None."""
    if out is None:
        return tuple(torch.empty_like(like) for _ in range(n))
    out = tuple(out)
    if len(out) != n:
        raise ValueError(f"out must hold {n} tensors, got {len(out)}")
    for i, x in enumerate(out):
        if x.shape != like.shape or x.dtype != torch.float32 or x.device != like.device:
            raise ValueError(f"out[{i}] must be float32 {tuple(like.shape)} on {like.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"out[{i}] must be contiguous")
    return out
