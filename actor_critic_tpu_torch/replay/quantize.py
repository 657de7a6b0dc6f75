"""Quantized replay storage: per-leaf codecs behind dynamic standardization
(counterpart of `actor_critic_tpu/replay/quantize.py`).

The codec layer `replay/buffer.py` calls on every `add_batch` (the stats
update, then the encode before the scatter) and on every sample (the
decode after the gather). Each function here is pure and returns new
tensors; the ring writes the encoded rows and the new stats into its own
tensors in place.

| kind      | storage    | stats            | decode error bound    |
|-----------|------------|------------------|-----------------------|
| `raw`     | leaf dtype | —                | exact                 |
| `f16`     | float16    | —                | ~2^-11 relative       |
| `i8`      | int8       | mean/scale       | scale/127 per element |
| `i8_unit` | int8       | — ([-1,1] fixed) | 1/127                 |
| `bool8`   | int8       | — ({0,1} exact)  | exact                 |

`i8` standardizes with a cumulative-average mean and a monotone
running-max scale, both frozen once `CALIBRATION_TRANSITIONS` transitions
have been absorbed, so that every later entry decodes through the stats it
was encoded with.

Modes for the off-policy ring (`--replay-dtype`): `fp32` stores every leaf
raw; `mixed` stores obs, next_obs and reward as `i8`, done and terminated
as `bool8`, actions raw; `int8` also stores the actions as `i8_unit`.

Rounding, against XLA on the CPU (the JAX reference): the constant
divisor of `decode` (`/ 127.0`) is a multiply by the float32 reciprocal,
as XLA rewrites it; the traced divisor of `encode` (`(x − mean) / scale`)
is a true division; `update_stats`' weight `b / max(count + b, 1)` divides
a tensor by a tensor (in torch `b / t` would be `t.reciprocal() · b`); both
sides round half to even.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from actor_critic_tpu_torch.algos.common import OffPolicyTransition
from actor_critic_tpu_torch.tree import named_leaves, tree_leaves, tree_map

# Leaves whose codec carries running stats.
STAT_KINDS = ("i8",)
KINDS = ("raw", "f16", "i8", "i8_unit", "bool8")
MODES = ("fp32", "mixed", "int8")

_EPS = 1e-6  # scale floor: an all-constant leaf must not divide by zero
_MEAN_SATURATE = 1 << 30  # count saturation
_INV_127 = float(np.float32(1) / np.float32(127))
_F16_MAX = float(torch.finfo(torch.float16).max)

# Transitions after which an `i8` leaf's mean and scale freeze.
CALIBRATION_TRANSITIONS = 4096


class QuantStats(NamedTuple):
    """Standardization stats of one `i8` leaf (item-shaped mean and scale);
    every other leaf carries scalar placeholders, so the ring's structure is
    the same in every mode."""

    mean: torch.Tensor
    scale: torch.Tensor
    count: torch.Tensor  # 0-dim int64: transitions absorbed (saturating)


def offpolicy_codecs(mode: str) -> OffPolicyTransition:
    """The per-leaf codec spec of the DDPG/TD3/SAC ring for a
    `replay_dtype`: an `OffPolicyTransition` of codec kinds."""
    if mode not in MODES:
        raise ValueError(f"replay_dtype must be one of {MODES}, got {mode!r}")
    if mode == "fp32":
        return OffPolicyTransition(obs="raw", action="raw", reward="raw", next_obs="raw",
                                   terminated="raw", done="raw")
    return OffPolicyTransition(
        obs="i8", action="i8_unit" if mode == "int8" else "raw", reward="i8",
        next_obs="i8", terminated="bool8", done="bool8")


def default_codecs(example: Any) -> Any:
    """All-`raw` codec tree of `example`'s structure."""
    return tree_map(lambda _: "raw", example)


def storage_dtype(kind: str, dtype: torch.dtype) -> torch.dtype:
    """The ring dtype a codec stores its leaf at."""
    if kind == "raw":
        return dtype
    if kind == "f16":
        return torch.float16
    if kind in ("i8", "i8_unit", "bool8"):
        return torch.int8
    raise ValueError(f"unknown codec kind {kind!r}; valid: {KINDS}")


def init_stats(kind: str, example_leaf: torch.Tensor) -> QuantStats:
    """Zeroed stats of one leaf (`example_leaf` is one item, no batch axis,
    on the ring's device): item-shaped for `i8`, scalars otherwise. The
    scale starts at the floor, not at 1.0, which the running max would
    never shrink."""
    shape = tuple(example_leaf.shape) if kind in STAT_KINDS else ()
    device = example_leaf.device
    return QuantStats(
        mean=torch.zeros(shape, device=device),
        scale=torch.full(shape, _EPS, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
    )


def update_stats(kind: str, stats: QuantStats, batch: torch.Tensor) -> QuantStats:
    """Fold a `[B, ...]` batch into the stats (the same stats for a
    stat-free codec): the mean by cumulative average, the scale by the
    running max of |x − mean| with the floor; both kept once the count has
    reached `CALIBRATION_TRANSITIONS`."""
    if kind not in STAT_KINDS:
        return stats
    x = batch.to(torch.float32)
    axes = tuple(range(x.dim() - stats.mean.dim()))
    b = int(np.prod([x.shape[a] for a in axes]))
    batch_mean = torch.mean(x, dim=axes)
    w = torch.full((), float(b), device=x.device) / torch.clamp(stats.count + b, min=1).to(
        torch.float32)
    mean = stats.mean + (batch_mean - stats.mean) * w
    absmax = torch.amax(torch.abs(x - mean), dim=axes)
    scale = torch.clamp(torch.maximum(stats.scale, absmax), min=_EPS)
    calibrating = stats.count < CALIBRATION_TRANSITIONS
    return QuantStats(
        mean=torch.where(calibrating, mean, stats.mean),
        scale=torch.where(calibrating, scale, stats.scale),
        count=torch.clamp(stats.count + b, max=_MEAN_SATURATE),
    )


def encode(kind: str, stats: QuantStats, x: torch.Tensor, store_dtype: torch.dtype) -> torch.Tensor:
    """A leaf batch → its stored representation, saturating: values are
    clipped to the codec's range before the narrowing cast, and a NaN
    becomes the range's midpoint for the int8 codecs (`nan_to_num`); the
    f16 codec keeps NaN."""
    if kind == "raw":
        return x.to(store_dtype)
    if kind == "f16":
        return torch.clamp(x, -_F16_MAX, _F16_MAX).to(torch.float16)
    if kind == "bool8":
        return torch.round(torch.clamp(torch.nan_to_num(x), 0.0, 1.0)).to(torch.int8)
    if kind == "i8_unit":
        q = torch.clamp(torch.nan_to_num(x.to(torch.float32)), -1.0, 1.0) * 127.0
        return torch.round(q).to(torch.int8)
    if kind == "i8":
        z = (x.to(torch.float32) - stats.mean) / stats.scale
        return torch.round(torch.clamp(torch.nan_to_num(z), -1.0, 1.0) * 127.0).to(torch.int8)
    raise ValueError(f"unknown codec kind {kind!r}; valid: {KINDS}")


def decode(kind: str, stats: QuantStats, q: torch.Tensor) -> torch.Tensor:
    """Stored representation → float32 (`raw` passes its dtype through).
    `i8` is `q · (scale / 127) + mean` with the product and sum as one
    fused multiply-add (`addcmul`): XLA contracts it on most of a leaf's
    lanes (not all: its vectorised loop leaves some unfused, by column), so
    an element may differ from JAX's by one ulp (`tests/test_torch_quantize.py`
    counts them)."""
    if kind == "raw":
        return q
    if kind in ("f16", "bool8"):
        return q.to(torch.float32)
    if kind == "i8_unit":
        return q.to(torch.float32) * _INV_127
    if kind == "i8":
        return torch.addcmul(stats.mean, q.to(torch.float32), stats.scale * _INV_127)
    raise ValueError(f"unknown codec kind {kind!r}; valid: {KINDS}")


def _item_bytes(leaf: torch.Tensor, dtype: torch.dtype) -> int:
    elements = int(np.prod(leaf.shape[1:], dtype=np.int64))
    return elements * torch.empty((), dtype=dtype).element_size()


def capacity_report(state, codecs: Any = None) -> dict:
    """{capacity, bytes_per_transition, fp32_bytes_per_transition,
    capacity_multiplier, ring_bytes, codec_mix} of a ring: the bytes an
    item takes in storage, against float32 for every quantized leaf (a
    `raw` leaf is priced at its own dtype)."""
    storage = state.storage
    if codecs is None:
        codecs = default_codecs(storage)
    kinds = named_leaves(codecs)
    leaves = tree_leaves(storage)
    stored = fp32 = 0
    mix = []
    for (name, kind), leaf in zip(kinds.items(), leaves, strict=True):
        stored += _item_bytes(leaf, leaf.dtype)
        fp32 += _item_bytes(leaf, leaf.dtype if kind == "raw" else torch.float32)
        mix.append(f"{name}:{kind}")
    cap = leaves[0].shape[0]
    return {
        "capacity": int(cap),
        "bytes_per_transition": int(stored),
        "fp32_bytes_per_transition": int(fp32),
        "capacity_multiplier": round(fp32 / max(stored, 1), 2),
        "ring_bytes": int(cap * stored),
        "codec_mix": ",".join(mix),
    }
