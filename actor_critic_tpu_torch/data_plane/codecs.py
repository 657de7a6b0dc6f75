"""The host-side numpy mirror of the `replay/quantize.py` codecs, and the
per-key codec specs of trajectory blocks (counterpart of
`actor_critic_tpu/data_plane/codecs.py`, line for line).

The device trajectory ring (`data_plane/ring.py`) encodes on the PRODUCER
side: an actor thread quantizes its numpy block on the host and copies
only the encoded bytes to the card (int8 obs at a quarter of the float32
bytes); the learner decodes on the card with the stats the block was
encoded with. So the encode and the stats update need a numpy
implementation: the torch versions would put a device op per block on the
actor's thread.

The stats calibrate, then freeze after `quantize.CALIBRATION_TRANSITIONS`
transitions, as the replay ring's do on the card.

Codec specs (`traj_codecs`) key on block-array NAMES, not tree positions:

- the observation family (obs / final_obs / last_obs / next_obs) carries
  most of a block's bytes and quantizes well (f16, or calibrated i8);
- reward quantizes as calibrated i8 in the int8 mode;
- done / terminated are exact {0,1} flags (bool8);
- action, log_prob, value, final_values, bootstrap_value stay raw: the
  behaviour log-probs feed the V-trace ratios and the recorded value is
  the clip anchor, so quantizing either would bias the correction itself.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from actor_critic_tpu_torch.replay import quantize

# Block keys treated as observations by the trajectory-codec presets.
OBS_KEYS = ("obs", "final_obs", "last_obs", "next_obs")
# Keys that must never quantize (see the module docstring).
RAW_KEYS = ("action", "log_prob", "value", "final_values", "bootstrap_value")
TRAJ_MODES = ("fp32", "f16", "int8")

_EPS = quantize._EPS
_MEAN_SATURATE = quantize._MEAN_SATURATE


def traj_codecs(mode: str, block_spec: dict[str, Any]) -> dict[str, str]:
    """Per-key codec kinds for a trajectory block shaped like `block_spec`
    (any mapping of name → array-like with a dtype).

    `fp32` is all raw (the bitwise-equivalence mode); `f16` halves the
    observation bytes; `int8` also standardizes observations and rewards
    to calibrated int8 and packs the flags."""
    if mode not in TRAJ_MODES:
        raise ValueError(f"data-plane codec must be one of {TRAJ_MODES}, got {mode!r}")
    out: dict[str, str] = {}
    for name, leaf in block_spec.items():
        dtype = np.dtype(getattr(leaf, "dtype", np.float32))
        if mode == "fp32" or name in RAW_KEYS or dtype != np.float32:
            # Non-float leaves (discrete int actions, uint8 pixel obs) pass
            # through: uint8 is already dense and int actions must be exact.
            out[name] = "raw"
        elif name in OBS_KEYS:
            out[name] = "f16" if mode == "f16" else "i8"
        elif name == "reward":
            out[name] = "i8" if mode == "int8" else "raw"
        elif name in ("done", "terminated"):
            out[name] = "bool8" if mode == "int8" else "raw"
        else:
            out[name] = "raw"
    return out


# ---------------------------------------------------------------------------
# numpy stats (calibrate-then-freeze, mirroring quantize.update_stats)
# ---------------------------------------------------------------------------

def np_init_stats(kind: str, item_shape: tuple[int, ...]) -> dict:
    """A zeroed numpy stats slot, with `quantize.init_stats`' shape policy
    (item-shaped mean/scale for `i8`, scalar placeholders otherwise, the
    scale at the _EPS floor)."""
    shape = tuple(item_shape) if kind in quantize.STAT_KINDS else ()
    return {
        "mean": np.zeros(shape, np.float32),
        "scale": np.full(shape, _EPS, np.float32),
        "count": np.zeros((), np.int32),
    }


def np_update_stats(kind: str, stats: dict, batch: np.ndarray,
                    num_transitions: int | None = None) -> dict:
    """Fold one batch into the running stats (the same dict for a
    stat-free codec): a cumulative-average mean and a monotone running-max
    scale, both FROZEN once `quantize.CALIBRATION_TRANSITIONS` transitions
    have been absorbed.

    `num_transitions` is how many TRANSITIONS this batch holds, the unit
    of the freeze threshold. The ring's stats are scalar per key, so the
    element count would advance a [K, E, obs_dim] block's clock obs_dim
    times too fast; `DeviceTrajRing` passes each key's transition count.
    With a constant feature size per key the cumulative mean is the same
    either way; only the freeze clock differs."""
    if kind not in quantize.STAT_KINDS:
        return stats
    count = int(stats["count"])
    if count >= quantize.CALIBRATION_TRANSITIONS:
        return stats  # frozen
    x = np.asarray(batch, np.float32)
    item_ndim = stats["mean"].ndim
    axes = tuple(range(x.ndim - item_ndim))
    b = 1
    for a in axes:
        b *= x.shape[a]
    n = b if num_transitions is None else int(num_transitions)
    w = np.float32(n) / np.float32(max(count + n, 1))
    mean = (stats["mean"] + (x.mean(axis=axes, dtype=np.float32)
                             - stats["mean"]) * w).astype(np.float32)
    absmax = np.abs(x - mean).max(axis=axes).astype(np.float32)
    scale = np.maximum(np.maximum(stats["scale"], absmax), np.float32(_EPS))
    return {
        "mean": mean,
        "scale": scale,
        "count": np.asarray(min(count + n, _MEAN_SATURATE), np.int32),
    }


def np_encode(kind: str, stats: dict, x: np.ndarray) -> np.ndarray:
    """One host leaf → its stored representation (the numpy twin of
    `quantize.encode`). Saturates as the device codec does: out-of-range
    values clip to the representable range before the narrowing cast, a
    NaN narrows through nan_to_num on the int8 paths and stays NaN through
    f16."""
    if kind == "raw":
        return np.asarray(x)
    if kind == "f16":
        f16_max = float(np.finfo(np.float16).max)
        return np.clip(x, -f16_max, f16_max).astype(np.float16)
    if kind == "bool8":
        return np.round(np.clip(np.nan_to_num(x), 0.0, 1.0)).astype(np.int8)
    if kind == "i8_unit":
        q = np.clip(np.nan_to_num(np.asarray(x, np.float32)), -1.0, 1.0) * 127.0
        return np.round(q).astype(np.int8)
    if kind == "i8":
        z = (np.asarray(x, np.float32) - stats["mean"]) / stats["scale"]
        return np.round(np.clip(np.nan_to_num(z), -1.0, 1.0) * 127.0).astype(np.int8)
    raise ValueError(f"unknown codec kind {kind!r}; valid: {quantize.KINDS}")


def np_decode(kind: str, stats: dict, q: np.ndarray) -> np.ndarray:
    """The numpy twin of the ring's decode (`ring.decode_leaf`); the tests
    hold the two equal bit for bit. The trainers only decode on the
    device."""
    if kind == "raw":
        return np.asarray(q)
    if kind == "f16":
        return np.asarray(q, np.float32)
    if kind == "bool8":
        return np.asarray(q, np.float32)
    if kind == "i8_unit":
        return np.asarray(q, np.float32) / 127.0
    if kind == "i8":
        return (np.asarray(q, np.float32) * (stats["scale"] / 127.0)
                + stats["mean"]).astype(np.float32)
    raise ValueError(f"unknown codec kind {kind!r}; valid: {quantize.KINDS}")


def storage_np_dtype(kind: str, dtype) -> np.dtype:
    """The numpy storage dtype of one leaf (`quantize.storage_dtype`)."""
    if kind == "raw":
        return np.dtype(dtype)
    if kind == "f16":
        return np.dtype(np.float16)
    if kind in ("i8", "i8_unit", "bool8"):
        return np.dtype(np.int8)
    raise ValueError(f"unknown codec kind {kind!r}; valid: {quantize.KINDS}")
