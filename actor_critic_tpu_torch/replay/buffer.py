"""The replay ring on the device (counterpart of
`actor_critic_tpu/replay/buffer.py`).

The ring is a tree of `[capacity, ...]` tensors, one per transition leaf,
plus a write cursor, a count of valid entries and the codecs' running
stats (`replay/quantize.py`). The JAX package returns a new ring from
every insert and relies on donation for the storage to be updated in
place; here the functions write the ring's own tensors in place
(`index_copy_` into the storage, `copy_` into the cursor, the count and
the stats), so that a CUDA graph that captured an insert and a sample
replays them on the same storage (`algos/loop.py`).

A sample draws its indices on the device from the trainer's generator:
int64 draws in [0, 2^62) taken modulo the count of valid entries (a
device tensor, so the bound is what the ring holds at each replay, not
what it held at capture). The modulo's bias is below 2^-31 at any ring
size a device holds. The draw and the gather are split
(`draw_indices`, `sample_at`, `sequences_at`) so that a test can give the
port the indices the JAX package drew.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from actor_critic_tpu_torch.parallel.mesh import Group
from actor_critic_tpu_torch.replay import quantize
from actor_critic_tpu_torch.tree import tree_leaves, tree_map

# Index draws are uniform over [0, 2^62) before the modulo.
_DRAW_RANGE = 1 << 62


class ReplayState(NamedTuple):
    """The ring: `storage` (a tree of [capacity, ...] tensors at the codecs'
    storage dtypes), `insert_pos` (the next slot to write) and `size` (valid
    entries, saturating at capacity), both 0-dim int64, and `quant` (one
    `quantize.QuantStats` per storage leaf). Every tensor is written in
    place."""

    storage: Any
    insert_pos: torch.Tensor
    size: torch.Tensor
    quant: Any


def capacity_of(state: ReplayState) -> int:
    """The ring's capacity (the leading dim of every storage leaf)."""
    return tree_leaves(state.storage)[0].shape[0]


def _codec_tree(codecs: Optional[Any], example: Any) -> Any:
    return quantize.default_codecs(example) if codecs is None else codecs


def _guard_defaulted_codecs(state: ReplayState) -> None:
    """Refuse the codecs=None default against a ring built quantized: an
    all-`raw` spec would store and return the int8 / float16 codes
    unchanged, and training would go on on codes as if they were values.
    A caller that wants a raw int8 ring passes an all-`raw` spec."""
    for leaf in tree_leaves(state.storage):
        if leaf.dtype in (torch.int8, torch.float16):
            raise ValueError(
                "this replay ring holds quantized storage "
                f"(a {leaf.dtype} leaf) but no codec spec was passed — "
                "pass the same `codecs` used at replay.init "
                "(e.g. replay.offpolicy_codecs(cfg.replay_dtype)) so "
                "values are encoded/decoded, not read as raw codes"
            )


def init(example_item: Any, capacity: int, codecs: Optional[Any] = None) -> ReplayState:
    """A zeroed ring shaped after one item (a tree of tensors with no batch
    axis, on the ring's device): storage leaves [capacity, *item_shape] at
    their codec's storage dtype."""
    codecs = _codec_tree(codecs, example_item)
    storage = tree_map(
        lambda kind, x: torch.zeros((capacity, *x.shape), device=x.device,
                                    dtype=quantize.storage_dtype(kind, x.dtype)),
        codecs, example_item)
    device = tree_leaves(example_item)[0].device
    return ReplayState(
        storage=storage,
        insert_pos=torch.zeros((), dtype=torch.int64, device=device),
        size=torch.zeros((), dtype=torch.int64, device=device),
        quant=tree_map(quantize.init_stats, codecs, example_item),
    )


def add_batch(state: ReplayState, batch: Any, codecs: Optional[Any] = None,
              group: Group = None) -> None:
    """Insert a [B, ...] batch at slots (insert_pos + arange(B)) % capacity,
    in place: the stats take the batch first, then each leaf is encoded
    and written by `index_copy_`. A batch larger than the ring keeps its
    newest `capacity` rows (the modulo would otherwise write one slot
    twice, in no defined order). Under dp each rank's ring is its sub-ring
    (capacity/W, `parallel.dp.replay_specs`) and `group` syncs the codecs'
    stats across the ranks (`quantize.update_stats`)."""
    if codecs is None:
        _guard_defaulted_codecs(state)
    codecs = _codec_tree(codecs, batch)
    capacity = capacity_of(state)
    b = tree_leaves(batch)[0].shape[0]
    if b > capacity:
        batch = tree_map(lambda x: x[-capacity:], batch)
        b = capacity
    quant = tree_map(lambda kind, stats, x: quantize.update_stats(kind, stats, x, group),
                     codecs, state.quant, batch)
    idx = (state.insert_pos + torch.arange(b, device=state.size.device)) % capacity
    encoded = tree_map(lambda kind, stats, s, x: quantize.encode(kind, stats, x, s.dtype),
                       codecs, quant, state.storage, batch)
    for s, rows in zip(tree_leaves(state.storage), tree_leaves(encoded), strict=True):
        s.index_copy_(0, idx, rows)
    for old, new in zip(tree_leaves(state.quant), tree_leaves(quant), strict=True):
        if new is not old:
            old.copy_(new)
    state.insert_pos.copy_((state.insert_pos + b) % capacity)
    state.size.copy_(torch.clamp(state.size + b, max=capacity))


def draw_indices(generator: torch.Generator, n: int, bound: torch.Tensor) -> torch.Tensor:
    """[n] int64 indices uniform in [0, max(bound, 1)), drawn on the
    generator's device: `bound` is a 0-dim device tensor, so a CUDA graph
    replays the draw against the bound of the moment."""
    draws = torch.randint(0, _DRAW_RANGE, (n,), generator=generator, device=generator.device)
    return draws % torch.clamp(bound, min=1)


def _decode_tree(state: ReplayState, codecs: Any, gathered: Any) -> Any:
    return tree_map(quantize.decode, codecs, state.quant, gathered)


def sample_at(state: ReplayState, idx: torch.Tensor, codecs: Optional[Any] = None) -> Any:
    """The transitions at slots `idx` (any index shape), decoded."""
    if codecs is None:
        _guard_defaulted_codecs(state)
    codecs = _codec_tree(codecs, state.storage)
    return _decode_tree(state, codecs, tree_map(lambda s: s[idx], state.storage))


def sample(
    state: ReplayState, generator: torch.Generator, batch_size: int,
    codecs: Optional[Any] = None,
) -> Any:
    """A uniform sample of `batch_size` transitions, with replacement, from
    the valid entries. Callers do not sample an empty ring (the warm-up
    gate); the bound's floor of 1 only keeps the draw legal."""
    return sample_at(state, draw_indices(generator, batch_size, state.size), codecs)


def oldest_slot(state: ReplayState) -> torch.Tensor:
    """The slot of the oldest valid entry: 0 until the ring fills, then the
    slot the cursor is about to overwrite."""
    return torch.where(state.size < capacity_of(state), torch.zeros_like(state.insert_pos),
                       state.insert_pos)


def window_bound(state: ReplayState, seq_len: int) -> torch.Tensor:
    """How many windows of `seq_len` consecutive inserts the ring holds,
    at least 1: the bound of `sample_sequences`' start draw."""
    return torch.clamp(state.size - seq_len + 1, min=1)


def sequences_at(
    state: ReplayState, start: torch.Tensor, seq_len: int, codecs: Optional[Any] = None
) -> Any:
    """Windows of `seq_len` consecutive inserts beginning `start` [B]
    inserts after the oldest valid entry, as [B, seq_len, ...] leaves."""
    capacity = capacity_of(state)
    offsets = torch.arange(seq_len, device=start.device)
    idx = (oldest_slot(state) + start[:, None] + offsets[None, :]) % capacity
    return sample_at(state, idx, codecs)


def sample_sequences(
    state: ReplayState, generator: torch.Generator, batch_size: int, seq_len: int,
    codecs: Optional[Any] = None,
) -> Any:
    """`batch_size` windows of `seq_len` consecutive inserts, under the JAX
    package's window contract (`actor_critic_tpu/replay/buffer.py`'s
    `sample_sequences`):

    1. Start offsets are drawn in insertion order from the oldest valid
       entry, so a window may wrap around the physical ring but never
       crosses the write cursor's seam (it never splices the newest
       inserts onto the oldest).
    2. Episode ends inside a window are the consumer's to mask (the stored
       `done` flags; `algos.ddpg.nstep_batch`).
    3. Env interleaving is the caller's: consecutive inserts are one env's
       consecutive steps only when E == 1.

    Callers ensure size >= seq_len; the bound's floor only keeps the draw
    legal. Leaves are [batch_size, seq_len, ...], decoded."""
    start = draw_indices(generator, batch_size, window_bound(state, seq_len))
    return sequences_at(state, start, seq_len, codecs)
