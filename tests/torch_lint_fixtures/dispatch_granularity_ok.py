"""torchlint fixture (near miss, must NOT flag): the same work inside one
captured program — the reduction, the scale and the gather run in the
step, and the loop replays it once an iteration. Parsed only — never
imported."""

import torch


def make_fused_step(codecs):
    """Gather, scale, reduce and update inside one captured step."""

    def fused(state, slot):
        block = state.storage[slot]
        scaled = torch.mul(block, 0.5)
        total = torch.sum(scaled)
        return state, total

    return fused


def consume(state, slots, codecs):
    fused = make_fused_step(codecs)
    for slot in slots:
        state, metrics = fused(state, slot)  # one program per iteration
    return state, metrics


def log_cadence_reduction(states, fused, state, slots):
    for slot in slots:
        state, metrics = fused(state, slot)
    return sum(float(m) for m in [metrics])  # once, after the loop
