# torchlint: hot-module
"""torchlint fixture (near miss, must NOT flag): the same hot-module shapes,
with the values kept on the card inside the loops and the reads and copies
made once outside them. Parsed only — never imported."""

import numpy as np

import torch


def collect(pool, act, obs, steps, update, state):
    for _ in range(steps):
        action = act(obs)  # the mirror's numpy act: nothing crosses
        out = pool.step(action)
        state, metrics = update(state, out)
    history = {k: float(v) for k, v in metrics.items()}  # once, after the loop
    block = torch.as_tensor(np.zeros((steps, 4)), device="cuda")  # not in a loop
    return state, history, block


def consume(ring, update, params, opt_state, n):
    """The device-plane consume: only the slot index rides the dispatch —
    the steady-state loop touches no host arrays."""
    for _ in range(n):
        lease = ring.get()
        params, opt_state, _ = ring.run(
            lambda state: update(params, opt_state, state, lease.slot)
        )
        ring.release(lease)
    out = {k: v.cpu() for k, v in params.items()}  # once, after the loop
    return params, opt_state, out


def restage(run, state, blocks_staged):
    for b in blocks_staged:  # staged ONCE by the caller: resident
        state = run(state, b)
    return state
