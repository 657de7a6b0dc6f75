# torchlint: hot-module
"""torchlint fixture (MUST FLAG transfer-discipline): host<->device
crossings inside steady-state loop bodies — the syncs (the host-sync
family this pass absorbed) and the per-iteration copies to the card,
the class the device data plane exists to remove. Parsed only — never
imported."""

import numpy as np

import torch


def collect(pool, act, obs, steps, update, state):
    for _ in range(steps):
        action = act(obs).cpu().numpy()  # device→host copy per step
        out = pool.step(np.asarray(action))
        state, metrics = update(state, out)
        loss = float(metrics["loss"])  # sync per step
        torch.cuda.synchronize()  # a hard fence per step
    return state, loss


def consume(queue, update, params, opt_state, n):
    """The host-gather learner shape: every consumed block is fetched to
    the host and copied back inside the steady-state loop."""
    for _ in range(n):
        block = queue.get()
        host = {k: v.cpu() for k, v in block.arrays.items()}  # device→host per block
        arrays = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}  # back
        params, opt_state, _ = update(params, opt_state, arrays)
    return params, opt_state


def restage(run, state, blocks):
    for b in blocks:
        staged = b.to("cuda", non_blocking=True)  # host→device copy per iteration
        state = run(state, staged)
    return state
