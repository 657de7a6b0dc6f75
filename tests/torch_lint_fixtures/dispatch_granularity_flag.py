"""torchlint fixture (MUST FLAG dispatch-granularity): per-step work launched
as many small programs — a Python reduction over device values, an eager
torch op in the step loop, and a two-program gather/update chain one
captured program should hold. Parsed only — never imported."""

import torch

from actor_critic_tpu_torch.algos.ppo import make_device_update_step, make_host_update_step

step = make_host_update_step(None, None)
gather = make_device_update_step(None, None)


def python_reduction(states, blocks):
    for b in blocks:
        total = sum(torch.sum(s) for s in states)  # a launch per element
        metrics = step(total, b)
    return metrics


def eager_per_step(state, blocks):
    for b in blocks:
        scaled = torch.mul(b, 0.5)  # its own kernel every step
        metrics = step(state, scaled)
    return metrics


def two_program_chain(state, slots):
    for slot in slots:
        block = gather(state, slot)  # program 1 ...
        metrics = step(state, block)  # ... program 2, every iteration
    return metrics
