"""torchlint fixture (near miss, must NOT flag): one capture per key (as
loop.warm_up keeps them), and the data-dependent scalar passed in a device
tensor. Parsed only — never imported."""

import torch

from actor_critic_tpu_torch.algos import loop
from actor_critic_tpu_torch.algos.ppo import make_host_update_step


def per_item(step, state, sizes):
    graphs = {}
    for n in sizes:
        graphs[n] = loop.CapturedStep(step, state, n)  # one graph per steps-per-replay
    return graphs


tail_update = make_host_update_step(None, None)


def dispatch_tail(batch):
    n = len(batch)
    return tail_update(batch, torch.as_tensor(n))
