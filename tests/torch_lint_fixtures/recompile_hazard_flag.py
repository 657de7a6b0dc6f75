"""torchlint fixture (MUST FLAG recompile-hazard): a capture inside a loop,
and a len()-derived Python scalar fed to a captured program. Parsed only —
never imported."""

from actor_critic_tpu_torch.algos import loop
from actor_critic_tpu_torch.algos.ppo import make_host_update_step


def per_item(step, states):
    out = []
    for state in states:
        graph = loop.CapturedStep(step, state)  # a fresh capture every iteration
        out.append(graph)
    return out


tail_update = make_host_update_step(None, None)


def dispatch_tail(batch):
    n = len(batch)
    return tail_update(batch, n)  # the graph bakes in the first n
