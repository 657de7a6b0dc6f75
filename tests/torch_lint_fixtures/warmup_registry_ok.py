"""torchlint fixture (near miss, must NOT flag): the same capture-site
shape, but its key IS in the registry the test injects. Parsed only —
never imported."""

from actor_critic_tpu_torch.algos import loop


def make_step(cfg):
    def step(state):
        return state, {}

    return loop.CapturedStep(step, cfg)
