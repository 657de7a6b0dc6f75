"""torchlint fixture (MUST FLAG warmup-registry when its key is not
registered): a capture site with no warm-up entry. The test injects the
registry; parsed only — never imported."""

from actor_critic_tpu_torch.algos import loop


def make_step(cfg):
    def step(state):
        return state, {}

    return loop.CapturedStep(step, cfg)
