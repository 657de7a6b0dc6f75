"""The whole step's share of the card's float32 peak, in %: the model
FLOPs of one iteration (the configuration's `model_flops`) over the
iteration's device time in the untraced block of a traced run."""

from chipbench import peaks


def read(run):
    if run.plain is None or run.plain.seconds <= 0 or run.trace is None:
        return None
    per_iter = run.plain.seconds / run.plain.iterations
    flops = run.cell.config_mod.model_flops(run.cell.conf, run.cell.num_envs, run.cell.steps)
    return 100.0 * flops / per_iter / peaks.FP32_FLOPS_PER_S
