"""Env steps completed a second in the timed window: iterations × E × T
over the window's device seconds, from the event before the first replay
to the event after the last."""


def read(run):
    w = run.window
    if w is None or w.seconds <= 0:
        return None
    return w.iterations * run.cell.num_envs * run.cell.steps / w.seconds
