"""Seconds from the process's start to the first timed replay: imports,
the card's start, the env, the state and the weights, the warm-up's two
eager steps and the capture (and, in a fresh checkout, the kernels'
build), and the check's first steps."""


def read(run):
    return run.setup_s if run.window is not None else None
