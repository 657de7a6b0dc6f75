"""torchlint fixture (near miss, must NOT flag): branches on host metadata
(.shape, .dim()), identity checks (`is None`), a Python scalar argument,
and torch.where for the data-dependent choice. Parsed by the tests;
chip_smoke.py captures it."""

import torch


def relu_branch(x, n: int = 0):
    if x.shape[0] > 1 and x.dim() == 1:  # host metadata: no sync
        x = x * 1.0
    if n > 0:  # a Python value: static for the capture
        x = x + n
    return torch.where(x.sum() > 0, x, -x)  # the choice stays on the card


def make_step(cfg):
    def step(state, flat=None):
        if flat is not None and flat.shape[0] % 4 != 0:  # shape guard
            raise ValueError("bad batch")
        return state.sum()

    return step


def captured_relu(x):
    """`relu_branch(x)` captured into a graph: (graph, its output)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = relu_branch(x)
    return graph, out
