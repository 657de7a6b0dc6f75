"""torchlint fixture (MUST FLAG tracer-leak): a host sync on a captured
tensor inside a CUDA-graph capture. Parsed by the tests; chip_smoke.py
captures it on the card."""

import torch


def relu_branch(x):
    if x.sum() > 0:  # a tensor in a Python `if`: a sync inside the capture
        return x * 1.0
    return -x


def make_step(cfg):
    def step(state):
        total = state.sum()
        while total > 0:  # a tensor drives a Python `while`
            total = total - 1.0
        return total

    return step


def captured_relu(x):
    """`relu_branch(x)` captured into a graph: (graph, its output)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = relu_branch(x)
    return graph, out
