"""torchlint fixture (MUST FLAG prng-reuse): two generators seeded alike,
and a draw inside a capture from a generator the graph does not know.
Parsed by the tests; chip_smoke.py captures noisy_capture on the card."""

import torch


def sample_pair(seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(4, generator=gen, device="cuda")
    twin = torch.Generator(device="cuda").manual_seed(seed)  # the same stream again
    return a + torch.randn(4, generator=twin, device="cuda")


def noisy_capture(gen, x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = x + torch.randn(x.shape, generator=gen, device=x.device)  # unregistered
    return graph, out
