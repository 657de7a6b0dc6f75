"""torchlint fixture (near miss, must NOT flag): the second generator's
seed is offset, and the capture registers the generator it draws from
(as loop.CapturedStep does). Parsed by the tests; chip_smoke.py captures
noisy_capture on the card."""

import torch


def sample_pair(seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(4, generator=gen, device="cuda")
    twin = torch.Generator(device="cuda").manual_seed(seed + 1)  # another stream
    b = torch.randn(4, generator=twin, device="cuda")
    return a + b


def noisy_capture(gen, x):
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)  # every replay advances gen's offset
    with torch.cuda.graph(graph):
        out = x + torch.randn(x.shape, generator=gen, device=x.device)
    return graph, out
