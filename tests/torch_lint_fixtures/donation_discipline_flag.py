"""torchlint fixture (MUST FLAG donation-discipline): a recycled buffer
rebuilt out of place every iteration where the port writes in place, and a
view of a buffer read after the buffer was rebuilt. Parsed only — never
imported."""

import torch


def make_update_step(cfg):
    """The ring's per-step update: the buffer is the trainer's, recycled
    every iteration."""

    def update(ring, block):
        return ring

    return update


def learner_loop(cfg, ring, blocks):
    update = make_update_step(cfg)
    for block in blocks:
        # a fresh buffer every iteration, and a graph captured over the
        # old one keeps reading it
        ring = torch.cat([ring[1:], block[None]])
    return update(ring, blocks[0])


def stale_view(stats, block):
    """A view of a rebuilt tensor still reads the old storage."""
    quant = stats[0]  # a view INTO the tensor ...
    stats = torch.cat([stats[1:], block[None]])  # ... rebuilt elsewhere
    return stats, quant  # ... the view reads the old storage
