"""torchlint fixture (near miss, must NOT flag): the same recycled shape
written in place, and the view re-derived after the rebuild. Parsed only —
never imported."""

import torch


def make_update_step(cfg):
    def update(ring, block):
        return ring

    return update


def learner_loop(cfg, ring, blocks):
    update = make_update_step(cfg)
    for block in blocks:
        ring[:-1].copy_(ring[1:].clone())  # in place: the same buffer
        ring[-1].copy_(block)
    return update(ring, blocks[0])


def fresh_view(stats, block):
    stats = torch.cat([stats[1:], block[None]])
    quant = stats[0]  # derived from the NEW tensor
    return stats, quant


def read_before_rebuild(stats, block):
    quant = stats[0]
    digest = float(quant.sum())  # the view consumed BEFORE the rebuild ...
    stats = torch.cat([stats[1:], block[None]])
    return stats, digest  # ... only the host value survives
