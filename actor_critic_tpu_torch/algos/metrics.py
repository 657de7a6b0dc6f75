"""Metric aggregation shared by the trainers (counterpart of
`actor_critic_tpu/algos/metrics.py`): single device without a group, the
cross-rank pmean/psum with one (`parallel/mesh.py`)."""

from __future__ import annotations

import torch

from actor_critic_tpu_torch.parallel.mesh import Group, pmean, psum


def aggregate_metrics(metrics: dict, ep_metrics: dict, group: Group = None) -> dict:
    """Combine loss metrics (pmean over `group`'s ranks) with episode
    accounting (psum, then divide, so ranks with no finished episode do not
    bias the mean); `group=None` is the single device."""
    n = psum(ep_metrics["episodes_finished"], group)
    out = {k: pmean(v, group) for k, v in metrics.items()}
    out["episodes_finished"] = n
    out["mean_finished_return"] = (psum(ep_metrics["finished_return_sum"], group)
                                   / torch.clamp(n, min=1.0))
    if "finished_length_sum" in ep_metrics:
        out["mean_ep_length"] = (psum(ep_metrics["finished_length_sum"], group)
                                 / torch.clamp(n, min=1.0))
    # avg_return_ema is pmean'd by the caller before the state update.
    out["avg_return_ema"] = ep_metrics["avg_return_ema"]
    return out
