"""Metric aggregation shared by the trainers (counterpart of
`actor_critic_tpu/algos/metrics.py`), single device: the cross-device
psum/pmean comes with the multi-GPU slice."""

from __future__ import annotations

import torch


def aggregate_metrics(metrics: dict, ep_metrics: dict) -> dict:
    """Combine loss metrics with episode accounting (sum-then-divide)."""
    n = ep_metrics["episodes_finished"]
    out = dict(metrics)
    out["episodes_finished"] = n
    out["mean_finished_return"] = ep_metrics["finished_return_sum"] / torch.clamp(n, min=1.0)
    if "finished_length_sum" in ep_metrics:
        out["mean_ep_length"] = ep_metrics["finished_length_sum"] / torch.clamp(n, min=1.0)
    out["avg_return_ema"] = ep_metrics["avg_return_ema"]
    return out
