"""The comparison that decides `correct`: the program's first train
steps against the plain reference's, from the same weights and draws.

Both sides give the same readings: each step's loss, the clipped first
gradient's norm by leaf (the program's worked out from its optimizer
state after one step), the parameters' change by leaf after the steps,
and the carried env and episode state. The numbers:

- `loss_gap`: the widest relative gap of a step's loss;
- `grad_gap`: the worst leaf's gap between the two gradient norms,
  against the reference's norm of that leaf or of the median leaf,
  whichever is larger (some gradients are all but zero);
- `delta_gap`: the same of the parameters' change, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's (a
  leaf whose gradient is nought to rounding moves under Adam by
  round-off alone);
- `actor_gap`, where the configuration keeps stale actors: the same of
  the actors' change after the steps, which span the first refresh (an
  actor never refreshed reads 1);
- `state_gap`: the widest relative L1 gap of a carried state tensor
  (obs, episode return and length), against the reference's L1 or 1.

A non-finite reading is an infinite gap. A number with a limit in the
cell's limits file is compared; the others are printed for the record.
"""

from __future__ import annotations

import math
import statistics

import torch

# The rule that leaves a leaf out of `delta_gap`: its reference gradient
# under this share of the median leaf's.
NEGLIGIBLE_GRADIENT = 1e-3


def _rel(p: float, r: float, scale: float) -> float:
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / scale if scale > 0 else (0.0 if p == r else math.inf)


def kept_leaves(ref_grads: dict) -> list[str]:
    med = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= NEGLIGIBLE_GRADIENT * med]


def _change_gap(prog: dict, ref: dict, kept: list[str]) -> float:
    """The worst kept leaf's gap of change norms, against the larger of its
    and the median kept leaf's reference norm."""
    med = statistics.median(ref[k] for k in kept)
    return max(_rel(prog[k], ref[k], max(ref[k], med)) for k in kept)


def gaps(prog: dict, ref: dict) -> dict[str, float]:
    """The numbers of the module's docstring, program against reference."""
    loss_gap = max(_rel(p, r, abs(r)) for p, r in zip(prog["losses"], ref["losses"], strict=True))
    rg, pg = ref["grad_norms"], prog["grad_norms"]
    med = statistics.median(rg.values())
    grad_gap = max(_rel(pg[k], rg[k], max(rg[k], med)) for k in rg)
    kept = kept_leaves(rg)
    delta_gap = _change_gap(prog["delta_norms"], ref["delta_norms"], kept)
    changes = {"delta_gap": delta_gap}
    if "actor_delta_norms" in ref:
        changes["actor_gap"] = _change_gap(prog["actor_delta_norms"], ref["actor_delta_norms"], kept)
    state_gap = 0.0
    for k, r in ref["state"].items():
        p = prog["state"][k].double()
        r = r.double()
        if not torch.isfinite(p).all():
            return dict(loss_gap=loss_gap, grad_gap=grad_gap, **changes, state_gap=math.inf)
        state_gap = max(state_gap, float((p - r).abs().sum()) / max(float(r.abs().sum()), 1.0))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, **changes, "state_gap": state_gap}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every compared number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
