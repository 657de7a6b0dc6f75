"""One rank of a CPU (gloo) process group for `tests/test_torch_multihost.py`:

    python tests/torch_multihost_worker.py MODE[,MODE2..] RANK WORLD HOST:PORT \
        IN.npz[,IN2.npz..] OUT.npz[,OUT2.npz..]

It joins the group through `multihost.distributed_init(..., "cpu")`, runs
each MODE on its share of the matching IN and writes its results to the
matching OUT:

- `update`: the sync learner's update (`ppo.make_async_update_fn` with the
  world group) on this rank's half of the [T, 2·E_a] block, the
  normalized advantages of its half through `normalize_advantages(group)`,
  and the same update through a one-rank group against the update with no
  group (`w1_*`: every parameter, moment and metric, their largest
  difference and mismatch count);
- `check`: `multihost.make_consistency_check` on a fingerprint whose
  float sum over three ranks would round, once with every rank equal and
  once with rank 1 one ulp off, and a stop vote from the last rank;
- `metrics`: `aggregate_metrics` with the world group on this rank's row
  of each metric and episode count, and `mesh.pmean_tree` of this rank's
  slice of a tree.

Imports nothing of JAX: the test builds the inputs from JAX's side.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from actor_critic_tpu_torch.algos import ppo
from actor_critic_tpu_torch.algos.metrics import aggregate_metrics
from actor_critic_tpu_torch.envs.env import EnvSpec
from actor_critic_tpu_torch.ops.returns import normalize_advantages
from actor_critic_tpu_torch.parallel import mesh, multihost

FIELDS = ("obs", "action", "log_prob", "value", "reward", "done", "terminated", "final_obs",
          "last_obs")


def _learner(spec, cfg, state):
    net = ppo.make_network(spec, cfg)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return net, ppo.make_optimizer(cfg).init(dict(net.named_parameters()))


def _update(spec, cfg, state, block, perms, group):
    net, opt_state = _learner(spec, cfg, state)
    metrics = ppo.make_async_update_fn(spec, cfg, group=group)(
        net, opt_state, ppo.make_schedule(cfg), *(block[k] for k in FIELDS), perms)
    out = {f"param.{k}": p.detach().numpy().copy() for k, p in net.named_parameters()}
    out.update({f"mu.{k}": v.numpy().copy() for k, v in opt_state.mu.items()})
    out.update({f"nu.{k}": v.numpy().copy() for k, v in opt_state.nu.items()})
    out.update({f"metric.{k}": np.asarray(float(v)) for k, v in metrics.items()})
    out["count"] = opt_state.count.numpy().copy()
    return out


def run_update(rank: int, world: int, z) -> dict:
    meta = json.loads(str(z["meta"]))
    spec = EnvSpec(obs_shape=tuple(meta["obs_shape"]), action_dim=meta["action_dim"],
                   discrete=meta["discrete"])
    cfg = ppo.PPOConfig(**{k: tuple(v) if k == "hidden" else v for k, v in meta["cfg"].items()})
    state = {k[len("param."):]: z[k] for k in z.files if k.startswith("param.")}
    E = z["block.reward"].shape[1] // world
    cols = slice(rank * E, (rank + 1) * E)
    block = {k: torch.from_numpy(np.ascontiguousarray(
        z[f"block.{k}"][cols] if k == "last_obs" else z[f"block.{k}"][:, cols])) for k in FIELDS}
    perms = torch.from_numpy(z["perms"])
    out = _update(spec, cfg, state, block, perms, mesh.world_group())
    n = z["adv"].shape[0] // world
    adv = torch.from_numpy(z["adv"][rank * n:(rank + 1) * n].copy())
    out["norm"] = normalize_advantages(adv, mesh.world_group()).numpy()
    # World 1: each rank's own one-rank group against no group at all.
    singles = [dist.new_group([r]) for r in range(world)]
    one = _update(spec, cfg, state, block, perms, singles[rank])
    alone = _update(spec, cfg, state, block, perms, None)
    diffs = [np.abs(one[k].astype(np.float64) - alone[k].astype(np.float64)).max()
             for k in one]
    out["w1_max_diff"] = np.asarray(max(diffs))
    out["w1_mismatches"] = np.asarray(sum(int((one[k] != alone[k]).sum()) for k in one))
    out["w1_tensors"] = np.asarray(len(one))
    return out


def run_check(rank: int, world: int, z) -> dict:
    check = multihost.make_consistency_check(mesh.world_group(), torch.device("cpu"))
    fp = float(z["fingerprint"])
    vote = 1.0 if rank == world - 1 else 0.0
    equal = check(7.0, fp, vote)
    off = check(7.0, float(np.nextafter(fp, np.inf)) if rank == 1 else fp, 0.0)
    summed = mesh.psum(torch.tensor([fp], dtype=torch.float64), mesh.world_group())
    return {"equal": np.asarray(equal), "off": np.asarray(off),
            "sum_mean": np.asarray(float(summed[0]) / world)}


def run_metrics(rank: int, world: int, z) -> dict:
    group = mesh.world_group()
    row = lambda prefix: {k[len(prefix):]: torch.tensor(z[k][rank]) for k in z.files
                          if k.startswith(prefix)}
    agg = aggregate_metrics(row("metric."), row("ep."), group)
    tree = {k[len("tree."):]: torch.from_numpy(np.array(z[k][rank])) for k in z.files
            if k.startswith("tree.")}
    out = {f"agg.{k}": v.numpy() for k, v in agg.items()}
    out.update({f"tree.{k}": v.numpy() for k, v in mesh.pmean_tree(tree, group).items()})
    return out


def main(argv) -> int:
    modes, rank, world, coordinator, inputs, outputs = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    multihost.distributed_init(coordinator, world, rank, "cpu")
    try:
        # Several cases in one group, one after the other: MODE, IN and OUT
        # are comma-separated lists of the same length.
        for mode, inp, out in zip(modes.split(","), inputs.split(","), outputs.split(","),
                                  strict=True):
            with np.load(inp) as z:
                run = {"update": run_update, "check": run_check, "metrics": run_metrics}[mode]
                result = run(rank, world, z)
            np.savez(out, **result)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
