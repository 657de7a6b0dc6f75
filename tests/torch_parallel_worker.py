"""One rank of a CPU (gloo) process group for the port's data- and
sequence-parallel tests (`tests/test_torch_parallel.py`,
`test_torch_seqpar.py`, `test_torch_checkpoint_sharded.py`):

    python tests/torch_parallel_worker.py RANK WORLD HOST:PORT IN.npz OUT.npz

(`run_ranks` spawns the ranks and reads their results back.)

It joins the group through `multihost.distributed_init(..., "cpu")` and runs
every case IN names (`cases`, a JSON list of [name, mode, options]) in that
order, each on its share of the case's inputs (`<name>.<key>` in IN), and
writes each case's results as `<name>.<key>` into OUT. Every rank runs the
same cases in the same order, so every `new_group` and collective matches.

Modes:
- `seqpar`: `make_seqpar_fn` of `seqpar_discounted_returns`, `seqpar_gae`
  and `seqpar_vtrace` over an sp mesh of the world, this rank's segment of
  each output;
- `sp_update`: `impala.make_sp_update` on a global trajectory, 1-D (sp) or
  2-D (sp × dp) from given parameters: the parameters and metrics after;
- `sp_train`: `impala.make_sp_train_step` for three iterations against the
  step it must equal: the single-device step (1-D) or the dp step over the
  mesh's dp group (2-D), both run here from the same state;
- `grad`: A2C's loss gradient on this rank's env shard, pmean'd over the
  world (`FlatGradients`);
- `dp_step`: `distribute_state` → `make_dp_train_step` → two steps of a
  fused trainer: every carried tensor and metric after;
- `world1`: the same dp steps through a one-rank group against no group;
- `learn`: dp A2C on the two-state MDP, π(a=1) at both states after;
- `mismatch`: `make_dp_train_step` over ranks built from different seeds;
- `mesh`: `make_mesh` and a 2-D `make_process_mesh` of the world (shape,
  coordinates, group sizes, the error of a layout that does not fit);
- `stats`: `quantize.update_stats` of this rank's rows of a batch with the
  world group (an `i8` leaf's mean and scale);
- `gather`: `mesh.all_gather` of each rank's row of a plane holding −0.0,
  NaN and ±inf;
- `ckpt`: dp TD3 saved by every rank (`Checkpointer(mesh=...)`), continued,
  and restored into a fresh distributed template and continued again.

Imports nothing of JAX: the tests build the inputs on JAX's side.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from actor_critic_tpu_torch.algos import a2c, ddpg, impala, ppo, sac
from actor_critic_tpu_torch.algos.common import Transition, carried_tensors
from actor_critic_tpu_torch.envs import make_point_mass, make_two_state_mdp
from actor_critic_tpu_torch.parallel import dp, mesh, multihost, seqpar

TRANSITION = Transition._fields
GAMMA, LAM = 0.99, 0.95


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def run_seqpar(z, opts) -> dict:
    m = seqpar.make_sp_mesh()
    disc = seqpar.make_seqpar_fn(seqpar.seqpar_discounted_returns, m, n_time_sharded_args=2)
    gae = seqpar.make_seqpar_fn(seqpar.seqpar_gae, m, n_time_sharded_args=3)
    vtrace = seqpar.make_seqpar_fn(seqpar.seqpar_vtrace, m, n_time_sharded_args=5)
    r, v, d, b = (_t(z[k]) for k in ("rewards", "values", "dones", "bootstrap"))
    out = {"disc": disc(r, d, b, GAMMA).numpy()}
    out["adv"], out["ret"] = (x.numpy() for x in gae(r, v, d, b, GAMMA, LAM))
    vt = vtrace(_t(z["target_lp"]), _t(z["behav_lp"]), r, v, d, b, GAMMA, 1.0, 1.0, 0.9)
    out.update(vs=vt.vs.numpy(), pg=vt.pg_advantages.numpy(), rho=vt.clipped_rhos.numpy())
    out["nodones_adv"] = gae(*(_t(z[f"nodones_{k}"]) for k in ("rewards", "values", "dones",
                                                               "bootstrap")), GAMMA, LAM)[0].numpy()
    long = gae(*(_t(z[f"long_{k}"]) for k in ("rewards", "values", "dones", "bootstrap")),
               GAMMA, LAM)
    out["long_adv"], out["long_ret"] = (x.numpy() for x in long)
    return out


def _sp_mesh(layout: str) -> mesh.Mesh:
    if layout == "1d":
        return seqpar.make_sp_mesh()
    return mesh.make_process_mesh((2, dist.get_world_size() // 2), (seqpar.SP_AXIS, mesh.DP_AXIS))


def _impala_cfg(opts) -> impala.ImpalaConfig:
    return impala.ImpalaConfig(**{k: tuple(v) if k == "hidden" else v
                                  for k, v in opts["cfg"].items()})


def _params_out(net, prefix="param.") -> dict:
    return {f"{prefix}{k}": p.detach().numpy().copy() for k, p in net.named_parameters()}


def run_sp_update(z, opts) -> dict:
    env = make_two_state_mdp()
    cfg = _impala_cfg(opts)
    net = impala.make_network(env, cfg)
    net.load_state_dict({k[len("param."):]: _t(z[k]) for k in z if k.startswith("param.")})
    opt_state = impala.make_optimizer(cfg).init(dict(net.named_parameters()))
    traj = Transition(*(_t(z[f"traj.{k}"]) for k in TRANSITION))
    dp_axis = None if opts["layout"] == "1d" else mesh.DP_AXIS
    update = impala.make_sp_update(env, cfg, _sp_mesh(opts["layout"]), dp_axis_name=dp_axis)
    metrics = update(net, opt_state, traj, _t(z["bootstrap_obs"]))
    out = _params_out(net)
    out.update({f"metric.{k}": np.asarray(float(v)) for k, v in metrics.items()})
    return out


def _state_out(state, metrics, prefix: str) -> dict:
    out = {f"{prefix}state.{k}": t.detach().numpy().copy() for k, t in
           carried_tensors(state).items()}
    out.update({f"{prefix}metric.{k}": np.asarray(float(v)) for k, v in metrics.items()})
    return out


def run_sp_train(z, opts) -> dict:
    env = make_two_state_mdp()
    cfg = _impala_cfg(opts)
    m = _sp_mesh(opts["layout"])
    out = {}
    if opts["layout"] == "1d":
        ref_step, sp_dp = impala.make_train_step(env, cfg), None
    else:
        ref_step, sp_dp = impala.make_train_step(env, cfg, group=m.group(mesh.DP_AXIS)), \
            mesh.DP_AXIS
    for prefix, make in (("ref.", lambda: ref_step),
                         ("sp.", lambda: impala.make_sp_train_step(env, cfg, m,
                                                                   dp_axis_name=sp_dp))):
        state = impala.init_state(env, cfg, seed=0, device="cpu")
        if sp_dp is not None:
            state = dp.distribute_state(state, m, dp.impala_state_specs())
        step = make()
        for _ in range(opts["iterations"]):
            state, metrics = step(state)
        out.update(_state_out(state, metrics, prefix))
    return out


def run_grad(z, opts) -> dict:
    env = make_two_state_mdp()
    cfg = a2c.A2CConfig(num_envs=8, rollout_steps=4, hidden=(16,),
                        normalize_adv=opts["normalize_adv"])
    net = a2c.make_network(env, cfg)
    net.load_state_dict({k[len("param."):]: _t(z[k]) for k in z if k.startswith("param.")})
    group = mesh.world_group()
    n, r = dist.get_world_size(), dist.get_rank()
    E = z["adv"].shape[1] // n
    cols = slice(r * E, (r + 1) * E)
    traj = Transition(*(_t(z[f"traj.{k}"][:, cols]) for k in TRANSITION))
    loss, _ = a2c.a2c_loss(net, traj, _t(z["adv"][:, cols]), _t(z["ret"][:, cols]), cfg,
                           group=group)
    params = dict(net.named_parameters())
    grads = mesh.FlatGradients(group)(torch.autograd.grad(loss, list(params.values())))
    return {f"grad.{k}": g.numpy().copy() for k, g in zip(params, grads)}


def _trainer(name: str):
    """(module, env, cfg, specs) of a small dp case of each fused trainer."""
    mdp, pm = make_two_state_mdp(), make_point_mass()
    off = dict(num_envs=16, steps_per_iter=4, updates_per_iter=2, buffer_capacity=512,
               batch_size=8, warmup_steps=0, hidden=(16,))
    return {
        "a2c": (a2c, mdp, a2c.A2CConfig(num_envs=32, rollout_steps=4, hidden=(16,),
                                        normalize_adv=True), dp.train_state_specs()),
        "ppo": (ppo, mdp, ppo.PPOConfig(num_envs=16, rollout_steps=8, hidden=(16,), epochs=2,
                                        num_minibatches=4), dp.train_state_specs()),
        "impala": (impala, mdp, impala.ImpalaConfig(num_envs=16, rollout_steps=4, hidden=(16,),
                                                    actor_refresh_every=2),
                   dp.impala_state_specs()),
        "td3_fp32": (ddpg, pm, ddpg.td3_config(**off), dp.offpolicy_state_specs()),
        "td3_int8": (ddpg, pm, ddpg.td3_config(**off, replay_dtype="int8"),
                     dp.offpolicy_state_specs()),
        "sac": (sac, pm, sac.SACConfig(**off), dp.sac_state_specs()),
    }[name]


def _dp_run(name: str, m: mesh.Mesh, group, iterations: int, seed: int = 0):
    mod, env, cfg, specs = _trainer(name)
    state = dp.distribute_state(mod.init_state(env, cfg, seed=seed, device="cpu"), m, specs)
    step = mod.make_train_step(env, cfg, group=group)
    if group is not None:
        step = dp.make_dp_train_step(step, m, specs)
    for _ in range(iterations):
        state, metrics = step(state)
    return state, metrics


def run_dp_step(z, opts) -> dict:
    m = mesh.make_mesh()
    state, metrics = _dp_run(opts["trainer"], m, m.group(mesh.DP_AXIS), opts["iterations"])
    return _state_out(state, metrics, "")


def run_world1(z, opts) -> dict:
    """The dp step through this rank's own one-rank group against the step
    with no group, from the same distributed state: equal at 0.0."""
    singles = [dist.new_group([r]) for r in range(dist.get_world_size())]
    one_rank = mesh.Mesh({mesh.DP_AXIS: 1, mesh.MODEL_AXIS: 1}, 0,
                         {(mesh.DP_AXIS,): singles[dist.get_rank()], (mesh.MODEL_AXIS,): None,
                          (mesh.DP_AXIS, mesh.MODEL_AXIS): singles[dist.get_rank()]})
    out = {}
    for name in opts["trainers"]:
        grouped = _state_out(*_dp_run(name, one_rank, one_rank.group(mesh.DP_AXIS), 2), "")
        alone = _state_out(*_dp_run(name, one_rank, None, 2), "")
        assert sorted(grouped) == sorted(alone)
        out[f"{name}.max_diff"] = np.asarray(max(
            float(np.abs(grouped[k].astype(np.float64) - alone[k].astype(np.float64)).max())
            for k in grouped))
        out[f"{name}.mismatches"] = np.asarray(sum(
            int((grouped[k] != alone[k]).sum()) for k in grouped))
        out[f"{name}.tensors"] = np.asarray(len(grouped))
    return out


def run_learn(z, opts) -> dict:
    env = make_two_state_mdp()
    cfg = a2c.A2CConfig(num_envs=32, rollout_steps=8, lr=3e-3, gamma=0.9, hidden=(32,),
                        entropy_coef=0.001)
    m = mesh.make_mesh()
    state = dp.distribute_state(a2c.init_state(env, cfg, seed=1, device="cpu"), m)
    step = dp.make_dp_train_step(a2c.make_train_step(env, cfg, group=m.group(mesh.DP_AXIS)), m)
    for _ in range(opts["iterations"]):
        state, metrics = step(state)
    with torch.no_grad():
        dist_, _ = state.net(torch.eye(2))
        p1 = torch.softmax(dist_.logits, -1)[:, 1]
    return {"p1": p1.numpy(), "loss": np.asarray(float(metrics["loss"]))}


def run_mismatch(z, opts) -> dict:
    try:
        _dp_run("a2c", mesh.make_mesh(), mesh.world_group(), 1, seed=dist.get_rank())
    except ValueError as e:
        return {"error": np.asarray(str(e))}
    return {"error": np.asarray("")}


def run_mesh(z, opts) -> dict:
    m = mesh.make_mesh()
    grid = mesh.make_process_mesh((2, dist.get_world_size() // 2), ("sp", mesh.DP_AXIS))
    try:
        mesh.make_mesh(mesh.MeshConfig(dp=dist.get_world_size() + 1))
        error = ""
    except ValueError as e:
        error = str(e)
    sizes = [mesh.world_size(g) if g is not None else 1
             for g in (grid.group("sp"), grid.group(mesh.DP_AXIS), grid.group("sp", mesh.DP_AXIS))]
    # Each line's collective reaches its own ranks only.
    ranks_sp = mesh.all_gather(torch.tensor([float(dist.get_rank())]), grid.group("sp"))
    return {"dp": np.asarray(m.shape[mesh.DP_AXIS]), "index": np.asarray(m.index(mesh.DP_AXIS)),
            "grid_index": np.asarray([grid.index("sp"), grid.index(mesh.DP_AXIS)]),
            "grid_sizes": np.asarray(sizes), "sp_line": ranks_sp.numpy()[:, 0],
            "error": np.asarray(error)}


def run_stats(z, opts) -> dict:
    from actor_critic_tpu_torch.replay import quantize

    n, r = dist.get_world_size(), dist.get_rank()
    rows = z["batch"].shape[0] // n
    stats = quantize.init_stats("i8", _t(z["batch"][0]))
    for lo in range(0, rows, opts["chunk"]):
        batch = _t(z["batch"][r * rows:(r + 1) * rows][lo:lo + opts["chunk"]])
        stats = quantize.update_stats("i8", stats, batch, mesh.world_group())
    return {"mean": stats.mean.numpy(), "scale": stats.scale.numpy(),
            "count": stats.count.numpy()}


def run_ckpt(z, opts) -> dict:
    from actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    m = mesh.make_mesh()
    group = m.group(mesh.DP_AXIS)
    mod, env, cfg, specs = _trainer("td3_fp32")
    step = dp.make_dp_train_step(mod.make_train_step(env, cfg, group=group), m, specs)
    state = dp.distribute_state(mod.init_state(env, cfg, seed=0, device="cpu"), m, specs)
    for _ in range(3):
        state, _ = step(state)
    ckpt = Checkpointer(opts["directory"], mesh=m)
    ckpt.save(3, state, {})
    dist.barrier()
    saved = {k: t.clone() for k, t in carried_tensors(state).items()}
    saved_generator = state.generator.get_state()
    out = {}
    for i in range(2):
        state, metrics = step(state)
        out.update(_state_out(state, metrics, f"cont{i}."))
    template = dp.distribute_state(mod.init_state(env, cfg, seed=0, device="cpu"), m, specs)
    restored_step = ckpt.restore(template, 3)
    out["restored_step"] = np.asarray(restored_step)
    out["restored_equal"] = np.asarray(all(
        torch.equal(t, saved[k]) for k, t in carried_tensors(template).items()))
    out["generator_equal"] = np.asarray(torch.equal(template.generator.get_state(),
                                                    saved_generator))
    out["ring_rows"] = np.asarray(template.learner.replay.storage.obs.shape[0])
    for i in range(2):
        template, metrics = step(template)
        out.update(_state_out(template, metrics, f"restored{i}."))
    return out


def run_gather(z, opts) -> dict:
    """`mesh.all_gather` over the world of this rank's row of `x` (a
    [W, n] float32 plane: −0.0, NaN and ±inf among the values)."""
    x = _t(z["x"][dist.get_rank()])
    return {"gathered": mesh.all_gather(x, mesh.world_group()).numpy()}


MODES = {"seqpar": run_seqpar, "gather": run_gather, "sp_update": run_sp_update, "sp_train": run_sp_train,
         "grad": run_grad, "dp_step": run_dp_step, "world1": run_world1, "learn": run_learn,
         "mismatch": run_mismatch, "mesh": run_mesh, "stats": run_stats, "ckpt": run_ckpt}


def main(argv) -> int:
    rank, world, coordinator, inp, outp = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    multihost.distributed_init(coordinator, world, rank, "cpu")
    results = {}
    try:
        with np.load(inp) as z:
            cases = json.loads(str(z["cases"]))
            for name, mode, opts in cases:
                prefix = f"{name}."
                arrays = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
                for k, v in MODES[mode](arrays, opts).items():
                    results[f"{name}.{k}"] = v
        np.savez(outp, **results)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, cases: list, directory, timeout: float = 240.0) -> dict:
    """Spawn `world` gloo ranks running `cases` ([(name, mode, options,
    inputs)], in that order) and return {name: [each rank's results]}."""
    directory = str(directory)
    inputs = {"cases": np.asarray(json.dumps([[n, m, o] for n, m, o, _ in cases]))}
    for name, _, _, arrays in cases:
        inputs.update({f"{name}.{k}": v for k, v in arrays.items()})
    inp = os.path.join(directory, f"parallel_in_w{world}.npz")
    np.savez(inp, **inputs)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH", "")) if p))
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = [os.path.join(directory, f"parallel_out_w{world}_r{r}.npz") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               coordinator, inp, outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{log[-4000:]}"
    results: dict = {name: [] for name, *_ in cases}
    for out in outs:
        with np.load(out) as z:
            for name in results:
                prefix = f"{name}."
                results[name].append({k[len(prefix):]: z[k] for k in z.files
                                      if k.startswith(prefix)})
    return results


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
