"""Save and restore of a dp-sharded state (`utils/checkpoint.py` with a
mesh), the port's counterpart of `tests/test_checkpoint_sharded.py`:

- a dp TD3 (its replay ring split over two gloo ranks, spawned as
  processes by `tests/torch_parallel_worker.py`) trains three iterations,
  every rank saves its shard, the run goes on two iterations, and a
  restart-style restore into a freshly distributed template gives back
  every carried tensor and the generator bitwise, the ring still a
  sub-ring of capacity / W, and the two continued iterations bitwise the
  uninterrupted run's (metrics, parameters, ring);
- a restore by a mesh of another size raises and names both sizes (JAX's
  orbax reshards; the port refuses, a deliberate divergence);
- a rank keeps only its newest `max_to_keep` shards.
"""

import os

import numpy as np
import pytest

from actor_critic_tpu_torch.algos import a2c
from actor_critic_tpu_torch.envs import make_two_state_mdp
from actor_critic_tpu_torch.parallel import mesh
from actor_critic_tpu_torch.utils.checkpoint import Checkpointer
from torch_parallel_worker import run_ranks
from torch_threads import one_intra_op_thread  # noqa: F401 (an autouse fixture)

WORLD = 2


def _fake_mesh(rank: int, world: int) -> mesh.Mesh:
    """A rank's view of a dp mesh of `world`, without a process group (the
    checkpointer reads only the rank and the size)."""
    return mesh.Mesh({"dp": world, "model": 1}, rank,
                     {("dp",): None, ("model",): None, ("dp", "model"): None})


def test_sharded_offpolicy_checkpoint_roundtrip(tmp_path):
    directory = tmp_path / "ckpt"
    res = run_ranks(WORLD, [("ckpt", "ckpt", {"directory": str(directory)}, {})],
                    tmp_path)["ckpt"]
    assert sorted(os.listdir(directory / "3")) == ["metrics.json", "state.0-of-2.pt",
                                                    "state.1-of-2.pt"]
    for r, out in enumerate(res):
        assert int(out["restored_step"]) == 3
        assert bool(out["restored_equal"]) and bool(out["generator_equal"]), r
        assert int(out["ring_rows"]) == 512 // WORLD
        for i in range(2):
            cont = {k[len(f"cont{i}."):]: v for k, v in out.items() if k.startswith(f"cont{i}.")}
            rest = {k[len(f"restored{i}."):]: v for k, v in out.items()
                    if k.startswith(f"restored{i}.")}
            assert sorted(cont) == sorted(rest) and cont
            for k in cont:
                np.testing.assert_array_equal(rest[k], cont[k], err_msg=f"rank {r} step {i} {k}")
    # Replicated after the restore and the steps: the ranks' critics agree,
    # their sub-rings do not.
    a, b = res
    for k in a:
        if k.startswith("restored1.state.learner.critic "):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ring = "restored1.state.learner.replay storage.obs"
    assert not np.array_equal(a[ring], b[ring])


def _state():
    cfg = a2c.A2CConfig(num_envs=4, rollout_steps=2, hidden=(8,))
    return a2c.init_state(make_two_state_mdp(), cfg, seed=0, device="cpu")


@pytest.mark.parametrize("saved,restoring", [(2, 1), (1, 2), (2, 4)])
def test_restore_at_another_world_size_names_both(tmp_path, saved, restoring):
    Checkpointer(tmp_path, mesh=_fake_mesh(0, saved) if saved > 1 else None).save(1, _state())
    ckpt = Checkpointer(tmp_path, mesh=_fake_mesh(0, restoring) if restoring > 1 else None)
    for step in (None, 1):
        with pytest.raises(ValueError, match=f"world of {saved} rank.*this mesh has {restoring}"):
            ckpt.restore(_state(), step)


def test_each_rank_keeps_its_newest_shards(tmp_path):
    ranks = [Checkpointer(tmp_path, max_to_keep=2, mesh=_fake_mesh(r, 2)) for r in range(2)]
    state = _state()
    for step in range(1, 5):
        for ckpt in ranks:
            ckpt.save(step, state, {"loss": 0.5})
    assert sorted(os.listdir(tmp_path)) == ["3", "4"]
    assert ranks[1].all_steps() == [3, 4] and ranks[1].restore(_state()) == 4
    assert ranks[0].restore_metrics(4) == {"loss": 0.5}
    assert Checkpointer(tmp_path).saved_worlds() == [2]
