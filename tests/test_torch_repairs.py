"""Two repairs of the port against the JAX package.

1. `parallel/mesh.py::all_gather` is a real gather (JAX's `lax.all_gather`
   keeps every bit): at world 2 over gloo, with the ranks spawned as
   processes by `tests/torch_parallel_worker.py`, a −0.0 in either rank's
   slot comes back with its sign bit set, and NaN and ±inf come back in
   their own slot only. The comparison is bitwise.
2. Every commit gate goes through the one seam `numguard.check_finite`, as
   JAX's do (`traj_queue.py:387`, `checkpoint.py:159`): with the seam
   no-op'd the four gates (publish, mailbox, swap, checkpoint) let a NaN
   tree through, as JAX's do; with it in place each refusal's message is
   JAX's for the same tree, leaf paths apart (the checkpoint names the
   port's flat tensor names).
"""

import numpy as np
import pytest
import torch

from actor_critic_tpu.algos import traj_queue as jtq
from actor_critic_tpu.parallel import multihost as jmultihost
from actor_critic_tpu.serving.policy_store import PolicyStore as JaxStore
from actor_critic_tpu.utils import numguard as jnumguard
from actor_critic_tpu_torch.algos import host_loop, traj_queue as tq
from actor_critic_tpu_torch.parallel import mesh, multihost
from actor_critic_tpu_torch.serving.policy_store import PolicyStore
from actor_critic_tpu_torch.utils import numguard
from actor_critic_tpu_torch.utils.checkpoint import Checkpointer
from torch_parallel_worker import run_ranks


def _plane() -> np.ndarray:
    x = np.array([[-0.0, 1.5, np.nan, 0.0, np.inf],
                  [2.0, -0.0, -np.inf, -0.0, 0.0]], np.float32)
    return x


def test_all_gather_keeps_sign_of_zero_and_nonfinite_slots(tmp_path):
    x = _plane()
    out = run_ranks(2, [("gather", "gather", {}, {"x": x})], tmp_path)["gather"]
    for rank_out in out:
        got = rank_out["gathered"]
        assert got.shape == (2, 5) and got.dtype == np.float32
        # Bitwise: each slot holds exactly the bits its rank sent.
        assert got.tobytes() == x.tobytes()
        assert torch.signbit(torch.from_numpy(got)).tolist() == [
            [True, False, False, False, False], [False, True, True, True, False]]
        assert np.isnan(got).tolist() == [[False, False, True, False, False],
                                          [False] * 5]
        assert np.isinf(got[0]).tolist() == [False, False, False, False, True]
        assert np.isinf(got[1]).tolist() == [False, False, True, False, False]


def test_all_gather_without_a_group_is_a_leading_axis():
    x = torch.tensor([-0.0, 1.0])
    out = mesh.all_gather(x, None)
    assert out.shape == (1, 2) and torch.signbit(out[0, 0])


class _StubEngine:
    max_rows = 8

    def prepare_params(self, params):
        return {k: np.array(v) for k, v in params.items()}

    def act(self, params, obs):
        return np.asarray(obs)[:, 0]


def _good():
    return {"w": np.full((3, 2), 0.5, np.float32), "b": np.zeros(2, np.float32)}


def _poisoned():
    tree = _good()
    tree["w"][1, 0] = np.nan
    tree["b"][1] = np.inf
    return tree


def _checkpoint_state(params: dict) -> host_loop.HostCheckpoint:
    return host_loop.HostCheckpoint(
        generator=torch.Generator().manual_seed(0),
        device_state={"params": {k: torch.from_numpy(v.copy()) for k, v in params.items()}},
        pool={})


def _gates(tmp_path, good):
    """The port's four gates, each a (name, commit, read-back) pair on a
    sink that holds `good` as version 1."""
    publisher = tq.PolicyPublisher(good, version=1)
    store = PolicyStore()
    store.register("default", _StubEngine(), good, version=1)
    mailbox = tmp_path / "mailbox"
    mailbox.mkdir()
    multihost.write_params(str(mailbox), 0, 1, good)
    ck = Checkpointer(tmp_path / "ck")
    ck.save(0, _checkpoint_state(good))

    def read_ckpt():
        state = _checkpoint_state(_good())
        ck.restore(state)
        return {k: t.numpy() for k, t in state.device_state["params"].items()}

    return [
        ("publish", lambda t: publisher.publish(t, 2), lambda: publisher.get()[1]),
        ("mailbox", lambda t: multihost.write_params(str(mailbox), 0, 2, t),
         lambda: multihost.read_params(str(mailbox), 0, _good())[1]),
        ("swap", lambda t: store.swap("default", t, version=2),
         lambda: dict(store.get("default").params)),
        ("checkpoint", lambda t: ck.save(1, _checkpoint_state(t)), read_ckpt),
    ]


def test_noop_seam_opens_all_four_gates(tmp_path, monkeypatch):
    """`numguard.check_finite` no-op'd (numsan's reverted-guard mode): every
    gate lets the NaN tree through and the sink then holds it."""
    monkeypatch.setattr(numguard, "check_finite", lambda *a, **k: None)
    for name, commit, read in _gates(tmp_path, _good()):
        commit(_poisoned())
        assert numguard.nonfinite_leaves(read()), name


def test_guarded_gates_refuse_with_jax_messages(tmp_path):
    """With the seam in place every gate refuses and the sink keeps its good
    version; each message is JAX's gate's for the same tree."""
    poisoned = _poisoned()
    jax_messages = {}
    jpub = jtq.PolicyPublisher(_good(), version=1)
    jstore = JaxStore()
    jstore.register("default", _StubEngine(), _good(), version=1)
    for name, fn in (
        ("publish", lambda: jpub.publish(poisoned, 2)),
        ("mailbox", lambda: jmultihost.write_params(str(tmp_path / "jmbox"), 0, 2, poisoned)),
        ("swap", lambda: jstore.swap("default", poisoned, version=2)),
        # JAX's checkpoint gate: `check_finite(packed, "checkpoint commit", name="state")`.
        ("checkpoint", lambda: jnumguard.check_finite(
            {"device_state": {"params": poisoned}}, "checkpoint commit", name="state")),
    ):
        with pytest.raises(jnumguard.NonFiniteError) as e:
            fn()
        jax_messages[name] = str(e.value)
    for name, commit, read in _gates(tmp_path, _good()):
        with pytest.raises(numguard.NonFiniteError) as e:
            commit(poisoned)
        assert not numguard.nonfinite_leaves(read()), name
        assert _without_paths(str(e.value)) == _without_paths(jax_messages[name]), name


def _without_paths(msg: str) -> tuple[str, list[str]]:
    """A refusal's text with its leaf list cut out, and the kinds of the
    poisoned elements it listed (the names follow each package's tree)."""
    head, rest = msg.split(" at ", 1)
    detail, tail = rest.split(" — ", 1)
    kinds = sorted(item.rsplit(": ", 1)[1] for item in detail.split(", "))
    return f"{head} at PATHS — {tail}", kinds
