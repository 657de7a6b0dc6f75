"""The port's numerics guards and serving telemetry against the JAX
package's (`utils/numguard.py`, `telemetry/histo.py`, the exporter's
Prometheus helpers, the sampler's gauge registry): the same trees and the
same observations give the same leaves, rows, snapshots, quantiles and
Prometheus text (compared as strings); torch tensors are walked as their
numpy values are; the checkpoint and the publisher refuse through the one
gate with their messages unchanged."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from actor_critic_tpu.telemetry import exporter as jexporter
from actor_critic_tpu.telemetry import histo as jhisto
from actor_critic_tpu.utils import numguard as jnumguard
from actor_critic_tpu_torch.algos import traj_queue as tq
from actor_critic_tpu_torch.telemetry import exporter, histo, sampler
from actor_critic_tpu_torch.utils import checkpoint, numguard


class _Pair(NamedTuple):
    a: np.ndarray
    b: float


def _trees():
    nan, inf = np.nan, np.inf
    return {
        "clean": {"w": np.ones((2, 3), np.float32), "n": np.arange(4)},
        "nested": {"params": {"dense_0": {"kernel": np.array([[1.0, nan], [inf, 2.0]],
                                                             np.float32),
                                          "bias": np.zeros(2, np.float32)}},
                   "log_std": np.array([-inf], np.float32)},
        "many": {"ring": np.full(10, nan, np.float32), "steps": np.array([3, 4])},
        "seq": [np.array([1.0, 2.0]), (np.array([inf]), 3, "x", None), True],
        "named": {"pair": _Pair(np.array([0.0, -inf], np.float64), nan)},
        "scalars": {"f": inf, "np32": np.float32(nan), "i": 7, "b": False},
        "f16": {"h": np.array([1.0, nan], np.float16)},
    }


@pytest.mark.parametrize("case", sorted(_trees()))
def test_nonfinite_leaves_equal_jax(case):
    tree = _trees()[case]
    assert numguard.nonfinite_leaves(tree, "t") == jnumguard.nonfinite_leaves(tree, "t")


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


@pytest.mark.parametrize("case", ["clean", "nested", "many", "f16"])
def test_torch_leaves_walk_as_their_numpy_values(case):
    tree = _trees()[case]
    assert numguard.nonfinite_leaves(_to_torch(tree), "t") == jnumguard.nonfinite_leaves(tree, "t")


def test_bf16_tensor_leaf_is_walked():
    t = torch.tensor([1.0, float("nan"), float("inf")], dtype=torch.bfloat16)
    assert numguard.nonfinite_leaves({"x": t}, "p") == [("p['x'][1]", "nan"),
                                                         ("p['x'][2]", "inf")]


@pytest.mark.parametrize("case", sorted(_trees()))
def test_check_finite_refuses_as_jax(case):
    tree = _trees()[case]
    jbad = jnumguard.nonfinite_leaves(tree, "params")
    if not jbad:
        numguard.check_finite(tree, "policy swap", name="params")
        return
    with pytest.raises(numguard.NonFiniteError) as e:
        numguard.check_finite(tree, "policy swap", name="params")
    assert str(e.value).startswith("policy swap refused: non-finite values at ")
    for path, kind in jbad[:6]:
        assert f"{path}: {kind}" in str(e.value)


def test_nonfinite_paths_are_dotted_leaf_paths():
    tree = _trees()["nested"]
    assert numguard.nonfinite_paths(tree, "params") == [
        "params.params.dense_0.kernel", "params.log_std"]
    flat = {"param torso.dense_0.weight": torch.tensor([1.0, float("inf")]),
            "count": torch.tensor([3])}
    assert numguard.nonfinite_paths(flat) == ["param torso.dense_0.weight"]
    assert numguard.nonfinite_paths(_trees()["seq"], "s") == ["s.1.0"]


@pytest.mark.parametrize("row", [
    {"loss": 0.5, "n": 3, "ok": True, "none": None, "name": "x"},
    {"loss": float("nan"), "grad": float("inf"), "nested": {"v": float("-inf"), "w": 1.5}},
    {"np": np.float32(2.5), "bad": np.float64(np.nan), "i": np.int64(4)},
    {"arr": np.array([1.0, np.nan]), "scalar": np.array(3.0), "list": [1.0, float("nan")]},
    {"obj": {1, 2}},
], ids=["finite", "nonfinite", "numpy-scalars", "arrays", "foreign"])
def test_safe_json_row_equals_jax(row):
    assert numguard.safe_json_row(row) == jnumguard.safe_json_row(row)


def test_checkpoint_and_publisher_refuse_through_numguard():
    assert checkpoint.NonFiniteError is numguard.NonFiniteError
    assert tq.NonFiniteError is numguard.NonFiniteError
    pub = tq.PolicyPublisher({"w": np.zeros(2, np.float32)})
    poisoned = {"w": np.array([np.nan, 1.0], np.float32), "k": np.ones(1)}
    with pytest.raises(numguard.NonFiniteError,
                       match=r"^behavior-params publish refused: non-finite values at "
                             r"params\['w'\]\[0\]: nan") as e:
        pub.publish(poisoned, version=1)
    with pytest.raises(jnumguard.NonFiniteError) as je:
        jnumguard.check_finite(poisoned, "behavior-params publish", name="params")
    assert str(e.value) == str(je.value)


# ------------------------------------------------------------- histograms


def _observations(kind: str) -> list:
    rng = np.random.default_rng(0)
    if kind == "lognormal":
        return list(rng.lognormal(1.0, 1.5, 500))
    if kind == "edges":
        return [1.0, 2.5, 5.0, 0.0, 2500.0, 2500.1, 1e9, float("nan"), 0.9999]
    if kind == "empty":
        return []
    return [3.0] * 7


@pytest.mark.parametrize("kind", ["lognormal", "edges", "empty", "constant"])
@pytest.mark.parametrize("bounds", [None, (0.5, 1.0, 2.0)], ids=["default", "custom"])
def test_histogram_equals_jax(kind, bounds):
    obs = _observations(kind)
    kw = {} if bounds is None else {"boundaries": bounds}
    ours, theirs = histo.Histogram(**kw), jhisto.Histogram(**kw)
    half = len(obs) // 2
    for v in obs[:half]:
        ours.observe(v)
        theirs.observe(v)
    ours.observe_many(obs[half:])
    theirs.observe_many(obs[half:])
    labels = {"policy": 'a"b'}
    snap, jsnap = ours.snapshot(labels=labels), theirs.snapshot(labels=labels)
    assert snap == jsnap
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0, 1.5):
        assert histo.quantile(snap, q) == jhisto.quantile(jsnap, q)
    assert histo.render_prometheus("m", snap, {"rank": 0}) == \
        jhisto.render_prometheus("m", jsnap, {"rank": 0})
    text = "\n".join(histo.render_prometheus("m", snap))
    assert histo.parse_prometheus(text) == jhisto.parse_prometheus(text)
    assert histo.merge([snap, snap]) == jhisto.merge([jsnap, jsnap])


def test_histogram_rejects_bad_boundaries_and_merge_mismatch():
    for bad in ((), (1.0, 1.0), (2.0, 1.0)):
        with pytest.raises(ValueError):
            histo.Histogram(bad)
    a = histo.Histogram((1.0,)).snapshot()
    b = histo.Histogram((2.0,)).snapshot()
    assert histo.merge([a, b]) is None and histo.merge([]) is None
    assert not histo.is_snapshot({"histogram": True})


def test_parse_prometheus_equals_jax_on_odd_lines():
    text = ('# HELP x\nm{a="1,2",b="q\\"x"} 3\nbad line\nm_total 4.5\n'
            'n{broken} 1\n\nz{k="v"} nope\n')
    assert histo.parse_prometheus(text) == jhisto.parse_prometheus(text)


@pytest.mark.parametrize("parts,value,labels", [
    (("serving", "requests_total"), 3, None),
    (("serving", "latency-p99 ms"), 2.5, {"policy": "a\nb"}),
    (("", "x"), np.float64(4.0), {"le": "+Inf"}),
])
def test_prometheus_helpers_equal_jax(parts, value, labels):
    assert exporter._metric_name(*parts) == jexporter._metric_name(*parts)
    name = exporter._metric_name(*parts)
    assert exporter._line(name, value, labels) == jexporter._line(name, value, labels)


def test_gauge_registry_suffixes_and_reads():
    a = sampler.register_gauge("probe_gauge", lambda: {"x": 1})
    b = sampler.register_gauge("probe_gauge", lambda: 2)
    c = sampler.register_gauge("probe_broken", lambda: 1 / 0)
    try:
        assert (a, b) == ("probe_gauge", "probe_gauge_2")
        got = sampler.gauges()
        assert got["probe_gauge"] == {"x": 1} and got["probe_gauge_2"] == 2
        assert "probe_broken" not in got
    finally:
        for key in (a, b, c):
            sampler.unregister_gauge(key)
    assert "probe_gauge" not in sampler.gauges()
