"""The port's V-trace (`actor_critic_tpu_torch.ops`) and its correction seam
`algos.common.corrected_advantages` against the JAX package's
`ops.returns.vtrace` (lax), `ops.pallas_scan.vtrace` (the Pallas kernel, in
interpret mode on the CPU as tests/test_pallas_scan.py runs it) and
`algos.common.corrected_advantages`.

Inputs are made with numpy from a seed and handed to both packages. The
tolerance is that of tests/test_pallas_scan.py::test_vtrace_matches_golden:
rtol 1e-5, atol 1e-6. The two sides compute the same float32 recurrence;
they differ by the exp (XLA's and PyTorch's differ in the last bit) and,
against the Pallas kernel, by which lines XLA contracts into a fused
multiply-add (the lax reference contracts the trace carry, as the plain
version and the CUDA kernel do; the interpreted kernel contracts the two
`r + γ_t·v` lines instead). On CPU tensors the wrapper
`vtrace_cuda.vtrace` takes the plain version; the CUDA kernel itself is
held against it on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.algos import common as jcommon
from actor_critic_tpu.ops import pallas_scan
from actor_critic_tpu.ops import returns as jreturns
from actor_critic_tpu_torch.algos import common as tcommon
from actor_critic_tpu_torch.ops import returns as treturns
from actor_critic_tpu_torch.ops import vtrace_cuda

GAMMA = 0.99
TOL = dict(rtol=1e-5, atol=1e-6)
FIELDS = ("vs", "pg_advantages", "clipped_rhos")


def _batch(T, E, seed, done_p=0.1, done_at_t0=False, lp_scale=0.3):
    rng = np.random.default_rng(seed)
    tlp = (rng.normal(size=(T, E)) * lp_scale).astype(np.float32)
    blp = (rng.normal(size=(T, E)) * lp_scale).astype(np.float32)
    rewards = rng.normal(size=(T, E)).astype(np.float32)
    values = rng.normal(size=(T, E)).astype(np.float32)
    dones = (rng.random(size=(T, E)) < done_p).astype(np.float32)
    if done_at_t0:
        dones[:] = 0.0
        dones[0] = 1.0
    bootstrap = rng.normal(size=(E,)).astype(np.float32)
    return tlp, blp, rewards, values, dones, bootstrap


def _capped():
    # A few log-ratios far above the cap of 20, with ρ̄ loose enough that the
    # capped ratio exp(20) reaches the outputs. Without the cap exp(100)
    # would be inf in float32.
    tlp, blp, r, v, d, b = _batch(4, 128, seed=11)
    tlp[np.random.default_rng(12).random(tlp.shape) < 0.05] = 100.0
    return tlp, blp, r, v, d, b


# name -> (inputs, rho_bar, c_bar, lam)
CASES = {
    "T17-E512": (lambda: _batch(17, 512, seed=1), 1.0, 1.0, 0.9),
    "T1-tile": (lambda: _batch(1, 128, seed=7, done_p=0.15), 1.0, 1.0, 1.0),
    "T1-tiny": (lambda: _batch(1, 7, seed=7, done_p=0.15), 1.0, 1.0, 1.0),
    "E-sub-tile": (lambda: _batch(5, 96, seed=7, done_p=0.15), 1.0, 1.0, 1.0),
    "E-ragged": (lambda: _batch(3, 300, seed=7, done_p=0.15), 1.0, 1.0, 1.0),
    "done-at-t0": (lambda: _batch(4, 128, seed=17, done_at_t0=True), 1.0, 1.0, 1.0),
    # c clips the RAW ratio: c̄ > ρ̄ must still match.
    "cbar-above-rhobar": (lambda: _batch(17, 512, seed=5, lp_scale=1.0), 1.0, 2.0, 0.9),
    "capped-ratio": (_capped, 1e9, 1.0, 1.0),
    "preset-shape": (lambda: _batch(20, 64, seed=3), 1.0, 1.0, 1.0),
}


def _jax(impl, args, rho_bar, c_bar, lam):
    fn = jreturns.vtrace if impl == "lax" else pallas_scan.vtrace
    out = fn(*(jnp.asarray(a) for a in args), GAMMA, rho_bar=rho_bar, c_bar=c_bar, lam=lam)
    return {k: np.asarray(getattr(out, k)) for k in FIELDS}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("impl", ["lax", "pallas"])
def test_vtrace_matches_jax(case, impl):
    make, rho_bar, c_bar, lam = CASES[case]
    args = make()
    want = _jax(impl, args, rho_bar, c_bar, lam)
    t = [torch.from_numpy(a) for a in args]
    got = vtrace_cuda.vtrace(*t, GAMMA, rho_bar=rho_bar, c_bar=c_bar, lam=lam)
    for k in FIELDS:
        g = getattr(got, k).numpy()
        assert g.shape == args[2].shape and np.all(np.isfinite(g)), k
        np.testing.assert_allclose(g, want[k], **TOL, err_msg=k)
    # The wrapper's CPU path IS the plain version, bit for bit.
    plain = treturns.vtrace(*t, GAMMA, rho_bar, c_bar, lam)
    assert all(torch.equal(getattr(got, k), getattr(plain, k)) for k in FIELDS)


def test_capped_ratio_reaches_the_outputs():
    tlp, blp, *_ = args = _capped()
    out = treturns.vtrace(*(torch.from_numpy(a) for a in args), GAMMA, 1e9, 1.0, 1.0)
    capped = torch.from_numpy((tlp - blp) > 20.0)
    assert capped.any()
    torch.testing.assert_close(out.clipped_rhos[capped],
                               torch.full((int(capped.sum()),), float(np.exp(np.float32(20.0)))),
                               rtol=1e-6, atol=0.0)


def test_on_policy_vtrace_is_the_lambda_return():
    """π == μ and loose clips: vs equals the GAE return (the JAX package's
    golden identity), through the port's two plain versions."""
    tlp, _, r, v, d, b = (torch.from_numpy(a) for a in _batch(9, 64, seed=21))
    out = treturns.vtrace(tlp, tlp, r, v, d, b, GAMMA, 1e9, 1e9, 0.95)
    _, ret = treturns.gae(r, v, d, b, GAMMA, 0.95)
    torch.testing.assert_close(out.vs, ret, **TOL)
    assert torch.all(out.clipped_rhos == 1.0)


def test_cpu_path_detaches_and_does_not_count_launches():
    args = [torch.from_numpy(a) for a in _batch(5, 33, seed=1)]
    args[0].requires_grad_(True)
    args[3].requires_grad_(True)
    vtrace_cuda.reset_launch_count()
    out = vtrace_cuda.vtrace(*args, GAMMA)
    assert not any(getattr(out, k).requires_grad for k in FIELDS)
    assert vtrace_cuda.launch_count() == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "bootstrap", "noncontig", "ndim", "logp-dtype"])
def test_wrapper_rejects_bad_inputs(bad):
    tlp, blp, r, v, d, b = (torch.from_numpy(a) for a in _batch(6, 16, seed=4))
    if bad == "dtype":
        d = d.to(torch.float64)
    elif bad == "shape":
        v = v[:, :8]
    elif bad == "bootstrap":
        b = b[:8]
    elif bad == "noncontig":
        blp = torch.from_numpy(np.asfortranarray(blp.numpy()))
        assert not blp.is_contiguous()
    elif bad == "ndim":
        tlp, blp, r, v, d, b = tlp[:, 0], blp[:, 0], r[:, 0], v[:, 0], d[:, 0], b[0]
    elif bad == "logp-dtype":
        tlp = tlp.to(torch.float16)
    with pytest.raises((TypeError, ValueError)):
        vtrace_cuda.vtrace(tlp, blp, r, v, d, b, GAMMA)


@pytest.mark.parametrize("correction,lam", [("vtrace", 1.0), ("vtrace", 0.9), ("none", 0.95)])
def test_corrected_advantages_match_jax(correction, lam):
    args = _batch(12, 48, seed=31, lp_scale=0.5)
    jout = jcommon.corrected_advantages(
        *(jnp.asarray(a) for a in args), GAMMA, lam, rho_bar=1.0, c_bar=1.0,
        correction=correction)
    tout = tcommon.corrected_advantages(
        *(torch.from_numpy(a) for a in args), GAMMA, lam, rho_bar=1.0, c_bar=1.0,
        correction=correction)
    for name, g, w in zip(("pg_advantages", "value_targets", "mean_rho"), tout, jout):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)
    if correction == "none":
        assert float(tout[2]) == 1.0


def test_corrected_advantages_rejects_unknown_correction():
    args = [torch.from_numpy(a) for a in _batch(2, 4, seed=0)]
    with pytest.raises(ValueError, match="unknown correction"):
        tcommon.corrected_advantages(*args, GAMMA, 1.0, correction="retrace")
