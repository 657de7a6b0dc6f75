"""The port's GAE / λ-returns (`actor_critic_tpu_torch.ops`) against the JAX
package's `ops.returns` (lax.scan) and `ops.pallas_scan` (the Pallas
kernel, in interpret mode on the CPU as tests/test_pallas_scan.py runs it).

Inputs are made with numpy from a seed and handed to both packages. The
tolerance is that of tests/test_pallas_scan.py: atol = rtol = 1e-6 (the
same float32 recurrence on both sides; only rounding order may differ).
On CPU tensors the wrapper `gae_cuda.gae` takes the plain version; the
CUDA kernel itself is held against it on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.ops import pallas_scan
from actor_critic_tpu.ops import returns as jreturns
from actor_critic_tpu_torch.ops import gae_cuda
from actor_critic_tpu_torch.ops import returns as treturns

GAMMA, LAM = 0.99, 0.95
TOL = dict(rtol=1e-6, atol=1e-6)


def _batch(T, E, seed, done_p=0.1, done_at_t0=False):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(T, E)).astype(np.float32)
    values = rng.normal(size=(T, E)).astype(np.float32)
    dones = (rng.random(size=(T, E)) < done_p).astype(np.float32)
    if done_at_t0:
        dones[:] = 0.0
        dones[0] = 1.0
    bootstrap = rng.normal(size=(E,)).astype(np.float32)
    return rewards, values, dones, bootstrap


def _multi_block():
    # tests/test_pallas_scan.py::test_gae_multi_block: two 512-wide halves.
    r, v, d, b = _batch(17, 512, seed=0)
    return (np.concatenate([r, r * 2.0], 1), np.concatenate([v, -v], 1),
            np.concatenate([d, d], 1), np.concatenate([b, b], 0))


CASES = {
    "T17-E512": lambda: _batch(17, 512, seed=0),
    "T1-tile": lambda: _batch(1, 128, seed=7, done_p=0.15),
    "T1-tiny": lambda: _batch(1, 7, seed=7, done_p=0.15),
    "E-sub-tile": lambda: _batch(5, 96, seed=7, done_p=0.15),
    "E-ragged": lambda: _batch(3, 300, seed=7, done_p=0.15),
    "E-nondiv-block": lambda: _batch(17, 640, seed=7, done_p=0.15),
    "E200": lambda: _batch(17, 200, seed=3),
    "multi-block": _multi_block,
    "done-at-t0": lambda: _batch(4, 128, seed=17, done_at_t0=True),
    "preset-shape": lambda: _batch(64, 4096, seed=5),
}


def _jax_ref(impl, args):
    j = [jnp.asarray(a) for a in args]
    fn = jreturns.gae if impl == "lax" else pallas_scan.gae
    adv, ret = fn(*j, GAMMA, LAM)
    lam_fn = jreturns.lambda_returns if impl == "lax" else pallas_scan.lambda_returns
    return np.asarray(adv), np.asarray(ret), np.asarray(lam_fn(*j, GAMMA, LAM))


# Interpret-mode Pallas at the preset shape [64, 4096] is too slow for
# tier-1; the lax reference covers that shape.
PAIRS = [(c, i) for c in sorted(CASES) for i in ("lax", "pallas")
         if not (i == "pallas" and c == "preset-shape")]


@pytest.mark.parametrize("case,impl", PAIRS)
def test_gae_matches_jax(case, impl):
    args = CASES[case]()
    adv_j, ret_j, lam_j = _jax_ref(impl, args)
    t = [torch.from_numpy(a) for a in args]
    adv, ret = gae_cuda.gae(*t, GAMMA, LAM)
    np.testing.assert_allclose(adv.numpy(), adv_j, **TOL)
    np.testing.assert_allclose(ret.numpy(), ret_j, **TOL)
    np.testing.assert_allclose(treturns.lambda_returns(*t, GAMMA, LAM).numpy(), lam_j, **TOL)
    # The wrapper's CPU path IS the plain version, bit for bit.
    adv_p, ret_p = treturns.gae(*t, GAMMA, LAM)
    assert torch.equal(adv, adv_p) and torch.equal(ret, ret_p)


def test_normalize_advantages_matches_jax():
    x = np.random.default_rng(2).normal(3.0, 2.0, size=(8, 64)).astype(np.float32)
    got = treturns.normalize_advantages(torch.from_numpy(x)).numpy()
    want = np.asarray(jreturns.normalize_advantages(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cpu_path_detaches_and_does_not_count_launches():
    args = [torch.from_numpy(a) for a in _batch(5, 33, seed=1)]
    args[1].requires_grad_(True)
    gae_cuda.reset_launch_count()
    adv, ret = gae_cuda.gae(*args, GAMMA, LAM)
    assert not adv.requires_grad and not ret.requires_grad
    assert gae_cuda.launch_count() == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "bootstrap", "noncontig", "ndim"])
def test_wrapper_rejects_bad_inputs(bad):
    r, v, d, b = (torch.from_numpy(a) for a in _batch(6, 16, seed=4))
    if bad == "dtype":
        d = d.to(torch.float64)
    elif bad == "shape":
        v = v[:, :8]
    elif bad == "bootstrap":
        b = b[:8]
    elif bad == "noncontig":
        r = torch.from_numpy(np.asfortranarray(r.numpy()))
        assert not r.is_contiguous()
    elif bad == "ndim":
        r, v, d, b = r[:, 0], v[:, 0], d[:, 0], b[0]
    with pytest.raises((TypeError, ValueError)):
        gae_cuda.gae(r, v, d, b, GAMMA, LAM)
