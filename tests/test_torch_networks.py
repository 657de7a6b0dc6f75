"""The port's `ActorCriticDiscrete` / `Categorical` against the flax
`ActorCriticDiscrete` with the same parameters (converted by
`actor_critic_tpu_torch.weights.from_flax`) and the same observations.

Tolerance 1e-5 (atol and rtol): two float32 matrix products and a tanh
per layer, summed in a different order by XLA and by PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.models import networks as jnets
from actor_critic_tpu_torch import weights
from actor_critic_tpu_torch.models.distributions import Categorical
from actor_critic_tpu_torch.models.networks import ActorCriticDiscrete

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(hidden, num_actions, seed):
    jnet = jnets.ActorCriticDiscrete(num_actions=num_actions, hidden=hidden)
    params = jnet.init(jax.random.key(seed), jnp.zeros((1, 4), jnp.float32))
    tnet = ActorCriticDiscrete(4, num_actions, hidden)
    tnet.load_state_dict(weights.from_flax(jax.device_get(params)))
    return jnet, params, tnet


@pytest.mark.parametrize("hidden,num_actions", [((64, 64), 2), ((32,), 3), ((16, 8, 8), 5)])
def test_forward_and_distribution_match_flax(hidden, num_actions):
    jnet, params, tnet = _pair(hidden, num_actions, seed=0)
    rng = np.random.default_rng(1)
    # Larger-than-init logits, so log_prob / entropy / mode are exercised
    # away from the uniform distribution.
    obs = rng.normal(scale=3.0, size=(257, 4)).astype(np.float32)
    actions = rng.integers(0, num_actions, size=257)
    params = jax.tree.map(lambda x: x * 20.0 if x.ndim == 2 and x.shape[1] == num_actions else x, params)
    tnet.load_state_dict(weights.from_flax(jax.device_get(params)))

    jdist, jvalue = jnet.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        tdist, tvalue = tnet(torch.from_numpy(obs))
    assert tdist.logits.dtype == torch.float32 and tvalue.dtype == torch.float32
    assert tvalue.shape == (257,)
    np.testing.assert_allclose(tdist.logits.numpy(), np.asarray(jdist.logits), **TOL)
    np.testing.assert_allclose(tvalue.numpy(), np.asarray(jvalue), **TOL)
    np.testing.assert_allclose(
        tdist.log_prob(torch.from_numpy(actions)).numpy(),
        np.asarray(jdist.log_prob(jnp.asarray(actions))), **TOL)
    np.testing.assert_allclose(tdist.entropy().numpy(), np.asarray(jdist.entropy()), **TOL)
    np.testing.assert_array_equal(tdist.mode().numpy(), np.asarray(jdist.mode()))


def test_state_dict_names_follow_flax_tree():
    tnet = ActorCriticDiscrete(4, 2, (64, 64))
    assert sorted(tnet.state_dict()) == sorted([
        "torso.dense_0.weight", "torso.dense_0.bias",
        "torso.dense_1.weight", "torso.dense_1.bias",
        "policy.weight", "policy.bias", "value.weight", "value.bias",
    ])


@pytest.mark.parametrize("name,gain", [
    ("torso.dense_0", 2.0 ** 0.5), ("torso.dense_1", 2.0 ** 0.5),
    ("policy", 0.01), ("value", 1.0),
])
def test_init_is_orthogonal_with_flax_gains(name, gain):
    """Orthogonal init with the JAX package's gains, zero biases: the rows
    (or columns, whichever are fewer) of weight/gain are orthonormal."""
    sd = ActorCriticDiscrete(4, 2, (64, 64), torch.Generator().manual_seed(0)).state_dict()
    w = sd[f"{name}.weight"].double() / gain
    small = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    np.testing.assert_allclose(small.numpy(), np.eye(small.shape[0]), atol=1e-5)
    assert torch.count_nonzero(sd[f"{name}.bias"]) == 0


def test_init_is_seeded():
    a = ActorCriticDiscrete(4, 2, (64, 64), torch.Generator().manual_seed(7)).state_dict()
    b = ActorCriticDiscrete(4, 2, (64, 64), torch.Generator().manual_seed(7)).state_dict()
    c = ActorCriticDiscrete(4, 2, (64, 64), torch.Generator().manual_seed(8)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["torso.dense_0.weight"], c["torso.dense_0.weight"])


def test_categorical_sample_follows_probabilities():
    """Gumbel-max sampling draws each action with its softmax probability
    (the JAX and torch random streams differ, so this is checked by
    frequency: 4σ bounds over 200k draws)."""
    logits = torch.tensor([0.0, 1.0, -1.0, 2.0])
    n = 200_000
    draws = Categorical(logits.expand(n, 4)).sample(torch.Generator().manual_seed(0))
    freq = torch.bincount(draws, minlength=4).double() / n
    p = torch.softmax(logits.double(), 0)
    sigma = torch.sqrt(p * (1 - p) / n)
    assert torch.all((freq - p).abs() < 4 * sigma), (freq, p)


# ------------------------------------------------------ Nature CNN (pixels)
# Tolerance 1e-5 (atol and rtol) as above: three convolutions and a
# 512-wide dense product, summed in another order by XLA and by PyTorch
# (the uint8 scaling is the same multiply on both sides).


def _pixel_pair(size, seed):
    jnet = jnets.ActorCriticDiscrete(num_actions=3, pixel_obs=True)
    params = jnet.init(jax.random.key(seed), jnp.zeros((1, size, size, 2), jnp.uint8))
    # Larger-than-init policy weights, so log_prob / entropy / mode are
    # exercised away from the uniform distribution.
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 50.0 if "policy" in jax.tree_util.keystr(path) else x, params)
    tnet = ActorCriticDiscrete((size, size, 2), 3, generator=None, pixel_obs=True)
    tnet.load_state_dict(weights.from_flax(jax.device_get(params)))
    return jnet, params, tnet


def _frames(n, size, seed):
    rng = np.random.default_rng(seed)
    # Sparse bright pixels like the env's, plus dense noise in some frames.
    obs = np.where(rng.random((n, size, size, 2)) < 0.05, 255, 0).astype(np.uint8)
    obs[: n // 2] = rng.integers(0, 256, size=(n // 2, size, size, 2), dtype=np.uint8)
    return obs


@pytest.mark.parametrize("size", [42, 84])
def test_pixel_net_matches_flax(size):
    jnet, params, tnet = _pixel_pair(size, seed=2)
    obs = _frames(16, size, seed=3)
    actions = np.random.default_rng(4).integers(0, 3, size=16)
    jdist, jvalue = jnet.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        tdist, tvalue = tnet(torch.from_numpy(obs))
    assert tvalue.shape == (16,) and tdist.logits.shape == (16, 3)
    np.testing.assert_allclose(tdist.logits.numpy(), np.asarray(jdist.logits), **TOL)
    np.testing.assert_allclose(tvalue.numpy(), np.asarray(jvalue), **TOL)
    np.testing.assert_allclose(
        tdist.log_prob(torch.from_numpy(actions)).numpy(),
        np.asarray(jdist.log_prob(jnp.asarray(actions))), **TOL)
    np.testing.assert_allclose(tdist.entropy().numpy(), np.asarray(jdist.entropy()), **TOL)
    np.testing.assert_array_equal(tdist.mode().numpy(), np.asarray(jdist.mode()))
    # Leading batch axes are kept, as flax keeps them ([T, E, H, W, C]).
    with torch.no_grad():
        _, tv2 = tnet(torch.from_numpy(obs.reshape(4, 4, size, size, 2)))
    np.testing.assert_allclose(tv2.reshape(-1).numpy(), np.asarray(jvalue), **TOL)


def test_pixel_torso_matches_flax_features():
    """The torso's 512 features, before the heads: the flatten order of the
    conv output (NHWC, as flax flattens) is what `Dense_0` expects."""
    size = 36
    jcnn = jnets.NatureCNN()
    params = jcnn.init(jax.random.key(5), jnp.zeros((1, size, size, 2), jnp.uint8))
    tcnn = ActorCriticDiscrete((size, size, 2), 3, pixel_obs=True).torso
    tcnn.load_state_dict(weights.from_flax(jax.device_get(params)))
    obs = _frames(8, size, seed=6)
    with torch.no_grad():
        got = tcnn(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcnn.apply(params, jnp.asarray(obs))), **TOL)


def test_conv_kernel_converts_element_by_element():
    """flax `kernel[kh, kw, in, out]` is torch `weight[out, in, kh, kw]`;
    a plain transpose would give `weight[out, in, kw, kh]`, which has the
    same shape for the Nature CNN's square kernels but other values."""
    jnet = jnets.ActorCriticDiscrete(num_actions=3, pixel_obs=True)
    params = jax.device_get(jnet.init(jax.random.key(0), jnp.zeros((1, 42, 42, 2), jnp.uint8)))
    sd = weights.from_flax(params)
    for i in range(3):
        k = np.asarray(params["params"]["torso"][f"conv_{i}"]["kernel"])
        w = sd[f"torso.conv_{i}.weight"].numpy()
        kh, kw, cin, cout = k.shape
        assert w.shape == (cout, cin, kh, kw)
        for o, c, y, x in [(0, 0, 0, 1), (cout - 1, cin - 1, kh - 1, 0), (1, 1, 2, 0)]:
            assert w[o, c, y, x] == k[y, x, c, o]
        np.testing.assert_array_equal(w, k.transpose(3, 2, 0, 1))
        assert not np.array_equal(w, k.T)  # what the old conversion gave


def test_pixel_state_dict_names_follow_flax_tree():
    tnet = ActorCriticDiscrete((84, 84, 2), 3, pixel_obs=True)
    jnet = jnets.ActorCriticDiscrete(num_actions=3, pixel_obs=True)
    params = jnet.init(jax.random.key(0), jnp.zeros((1, 84, 84, 2), jnp.uint8))
    conv = weights.from_flax(jax.device_get(params))
    assert sorted(tnet.state_dict()) == sorted(conv)
    for k, v in tnet.state_dict().items():
        assert v.shape == conv[k].shape, k
    # 84 → 20 → 9 → 7: Dense_0 takes 7·7·64 features.
    assert tnet.torso.Dense_0.in_features == 7 * 7 * 64


@pytest.mark.parametrize("name,gain", [
    ("torso.conv_0", 2.0 ** 0.5), ("torso.conv_2", 2.0 ** 0.5), ("torso.Dense_0", 2.0 ** 0.5),
])
def test_pixel_init_is_orthogonal_with_flax_gains(name, gain):
    sd = ActorCriticDiscrete((42, 42, 2), 3, generator=torch.Generator().manual_seed(0),
                             pixel_obs=True).state_dict()
    w = sd[f"{name}.weight"].double().reshape(sd[f"{name}.weight"].shape[0], -1) / gain
    small = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    np.testing.assert_allclose(small.numpy(), np.eye(small.shape[0]), atol=1e-5)
    assert torch.count_nonzero(sd[f"{name}.bias"]) == 0
