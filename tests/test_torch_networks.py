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
