"""The port's batched point mass (`envs/testbeds.py::make_point_mass`)
against the JAX package's: from the same states and actions, one step
gives the same obs, reward, done and final obs (elementwise float32, so
exactly equal); resets are checked by their range, the two random streams
being different."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from actor_critic_tpu.envs import make_point_mass as make_jax_point_mass
from actor_critic_tpu_torch.envs import make_point_mass
from actor_critic_tpu_torch.envs.testbeds import PointMassState


def test_step_matches_jax():
    E = 257
    jenv, tenv = make_jax_point_mass(), make_point_mass()
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), E))
    rng = np.random.default_rng(0)
    # Positions over the whole clipped range and step counts up to the
    # horizon; actions beyond ±1, so both clips act.
    jstate = jstate._replace(
        pos=jnp.asarray(rng.uniform(-2.0, 2.0, E), jnp.float32),
        t=jnp.asarray(rng.integers(0, 16, E), jnp.int32))
    actions = rng.normal(scale=1.5, size=(E, 1)).astype(np.float32)
    jout = jax.jit(jax.vmap(jenv.step))(jstate, jnp.asarray(actions))
    tstate = PointMassState(pos=torch.from_numpy(np.array(jstate.pos)),
                            t=torch.from_numpy(np.array(jstate.t)))
    tout = tenv.step(tstate, torch.from_numpy(actions), torch.Generator().manual_seed(0))

    done = np.asarray(jout.done)
    assert 0 < done.sum() < E
    np.testing.assert_array_equal(tout.done.numpy(), done)
    np.testing.assert_array_equal(tout.info["terminated"].numpy(), 0.0)
    np.testing.assert_array_equal(tout.reward.numpy(), np.asarray(jout.reward))
    np.testing.assert_array_equal(tout.info["final_obs"].numpy(), np.asarray(jout.info["final_obs"]))
    live = done == 0
    np.testing.assert_array_equal(tout.obs.numpy()[live], np.asarray(jout.obs)[live])
    np.testing.assert_array_equal(tout.state.t.numpy()[live], np.asarray(jout.state.t)[live])
    # Where the episode ended, a fresh one: t back at 0, pos from the reset range.
    assert np.all(tout.state.t.numpy()[~live] == 0)
    assert np.all(np.abs(tout.obs.numpy()[~live]) <= 0.5)


def test_reset_range_and_spec():
    env = make_point_mass()
    state, obs = env.reset(4096, torch.Generator().manual_seed(1))
    assert obs.shape == (4096, 1) and obs.dtype == torch.float32
    assert torch.equal(obs[:, 0], state.pos) and torch.all(state.t == 0)
    assert float(obs.min()) >= -0.5 and float(obs.max()) < 0.5
    assert float(obs.min()) < -0.45 and float(obs.max()) > 0.45
    spec = env.spec
    assert (spec.obs_shape, spec.action_dim, spec.discrete, spec.episode_horizon) == ((1,), 1, False, 16)
