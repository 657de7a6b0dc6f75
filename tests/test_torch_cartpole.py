"""The port's batched CartPole against the JAX package's `envs/cartpole.py`.

Each step starts both envs from the same state (the JAX state, copied into
the port's tensors) with the same actions, and compares obs, reward,
terminated, truncated and done of that step. Comparing step by step keeps
one rounding difference in sin/cos from growing through the unstable
dynamics. Each env is compared up to its first episode end: after a reset
the two random streams differ, so the reset draws are checked by their
range instead. Tolerance 1e-6 (atol and rtol) on the float32 state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from actor_critic_tpu.envs import make_cartpole as make_jax_cartpole
from actor_critic_tpu_torch.envs import cartpole as tcart
from actor_critic_tpu_torch.envs import make_cartpole

TOL = dict(rtol=1e-6, atol=1e-6)


def _to_torch(js) -> tcart.CartPoleState:
    return tcart.CartPoleState(
        x=torch.from_numpy(np.array(js.x)), x_dot=torch.from_numpy(np.array(js.x_dot)),
        theta=torch.from_numpy(np.array(js.theta)),
        theta_dot=torch.from_numpy(np.array(js.theta_dot)),
        t=torch.from_numpy(np.array(js.t)),
    )


def test_step_matches_jax_until_first_episode_end():
    E, steps = 128, 300
    jenv = make_jax_cartpole()
    tenv = make_cartpole()
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), E))
    # Start near the time limit so many envs truncate at 500 before the
    # random policy drops their pole.
    rng = np.random.default_rng(0)
    jstate = jstate._replace(t=jnp.asarray(rng.integers(480, 500, size=E), jnp.int32))
    jstep = jax.jit(jax.vmap(jenv.step))
    gen = torch.Generator().manual_seed(0)

    alive = np.ones(E, bool)
    n_term = n_trunc = 0
    for _ in range(steps):
        actions = (rng.random(E) < 0.5).astype(np.int32)
        jout = jstep(jstate, jnp.asarray(actions))
        tout = tenv.step(_to_torch(jstate), torch.from_numpy(actions), gen)
        m = alive
        j_term = np.asarray(jout.info["terminated"])
        j_done = np.asarray(jout.done)
        t_term = tout.info["terminated"].numpy()
        t_done = tout.done.numpy()
        np.testing.assert_allclose(tout.info["final_obs"].numpy()[m],
                                   np.asarray(jout.info["final_obs"])[m], **TOL)
        np.testing.assert_array_equal(tout.reward.numpy()[m], np.asarray(jout.reward)[m])
        np.testing.assert_array_equal(t_term[m], j_term[m])
        np.testing.assert_array_equal(t_done[m], j_done[m])
        np.testing.assert_array_equal((t_done * (1 - t_term))[m], (j_done * (1 - j_term))[m])
        cont = m & (j_done == 0)
        np.testing.assert_allclose(tout.obs.numpy()[cont], np.asarray(jout.obs)[cont], **TOL)
        np.testing.assert_array_equal(tout.state.t.numpy()[cont], np.asarray(jout.state.t)[cont])
        ended = m & (t_done == 1)
        # Reset draws: U(-0.05, 0.05) and a fresh time-limit counter.
        assert np.all(np.abs(tout.obs.numpy()[ended]) <= 0.05)
        assert np.all(tout.state.t.numpy()[ended] == 0)
        n_term += int((j_term[m] == 1).sum())
        n_trunc += int(((j_done - j_term)[m] == 1).sum())
        alive = alive & (j_done == 0)
        jstate = jout.state
    # Both episode ends were exercised.
    assert n_term > 10 and n_trunc > 10, (n_term, n_trunc)


def test_reset_draws_in_range_and_seeded():
    s1, o1 = tcart.reset(4096, torch.Generator().manual_seed(3))
    s2, o2 = tcart.reset(4096, torch.Generator().manual_seed(3))
    assert o1.shape == (4096, 4) and o1.dtype == torch.float32
    assert torch.equal(o1, o2)
    assert float(o1.min()) >= -0.05 and float(o1.max()) < 0.05
    # Spread over the range, not a constant.
    assert float(o1.std()) > 0.025
    assert torch.all(s1.t == 0) and s1.t.dtype == torch.int32


def test_float32_physics_constants():
    """The JAX env forms these in float32 from float32 scalars."""
    assert tcart.TOTAL_MASS == float(np.float32(1.0) + np.float32(0.1))
    assert tcart.POLEMASS_LENGTH == float(np.float32(0.1) * np.float32(0.5))
    assert tcart.TOTAL_MASS != 1.1


def test_auto_reset_contract():
    """done = max(term, trunc); obs and state come from a fresh episode
    where done, and `final_obs` keeps the pre-reset obs."""
    env = make_cartpole()
    state = tcart.CartPoleState(
        x=torch.tensor([2.39, 0.0, 0.0]), x_dot=torch.tensor([1.0, 0.0, 0.0]),
        theta=torch.zeros(3), theta_dot=torch.zeros(3),
        t=torch.tensor([10, 499, 5], dtype=torch.int32),
    )
    out = env.step(state, torch.tensor([1, 1, 0]), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(out.info["terminated"].numpy(), [1.0, 0.0, 0.0])
    np.testing.assert_array_equal(out.done.numpy(), [1.0, 1.0, 0.0])
    assert float(out.info["final_obs"][0, 0]) > 2.4
    assert torch.all(out.obs[:2].abs() <= 0.05)
    np.testing.assert_array_equal(out.state.t.numpy(), [0, 0, 6])
    assert torch.equal(out.obs[2], out.info["final_obs"][2])
