"""The port's batched Pong (`actor_critic_tpu_torch.envs.pong`) against the
JAX package's `envs/pong.py`.

Each step starts both envs from the same state (the JAX state, copied into
the port's tensors) with the same actions, as tests/test_torch_cartpole.py
does. On a step where no point fell, everything must match: frames,
positions, velocities, scores, reward, terminated and done, exactly
(the physics is the same float32 arithmetic in the same order, and the
frames are comparisons of it). On a step where a point fell the ball is
re-served from each framework's own random stream, so there the reward,
scores, termination and done must match, and the re-served ball is
checked by its range. Episode ends reset from the random streams too and
are checked the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.envs import make_pong as make_jax_pong
from actor_critic_tpu_torch.envs import make_pong
from actor_critic_tpu_torch.envs.pong import PongState

FLOAT_FIELDS = ("ball_x", "ball_y", "vel_x", "vel_y", "player_y", "opp_y")
INT_FIELDS = ("player_score", "opp_score", "t")


def _to_torch(js) -> PongState:
    return PongState(**{k: torch.from_numpy(np.array(getattr(js, k)))
                        for k in PongState._fields})


@pytest.mark.parametrize("frame_skip", [1, 4])
def test_step_matches_jax(frame_skip):
    size, E, steps = 42, 48, 160
    kw = dict(size=size, points_to_win=2, max_steps=60, frame_skip=frame_skip)
    jenv, tenv = make_jax_pong(**kw), make_pong(**kw)
    scale = size / 84.0
    serve_vx = np.float32(1.8 * scale)
    centre = (size - 1) / 2.0
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), E))
    jstep = jax.jit(jax.vmap(jenv.step))
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    counts = dict(quiet=0, point=0, term=0, trunc=0, hit=0, bounce=0)

    for _ in range(steps):
        actions = rng.integers(0, 3, size=E).astype(np.int32)
        jout = jstep(jstate, jnp.asarray(actions))
        tout = tenv.step(_to_torch(jstate), torch.from_numpy(actions), gen)
        j = {k: np.asarray(getattr(jout.state, k)) for k in FLOAT_FIELDS + INT_FIELDS}
        t = {k: getattr(tout.state, k).numpy() for k in FLOAT_FIELDS + INT_FIELDS}
        j_rew, j_done = np.asarray(jout.reward), np.asarray(jout.done)
        j_term = np.asarray(jout.info["terminated"])

        np.testing.assert_array_equal(tout.reward.numpy(), j_rew)
        np.testing.assert_array_equal(tout.done.numpy(), j_done)
        np.testing.assert_array_equal(tout.info["terminated"].numpy(), j_term)
        for k in ("player_score", "opp_score", "t"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)

        point = j_rew != 0
        quiet = ~point & (j_done == 0)
        for k in FLOAT_FIELDS:
            np.testing.assert_array_equal(t[k][quiet], j[k][quiet], err_msg=k)
        np.testing.assert_array_equal(tout.obs.numpy()[quiet], np.asarray(jout.obs)[quiet])
        np.testing.assert_array_equal(tout.state.prev_frame.numpy()[quiet],
                                      np.asarray(jout.state.prev_frame)[quiet])
        # An episode cut by the time limit without a point: the pre-reset
        # frames match too.
        trunc = ~point & (j_done == 1)
        np.testing.assert_array_equal(tout.info["final_obs"].numpy()[trunc],
                                      np.asarray(jout.info["final_obs"])[trunc])

        # Re-served (point, game on) or reset (episode over) balls: in range.
        served = point & (j_done == 0)
        assert np.all(np.abs(t["vel_x"][served]) == serve_vx)
        assert np.all(np.abs(t["vel_y"][served]) <= scale)
        assert np.all(np.abs(t["ball_x"][served] - centre) <= (frame_skip - 1) * serve_vx + 1e-4)
        ended = j_done == 1
        assert np.all(t["ball_x"][ended] == np.float32(centre))
        assert np.all(t["ball_y"][ended] == np.float32(centre))
        assert np.all(np.abs(t["vel_x"][ended]) == serve_vx)
        assert np.all(np.abs(t["vel_y"][ended]) <= scale)
        assert np.all(t["t"][ended] == 0)
        frames = tout.obs.numpy()[ended]
        np.testing.assert_array_equal(frames[..., 0], frames[..., 1])

        counts["quiet"] += int(quiet.sum())
        counts["point"] += int(point.sum())
        counts["term"] += int(j_term.sum())
        counts["trunc"] += int(((j_done == 1) & (j_term == 0)).sum())
        prev_vx = np.asarray(jstate.vel_x)
        prev_vy = np.asarray(jstate.vel_y)
        counts["hit"] += int((quiet & (np.sign(j["vel_x"]) != np.sign(prev_vx))).sum())
        counts["bounce"] += int((quiet & (np.sign(j["vel_y"]) == -np.sign(prev_vy))
                                 & (prev_vy != 0)).sum())
        jstate = jout.state
    # Every branch of the physics and both episode ends were exercised.
    assert all(n > 5 for n in counts.values()), counts


def test_reset_shapes_dtype_and_seeding():
    env = make_pong(size=42)
    s1, o1 = env.reset(64, torch.Generator().manual_seed(3))
    _, o2 = env.reset(64, torch.Generator().manual_seed(3))
    assert o1.shape == (64, 42, 42, 2) and o1.dtype == torch.uint8
    assert torch.equal(o1, o2)
    assert env.spec.obs_shape == (42, 42, 2) and env.spec.pixel_obs
    assert env.spec.discrete and env.spec.action_dim == 3
    assert env.spec.episode_horizon == 1000
    # Ball and both paddles are rendered; both directions are served.
    assert int((o1[..., 1] > 0).sum(dim=(1, 2)).min()) > 0
    assert bool((s1.vel_x > 0).any()) and bool((s1.vel_x < 0).any())
    assert s1.player_score.dtype == torch.int32 and bool((s1.t == 0).all())


def test_reset_frame_matches_jax_render():
    """The first frame depends only on the ball and paddle positions, all
    centred at reset: identical to JAX's, whatever the serve."""
    for size in (36, 84):
        _, jobs = make_jax_pong(size=size).reset(jax.random.key(0))
        _, tobs = make_pong(size=size).reset(3, torch.Generator().manual_seed(0))
        for i in range(3):
            np.testing.assert_array_equal(tobs[i].numpy(), np.asarray(jobs))


@pytest.mark.parametrize("kwargs", [dict(size=35), dict(frame_skip=0), dict(opp_skill=2.0),
                                    dict(opp_skill=-0.1)])
def test_rejects_what_jax_rejects(kwargs):
    with pytest.raises(ValueError):
        make_jax_pong(**kwargs)
    with pytest.raises(ValueError):
        make_pong(**kwargs)
