"""The port's scenario fleet (`envs/env.py`: `scenario_ranges`,
`draw_scenario`, `is_randomized`; the scenario CartPole carries) against
the JAX package's `envs/jax_env.py` and `envs/cartpole.py`.

Ranges are pure Python in both packages and must be equal. Draws cannot be
bitwise (threefry and Philox differ): they are held by range, by
determinism under one seed and by their spread. A randomized CartPole is
stepped from the JAX fleet's states, scenario included, at 1e-6 (atol and
rtol, float32 state), as `tests/test_torch_cartpole.py` does for the
default physics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.envs import jax_env
from actor_critic_tpu.envs import make_cartpole as make_jax_cartpole
from actor_critic_tpu_torch.envs import cartpole as tcart
from actor_critic_tpu_torch.envs import env as tenv
from actor_critic_tpu_torch.envs import make_cartpole

TOL = dict(rtol=1e-6, atol=1e-6)

RANGE_CASES = [
    ({"mass": 2.0}, 0.25, None),
    ({"mass": 2.0}, 0.0, None),
    ({"a": 1.0, "b": 1.0, "c": 1.0}, 0.1, {"a": (0.5, 2.0), "b": "0.25,4", "c": 3.0}),
    ({"a": -3.0, "b": 0.0}, 0.5, {"a": [4.0, -1.0], "b": None}),
    (tcart.SCENARIO_DEFAULTS, 0.2, {"masspole": "0.05,0.5"}),
]


@pytest.mark.parametrize("defaults,randomize,overrides", RANGE_CASES)
def test_scenario_ranges_match_jax(defaults, randomize, overrides):
    got = tenv.scenario_ranges(defaults, randomize, overrides)
    want = jax_env.scenario_ranges(defaults, randomize, overrides)
    assert got == want
    assert tenv.is_randomized(got) == jax_env.is_randomized(want)


@pytest.mark.parametrize("overrides,randomize,match", [
    ({"masss": 2.0}, 0.0, "unknown scenario parameter"),
    ({"mass": "1,2,3"}, 0.0, "lo,hi"),
    (None, -0.5, "randomize"),
])
def test_scenario_ranges_reject_what_jax_rejects(overrides, randomize, match):
    for fn in (tenv.scenario_ranges, jax_env.scenario_ranges):
        with pytest.raises(ValueError, match=match):
            fn({"mass": 1.0}, randomize, overrides)


def test_draw_in_range_seeded_and_spread():
    ranges = tenv.scenario_ranges({"mass": 1.0, "g": 10.0, "fixed": 3.0}, 0.5,
                                  {"fixed": 3.0})
    bounds = tenv.ScenarioBounds.of(ranges)
    a = tenv.draw_scenario(torch.Generator().manual_seed(7), 4096, bounds)
    b = tenv.draw_scenario(torch.Generator().manual_seed(7), 4096, bounds)
    c = tenv.draw_scenario(torch.Generator().manual_seed(8), 4096, bounds)
    assert a.shape == (4096, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    for j, (lo, hi) in enumerate(ranges.values()):
        col = a[:, j].numpy()
        assert col.min() >= np.float32(lo) and col.max() <= np.float32(hi)
        if lo != hi:  # uniform over the range: the mean near its middle
            assert abs(col.mean() - (lo + hi) / 2) < 0.02 * (hi - lo)
    # A degenerate range gives its exact constant, as JAX's draw does.
    assert torch.all(a[:, 2] == np.float32(3.0))


def test_unrandomized_draw_is_the_constants_and_draws_nothing():
    bounds = tenv.ScenarioBounds.of(tenv.scenario_ranges(tcart.SCENARIO_DEFAULTS))
    g = torch.Generator().manual_seed(0)
    before = g.get_state()
    sc = tenv.draw_scenario(g, 16, bounds)
    assert torch.equal(g.get_state(), before)
    want = np.float32(list(tcart.SCENARIO_DEFAULTS.values()))
    np.testing.assert_array_equal(sc.numpy(), np.broadcast_to(want, (16, 5)))
    # JAX's default env carries the same float32 constants.
    js, _ = make_jax_cartpole().reset(jax.random.key(0))
    np.testing.assert_array_equal(np.float32([getattr(js.scenario, k) for k in
                                              tcart.SCENARIO_DEFAULTS]), want)


def _to_torch(js) -> tcart.CartPoleState:
    f = lambda x: torch.from_numpy(np.array(x))
    return tcart.CartPoleState(
        x=f(js.x), x_dot=f(js.x_dot), theta=f(js.theta), theta_dot=f(js.theta_dot), t=f(js.t),
        scenario=torch.stack([f(getattr(js.scenario, k)) for k in tcart.SCENARIO_DEFAULTS], -1),
    )


def test_randomized_cartpole_steps_like_jax_scenario_carried_across():
    """JAX's randomized fleet (each instance its own physics), stepped by
    both envs from the same state; the scenario rides the state: kept by a
    running episode, redrawn within its ranges at an episode end."""
    E, steps = 64, 120
    kw = dict(randomize=0.3, masspole=(0.05, 0.5))
    jenv, env = make_jax_cartpole(**kw), make_cartpole(**kw)
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), E))
    assert len(np.unique(np.asarray(jstate.scenario.gravity))) == E
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    ranges = tenv.scenario_ranges(tcart.SCENARIO_DEFAULTS, 0.3, {"masspole": (0.05, 0.5)})
    alive = np.ones(E, bool)
    n_ended = 0
    for _ in range(steps):
        actions = (rng.random(E) < 0.5).astype(np.int32)
        jout = jstep(jstate, jnp.asarray(actions))
        before = _to_torch(jstate)
        out = env.step(before, torch.from_numpy(actions), gen)
        m = alive
        np.testing.assert_allclose(out.info["final_obs"].numpy()[m],
                                   np.asarray(jout.info["final_obs"])[m], **TOL)
        np.testing.assert_array_equal(out.done.numpy()[m], np.asarray(jout.done)[m])
        np.testing.assert_array_equal(out.info["terminated"].numpy()[m],
                                      np.asarray(jout.info["terminated"])[m])
        done = out.done.numpy() == 1
        cont = ~done
        assert torch.equal(out.state.scenario[cont], before.scenario[cont])
        sc = out.state.scenario[done].numpy()
        for j, (lo, hi) in enumerate(ranges.values()):
            assert np.all((sc[:, j] >= np.float32(lo)) & (sc[:, j] <= np.float32(hi)))
        assert not np.any(np.all(sc == before.scenario[done].numpy(), axis=1))
        n_ended += int(done[m].sum())
        alive &= np.asarray(jout.done) == 0
        jstate = jout.state
    assert n_ended > 20, n_ended
