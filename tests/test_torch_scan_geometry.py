"""Launch geometry of the reverse-scan kernels (`csrc/gae.cu`,
`csrc/vtrace.cu`), computed on the host by
`actor_critic_tpu_torch.ops._scan_args.scan_geometry`, and a model of the
kernels' chunked walk over T.

The kernels run only on the card; what they take from the host is checked
here: the column strips cover every env column exactly once, the shared
memory fits a block, 16-byte copies are chosen only where every row of a
strip starts on 16 bytes, and the launchers' own check accepts the
geometry, which the kernels are compiled for. The model repeats each
kernel's order on the CPU (chunks of `chunk` rows from the top of T down;
in each, the data-only terms over the whole chunk first, then the carry
row by row, then the outputs, for V-trace vs from the carry and pg from vs
one row down) with the carries and the values at a chunk's top row passed
across chunk boundaries, and must equal the plain versions in
`ops/returns.py` bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from actor_critic_tpu_torch.ops import returns
from actor_critic_tpu_torch.ops._scan_args import (
    SCAN_CHUNK,
    SCAN_COLUMNS,
    SCAN_THREADS,
    SHARED_BYTES_LIMIT,
    STATIC_SHARED_BYTES,
    scan_geometry,
)

HEADER = Path(__file__).resolve().parent.parent / "actor_critic_tpu_torch" / "csrc" / "scan_tile.cuh"

GAMMA, LAM = 0.99, 0.95
# kernel -> (input planes, scratch planes), as its wrapper asks for them.
PLANES = {"gae": (3, 0), "vtrace": (5, 1)}
E_CASES = [1, 7, 37, 64, 96, 200, 4096, 4133]
T_CASES = [1, 4, 17, 20, 64, 65, 256]


def _compiled(name: str) -> int:
    """A `constexpr int` of the kernels' shared header."""
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER.read_text()).group(1))


def _launcher_accepts(T, E, planes, scratch, g) -> bool:
    """csrc/scan_tile.cuh::geometry_fits, the launchers' check."""
    buffers = 2 if T > g.chunk else 1
    needed = (buffers * planes + scratch) * g.chunk * g.columns * 4
    return (g.threads == _compiled("kThreads") and g.columns == _compiled("kColumns")
            and 0 < g.chunk <= _compiled("kChunk") and g.blocks * g.columns >= E
            and g.smem_bytes >= needed
            and (g.copy_bytes == 4 or (g.copy_bytes == 16 and E % 4 == 0)))


def test_geometry_constants_are_the_compiled_ones():
    assert (SCAN_COLUMNS, SCAN_CHUNK, SCAN_THREADS) == (
        _compiled("kColumns"), _compiled("kChunk"), _compiled("kThreads"))
    # The carry's output for a chunk and the boundary rows, as declared in
    # the kernels (v_next; v_next and vs_next[2] in V-trace).
    assert STATIC_SHARED_BYTES == (SCAN_CHUNK + 3) * SCAN_COLUMNS * 4


@pytest.mark.parametrize("E", E_CASES)
@pytest.mark.parametrize("T", T_CASES)
@pytest.mark.parametrize("kernel", sorted(PLANES))
def test_geometry(kernel, T, E):
    planes, scratch = PLANES[kernel]
    g = scan_geometry(T, E, planes, scratch)
    covered = np.zeros(E, dtype=int)
    for b in range(g.blocks):
        strip = covered[b * g.columns:(b + 1) * g.columns]
        assert strip.size > 0, f"block {b} has no column"
        strip += 1
    assert np.all(covered == 1)
    assert g.smem_bytes + STATIC_SHARED_BYTES <= SHARED_BYTES_LIMIT
    assert g.copy_bytes == (16 if E % 4 == 0 else 4)
    assert scan_geometry(T, E, planes, scratch, aligned=False).copy_bytes == 4
    assert _launcher_accepts(T, E, planes, scratch, g)
    assert g.chunk == min(T, SCAN_CHUNK)


@pytest.mark.parametrize("kernel", sorted(PLANES))
def test_trainer_shape_fills_the_card(kernel):
    """[64, 4096] (a2c_cartpole) gives at least 128 blocks for 132 SMs, in
    one chunk of the sizes the kernels' notes give."""
    planes, scratch = PLANES[kernel]
    g = scan_geometry(64, 4096, planes, scratch)
    assert g.blocks >= 128 and g.chunk == 64 and g.copy_bytes == 16
    assert g.smem_bytes == (planes + scratch) * 64 * g.columns * 4


def _inputs(T, E, seed):
    rng = np.random.default_rng(seed)
    tlp, blp = (torch.from_numpy((rng.normal(size=(T, E)) * 0.5).astype(np.float32)) for _ in range(2))
    r, v = (torch.from_numpy(rng.normal(size=(T, E)).astype(np.float32)) for _ in range(2))
    d = torch.from_numpy((rng.random(size=(T, E)) < 0.1).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(E,)).astype(np.float32))
    return tlp, blp, r, v, d, b


def _chunks(T, chunk):
    """(lo, hi) of each chunk, in the kernels' order: from the top of T down."""
    hi = T
    while hi > 0:
        yield max(0, hi - chunk), hi
        hi = max(0, hi - chunk)


def emulate_gae(r, v, d, b, gamma, lam, chunk):
    adv = torch.empty_like(r)
    carry = torch.zeros_like(b)
    v_next = b  # values at the row above the chunk
    for lo, hi in _chunks(r.shape[0], chunk):
        nonterm = 1.0 - d[lo:hi]
        delta = r[lo:hi] + gamma * torch.cat([v[lo + 1:hi], v_next[None]]) * nonterm - v[lo:hi]
        coef = gamma * lam * nonterm
        for t in range(hi - 1, lo - 1, -1):
            carry = torch.addcmul(delta[t - lo], coef[t - lo], carry)
            adv[t] = carry
        v_next = v[lo]
    return adv, adv + v


def emulate_vtrace(tlp, blp, r, v, d, b, gamma, rho_bar, c_bar, lam, chunk):
    vs, pg, rhos = (torch.empty_like(r) for _ in range(3))
    acc = torch.zeros_like(b)
    v_next = vs_next = b  # values and vs at the row above the chunk
    for lo, hi in _chunks(r.shape[0], chunk):
        rows = slice(lo, hi)
        # The exp row by row, as the plain version takes it: PyTorch's CPU
        # exp may round a tensor's vectorised body and its tail differently.
        raw = torch.stack([torch.exp(torch.clamp(tlp[t] - blp[t], max=returns.LOG_RATIO_CAP))
                           for t in range(lo, hi)])
        rho = torch.clamp(raw, max=rho_bar)
        c = lam * torch.clamp(raw, max=c_bar)
        disc = gamma * (1.0 - d[rows])
        delta = rho * (r[rows] + disc * torch.cat([v[lo + 1:hi], v_next[None]]) - v[rows])
        dc = disc * c
        accs = torch.empty_like(delta)
        for t in range(hi - 1, lo - 1, -1):
            acc = torch.addcmul(delta[t - lo], dc[t - lo], acc)
            accs[t - lo] = acc
        # The last pass: vs from the carry, pg from vs one row down in time.
        vs[rows] = accs + v[rows]
        pg[rows] = rho * (r[rows] + disc * torch.cat([vs[lo + 1:hi], vs_next[None]]) - v[rows])
        rhos[rows] = rho
        v_next, vs_next = v[lo], vs[lo]
    return returns.VTraceOutput(vs=vs, pg_advantages=pg, clipped_rhos=rhos)


CHUNK_T = [1, SCAN_CHUNK, SCAN_CHUNK + 1, 256]


@pytest.mark.parametrize("E", [37, 64])
@pytest.mark.parametrize("T", CHUNK_T)
def test_gae_chunked_walk_equals_plain(T, E):
    tlp, blp, r, v, d, b = _inputs(T, E, seed=T * 1000 + E)
    chunk = scan_geometry(T, E, *PLANES["gae"]).chunk
    got = emulate_gae(r, v, d, b, GAMMA, LAM, chunk)
    want = returns.gae(r, v, d, b, GAMMA, LAM)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("E", [37, 64])
@pytest.mark.parametrize("T", CHUNK_T)
def test_vtrace_chunked_walk_equals_plain(T, E):
    args = _inputs(T, E, seed=T * 1000 + E + 1)
    chunk = scan_geometry(T, E, *PLANES["vtrace"]).chunk
    # c̄ above ρ̄ and λ < 1, so that ρ, c and the trace all differ.
    got = emulate_vtrace(*args, GAMMA, 1.0, 2.0, 0.9, chunk)
    want = returns.vtrace(*args, GAMMA, 1.0, 2.0, 0.9)
    for field in want._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def test_multi_chunk_cases_cross_boundaries():
    """T = SCAN_CHUNK + 1 and 256 take two and four chunks."""
    assert len(list(_chunks(SCAN_CHUNK + 1, SCAN_CHUNK))) == 2
    assert list(_chunks(256, SCAN_CHUNK)) == [(192, 256), (128, 192), (64, 128), (0, 64)]
