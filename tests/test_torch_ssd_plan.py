"""The SSD scan kernel's decomposition and geometry, on the CPU in float32.

``ref.ssd_split_ref`` is the plain PyTorch twin of the split that
``csrc/ssd_scan.cu`` computes: per 64-position tile the half that does not
read the state (decayed scores, y_intra, the tile's own state), then the
serial pass (inter from the state entering the tile, the carry).  It is
held to the JAX package's Pallas ``ssd_scan`` in interpret mode (B and C
per row, no start state), to the reference's ``models/ssd.py::ssd_chunked``
with ``h_init`` (through the port's ``ssd_chunked`` with the split as its
scan), and to the port's sequential ``ref.ssd_scan_ref``.  Inputs come from
a numpy seed.  The bound is the JAX suite's own for chunked against
sequential SSD, atol 5e-5 and rtol 1e-3 (tests/test_models.py), as in
tests/test_torch_ssd.py.  ``ssd_scan.plan`` mirrors the kernel's grid,
waves and load route; the card checks its numbers against the built
kernel's (``chip_smoke.py`` phase 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import ssd as jssd
from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.models import ssd

SCAN_TOL = dict(atol=5e-5, rtol=1e-3)
# The reference's chunked form, jitted once per shape (op by op it takes
# seconds a call on the CPU).
jssd_chunked = jax.jit(jssd.ssd_chunked, static_argnums=(6,))
SIZES = (1, 63, 64, 65, 300)
# (batch rows = groups, heads per group, P, N, decay): one group shared by
# several heads with the model's decays; one head a group at odd P and N with
# weak decays (the carried state dominates).
LAYOUTS = {"groups": (1, 3, 16, 8, "model"), "odd": (3, 1, 7, 33, "weak")}


def T(a):
    return torch.from_numpy(np.array(a))


def split_inputs(seed, bsz, heads, s, p, n, decay):
    """x, da (BH = bsz * heads rows), b, c (bsz groups), h0 (BH, N, P):
    model decays -softplus(N(0, 1)) * A with A = 1..16 across the heads,
    weak ones in [-1e-3, 0]."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    bh = bsz * heads
    if decay == "weak":
        da = -1e-3 * rng.random((bh, s))
    else:
        a = np.tile(np.linspace(1.0, 16.0, heads), bsz)[:, None]
        da = -np.log1p(np.exp(rng.normal(size=(bh, s)))) * a
    return f(bh, s, p), da.astype(np.float32), f(bsz, s, n), f(bsz, s, n), f(bh, n, p)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("s", SIZES)
def test_split_matches_jax_pallas_scan(s, layout):
    """Without a start state, against the Pallas kernel (interpret mode,
    B and C repeated per row as it takes them) and the sequential scan."""
    bsz, heads, p, n, decay = LAYOUTS[layout]
    x, da, b, c, _ = split_inputs(s, bsz, heads, s, p, n, decay)
    got = ref.ssd_split_ref(T(x), T(da), T(b), T(c))
    rows = lambda a: jnp.asarray(np.repeat(a, heads, axis=0))
    want = jops.ssd_scan(jnp.asarray(x), jnp.asarray(da), rows(b), rows(c), chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    seq = ref.ssd_scan_ref(T(x), T(da), T(b), T(c))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), **SCAN_TOL)


@pytest.mark.parametrize("s", SIZES)
def test_split_h_init_matches_jax_chunked(monkeypatch, s):
    """From a start state: the port's ``ssd_chunked`` with the split as its
    scan against the reference's ``ssd_chunked`` with ``h_init`` (y with
    the D skip, and the final state)."""
    bsz, heads, p, n = 2, 3, 8, 5
    rng = np.random.default_rng(100 + s)
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    x, bm, cm, d, h0 = f(bsz, s, heads, p), f(bsz, s, n), f(bsz, s, n), f(heads), \
        f(bsz, heads, p, n)
    dt = (np.abs(f(bsz, s, heads)) * 0.5 + 0.01).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, heads)).astype(np.float32)

    def split_scan(xk, da, bk, ck, *, chunk=256, return_state=False, h0=None):
        del chunk
        return ref.ssd_split_ref(xk, da, bk, ck, h0=h0, return_state=return_state)

    monkeypatch.setattr(ops, "ssd_scan", split_scan)
    y, final = ssd.ssd_chunked(T(x), T(dt), T(a_log), T(bm), T(cm), T(d), 64, T(h0),
                               return_state=True)
    jy, jfinal = jssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_log, bm, cm, d)), 64,
                              jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **SCAN_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("s", (1, 65, 300))
def test_split_matches_sequential_scan(s, layout, with_h0):
    """y and the final state against the port's sequential scan, with and
    without h0; h0 = 0 gives the bits of no h0."""
    bsz, heads, p, n, decay = LAYOUTS[layout]
    x, da, b, c, h0 = split_inputs(7 + s, bsz, heads, s, p, n, decay)
    h0 = T(h0) if with_h0 else None
    got = ref.ssd_split_ref(T(x), T(da), T(b), T(c), h0=h0, return_state=True)
    want = ref.ssd_scan_ref(T(x), T(da), T(b), T(c), h0=h0, return_state=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **SCAN_TOL)
    if not with_h0:
        zero = ref.ssd_split_ref(T(x), T(da), T(b), T(c), h0=torch.zeros((bsz * heads, n, p)),
                                 return_state=True)
        assert all(torch.equal(u, v) for u, v in zip(zero, got))


@pytest.mark.parametrize("bh,s,p,n,groups,blocks,waves,last", [
    (192, 512, 64, 128, 8, 384, 384 / 132, 120 / 132),   # path D's prefill, row 8
    (384, 256, 64, 128, 16, 768, 768 / 132, 108 / 132),  # path I2's training scan
    (6, 70, 40, 100, 2, 12, 12 / 132, 12 / 132),
    (2, 70, 7, 33, 1, 2, 2 / 132, 2 / 132),
])
def test_plan_grid_and_waves(bh, s, p, n, groups, blocks, waves, last):
    """One block an SM (its shared memory leaves no room for a second), a
    persistent grid of at most one block an SM walking the (BH, P / 32)
    items, and at the main paths' shapes a last round at least half full."""
    got = ssd_scan.plan(bh, s, p, n, groups)
    assert got["items"] == blocks and got["grid"] == (min(blocks, 132),)
    assert got["blocks_per_sm"] == 1 and got["threads"] == 384
    assert ssd_scan.SCAN_SMEM <= ssd_scan.SMEM_LIMIT < 2 * ssd_scan.SCAN_SMEM
    assert got["smem_bytes"] == 230992
    assert got["waves"] == pytest.approx(waves) and got["last_wave_fill"] == pytest.approx(last)
    assert got["prep_grid"] == (-(-s // 64), groups, 2) and got["tiles"] == -(-s // 64)
    assert got["boxes"] == -(-n // 32)
    if blocks >= 132:
        assert got["last_wave_fill"] >= 0.5


@pytest.mark.parametrize("p,n,aligned,route", [
    (64, 128, True, "tma"), (40, 100, True, "tma"), (16, 32, True, "tma"),
    (7, 33, True, "cp.async"), (64, 33, True, "cp.async"), (7, 128, True, "cp.async"),
    (64, 128, False, "cp.async"),
])
def test_plan_load_route(p, n, aligned, route):
    """TMA takes a tensor only with rows a multiple of 16 bytes and a
    16-byte aligned base; the rest copies by cp.async into the same boxes."""
    assert ssd_scan.plan(4, 100, p, n, 2, aligned=aligned)["route"] == route
