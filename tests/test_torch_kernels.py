"""Port kernels: the plain PyTorch versions against the jnp oracles and the
Pallas kernels (interpret mode), and the CPU dispatch policy.  The CUDA
kernels themselves are checked on a card by ``test_torch_cuda.py``.

Tolerances: elementwise outputs atol 1e-6 (fp32 values of O(1), a handful
of ops each); the residual sums and Gram matrices rtol 1e-5 (fp32 sums over
up to ~1e3 terms taken in another order), relative to the largest entry of
each tensor — an off-diagonal Gram entry that cancels to a small value
carries the absolute error of the large ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import rpca_admm as jadmm
from repro.kernels import svt_subspace as jsub
from repro_torch.kernels import backend, ref, rpca_admm, svt_subspace

ELEM = dict(atol=1e-6, rtol=0)


def assert_sums_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.max(np.abs(want)))


def make_inputs(seed, b, vec, d2, n_valid=None, pad_rows=0):
    """Bucket inputs from a numpy seed: (B, vec, d2) m/l/s/y with the last
    ``pad_rows`` rows zero (padded vec region), per-module scalars, a
    projector, and a mask with ``n_valid`` live columns (None = dense)."""
    rng = np.random.default_rng(seed)
    t = lambda *s: rng.normal(size=s).astype(np.float32)
    m, l, s, y = t(b, vec, d2), t(b, vec, d2), t(b, vec, d2), 0.3 * t(b, vec, d2)
    if pad_rows:
        for a in (m, l, s, y):
            a[:, vec - pad_rows:] = 0.0
    p = (t(b, d2, d2) / np.sqrt(d2)).astype(np.float32)
    rho = (0.5 + rng.random(b)).astype(np.float32)
    mu = (1.0 / rho).astype(np.float32)
    th = (0.4 * rho).astype(np.float32)
    mask = None
    if n_valid is not None:
        mask = (np.arange(d2) < n_valid).astype(np.float32)
        m = m * mask
    return dict(m=m, l=l, s=s, y=y, p=p, rho=rho, mu=mu, th=th, mask=mask)


def as_torch(x):
    return None if x is None else torch.from_numpy(np.array(x))


def as_jax(x):
    return None if x is None else jnp.asarray(x)


CASES = [
    # (d2, n_valid, pad_rows)
    (1, None, 0),
    (3, None, 5),
    (8, 5, 3),
    (40, None, 7),
    (40, 23, 0),
]


@pytest.mark.parametrize("d2,n_valid,pad_rows", CASES)
def test_admm_tail_plain_matches_jax(d2, n_valid, pad_rows):
    x = make_inputs(0, 3, 37, d2, n_valid, pad_rows)
    args = ("m", "l", "y", "rho", "mu", "th")
    got = ref.rpca_admm_tail_ref(*(as_torch(x[k]) for k in args), mask=as_torch(x["mask"]))
    want = jref.rpca_admm_tail_ref(*(as_jax(x[k]) for k in args), mask=as_jax(x["mask"]))
    pallas = jadmm.admm_tail(
        *(as_jax(x[k]) for k in args), mask=as_jax(x["mask"]), block_vec=16, interpret=True
    )
    for oracle in (want, pallas):
        for g, w in zip(got[:2], oracle[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **ELEM)
        assert_sums_close(got[2].numpy(), oracle[2])
    s, y_new, _ = got
    if pad_rows:
        assert np.all(s.numpy()[:, -pad_rows:] == 0) and np.all(y_new.numpy()[:, -pad_rows:] == 0)
    if n_valid is not None:
        assert np.all(s.numpy()[..., n_valid:] == 0) and np.all(y_new.numpy()[..., n_valid:] == 0)


@pytest.mark.parametrize("d2,n_valid,pad_rows", CASES)
def test_subspace_apply_plain_matches_jax(d2, n_valid, pad_rows):
    x = make_inputs(1, 2, 29, d2, n_valid, pad_rows)
    args = ("m", "s", "y", "p", "rho", "mu", "th")
    got = ref.svt_subspace_apply_ref(*(as_torch(x[k]) for k in args), mask=as_torch(x["mask"]))
    want = jref.svt_subspace_apply_ref(*(as_jax(x[k]) for k in args), mask=as_jax(x["mask"]))
    pallas = jsub.subspace_apply(
        *(as_jax(x[k]) for k in args), mask=as_jax(x["mask"]), block_vec=16, interpret=True
    )
    for oracle in (want, pallas):
        for g, w in zip(got[:3], oracle[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **ELEM)
        for g, w in zip(got[3:], oracle[3:]):
            assert_sums_close(g.numpy(), w)
    _, s_new, y_new, _, _ = got
    if pad_rows:
        assert np.all(s_new.numpy()[:, -pad_rows:] == 0)
    if n_valid is not None:
        assert np.all(s_new.numpy()[..., n_valid:] == 0) and np.all(y_new.numpy()[..., n_valid:] == 0)


def test_cpu_wrappers_take_the_plain_version():
    """A CPU tensor computes the plain version, bit for bit, and launches
    nothing; ``mask=None`` gives the same bits as an all-ones mask."""
    x = make_inputs(2, 2, 21, 6)
    t = {k: as_torch(v) for k, v in x.items()}
    ones = torch.ones(6)
    before = (rpca_admm.admm_tail.launches, svt_subspace.subspace_apply.launches)
    a = rpca_admm.admm_tail(t["m"], t["l"], t["y"], t["rho"], t["mu"], t["th"])
    a1 = rpca_admm.admm_tail(t["m"], t["l"], t["y"], t["rho"], t["mu"], t["th"], mask=ones)
    ar = ref.rpca_admm_tail_ref(t["m"], t["l"], t["y"], t["rho"], t["mu"], t["th"])
    b = svt_subspace.subspace_apply(t["m"], t["s"], t["y"], t["p"], t["rho"], t["mu"], t["th"])
    b1 = svt_subspace.subspace_apply(
        t["m"], t["s"], t["y"], t["p"], t["rho"], t["mu"], t["th"], mask=ones
    )
    br = ref.svt_subspace_apply_ref(t["m"], t["s"], t["y"], t["p"], t["rho"], t["mu"], t["th"])
    for got, same, plain in ((a, a1, ar), (b, b1, br)):
        for g, s1, p in zip(got, same, plain):
            assert torch.equal(g, p) and torch.equal(g, s1)
    assert (rpca_admm.admm_tail.launches, svt_subspace.subspace_apply.launches) == before
    assert not backend.use_kernel(t["m"])


@pytest.mark.parametrize("bad", ["shape", "mask", "projector"])
def test_wrappers_validate_shapes(bad):
    x = {k: as_torch(v) for k, v in make_inputs(3, 2, 9, 4).items()}
    if bad == "shape":
        with pytest.raises(ValueError, match="shape mismatch"):
            rpca_admm.admm_tail(x["m"], x["l"][:, :5], x["y"], x["rho"], x["mu"], x["th"])
    elif bad == "mask":
        with pytest.raises(ValueError, match="mask"):
            rpca_admm.admm_tail(x["m"], x["l"], x["y"], x["rho"], x["mu"], x["th"],
                                mask=torch.ones(3))
    else:
        with pytest.raises(ValueError, match="projector"):
            svt_subspace.subspace_apply(x["m"], x["s"], x["y"], x["p"][:, :3], x["rho"],
                                        x["mu"], x["th"])


@pytest.mark.parametrize("d2", [1, 3, 40, 128, 130, 1024])
def test_subspace_tiling_fits_shared_memory(d2):
    """The launch geometry stays inside the 192 KiB shared-memory budget,
    covers every row with whole groups, and keeps P in one column tile up
    to d2 = 128."""
    geo = svt_subspace.tiling(48, 4096, d2)
    floats = 2 * geo["tile_rows"] * d2 + d2 * geo["pcols"] + d2
    assert floats <= svt_subspace.SMEM_FLOATS
    assert geo["group_rows"] % geo["tile_rows"] == 0
    assert (geo["n_groups"] - 1) * geo["group_rows"] < 4096 <= geo["n_groups"] * geo["group_rows"]
    if d2 <= 128:
        assert geo["pcols"] == d2


@pytest.mark.parametrize("d2,route", [(1, "tensor"), (40, "tensor"), (128, "tensor"),
                                      (129, "scalar"), (130, "scalar"), (1024, "scalar")])
def test_subspace_route_edges(d2, route):
    """The shape alone picks the route: the tensor cores up to d2 = 128."""
    assert svt_subspace.route(d2) == route


def test_subspace_route_refuses_an_empty_cohort():
    with pytest.raises(ValueError, match="cohort width"):
        svt_subspace.route(0)


@pytest.mark.parametrize("b", [2, 48, 600])
@pytest.mark.parametrize("d2", [1, 3, 8, 20, 32, 40, 64, 100, 128])
def test_subspace_tc_tiling_fits_and_covers(b, d2):
    """The tensor route's geometry: a padded width the kernel is built for,
    shared memory within one block's and (at two blocks an SM) one SM's
    budget, every row covered by whole groups of whole tiles, and no more
    blocks than fit the card at once unless the modules alone exceed it."""
    geo = svt_subspace.tc_tiling(b, 4096, d2)
    assert geo["dn"] in svt_subspace.TC_WIDTHS and geo["dn"] >= d2
    assert geo["dn"] - d2 < 16 or geo["dn"] > 64
    assert geo["smem"] <= svt_subspace.BLOCK_SMEM_BYTES
    assert geo["blocks_per_sm"] >= 1
    assert geo["blocks_per_sm"] * (geo["smem"] + 1024) <= svt_subspace.SM_SMEM_BYTES
    assert geo["group_rows"] % geo["tile_rows"] == 0
    assert (geo["n_groups"] - 1) * geo["group_rows"] < 4096 <= geo["n_groups"] * geo["group_rows"]
    resident = svt_subspace.SM_COUNT * geo["blocks_per_sm"]
    assert b * geo["n_groups"] <= max(resident, b)


def test_subspace_tc_tiling_main_paths():
    """Path B's (48, 4096, 40) bucket runs 108 KB blocks, two an SM, in one
    wave of 240 blocks; path A's (2, 4096, 20) one tile a block."""
    geo = svt_subspace.tc_tiling(48, 4096, 40)
    assert (geo["dn"], geo["tile_rows"], geo["blocks_per_sm"], geo["n_groups"]) == (48, 64, 2, 5)
    assert 48 * geo["n_groups"] <= 2 * svt_subspace.SM_COUNT
    geo = svt_subspace.tc_tiling(2, 4096, 20)
    assert geo["group_rows"] == geo["tile_rows"] == 64 and geo["n_groups"] == 64


@pytest.mark.parametrize("bh,s,g", [(192, 512, 8), (6, 1, 2), (6, 0, 2), (4, 65, 4)])
def test_ssd_scan_scratch_covers_whole_tiles(bh, s, g):
    """Scratch of the scan's first pass: (G, tiles, 64, 64) score tiles and
    (BH, tiles * 64) sums, 1 MB of scores at path D's prefill."""
    from repro_torch.kernels import ssd_scan

    tiles = -(-s // 64)
    assert ssd_scan.scratch_floats(bh, s, g) == g * tiles * 64 * 64 + bh * tiles * 64
    if (bh, s, g) == (192, 512, 8):
        assert g * tiles * 64 * 64 * 4 == 2**20
