"""Port RPCA against the JAX package: the bucket loop in gram and subspace
modes (dense, masked, padded true dims, fixed-iteration and tolerance
loops), the per-matrix drivers, and the SVT building blocks.

L and S are held to atol 1e-4 * max|M| (fp32 eigh and matmul round-off
amplified over 20 ADMM iterations); iteration and fallback counts must be
equal.  Eigenvector signs differ between the libraries, so only projectors,
spans and reconstructions are compared, never raw bases.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rpca as jrpca
from repro_torch.core import rpca


def planted(seed, b, d, nc, rank=2, sparsity=0.05, true_dims=None, n_valid=None):
    """Shared low-rank core + sparse spikes per module; rows beyond each
    module's true dim and columns beyond ``n_valid`` are zero."""
    rng = np.random.default_rng(seed)
    low = rng.normal(size=(b, d, rank)) @ rng.normal(size=(b, rank, nc))
    spikes = rng.random((b, d, nc)) < sparsity
    m = (low + np.where(spikes, 5.0 * rng.normal(size=(b, d, nc)), 0.0)).astype(np.float32)
    if true_dims is not None:
        for i, td in enumerate(true_dims):
            m[i, td:] = 0.0
    if n_valid is not None:
        m[..., n_valid:] = 0.0
    return m


def close(got, want, scale, tol=1e-4):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=0, atol=tol * scale
    )


TRUE_DIMS = [48, 40, 33]


@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tol", [None, 2e-3])
def test_robust_pca_bucket_matches_jax(svt_mode, masked, tol):
    nc, n_valid = (16, 11) if masked else (12, None)
    m = planted(0, 3, 48, nc, true_dims=TRUE_DIMS, n_valid=n_valid)
    mask = None if not masked else (np.arange(nc) < n_valid).astype(np.float32)
    dims = np.asarray(TRUE_DIMS, np.int32)
    kw = dict(n_iter=20, tol=tol, svt_mode=svt_mode, true_cols=n_valid)
    want, carry = jrpca.robust_pca_bucket(
        jnp.asarray(m), jnp.asarray(dims), client_mask=None if mask is None else jnp.asarray(mask),
        return_carry=True, **kw,
    )
    got = rpca.robust_pca_bucket(
        torch.from_numpy(m), torch.from_numpy(dims),
        client_mask=None if mask is None else torch.from_numpy(mask), **kw,
    )
    scale = np.abs(m).max()
    close(got.low_rank.numpy(), want.low_rank, scale)
    close(got.sparse.numpy(), want.sparse, scale)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    assert got.n_fallback == int(carry.fall_count)
    if svt_mode == "subspace":
        assert 0 < got.n_fallback < 20  # the warm path ran too
    if tol is not None:
        assert int(got.n_iter.min()) < 20  # some module froze early
    for i, td in enumerate(TRUE_DIMS):  # padded rows stay exactly zero
        assert np.all(got.low_rank.numpy()[i, td:] == 0)
        assert np.all(got.sparse.numpy()[i, td:] == 0)
    if masked:  # masked columns stay exactly zero
        assert np.all(got.low_rank.numpy()[..., n_valid:] == 0)
        assert np.all(got.sparse.numpy()[..., n_valid:] == 0)


@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
def test_custom_shrink_on_a_cpu_bucket_matches_jax(svt_mode):
    """A CPU bucket runs the plain tail, which honours a custom shrink_fn
    (hard thresholding here) as the reference's unfused path does; only a
    CUDA bucket refuses one (``test_torch_cuda.py``)."""
    m = planted(1, 2, 40, 8)
    mask = (np.arange(8) < 6).astype(np.float32)
    kw = dict(n_iter=15, svt_mode=svt_mode, true_cols=6)
    want = jrpca.robust_pca_bucket(
        jnp.asarray(m), client_mask=jnp.asarray(mask),
        shrink_fn=lambda x, t: jnp.where(jnp.abs(x) > t, x, 0.0), **kw,
    )
    got = rpca.robust_pca_bucket(
        torch.from_numpy(m), client_mask=torch.from_numpy(mask),
        shrink_fn=lambda x, t: torch.where(torch.abs(x) > t, x, 0.0), **kw,
    )
    scale = float(np.abs(m).max())
    close(got.low_rank.numpy(), want.low_rank, scale)
    close(got.sparse.numpy(), want.sparse, scale)
    assert np.all(got.sparse.numpy()[..., 6:] == 0)


@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
@pytest.mark.parametrize("driver", ["fixed", "tol"])
def test_per_matrix_drivers_match_jax(svt_mode, driver):
    m = planted(3, 1, 40, 10)[0]
    if driver == "fixed":
        want = jrpca.robust_pca_fixed_iters(jnp.asarray(m), n_iter=20, svt_mode=svt_mode)
        got = rpca.robust_pca_fixed_iters(torch.from_numpy(m), n_iter=20, svt_mode=svt_mode)
    else:
        want = jrpca.robust_pca(jnp.asarray(m), tol=1e-3, max_iter=30, svt_mode=svt_mode)
        got = rpca.robust_pca(torch.from_numpy(m), tol=1e-3, max_iter=30, svt_mode=svt_mode)
    scale = np.abs(m).max()
    close(got.low_rank.numpy(), want.low_rank, scale)
    close(got.sparse.numpy(), want.sparse, scale)
    assert int(got.n_iter) == int(want.n_iter)
    np.testing.assert_allclose(float(got.residual), float(want.residual), rtol=1e-3, atol=1e-6)


def test_batched_robust_pca_matches_jax():
    ms = planted(4, 3, 24, 6)
    want = jrpca.batched_robust_pca(jnp.asarray(ms), n_iter=15)
    got = rpca.batched_robust_pca(torch.from_numpy(ms), n_iter=15)
    close(got.low_rank.numpy(), want.low_rank, np.abs(ms).max())
    close(got.sparse.numpy(), want.sparse, np.abs(ms).max())


@pytest.mark.parametrize("shape", [(30, 7), (7, 30)])
def test_svt_gram_and_svd_match_jax(shape):
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape).astype(np.float32)
    for t in (0.3, 2.0):
        want = jrpca.svt_gram(jnp.asarray(x), t)
        np.testing.assert_allclose(rpca.svt_gram(torch.from_numpy(x), t).numpy(), want, atol=2e-5)
        np.testing.assert_allclose(
            rpca.svt_svd(torch.from_numpy(x), t).numpy(), jrpca.svt_svd(jnp.asarray(x), t),
            atol=2e-5,
        )
    xb = rng.normal(size=(3,) + shape).astype(np.float32)
    tb = np.asarray([0.2, 1.0, 3.0], np.float32)
    np.testing.assert_allclose(
        rpca.svt_gram_batched(torch.from_numpy(xb), torch.from_numpy(tb)).numpy(),
        jrpca.svt_gram_batched(jnp.asarray(xb), jnp.asarray(tb)), atol=2e-5,
    )


def test_orthonormalize_matches_jax_triangular_solve():
    """CholeskyQR: ``solve_triangular(chol^T, z, upper, left=False)`` is the
    reference's ``triangular_solve(left_side=False, lower=True,
    transpose_a=True)``, so Q matches (Cholesky factors are unique)."""
    rng = np.random.default_rng(6)
    z = rng.normal(size=(2, 20, 4)).astype(np.float32)
    got = rpca._orthonormalize(torch.from_numpy(z)).numpy()
    want = np.asarray(jrpca._orthonormalize(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.einsum("bnr,bns->brs", got, got),
                               np.broadcast_to(np.eye(4), (2, 4, 4)), atol=1e-4)


def test_orthonormalize_failed_cholesky_is_nan():
    """Where JAX's Cholesky returns NaN, the port's does too (no raise)."""
    z = torch.full((1, 5, 2), float("nan"))
    assert torch.isnan(rpca._orthonormalize(z)).all()


@pytest.mark.parametrize("warm", [False, True])
def test_svt_subspace_matches_jax(warm):
    rng = np.random.default_rng(7)
    u, w = rng.normal(size=(64, 2)), rng.normal(size=(2, 12))
    x = (u @ w).astype(np.float32)
    x2 = (u @ (w + 0.01 * rng.normal(size=w.shape))).astype(np.float32)
    jc = jrpca.svt_subspace(jnp.asarray(x), 1.0)
    tc = rpca.svt_subspace(torch.from_numpy(x), 1.0)
    if warm:
        jc = jrpca.svt_subspace(jnp.asarray(x2), 1.0, jc.v)
        tc = rpca.svt_subspace(torch.from_numpy(x2), 1.0, tc.v)
    np.testing.assert_allclose(tc.low_rank.numpy(), jc.low_rank, atol=1e-4)
    assert tc.fell_back == bool(jc.fell_back) == (not warm)
    assert int(tc.n_live) == int(jc.n_live)
    # Same span of the live directions of the carried basis (top directions
    # last; signs, and the junk directions of the zero eigenvalues, differ).
    k = int(tc.n_live)
    vj, vt = np.asarray(jc.v)[:, -k:], tc.v.numpy()[:, -k:]
    np.testing.assert_allclose(vt @ vt.T, vj @ vj.T, atol=1e-4)


def test_subspace_state_and_rank():
    for d2, rank, cols in [(8, 8, None), (16, 8, 9), (16, 8, 7), (1, 8, None), (16, 3, None)]:
        assert rpca.subspace_rank(d2, rank, cols) == jrpca.subspace_rank(d2, rank, cols)
    m = planted(8, 2, 20, 6)
    st = rpca.subspace_init(torch.from_numpy(m), 8)
    sj = jrpca.subspace_init(jnp.asarray(m), 8)
    np.testing.assert_allclose(st.g.numpy(), sj.g, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(st.v.numpy(), sj.v)
    np.testing.assert_array_equal(st.n_live.numpy(), sj.n_live)


def test_sparse_energy_and_guard_match_jax():
    rng = np.random.default_rng(9)
    m = rng.normal(size=(3, 20, 6)).astype(np.float32)
    s = (m * (rng.random(m.shape) < 0.3)).astype(np.float32)
    s[:, :, 2] *= 8.0
    e_t = rpca.client_sparse_energy(torch.from_numpy(m), torch.from_numpy(s))
    e_j = jrpca.client_sparse_energy(jnp.asarray(m), jnp.asarray(s))
    np.testing.assert_allclose(e_t.numpy(), e_j, rtol=1e-5)
    valid = np.asarray([1, 1, 1, 1, 1, 0], np.float32)  # 5 valid: odd count
    base = np.asarray([1, 2, 3, 4, 5, 6], np.float32)
    for v in (None, valid, np.ones(6, np.float32)):  # even count averages the middle pair
        wt, ft = rpca.energy_guard_weights(
            e_t, 1.5, base_w=torch.from_numpy(base), valid=None if v is None else torch.from_numpy(v)
        )
        wj, fj = jrpca.energy_guard_weights(
            e_j, 1.5, base_w=jnp.asarray(base), valid=None if v is None else jnp.asarray(v)
        )
        np.testing.assert_allclose(wt.numpy(), wj, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(ft.numpy(), fj)
