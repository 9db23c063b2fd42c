"""The port's CUDA kernels on a card: each against its plain PyTorch version,
two launches bit for bit, ``mask=None`` bit for bit an all-ones mask, and a
bucket RPCA on the card against the same call on the CPU.

Every test is marked ``gpu`` and skips without a card.  This file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Tolerances: elementwise atol 1e-5 (fp32 FMA contraction and dot order of
L = X @ P, O(1) values); sums and Grams 1e-5 of their largest entry; the
RPCA result 1e-4 of max|M| (eigh on two libraries over 20 iterations).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import rpca
from repro_torch.kernels import ref, rpca_admm, svt_subspace


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(seed, b, vec, d2, n_valid, device):
    gen = torch.Generator().manual_seed(seed)
    t = lambda *s: torch.randn(s, generator=gen)
    m, l, s, y = t(b, vec, d2), t(b, vec, d2), t(b, vec, d2), 0.3 * t(b, vec, d2)
    mask = None
    if n_valid is not None:
        mask = (torch.arange(d2) < n_valid).float()
        m = m * mask
    p = t(b, d2, d2) / d2**0.5
    rho = torch.rand(b, generator=gen) + 0.5
    out = dict(m=m, l=l, s=s, y=y, p=p, rho=rho, mu=1.0 / rho, th=0.4 * rho, mask=mask)
    return {k: None if v is None else v.to(device) for k, v in out.items()}


def assert_sums_close(got, want, rtol=1e-5):
    err = float((got.double() - want.double()).abs().max())
    assert err <= rtol * float(want.double().abs().max()), err


SHAPES = [(40, None), (32, 20), (1, None), (3, None), (130, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("d2,n_valid", SHAPES)
def test_admm_tail_kernel_matches_plain(cuda, d2, n_valid):
    x = inputs(0, 3, 1000, d2, n_valid, cuda)
    args = (x["m"], x["l"], x["y"], x["rho"], x["mu"], x["th"])
    got = rpca_admm.admm_tail(*args, mask=x["mask"])
    again = rpca_admm.admm_tail(*args, mask=x["mask"])
    want = ref.rpca_admm_tail_ref(*args, mask=x["mask"])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    assert_sums_close(got[2], want[2])
    if x["mask"] is None:
        ones = rpca_admm.admm_tail(*args, mask=torch.ones(d2, device=cuda))
        assert all(torch.equal(a, b) for a, b in zip(got, ones))
    else:
        assert not bool(got[0][..., n_valid:].any()) and not bool(got[1][..., n_valid:].any())


@pytest.mark.gpu
@pytest.mark.parametrize("d2,n_valid", SHAPES)
def test_subspace_apply_kernel_matches_plain(cuda, d2, n_valid):
    x = inputs(1, 3, 1000, d2, n_valid, cuda)
    args = (x["m"], x["s"], x["y"], x["p"], x["rho"], x["mu"], x["th"])
    got = svt_subspace.subspace_apply(*args, mask=x["mask"])
    again = svt_subspace.subspace_apply(*args, mask=x["mask"])
    want = ref.svt_subspace_apply_ref(*args, mask=x["mask"])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    for g, w in zip(got[3:], want[3:]):
        assert_sums_close(g, w)
    if x["mask"] is None:
        ones = svt_subspace.subspace_apply(*args, mask=torch.ones(d2, device=cuda))
        assert all(torch.equal(a, b) for a, b in zip(got, ones))
    else:
        assert not bool(got[1][..., n_valid:].any()) and not bool(got[2][..., n_valid:].any())


@pytest.mark.gpu
@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
def test_bucket_rpca_card_matches_cpu(cuda, svt_mode):
    """The bucket loop on the card (kernel tails) against the CPU (inline
    tail), masked, with padded rows."""
    rng = np.random.default_rng(2)
    m = rng.normal(size=(3, 64, 2)) @ rng.normal(size=(3, 2, 16))
    m = (m + np.where(rng.random(m.shape) < 0.05, 5.0, 0.0)).astype(np.float32)
    m[:, 50:] = 0.0
    mask = torch.tensor([1.0] * 11 + [0.0] * 5)
    kw = dict(n_iter=20, svt_mode=svt_mode, client_mask=mask, true_cols=11,
              true_dims=torch.tensor([50, 50, 50], dtype=torch.int32))
    before = (rpca_admm.admm_tail.launches, svt_subspace.subspace_apply.launches)
    gpu = rpca.robust_pca_bucket(torch.from_numpy(m).to(cuda), **kw)
    cpu = rpca.robust_pca_bucket(torch.from_numpy(m), **kw)
    after = (rpca_admm.admm_tail.launches, svt_subspace.subspace_apply.launches)
    assert after[0 if svt_mode == "gram" else 1] - before[0 if svt_mode == "gram" else 1] == 20
    scale = float(np.abs(m).max())
    for g, c in ((gpu.low_rank, cpu.low_rank), (gpu.sparse, cpu.sparse)):
        torch.testing.assert_close(g.cpu(), c, atol=1e-4 * scale, rtol=0)
    assert gpu.n_fallback == cpu.n_fallback


@pytest.mark.gpu
def test_custom_shrink_refused_on_a_cuda_bucket(cuda):
    """The kernels hardcode soft thresholding: a CUDA bucket with another
    shrink raises rather than running a different tail."""
    m = torch.randn((2, 16, 4), generator=torch.Generator().manual_seed(3)).to(cuda)
    with pytest.raises(ValueError, match="soft-threshold"):
        rpca.robust_pca_bucket(m, shrink_fn=lambda x, t: torch.where(torch.abs(x) > t, x, 0.0))


@pytest.mark.gpu
def test_aggregate_runs_on_the_card_by_default(cuda):
    """``aggregate`` moves a CPU tree to the card unless asked otherwise,
    and the packed engine's tail launches the kernel there."""
    from repro_torch.core import AggregatorConfig, aggregate

    gen = torch.Generator().manual_seed(4)
    tree = {"A": torch.randn((6, 2, 8, 3), generator=gen), "B": torch.randn((6, 2, 3, 8), generator=gen)}
    before = rpca_admm.admm_tail.launches
    out = aggregate(tree, AggregatorConfig(method="fedrpca", rpca_iters=5))
    assert all(v.device.type == "cuda" for v in out.values())
    assert rpca_admm.admm_tail.launches - before == 5
    cpu = aggregate(tree, AggregatorConfig(method="fedrpca", rpca_iters=5), device="cpu")
    for k in out:
        torch.testing.assert_close(out[k].cpu(), cpu[k], atol=1e-4 * float(tree[k].abs().max()), rtol=0)
