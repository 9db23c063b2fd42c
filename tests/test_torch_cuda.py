"""The port's CUDA kernels on a card: each against its plain PyTorch version,
two launches bit for bit, ``mask=None`` bit for bit an all-ones mask, a
bucket RPCA on the card against the same call on the CPU, carried (warm)
rounds and sessions on the card against the CPU, and the merging methods.

Every test is marked ``gpu`` and skips without a card.  This file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Tolerances: elementwise atol 1e-5 (fp32 FMA contraction and dot order of
L = X @ P, O(1) values); sums and Grams 1e-5 of their largest entry; the
RPCA result 1e-4 of max|M| (eigh on two libraries over 20 iterations).
The serving kernels' tolerances are stated beside their tests.
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


def client_mask(d2, n_valid):
    """None (dense), a prefix of ``n_valid`` live columns, or, for a tuple,
    every column live but those it names (a mask with holes, as dropout,
    stragglers, the quarantine and the trace sampler make)."""
    if n_valid is None:
        return None
    if isinstance(n_valid, tuple):
        mask = torch.ones(d2)
        mask[list(n_valid)] = 0.0
        return mask
    return (torch.arange(d2) < n_valid).float()


def inputs(seed, b, vec, d2, n_valid, device):
    gen = torch.Generator().manual_seed(seed)
    t = lambda *s: torch.randn(s, generator=gen)
    m, l, s, y = t(b, vec, d2), t(b, vec, d2), t(b, vec, d2), 0.3 * t(b, vec, d2)
    mask = client_mask(d2, n_valid)
    if mask is not None:
        m = m * mask
    p = t(b, d2, d2) / d2**0.5
    rho = torch.rand(b, generator=gen) + 0.5
    out = dict(m=m, l=l, s=s, y=y, p=p, rho=rho, mu=1.0 / rho, th=0.4 * rho, mask=mask)
    return {k: None if v is None else v.to(device) for k, v in out.items()}


def assert_sums_close(got, want, rtol=1e-5):
    err = float((got.double() - want.double()).abs().max())
    assert err <= rtol * float(want.double().abs().max()), err


# Slots 3, 7 and 20-31 of a 32-slot cohort off: holes, then a padded tail.
HOLES = (3, 7, *range(20, 32))
SHAPES = [(40, None), (32, 20), (1, None), (3, None), (130, None), (32, HOLES)]


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
        off = x["mask"] == 0
        assert not bool(got[0][..., off].any()) and not bool(got[1][..., off].any())


# (B, vec, d2, n_valid): the tail shapes above on 3 x 1000 buckets; path B's
# main shapes (40 dense; 32 with 20 live, and with holes); path A's; every
# padded width class of the tensor route; and d2 = 130 on the scalar route,
# dense and with holes.
SUBSPACE_SHAPES = [(3, 1000, d2, n_valid) for d2, n_valid in SHAPES] + [
    (48, 4096, 40, None), (48, 4096, 32, 20), (2, 4096, 20, None), (3, 1000, 8, 5),
    (3, 1000, 20, None), (3, 1000, 64, None), (3, 1000, 128, 100), (3, 999, 7, None),
    (48, 4096, 32, HOLES), (3, 1000, 130, (0, 5, 64, *range(100, 130)))]


@pytest.mark.gpu
@pytest.mark.parametrize("b,vec,d2,n_valid", SUBSPACE_SHAPES)
def test_subspace_apply_kernel_matches_plain(cuda, b, vec, d2, n_valid):
    """Each launch takes the route ``route(d2)`` names (``.tc_launches``);
    both routes hold the plain version's tolerances, two launches give the
    same bits, ``mask=None`` the bits of an all-ones mask."""
    x = inputs(1, b, vec, d2, n_valid, cuda)
    args = (x["m"], x["s"], x["y"], x["p"], x["rho"], x["mu"], x["th"])
    fn = svt_subspace.subspace_apply
    before = (fn.launches, fn.tc_launches)
    got = fn(*args, mask=x["mask"])
    again = fn(*args, mask=x["mask"])
    tensor = svt_subspace.route(d2) == "tensor"
    assert (fn.launches - before[0], fn.tc_launches - before[1]) == (2, 2 if tensor else 0)
    assert tensor == (d2 <= 128)
    want = ref.svt_subspace_apply_ref(*args, mask=x["mask"])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    for g, w in zip(got[3:], want[3:]):
        assert_sums_close(g, w)
    if x["mask"] is None:
        ones = fn(*args, mask=torch.ones(d2, device=cuda))
        assert all(torch.equal(a, b) for a, b in zip(got, ones))
    else:
        off = x["mask"] == 0
        assert not bool(got[1][..., off].any()) and not bool(got[2][..., off].any())


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


@pytest.mark.gpu
@pytest.mark.parametrize("b,vec,d2,r,n_valid", [(48, 4096, 10, 8, None), (3, 1000, 7, 3, 5)])
def test_subspace_apply_factored_kernel_matches_plain(cuda, b, vec, d2, r, n_valid):
    """The factored tail of one client shard against its plain version, two
    launches bit for bit, ``mask=None`` bit for bit an all-ones mask."""
    x = inputs(5, b, vec, d2, n_valid, cuda)
    gen = torch.Generator().manual_seed(6)
    f = torch.randn((b, vec, r), generator=gen).to(cuda)
    vr = (torch.randn((b, d2, r), generator=gen) / d2**0.5).to(cuda)
    args = (x["m"], x["y"], f, vr, x["rho"], x["mu"], x["th"])
    got = svt_subspace.subspace_apply_factored(*args, mask=x["mask"])
    again = svt_subspace.subspace_apply_factored(*args, mask=x["mask"])
    want = ref.svt_subspace_apply_factored_ref(*args, mask=x["mask"])
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    assert_sums_close(got[3], want[3])
    if x["mask"] is None:
        ones = svt_subspace.subspace_apply_factored(*args, mask=torch.ones(d2, device=cuda))
        assert all(torch.equal(a, c) for a, c in zip(got, ones))
    else:
        off = x["mask"] == 0
        assert not bool(got[1][..., off].any()) and not bool(got[2][..., off].any())


@pytest.mark.gpu
def test_sharded_aggregate_on_the_card_matches_unsharded(cuda):
    """``aggregate`` on a 4-shard mesh of the card against the unsharded
    card call, 10 clients padded to 12; the Ritz iterations launch the
    factored kernel once a shard."""
    from repro_torch.core import AggregatorConfig, aggregate
    from repro_torch.launch.mesh import make_host_mesh

    rng = np.random.default_rng(7)
    core = rng.normal(size=(2, 96, 2)) @ rng.normal(size=(2, 2, 10))
    spikes = np.where(rng.random(core.shape) < 0.05, 5.0 * rng.normal(size=core.shape), 0.0)
    tree = {"w": torch.from_numpy(np.moveaxis(core + spikes, -1, 0).reshape(10, 2, 12, 8)
                                  .astype(np.float32))}
    cfg = AggregatorConfig(method="fedrpca", rpca_iters=20, svt_mode="subspace")
    base = aggregate(tree, cfg)
    before = svt_subspace.subspace_apply_factored.launches
    got = aggregate(tree, cfg, mesh=make_host_mesh(4))
    assert (svt_subspace.subspace_apply_factored.launches - before) % 4 == 0
    assert svt_subspace.subspace_apply_factored.launches > before
    scale = float(tree["w"].abs().max())
    torch.testing.assert_close(got["w"], base["w"], atol=1e-4 * scale, rtol=0)


# --- Cross-round carries and the merging methods on the card ------------------
def carried_rounds(seed, nc=16, n_valid=12, rounds=3):
    """Correlated (1, 64, nc) buckets, a rank-2 core drifting by round,
    columns from ``n_valid`` on zero."""
    rng = np.random.default_rng(seed)
    u, w = rng.normal(size=(64, 2)), rng.normal(size=(2, nc))
    sp = np.where(rng.random((64, nc)) < 0.05, 5.0 * rng.normal(size=(64, nc)), 0.0)
    out = []
    for t in range(rounds):
        m = (u @ (w + 0.02 * t * rng.normal(size=w.shape)) + sp)[None].astype(np.float32)
        m[..., n_valid:] = 0.0
        out.append(torch.from_numpy(m))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("svt_mode,tol", [("subspace", None), ("gram", 1e-4)])
def test_warm_bucket_card_matches_cpu(cuda, svt_mode, tol):
    """Carried rounds on the card (kernel tails, iteration 0 of a warm
    subspace call a Ritz attempt through ``subspace_apply``) against the
    same rounds on the CPU: L and S within 1e-4 of max|M|, the same
    iterations, fallbacks and hits round by round."""
    mask = torch.tensor([1.0] * 12 + [0.0] * 4)
    kw = dict(n_iter=20 if tol is None else 60, tol=tol, svt_mode=svt_mode, true_cols=12,
              return_carry=True)
    gc = rpca.init_bucket_carry(1, 64, 16, 8, 12, device=cuda)
    cc = rpca.init_bucket_carry(1, 64, 16, 8, 12, device="cpu")
    for i, m in enumerate(carried_rounds(3)):
        before = (rpca_admm.admm_tail.launches, svt_subspace.subspace_apply.launches,
                  svt_subspace.subspace_apply.tc_launches)
        g, gc = rpca.robust_pca_bucket(m.to(cuda), client_mask=mask.to(cuda), carry=gc, **kw)
        c, cc = rpca.robust_pca_bucket(m, client_mask=mask, carry=cc, **kw)
        after = (rpca_admm.admm_tail.launches, svt_subspace.subspace_apply.launches,
                 svt_subspace.subspace_apply.tc_launches)
        iters = int(g.n_iter.max())
        want = (iters, 0, 0) if svt_mode == "gram" else (0, iters, iters)
        assert tuple(a - b for a, b in zip(after, before)) == want
        scale = float(m.abs().max())
        for x, y in ((g.low_rank, c.low_rank), (g.sparse, c.sparse)):
            torch.testing.assert_close(x.cpu(), y, atol=1e-4 * scale, rtol=0)
        assert torch.equal(g.n_iter.cpu(), c.n_iter)
        assert int(gc.fall_count) == int(cc.fall_count) == g.n_fallback
        assert float(gc.hit) == float(cc.hit) == (0.0 if i == 0 else 1.0)
        assert gc.v.device.type == "cuda" and gc.l.device.type == "cuda"
        assert not g.low_rank[..., 12:].any() and not gc.y[..., 12:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
def test_invalid_carry_on_the_card_is_bitwise_cold(cuda, svt_mode):
    m = carried_rounds(4, rounds=1)[0].to(cuda)
    kw = dict(n_iter=20, svt_mode=svt_mode)
    with_c, new = rpca.robust_pca_bucket(m, carry=rpca.init_bucket_carry(1, 64, 16, 8, device=cuda),
                                         return_carry=True, **kw)
    without = rpca.robust_pca_bucket(m, **kw)
    assert torch.equal(with_c.low_rank, without.low_rank)
    assert torch.equal(with_c.sparse, without.sparse)
    assert float(new.hit) == 0.0


@pytest.mark.gpu
def test_sharded_session_on_the_card_matches_cpu(cuda):
    """A warm session on a 2-shard mesh of the card against the unsharded
    card session and a CPU mesh session: equal fallbacks round by round."""
    from repro_torch.core import AggregatorConfig, AggSession
    from repro_torch.launch.mesh import make_host_mesh

    cfg = AggregatorConfig(method="fedrpca", rpca_iters=20, svt_mode="subspace",
                           carry_mode="subspace")
    runs = {"mesh": AggSession(cfg, mesh=make_host_mesh(2)), "card": AggSession(cfg),
            "cpu": AggSession(cfg, mesh=make_host_mesh(2, "cpu"), device="cpu")}
    for m in carried_rounds(5, nc=10, n_valid=10):
        tree = {"w": m[0].T.reshape(10, 8, 8).contiguous()}
        outs = {k: s.step(tree) for k, s in runs.items()}
        falls = {k: int(d.scalars["fallback_count"]) for k, (_, d) in outs.items()}
        assert len(set(falls.values())) == 1, falls
        scale = float(tree["w"].abs().max())
        for k in ("card", "cpu"):
            torch.testing.assert_close(outs["mesh"][0]["w"].cpu(), outs[k][0]["w"].cpu(),
                                       atol=1e-4 * scale, rtol=0)
    assert float(outs["mesh"][1].scalars["carry_hit_rate"]) == 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["ties", "fedexp", "dare"])
def test_merging_methods_card_match_cpu(cuda, method):
    """The card and the CPU draw dare's keep masks from the same CPU
    generator, so every method agrees within fp32 reduction order."""
    from repro_torch.core import AggregatorConfig, aggregate

    gen = torch.Generator().manual_seed(6)
    tree = {"A": torch.randn((6, 2, 8, 3), generator=gen), "w": torch.randn((6, 40), generator=gen)}
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0])
    cfg = AggregatorConfig(method=method, dare_drop=0.5)
    for engine in ("packed", "reference"):
        got = aggregate(tree, cfg, engine=engine, key=9, mask=mask)
        want = aggregate(tree, cfg, engine=engine, key=9, mask=mask, device="cpu")
        for k in tree:
            assert got[k].device.type == "cuda"
            torch.testing.assert_close(got[k].cpu(), want[k], atol=1e-6 * 4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
def test_aggregate_on_a_side_stream_matches_the_main_stream(cuda, svt_mode):
    """The round pipeline runs each aggregation on a worker thread with its
    own stream current: a masked fedrpca ``aggregate`` issued so gives the
    bits of the same call on the main stream."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core import AggregatorConfig, aggregate

    gen = torch.Generator().manual_seed(8)
    tree = {"A": torch.randn((32, 3, 64, 4), generator=gen).to(cuda),
            "B": torch.randn((32, 3, 4, 64), generator=gen).to(cuda)}
    mask = client_mask(32, HOLES).to(cuda)
    cfg = AggregatorConfig(method="fedrpca", rpca_iters=12, svt_mode=svt_mode)
    main = aggregate(tree, cfg, mask=mask)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=cuda)
    fn = rpca_admm.admm_tail if svt_mode == "gram" else svt_subspace.subspace_apply
    before = fn.launches

    def work():
        with torch.cuda.stream(side):
            out = aggregate(tree, cfg, mask=mask)
        side.synchronize()
        return out

    with ThreadPoolExecutor(max_workers=1) as ex:
        got = ex.submit(work).result()
    assert fn.launches - before == 12
    for k in tree:
        assert torch.equal(got[k], main[k])


# --- Serving kernels -----------------------------------------------------------
# float32: K products summed in two orders (FMA kernel vs cuBLAS), error
# ~sqrt(K) ulps of the largest output.  bfloat16: each rounds fp32 sums to
# bf16, twice (x @ A, then the output): two bf16 ulps of the largest output.
def lora_tol(dtype, k, want):
    scale = float(want.double().abs().max())
    return (1e-6 * k**0.5 if dtype == torch.float32 else 2.0**-6) * scale


def lora_case(cuda, m, k, n, r, dtype, n_slots=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g).to(cuda, dtype)
    w = ((torch.rand((k, n), generator=g) * 2 - 1) / k**0.5).to(cuda, dtype)
    a_pool = (torch.randn((n_slots, 2, k, r), generator=g) / k**0.5).to(cuda)
    b_pool = torch.randn((n_slots, 2, r, n), generator=g).to(cuda)
    return x, w, a_pool[:, 1], b_pool[:, 1]  # a layer's slice: strided slots


# The serving path's shapes (StableLM q / v, Mamba-2's in_proj and out_proj,
# and the q / v projections (K -> N) of Gemma-7B 3072 -> 4096, Qwen1.5-32B
# and Llama-4-Maverick 5120 -> 5120 and 5120 -> 1024, DeepSeek-67B 8192 ->
# 8192 and 8192 -> 1024, Granite-MoE 1024 -> 1024 and 1024 -> 512, each at
# prefill and decode; Whisper-medium's q and v on the decoder's 8 x 416 rows
# and its cross v on the encoder's 8 x 1500, Qwen2-VL-2B's q 1536 -> 1536 and
# v 1536 -> 256, each also at decode) take the tensor route in bf16, K split
# at decode; float32 and the ragged (129, 513, 130) take the scalar route.
LM_QV = [(3072, 4096), (5120, 5120), (5120, 1024), (8192, 8192), (8192, 1024), (1024, 1024),
         (1024, 512)]
NO_QV = [(3328, 1024, 1024), (12000, 1024, 1024), (4096, 1536, 1536), (4096, 1536, 256)]
LORA_SHAPES = [(4096, 2048, 2048, 8), (8, 2048, 2048, 8), (4096, 768, 3352, 8),
               (8, 768, 3352, 8), (4096, 1536, 768, 8), (8, 1536, 768, 8),
               (129, 513, 130, 8), (5, 64, 40, 33),
               *((m, k, n, 8) for k, n in LM_QV for m in (4096, 8)),
               *((m_, k, n, 8) for m, k, n in NO_QV for m_ in (m, 8))]


def route_counts(fn):
    """Launches on the tensor route and on the scalar route."""
    return fn.tc_launches, fn.launches - fn.tc_launches


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,r", LORA_SHAPES)
def test_lora_kernels_match_plain(cuda, dtype, m, k, n, r):
    from repro_torch.kernels import lora_matmul as lm

    tensor = dtype == torch.bfloat16 and (k, n) != (513, 130)
    assert lm.route(k, n, dtype) == ("tensor" if tensor else "scalar")
    if tensor:  # the serving shapes split K at decode (M = 8) only
        assert (lm.k_splits(m, n, k, "tensor") > 1) == (m == 8)
    x, w, a, b = lora_case(cuda, m, k, n, r, dtype)
    before = [route_counts(fn) for fn in (lm.lora_matmul, lm.gathered_lora_matmul)]
    got = lm.lora_matmul(x, w, a[2], b[2], 2.0)
    assert torch.equal(got, lm.lora_matmul(x, w, a[2], b[2], 2.0))
    want = ref.lora_matmul_ref(x, w, a[2], b[2], 2.0)
    torch.testing.assert_close(got, want, atol=lora_tol(dtype, k, want), rtol=0)
    rows = (torch.arange(m) * 8 // m).to(torch.int32)
    slots = torch.tensor([1, 3, -1, 6, 1, 3, -1, 6], dtype=torch.int32)[rows].to(cuda)
    got = lm.gathered_lora_matmul(x, w, a, b, slots, 2.0)
    assert torch.equal(got, lm.gathered_lora_matmul(x, w, a, b, slots, 2.0))
    want = ref.gathered_lora_matmul_ref(x, w, a, b, slots, 2.0)
    torch.testing.assert_close(got, want, atol=lora_tol(dtype, k, want), rtol=0)
    a_z, b_z = a.clone(), b.clone()
    a_z[7], b_z[7] = 0.0, 0.0
    zero = lm.gathered_lora_matmul(x, w, a_z, b_z, torch.where(slots < 0, 7, slots), 2.0)
    assert torch.equal(got, zero)
    # One slot on every row: the bits of the single-adapter kernel.
    one = lm.gathered_lora_matmul(x, w, a, b, torch.full_like(slots, 2), 2.0)
    assert torch.equal(one, lm.lora_matmul(x, w, a[2], b[2], 2.0))
    after = [route_counts(fn) for fn in (lm.lora_matmul, lm.gathered_lora_matmul)]
    for (tc0, sc0), (tc1, sc1), n_calls in zip(before, after, (3, 4)):
        assert (tc1 - tc0, sc1 - sc0) == ((n_calls, 0) if tensor else (0, n_calls))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,d,window,causal", [
    (256, 512, 64, 0, True), (256, 300, 64, 0, True), (256, 512, 64, 128, True),
    (7, 45, 32, 0, True), (3, 70, 32, 9, True), (64, 300, 32, 128, True),
    (256, 512, 64, 0, False),
    # RecurrentGemma's prefill (80 head rows = 8 requests x 10 heads, window
    # 2048 past S = 2560), a ragged S, non-causal; and D = 128.
    (80, 2560, 256, 2048, True), (10, 700, 256, 300, True), (16, 333, 256, 0, True),
    (16, 300, 256, 0, False), (64, 512, 128, 0, True), (8, 300, 128, 100, True),
    (8, 300, 128, 0, False),
    # Whisper-medium's encoder (8 requests x 16 heads over 1500 frames,
    # bidirectional, no multiple of the tiles) and decoder prefill (416);
    # Qwen2-VL-2B's prefill (8 x 12 heads, D 128).
    (128, 1500, 64, 0, False), (128, 416, 64, 0, True), (96, 512, 128, 0, True),
    # The bf16 route's edges: one row, a query and a key tile one short of
    # and one past 128; D = 32's 64-byte swizzle at the encoder's shape; a
    # window of one key and one that is no multiple of the 64- and 128-key
    # tiles at D = 128 and 256.
    (4, 1, 64, 0, True), (4, 127, 64, 0, True), (4, 129, 64, 0, True),
    (128, 1500, 32, 0, False), (8, 300, 128, 1, True), (8, 300, 256, 1, True),
    (8, 300, 256, 100, True)])
def test_local_attention_kernel_matches_plain(cuda, dtype, bh, s, d, window, causal):
    """bf16 on the tensor route, float32 on the scalar one; causal and not;
    head widths 32 to 256."""
    from repro_torch.kernels import local_attention as la

    g = torch.Generator().manual_seed(s + window)
    q, k, v = (torch.randn((bh, s, d), generator=g).to(cuda, dtype) for _ in range(3))
    before = route_counts(la.local_attention)
    got = la.local_attention(q, k, v, window=window, causal=causal)
    assert torch.equal(got, la.local_attention(q, k, v, window=window, causal=causal))
    after = route_counts(la.local_attention)
    assert (after[0] - before[0], after[1] - before[1]) == (
        (2, 0) if dtype == torch.bfloat16 else (0, 2))
    want = ref.local_attention_ref(q, k, v, window=window, causal=causal)
    if dtype == torch.float32:
        # Online vs materialized softmax.
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        return
    # bf16: one ulp of the largest output, and entry by entry: the kernel's
    # rounding of p to bf16 moves an output by at most 2^-8 sum_j p_j |v_j| / l
    # (the plain version on |v|), the fp32 sums by 2^-12 of that, and each
    # result rounds to bf16 (2^-8 of itself).  The plain version with each
    # window cut or grown by one 32-key tile must fail the entry bound.
    mass = ref.local_attention_ref(q.float(), k.float(), v.float().abs(), window=window,
                                   causal=causal)

    def within(x):
        x, w = x.float(), want.float()
        bound = (2.0**-8 + 2.0**-12) * mass + 2.0**-8 * (x.abs() + w.abs())
        return bool(((x - w).abs() <= bound).all())

    torch.testing.assert_close(got, want, atol=2.0**-7 * float(want.float().abs().max()), rtol=0)
    assert within(got)
    if window > 32:
        for w in (window - 32, window + 32):
            assert not within(ref.local_attention_ref(q, k, v, window=w, causal=causal))


@pytest.mark.gpu
def test_reduced_serving_card_matches_cpu(cuda):
    """Reduced StableLM in float32 through the pool on the card (all three
    kernels) against the same weights and adapters on the CPU."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import local_attention as la
    from repro_torch.launch import serve
    from repro_torch.models import init_lora_params, init_params
    from repro_torch.serve import AdapterPool
    from repro_torch.utils.pytree import tree_to

    cfg = get_config("stablelm-1.6b").reduced()
    base = init_params(cfg, seed=0, device=cuda)
    cpu_base = copy.deepcopy(base).cpu()
    pool = AdapterPool(init_lora_params(cfg, seed=1, device=cuda), 4)
    cpu_pool = AdapterPool(tree_to(init_lora_params(cfg, seed=1, device=cuda), "cpu"), 4)
    for i in range(3):
        tree = init_lora_params(cfg, seed=2 + i, device=cuda)
        for node in tree["groups"][0]["mixer"].values():
            node["B"].normal_(0.0, 0.3, generator=torch.Generator(device=cuda).manual_seed(i))
        pool.publish(f"t{i}", tree)
        cpu_pool.publish(f"t{i}", tree_to(tree, "cpu"))
    toks = torch.randint(0, cfg.vocab_size, (4, 40), generator=torch.Generator().manual_seed(0))
    pre, _ = serve.make_serving_fns(cfg)
    before = (lm.gathered_lora_matmul.launches, la.local_attention.launches)
    got, _ = pre(base, pool.pooled, pool.acquire(["t0", "t1", "t2", "t0"]),
                 {"tokens": toks.to(cuda)})
    assert (lm.gathered_lora_matmul.launches - before[0],
            la.local_attention.launches - before[1]) == (2 * cfg.n_layers, cfg.n_layers)
    want, _ = pre(cpu_base, cpu_pool.pooled, cpu_pool.acquire(["t0", "t1", "t2", "t0"]),
                  {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, atol=1e-4 * float(want.abs().max()), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-2b"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_reduced_frontend_serving_card_matches_cpu(cuda, arch, kv_quant):
    """Reduced Whisper (encoder, cross-attention over stub frames) and
    Qwen2-VL (M-RoPE, vision stub) in float32 through the pool on the card
    against the CPU on the same weights, adapters and stubs: prefill logits,
    then 3 decode steps of the CPU's greedy tokens (with ``kv_quant`` both
    decode from the CPU's int8 cache bits, the card's own prefill caches at
    most one step off in at most 1e-3 of the values); logits within 1e-4 of
    the largest.  Launches: the gathered kernel at every adapted projection
    (Whisper: self and cross q and v at prefill, cross v on the frames' rows;
    self q, v and cross q at decode), attention at every encoder and decoder
    layer at prefill."""
    import copy

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import local_attention as la
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.launch import serve
    from repro_torch.models import init_lora_params, init_params
    from repro_torch.models.kvcache import QuantKVCache
    from repro_torch.serve import AdapterPool
    from repro_torch.utils.pytree import tree_map, tree_to

    cfg = get_config(arch).reduced().replace(kv_quant=kv_quant)
    base = init_params(cfg, seed=0, device=cuda)
    cpu_base = copy.deepcopy(base).cpu()
    pool = AdapterPool(init_lora_params(cfg, seed=1, device=cuda), 4)
    cpu_pool = AdapterPool(tree_to(init_lora_params(cfg, seed=1, device=cuda), "cpu"), 4)
    for i in range(3):
        tree = init_lora_params(cfg, seed=2 + i, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(i)
        for sub in tree["groups"][0].values():
            for node in sub.values():
                node["B"].normal_(0.0, 0.3, generator=g)
        pool.publish(f"t{i}", tree)
        cpu_pool.publish(f"t{i}", tree_to(tree, "cpu"))
    toks = torch.randint(0, cfg.vocab_size, (4, 40), generator=torch.Generator().manual_seed(0))
    batch = serve._make_batch(cfg, toks, np.random.default_rng(0))
    pre, dec = serve.make_serving_fns(cfg)
    ids = ["t0", "t1", "t2", "t0"]
    n_l, n_enc = cfg.n_layers, cfg.n_encoder_layers
    before = (lm.gathered_lora_matmul.launches, la.local_attention.launches)
    got, caches = pre(base, pool.pooled, pool.acquire(ids),
                      {k: v.to(cuda) for k, v in batch.items()})
    assert (lm.gathered_lora_matmul.launches - before[0], la.local_attention.launches - before[1]
            ) == ((4 if cfg.encoder_decoder else 2) * n_l, n_l + n_enc)
    want, cpu_caches = pre(cpu_base, cpu_pool.pooled, cpu_pool.acquire(ids), batch)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4 * float(want.abs().max()), rtol=0)
    caches = serve.extend_caches(caches, 4, cfg)
    cpu_caches = serve.extend_caches(cpu_caches, 4, cfg)
    if kv_quant:
        for c, w in zip(caches["groups"], cpu_caches["groups"]):
            assert isinstance(c["self"], QuantKVCache)
            for x, y in zip(c["self"][:2], w["self"][:2]):
                diff = (x.cpu().int() - y.int()).abs()
                assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
        caches = tree_map(lambda t: t.to(cuda), cpu_caches)
    tok = torch.argmax(want[:, -1:], -1)
    slots, cpu_slots = pool.acquire(ids), cpu_pool.acquire(ids)
    for i in range(3):
        before = lm.gathered_lora_matmul.launches
        got, caches = dec(base, pool.pooled, slots, tok.to(cuda), caches, 40 + i)
        assert lm.gathered_lora_matmul.launches - before == (3 if cfg.encoder_decoder else 2) * n_l
        want, cpu_caches = dec(cpu_base, cpu_pool.pooled, cpu_slots, tok, cpu_caches, 40 + i)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4 * float(want.abs().max()), rtol=0)
        tok = torch.argmax(want[:, -1:], -1)


@pytest.mark.gpu
def test_quantize_kv_on_the_card_is_the_cpu_bits(cuda):
    """``quantize_kv`` on the card gives the CPU's int8 values and float16
    scales bit for bit on the same float32 and bf16 inputs."""
    from repro_torch.models.kvcache import dequantize_kv, quantize_kv

    x = torch.randn((8, 300, 2, 128), generator=torch.Generator().manual_seed(5)) * 4
    for t in (x, x.to(torch.bfloat16)):
        q, sc = quantize_kv(t.to(cuda))
        wq, wsc = quantize_kv(t)
        assert torch.equal(q.cpu(), wq) and torch.equal(sc.cpu(), wsc)
        assert torch.equal(dequantize_kv(q, sc, torch.bfloat16).cpu(),
                           dequantize_kv(wq, wsc, torch.bfloat16))


# ssd_scan: the kernel sums each 64-position tile where the plain version
# steps position by position; held to 1e-4 of the largest output or state
# entry (fp32 sums of up to S * N products, exp of cumulative decays).
# (batch, heads per group, S, P, N, decay): path D's prefill and smaller
# cases; S across the tile edges; P across the 32-column blocks (40: a
# ragged second block); N below the state's 16-row tiles (100) and at the
# widest (128); one and 24 heads a group; odd P and N (4-byte copies).
SSD_SHAPES = [
    (8, 24, 512, 64, 128, 1.0), (8, 24, 300, 64, 128, 1e-3), (2, 3, 70, 40, 100, 1e-3),
    (2, 4, 33, 16, 32, 0.5), (1, 2, 0, 16, 32, 0.5),
    (2, 3, 1, 64, 128, 0.5), (2, 3, 63, 64, 128, 0.5), (2, 3, 64, 64, 128, 0.5),
    (2, 3, 65, 64, 128, 0.5), (2, 3, 512, 64, 128, 0.5), (2, 3, 130, 16, 128, 0.5),
    (2, 3, 130, 40, 128, 0.5), (2, 3, 130, 64, 32, 0.5), (2, 3, 130, 64, 100, 0.5),
    (4, 1, 200, 64, 128, 0.5), (2, 24, 200, 64, 128, 0.5), (1, 2, 70, 7, 33, 0.5)]


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,heads,s,p,n,decay", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda, bsz, heads, s, p, n, decay):
    """One launch a call (none for an empty scan), two launches bit for bit."""
    from repro_torch.kernels import ssd_scan

    g = torch.Generator().manual_seed(s + p + n)
    x = torch.randn((bsz * heads, s, p), generator=g).to(cuda)
    da = (-decay * torch.rand((bsz * heads, s), generator=g)).to(cuda)
    b, c = (torch.randn((bsz, s, n), generator=g).to(cuda) for _ in range(2))
    before = ssd_scan.ssd_scan.launches
    got = ssd_scan.ssd_scan(x, da, b, c, return_state=True)
    again = ssd_scan.ssd_scan(x, da, b, c, return_state=True)
    assert ssd_scan.ssd_scan.launches - before == (2 if s else 0)
    want = ref.ssd_scan_ref(x, da, b, c, return_state=True)
    for u, v, w in zip(got, again, want):
        assert torch.equal(u, v)
        tol = 1e-4 * float(w.abs().max()) if w.numel() else 0.0
        torch.testing.assert_close(u, w, rtol=0, atol=tol)


# ssd_scan from a given state h0 (the model's h_init): path D's prefill
# shape, the ragged S = 300, ragged P and N, and an empty scan (the state
# comes back as h0); the same 1e-4 bound.
SSD_H0_SHAPES = [(8, 24, 512, 64, 128, 1.0), (8, 24, 300, 64, 128, 1e-3),
                 (2, 3, 70, 40, 100, 0.5), (1, 2, 70, 7, 33, 0.5), (1, 2, 0, 16, 32, 0.5)]


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,heads,s,p,n,decay", SSD_H0_SHAPES)
def test_ssd_scan_kernel_h0_matches_plain(cuda, bsz, heads, s, p, n, decay):
    """y and the final state from h0 against the plain scan from h0, two
    launches bit for bit; h0 = 0 gives the bits of no h0."""
    from repro_torch.kernels import ssd_scan

    g = torch.Generator().manual_seed(7 + s + p + n)
    x = torch.randn((bsz * heads, s, p), generator=g).to(cuda)
    da = (-decay * torch.rand((bsz * heads, s), generator=g)).to(cuda)
    b, c = (torch.randn((bsz, s, n), generator=g).to(cuda) for _ in range(2))
    h0 = torch.randn((bsz * heads, n, p), generator=g).to(cuda)
    got = ssd_scan.ssd_scan(x, da, b, c, return_state=True, h0=h0)
    again = ssd_scan.ssd_scan(x, da, b, c, return_state=True, h0=h0)
    want = ref.ssd_scan_ref(x, da, b, c, h0=h0, return_state=True)
    for u, v, w in zip(got, again, want):
        assert torch.equal(u, v)
        tol = 1e-4 * float(w.abs().max()) if w.numel() else 0.0
        torch.testing.assert_close(u, w, rtol=0, atol=tol)
    zero = ssd_scan.ssd_scan(x, da, b, c, return_state=True, h0=torch.zeros_like(h0))
    for u, v in zip(zero, ssd_scan.ssd_scan(x, da, b, c, return_state=True)):
        assert torch.equal(u, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(196608, 40), (129, 130), (1, 7)])
def test_soft_threshold_kernel_matches_plain(cuda, dtype, m, n):
    """Equal bits: both round the same fp32 difference once."""
    from repro_torch.kernels import soft_threshold as st

    x = torch.randn((m, n), generator=torch.Generator().manual_seed(m)).to(cuda, dtype)
    for t in (0.05, torch.tensor(0.7, device=cuda), -0.1):
        got = st.soft_threshold(x, t)
        assert torch.equal(got, st.soft_threshold(x, t))
        assert torch.equal(got, ref.soft_threshold_ref(x, torch.as_tensor(t, dtype=dtype).to(cuda)))


@pytest.mark.gpu
def test_reduced_mamba_serving_card_matches_cpu(cuda):
    """Reduced Mamba-2 in float32 through the pool on the card (gathered LoRA
    and ssd_scan) against the same weights and adapters on the CPU, prefill
    and one decode step."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models import init_lora_params, init_params
    from repro_torch.serve import AdapterPool
    from repro_torch.utils.pytree import tree_to

    cfg = get_config("mamba2-130m").reduced()
    base = init_params(cfg, seed=0, device=cuda)
    cpu_base = copy.deepcopy(base).cpu()
    pool = AdapterPool(init_lora_params(cfg, seed=1, device=cuda), 4)
    cpu_pool = AdapterPool(tree_to(init_lora_params(cfg, seed=1, device=cuda), "cpu"), 4)
    for i in range(3):
        tree = init_lora_params(cfg, seed=2 + i, device=cuda)
        for node in tree["groups"][0]["mixer"].values():
            node["B"].normal_(0.0, 0.3, generator=torch.Generator(device=cuda).manual_seed(i))
        pool.publish(f"t{i}", tree)
        cpu_pool.publish(f"t{i}", tree_to(tree, "cpu"))
    toks = torch.randint(0, cfg.vocab_size, (4, 70), generator=torch.Generator().manual_seed(0))
    pre, dec = serve.make_serving_fns(cfg)
    ids = ["t0", "t1", "t2", "t0"]
    before = (lm.gathered_lora_matmul.launches, ssd_scan.ssd_scan.launches)
    got, caches = pre(base, pool.pooled, pool.acquire(ids), {"tokens": toks[:, :-1].to(cuda)})
    assert (lm.gathered_lora_matmul.launches - before[0],
            ssd_scan.ssd_scan.launches - before[1]) == (2 * cfg.n_layers, cfg.n_layers)
    want, cpu_caches = pre(cpu_base, cpu_pool.pooled, cpu_pool.acquire(ids),
                           {"tokens": toks[:, :-1]})
    torch.testing.assert_close(got.cpu(), want, atol=1e-4 * float(want.abs().max()), rtol=0)
    got, _ = dec(base, pool.pooled, pool.acquire(ids), toks[:, -1:].to(cuda), caches, 69)
    want, _ = dec(cpu_base, cpu_pool.pooled, cpu_pool.acquire(ids), toks[:, -1:], cpu_caches, 69)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4 * float(want.abs().max()), rtol=0)


@pytest.mark.gpu
def test_full_width_rglru_block_card_matches_cpu(cuda):
    """One RecurrentGemma-2B RG-LRU block at full width (d_model and
    lru_width 2560, GeGLU d_ff 7680) in float32 with a 2-D adapter on proj_x
    and out_proj: a 300-token prefill (output, h and the conv window), then
    3 decode steps written into the state in place, on the card
    (``lora_matmul`` on the scalar route) against the same block on the
    CPU; 1e-4 of the largest value (fp32 sums of 2560 and 7680 products and
    the doubling scan, in other orders)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.models import blocks, layers, rglru

    cfg = get_config("recurrentgemma-2b").replace(dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(0)
    blk = blocks.Block(cfg, "rglru", gen, dtype=torch.float32, device=cuda)
    cpu_blk = copy.deepcopy(blk).cpu()
    lora = {"mixer": {t: layers.init_lora(gen, d_in, d_out, 8, dtype=torch.float32, device=cuda)
                      for t, (d_in, d_out) in rglru.lora_dims(cfg).items()}}
    for node in lora["mixer"].values():
        node["B"].normal_(0.0, 0.05, generator=gen)
    cpu_lora = {"mixer": {t: {k: v.cpu() for k, v in node.items()}
                          for t, node in lora["mixer"].items()}}
    x = torch.randn((2, 303, cfg.d_model), generator=torch.Generator().manual_seed(1))
    pos = torch.zeros((2, 300), dtype=torch.int64)

    def near(got, want):
        torch.testing.assert_close(got.cpu(), want, atol=1e-4 * float(want.abs().max()), rtol=0)

    before = lm.lora_matmul.launches
    out, cache, _ = blk(x[:, :300].to(cuda), lora, cfg, positions=pos.to(cuda), mode="prefill")
    assert lm.lora_matmul.launches - before == 2
    want, cpu_cache, _ = cpu_blk(x[:, :300], cpu_lora, cfg, positions=pos, mode="prefill")
    near(out, want)
    near(cache["self"].h, cpu_cache["self"].h)
    near(cache["self"].conv, cpu_cache["self"].conv)
    for i in range(300, 303):
        out, new, _ = blk(x[:, i:i + 1].to(cuda), lora, cfg, positions=pos[:, :1].to(cuda),
                          mode="decode", cache=cache, cache_index=i)
        want, cpu_cache, _ = cpu_blk(x[:, i:i + 1], cpu_lora, cfg, positions=pos[:, :1],
                                     mode="decode", cache=cpu_cache, cache_index=i)
        assert new["self"] is cache["self"]
        near(out, want)
        near(cache["self"].h, cpu_cache["self"].h)


# --- Training: the kernels' autograd Functions --------------------------------
# The forward of each Function is the kernel (one launch, the bits of the
# no-grad call); the backward is plain PyTorch.  Gradients are held to the
# plain version's autograd on the card: LoRA dx within two bf16 ulps of its
# largest entry in bf16 (g W^T rounded to bf16 first) and 1e-5 of it in
# float32, dA and dB within 1e-4 of their largest entry (fp32 sums over the
# rows in other orders); attention within 1e-5 of the largest gradient in
# float32 and one bf16 ulp in bf16 (the same plain operations, recomputed);
# the SSD's chunked recompute against the sequential scan's autograd within
# 1e-4 of the largest gradient entry.


def _card_grads(fn, ins, g):
    live = [t.clone().requires_grad_() for t in ins]
    out = fn(*live)
    return out.detach(), torch.autograd.grad(out, live, g)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gathered", [False, True])
def test_lora_function_grads_on_the_card(cuda, dtype, gathered):
    from repro_torch.kernels import lora_matmul as lm

    m, k, n, r = 512, 2048, 2048, 8
    x, w, a, b = lora_case(cuda, m, k, n, r, dtype)
    gen = torch.Generator().manual_seed(9)
    g = torch.randn((m, n), generator=gen).to(cuda, dtype)
    slots = (torch.arange(m) * 8 // m).to(torch.int32).to(cuda)
    if gathered:
        fn = lambda x_, a_, b_: lm.gathered_lora_matmul(x_, w, a_, b_, slots, 2.0)
        plain = lambda x_, a_, b_: ref.gathered_lora_matmul_ref(x_, w, a_, b_, slots, 2.0)
        ins, counter = (x, a, b), lm.gathered_lora_matmul
    else:
        fn = lambda x_, a_, b_: lm.lora_matmul(x_, w, a_, b_, 2.0)
        plain = lambda x_, a_, b_: ref.lora_matmul_ref(x_, w, a_, b_, 2.0)
        ins, counter = (x, a[2], b[2]), lm.lora_matmul
    before = counter.launches
    out, got = _card_grads(fn, ins, g)
    assert counter.launches - before == 1
    assert torch.equal(out, fn(*ins))
    _, want = _card_grads(plain, ins, g)
    scale = float(want[0].float().abs().max())
    tol = 2 * 2.0**-7 * scale if dtype == torch.bfloat16 else 1e-5 * scale
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=0)
    for gg, ww in zip(got[1:], want[1:]):
        torch.testing.assert_close(gg, ww, atol=1e-4 * float(ww.abs().max()), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2])
def test_attention_function_grads_on_the_card(cuda, dtype, group):
    from repro_torch.kernels import local_attention as la
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(10 + group)
    q = torch.randn((4, 256, 8, 64), generator=gen).to(cuda, dtype)
    k, v = (torch.randn((4, 256, 8 // group, 64), generator=gen).to(cuda, dtype)
            for _ in range(2))
    g = torch.randn((4, 256, 8, 64), generator=gen).to(cuda, dtype)

    def plain(q_, k_, v_):
        bsz, s, h, d = q_.shape
        fold = lambda t: t.transpose(1, 2).reshape(bsz * h, s, d)
        kk, vv = (t.repeat_interleave(group, dim=2) for t in (k_, v_))
        out = ref.local_attention_ref(fold(q_), fold(kk), fold(vv), window=0)
        return out.reshape(bsz, h, s, d).transpose(1, 2)

    before = la.local_attention.launches
    out, got = _card_grads(lambda *t: ops.local_attention(*t), (q, k, v), g)
    assert la.local_attention.launches - before == 1
    assert torch.equal(out, ops.local_attention(q, k, v))
    _, want = _card_grads(plain, (q, k, v), g)
    for gg, ww in zip(got, want):
        scale = float(ww.float().abs().max())
        tol = 2.0**-7 * scale if dtype == torch.bfloat16 else 1e-5 * scale
        torch.testing.assert_close(gg.float(), ww.float(), atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,groups,s,chunk", [(48, 2, 256, 256), (24, 1, 300, 64)])
def test_ssd_function_grads_on_the_card(cuda, bh, groups, s, chunk):
    from repro_torch.kernels import ops, ssd_scan

    gen = torch.Generator().manual_seed(s)
    x = torch.randn((bh, s, 64), generator=gen).to(cuda)
    da = (-0.5 * torch.rand((bh, s), generator=gen)).to(cuda)
    b, c = (torch.randn((groups, s, 128), generator=gen).to(cuda) for _ in range(2))
    gy = torch.randn((bh, s, 64), generator=gen).to(cuda)
    before = ssd_scan.ssd_scan.launches
    out, got = _card_grads(lambda *t: ops.ssd_scan(*t, chunk=chunk), (x, da, b, c), gy)
    assert ssd_scan.ssd_scan.launches - before == 1
    assert torch.equal(out, ops.ssd_scan(x, da, b, c, chunk=chunk))
    _, want = _card_grads(lambda *t: ref.ssd_scan_ref(*t), (x, da, b, c), gy)
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg, ww, atol=1e-4 * float(ww.abs().max()), rtol=0)


@pytest.mark.gpu
def test_ssd_function_h0_grads_on_the_card(cuda):
    """The Function from a state h0: one launch, the no-grad bits, and the
    gradients of x, da, b, c and h0 against the plain scan's autograd."""
    from repro_torch.kernels import ops, ssd_scan

    gen = torch.Generator().manual_seed(11)
    bh, groups, s = 24, 2, 200
    x = torch.randn((bh, s, 64), generator=gen).to(cuda)
    da = (-0.5 * torch.rand((bh, s), generator=gen)).to(cuda)
    b, c = (torch.randn((groups, s, 128), generator=gen).to(cuda) for _ in range(2))
    h0 = torch.randn((bh, 128, 64), generator=gen).to(cuda)
    gy = torch.randn((bh, s, 64), generator=gen).to(cuda)
    before = ssd_scan.ssd_scan.launches
    fn = lambda x_, da_, b_, c_, h_: ops.ssd_scan(x_, da_, b_, c_, chunk=64, h0=h_)
    out, got = _card_grads(fn, (x, da, b, c, h0), gy)
    assert ssd_scan.ssd_scan.launches - before == 1
    assert torch.equal(out, fn(x, da, b, c, h0))
    _, want = _card_grads(lambda x_, da_, b_, c_, h_: ref.ssd_scan_ref(x_, da_, b_, c_, h0=h_),
                          (x, da, b, c, h0), gy)
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg, ww, atol=1e-4 * float(ww.abs().max()), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-130m"])
def test_reduced_local_step_card_matches_cpu(cuda, arch):
    """One local phase (Adam, 2 steps, 4 clients) of the reduced model in
    float32 on the card against the CPU from the same weights: the
    kernels forward, plain backward; per-client deltas within 1e-4 of each
    leaf's norm (Adam's near-eps elements)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels import local_attention as la
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch import steps
    from repro_torch.models import init_lora_params, init_params
    from repro_torch.utils.pytree import tree_leaves, tree_to

    cfg = get_config(arch).reduced()
    model = init_params(cfg, seed=0, device=cuda)
    cpu_model = copy.deepcopy(model).cpu()
    lora = init_lora_params(cfg, seed=1, device=cuda)
    for node in lora["groups"][0]["mixer"].values():
        node["B"].normal_(0.0, 0.1, generator=torch.Generator(device=cuda).manual_seed(2))
    toks = torch.randint(0, cfg.vocab_size, (4, 2, 33), generator=torch.Generator().manual_seed(3))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    step = steps.make_local_step(cfg, local_lr=1e-2, local_steps=2, local_optimizer="adam",
                                 remat=False)
    before = (lm.gathered_lora_matmul.launches, la.local_attention.launches,
              ssd_scan.ssd_scan.launches)
    got, loss, _ = step(model, lora, tree_to(batch, cuda))
    launched = (lm.gathered_lora_matmul.launches - before[0],
                la.local_attention.launches - before[1], ssd_scan.ssd_scan.launches - before[2])
    mixer = 1 if arch == "stablelm-1.6b" else 2
    assert launched == (2 * 2 * cfg.n_layers, 2 * cfg.n_layers * (mixer == 1),
                        2 * cfg.n_layers * (mixer == 2))
    want, cpu_loss, _ = step(cpu_model, tree_to(lora, "cpu"), batch)
    torch.testing.assert_close(loss.cpu(), cpu_loss, rtol=1e-5, atol=0)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert float((g.cpu() - w).norm()) <= 1e-4 * float(w.norm())


@pytest.mark.gpu
def test_apply_moe_gradient_is_deterministic_on_the_card(cuda):
    """The MoE layer's backward on the card (an indexed set's, a gather's and
    a sum over k) at Granite-MoE's width in bf16, with drops (capacity
    factor 0.6) and two routing groups: two passes give x's and every
    expert weight's gradient bit for bit."""
    from repro_torch.models import moe

    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.init_moe(gen, 1024, 512, 32, dtype=torch.bfloat16, device=cuda)
    for name in ("gate", "up", "down"):
        p[name].requires_grad_(True)
    x = torch.randn((4, 256, 1024), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((4, 256, 1024), generator=gen, device=cuda).to(torch.bfloat16)

    def grads():
        live = x.clone().requires_grad_()
        out, aux = moe.apply_moe(p, live, top_k=8, capacity_factor=0.6, groups=2)
        return torch.autograd.grad((out.float() * g).sum() + aux.sum(),
                                   [live, p["gate"], p["up"], p["down"]])

    first, second = grads(), grads()
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)
