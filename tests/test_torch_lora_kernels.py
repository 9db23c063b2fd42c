"""Serving kernels of the port on the CPU: the plain versions of
``lora_matmul``, ``gathered_lora_matmul`` and ``local_attention`` against
the jnp oracles of ``repro.kernels.ref`` (and, for attention, the Pallas
kernel in interpret mode), the leading-rank wrappers of ``kernels.ops``,
and the wrappers' CPU dispatch and validation.  The CUDA kernels themselves
are checked on a card by ``test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances (float32): a projection sums K products, taken in another order
by each library, so its error is held to 1e-6 * sqrt(K) of the largest
output; attention outputs are O(1) averages, held to atol 2e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import local_attention as la
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops, ref

ATTN = dict(atol=2e-6, rtol=0)


def lora_inputs(seed, m, k, n, r, n_slots=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(x=f(m, k), w=f(k, n) / np.float32(np.sqrt(k)),
                a=f(n_slots, k, r) / np.float32(np.sqrt(k)), b=f(n_slots, r, n))


def assert_proj_close(got, want, k):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-6 * np.sqrt(k) * np.abs(want).max())


T = lambda a: torch.from_numpy(np.array(a))


@pytest.mark.parametrize("m,k,n,r", [(16, 32, 24, 4), (129, 513, 130, 8), (1, 7, 3, 1),
                                     (33, 64, 40, 64)])
def test_lora_matmul_plain_matches_jax(m, k, n, r):
    d = lora_inputs(0, m, k, n, r)
    got = lm.lora_matmul(T(d["x"]), T(d["w"]), T(d["a"][0]), T(d["b"][0]), 2.0)
    want = jref.lora_matmul_ref(*(jnp.asarray(d[key]) for key in "xw"), d["a"][0], d["b"][0], 2.0)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert_proj_close(got, want, k)


@pytest.mark.parametrize("m,k,n,r,slots", [
    (24, 32, 16, 4, [0, 1, 2, 1, 0, 2]),        # mixed tenants, 4 rows each
    (37, 65, 33, 8, [-1, 3, 0, -1, 2]),         # ragged, rows without an adapter
    (8, 32, 48, 4, [-1] * 8),                   # no adapter at all: base only
])
def test_gathered_lora_matmul_plain_matches_jax(m, k, n, r, slots):
    d = lora_inputs(1, m, k, n, r, n_slots=4)
    req = np.arange(m) * len(slots) // m
    row_slot = np.asarray(slots, np.int32)[req]
    got = lm.gathered_lora_matmul(T(d["x"]), T(d["w"]), T(d["a"]), T(d["b"]), T(row_slot), 0.5)
    want = jref.gathered_lora_matmul_ref(*(jnp.asarray(d[key]) for key in "xwab"),
                                         jnp.asarray(row_slot), 0.5)
    assert_proj_close(got, want, k)
    base = (T(d["x"]) @ T(d["w"])).numpy()
    none = row_slot < 0
    np.testing.assert_array_equal(got.numpy()[none], base[none])


def test_gathered_slot_minus_one_equals_zero_adapter():
    d = lora_inputs(2, 20, 16, 12, 4, n_slots=3)
    a, b = T(d["a"]), T(d["b"])
    a[2], b[2] = 0.0, 0.0
    rs = torch.tensor([0, -1, 1, -1, 0] * 4, dtype=torch.int32)
    none = lm.gathered_lora_matmul(T(d["x"]), T(d["w"]), a, b, rs, 2.0)
    zero = lm.gathered_lora_matmul(T(d["x"]), T(d["w"]), a, b, torch.where(rs < 0, 2, rs), 2.0)
    assert torch.equal(none, zero)


def test_plain_rounds_where_the_kernel_rounds():
    """bf16 activations with a float32 pool: operands rounded to bf16, both
    products accumulated in fp32, x @ A rounded to bf16, one final
    rounding — the kernel's arithmetic, spelled out."""
    d = lora_inputs(3, 16, 32, 24, 4)
    x, w = T(d["x"]).bfloat16(), T(d["w"]).bfloat16()
    a, b = T(d["a"][0]), T(d["b"][0])
    got = lm.lora_matmul(x, w, a, b, 2.0)
    xa = (x.double() @ a.bfloat16().double()).float().bfloat16().double()
    want = (x.double() @ w.double() + 2.0 * (xa @ b.bfloat16().double())).bfloat16()
    assert got.dtype == torch.bfloat16
    # One bf16 ulp of the largest output: the fp64 sums here round to bf16
    # from the other side of a tie at most once per output.
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2.0**-7 * float(want.float().abs().max()))


@pytest.mark.parametrize("bh,s,d,window", [(3, 37, 32, 0), (2, 64, 64, 0), (2, 50, 32, 8),
                                           (1, 9, 64, 1)])
def test_local_attention_plain_matches_jax(bh, s, d, window):
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32) for _ in range(3))
    got = la.local_attention(T(q), T(k), T(v), window=window)
    want = jref.local_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)


@pytest.mark.parametrize("window", [0, 5])
def test_local_attention_ops_matches_pallas_interpret(window):
    """The leading-rank fold of ``ops.local_attention`` against the Pallas
    kernel in interpret mode, (B, S, H, D) = (2, 20, 3, 32)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 20, 3, 32)).astype(np.float32) for _ in range(3))
    got = ops.local_attention(T(q), T(k), T(v), window=window)
    want = jops.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)


def test_ops_lora_matmul_any_leading_rank():
    d = lora_inputs(6, 12, 16, 8, 4)
    x = T(d["x"]).reshape(2, 3, 2, 16)
    got = ops.lora_matmul(x, T(d["w"]), T(d["a"][0]), T(d["b"][0]), 2.0)
    want = lm.lora_matmul(T(d["x"]), T(d["w"]), T(d["a"][0]), T(d["b"][0]), 2.0)
    assert got.shape == (2, 3, 2, 8)
    assert torch.equal(got.reshape(12, 8), want)


def test_ops_gathered_broadcasts_request_slots():
    """Per-request (B,) slots broadcast over the sequence give the bits of
    the same slots written out per row."""
    d = lora_inputs(7, 15, 16, 8, 4, n_slots=3)
    x = T(d["x"]).reshape(3, 5, 16)
    per_req = torch.tensor([2, -1, 0], dtype=torch.int32)
    got = ops.gathered_lora_matmul(x, T(d["w"]), T(d["a"]), T(d["b"]), per_req, 2.0)
    rows = per_req.repeat_interleave(5)
    want = lm.gathered_lora_matmul(T(d["x"]), T(d["w"]), T(d["a"]), T(d["b"]), rows, 2.0)
    assert torch.equal(got.reshape(15, 8), want)
    with pytest.raises(ValueError, match="row_slot"):
        ops.gathered_lora_matmul(x, T(d["w"]), T(d["a"]), T(d["b"]), per_req[:2], 2.0)


def test_ops_local_attention_repeats_grouped_heads():
    rng = np.random.default_rng(8)
    q = T(rng.normal(size=(2, 11, 4, 32)).astype(np.float32))
    k, v = (T(rng.normal(size=(2, 11, 2, 32)).astype(np.float32)) for _ in range(2))
    got = ops.local_attention(q, k, v)
    want = ops.local_attention(q, k.repeat_interleave(2, 2), v.repeat_interleave(2, 2))
    assert torch.equal(got, want)


def launch_counts():
    """Every launch counter of the three serving wrappers: all launches and
    those of the tensor route."""
    return tuple(getattr(fn, c) for fn in (lm.lora_matmul, lm.gathered_lora_matmul,
                                           la.local_attention)
                 for c in ("launches", "tc_launches"))


def test_cpu_wrappers_take_the_plain_version():
    """CPU tensors compute the plain version bit for bit and launch nothing:
    no counter of either route moves."""
    d = lora_inputs(9, 10, 16, 8, 4, n_slots=2)
    rs = torch.tensor([0, 1] * 5, dtype=torch.int32)
    before = launch_counts()
    args = (T(d["x"]), T(d["w"]))
    assert torch.equal(lm.lora_matmul(*args, T(d["a"][0]), T(d["b"][0]), 2.0),
                       ref.lora_matmul_ref(*args, T(d["a"][0]), T(d["b"][0]), 2.0))
    assert torch.equal(lm.gathered_lora_matmul(*args, T(d["a"]), T(d["b"]), rs, 2.0),
                       ref.gathered_lora_matmul_ref(*args, T(d["a"]), T(d["b"]), rs, 2.0))
    q = T(d["x"]).reshape(2, 5, 16)
    assert torch.equal(la.local_attention(q, q, q), ref.local_attention_ref(q, q, q, window=0))
    bf = lambda t: t.bfloat16()
    lm.gathered_lora_matmul(bf(T(d["x"])), bf(T(d["w"])), T(d["a"]), T(d["b"]), rs, 2.0)
    la.local_attention(bf(q), bf(q), bf(q))
    assert launch_counts() == before


# The route rule: bf16 activations whose TMA row strides are multiples of 16
# bytes take the tensor-core (wgmma) route, everything else the scalar one.
@pytest.mark.parametrize("k,n,dtype,aligned,want", [
    (2048, 2048, torch.bfloat16, True, "tensor"),   # StableLM q and v, prefill and decode
    (768, 3352, torch.bfloat16, True, "tensor"),    # Mamba-2 in_proj (N ragged to the tile)
    (1536, 768, torch.bfloat16, True, "tensor"),    # Mamba-2 out_proj
    (64, 40, torch.bfloat16, True, "tensor"),
    (2048, 2048, torch.float32, True, "scalar"),    # TF32 would miss the float32 checks
    (513, 130, torch.bfloat16, True, "scalar"),     # the ragged check shape
    (513, 2048, torch.bfloat16, True, "scalar"),    # K not a multiple of 8
    (2048, 130, torch.bfloat16, True, "scalar"),    # N not a multiple of 8
    (0, 2048, torch.bfloat16, True, "scalar"),      # no K: nothing for TMA to read
    (2048, 2048, torch.bfloat16, False, "scalar"),  # a base TMA cannot read
])
def test_lora_route_rule(k, n, dtype, aligned, want):
    assert lm.route(k, n, dtype, aligned=aligned) == want


def test_lora_route_alignment():
    """A bf16 x that starts 2 bytes into its storage, or a B pool whose
    column pairs are split, is not aligned for the tensor route."""
    d = lora_inputs(11, 8, 16, 8, 4, n_slots=2)
    x, w, b = T(d["x"]).bfloat16(), T(d["w"]).bfloat16(), T(d["b"])
    assert lm._aligned(x, w, b)
    shifted = torch.empty(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    assert shifted.is_contiguous() and not lm._aligned(shifted, w, b)
    odd_b = torch.empty(b.numel() + 1)[1:].view(b.shape)
    assert not lm._aligned(x, w, odd_b)


def test_lora_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        lm.route(64, 64, torch.float16)


@pytest.mark.parametrize("d,dtype,want", [(64, torch.bfloat16, "tensor"),
                                          (32, torch.bfloat16, "tensor"),
                                          (64, torch.float32, "scalar"),
                                          (32, torch.float32, "scalar"),
                                          (256, torch.bfloat16, "tensor"),
                                          (256, torch.float32, "scalar"),
                                          (128, torch.bfloat16, "tensor"),
                                          (128, torch.float32, "scalar")])
def test_attention_route_rule(d, dtype, want):
    assert la.route(d, dtype) == want


@pytest.mark.parametrize("d,dtype,exc", [(48, torch.bfloat16, ValueError),
                                         (512, torch.float32, ValueError),
                                         (16, torch.bfloat16, ValueError),
                                         (64, torch.float16, TypeError)])
def test_attention_route_refuses(d, dtype, exc):
    with pytest.raises(exc):
        la.route(d, dtype)


@pytest.mark.parametrize("bad", ["chain", "adapter", "pool", "row_slot", "attn", "window"])
def test_wrappers_validate_shapes(bad):
    d = lora_inputs(10, 6, 8, 4, 2, n_slots=2)
    x, w, a, b = T(d["x"]), T(d["w"]), T(d["a"]), T(d["b"])
    rs = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "chain":
            lm.lora_matmul(x[:, :5], w, a[0], b[0])
        elif bad == "adapter":
            lm.lora_matmul(x, w, a[0, :, :1], b[0])
        elif bad == "pool":
            lm.gathered_lora_matmul(x, w, a, b[:1], rs)
        elif bad == "row_slot":
            lm.gathered_lora_matmul(x, w, a, b, rs[:5])
        elif bad == "attn":
            la.local_attention(x[None], x[None, :5], x[None])
        else:
            la.local_attention(x[None], x[None], x[None], window=-1)
