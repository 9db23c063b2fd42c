"""Operations and bytes reckoned from shapes: the yardstick of every
roofline and utilization metric, kept apart from the program.

A product of an (m, k) and a (k, n) operand counts 2 m k n operations.
Bytes count each input read once and each output written once, whatever a
kernel reads again.  Attention counts the (query, key) pairs that its mask
keeps.  Training counts the work the model needs and no recomputation:
the forward pass, the gradients of the activations through every frozen
product (the same operations as its forward), and the weight gradients of
the adapters only.
"""
from __future__ import annotations


def bound_s(flops: float, nbytes: float, peak_flops: float, peak_bw: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / peak_bw)


def lora_call(m: int, k: int, n: int, r: int, n_slots: int, act_bytes: int = 2,
              adapter_bytes: int = 4) -> tuple:
    """y = x W + s (x A_slot) B_slot over m rows: (flops, bytes).  Reads x
    (m, k), W (k, n), the adapter pools and one int32 slot a row; writes y
    (m, n)."""
    flops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n
    nbytes = (act_bytes * (m * k + k * n + m * n) + adapter_bytes * n_slots * (k * r + r * n)
              + 4 * m)
    return flops, nbytes


def kept_pairs(s: int, causal: bool = True, window: int = 0) -> int:
    """(query, key) pairs of one length-s sequence that the mask keeps."""
    if not causal:
        return s * s
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attention_call(bh: int, bh_kv: int, s: int, d: int, causal: bool = True, window: int = 0,
                   elem_bytes: int = 2) -> tuple:
    """softmax(q k^T) v over bh query heads of length s, k and v of bh_kv
    heads: (flops, bytes).  Reads q, k, v once and writes o."""
    flops = 4 * bh * kept_pairs(s, causal, window) * d
    nbytes = elem_bytes * s * d * (2 * bh + 2 * bh_kv)
    return flops, nbytes


def subspace_apply_call(b: int, vec: int, d2: int) -> tuple:
    """One fused subspace-SVT ADMM tail over a (b, vec, d2) float32 bucket:
    L = X P with X = M - S + rho Y, the shrink and dual step, and the Gram
    of the next iterate.  Reads M, S, Y, P and three scalars a module;
    writes L, S', Y', the residual sums and the Gram."""
    flops = 4 * b * vec * d2 * d2
    nbytes = 4 * (6 * b * vec * d2 + 2 * b * d2 * d2 + 4 * b)
    return flops, nbytes


def local_phase_flops(spec: dict, n_clients: int, per_client: int, seq: int,
                      local_steps: int) -> float:
    """Model operations of one round's local phase (see the module
    docstring)."""
    d, f, v = spec["d_model"], spec["d_ff"], spec["vocab_size"]
    hd, nh, nkv = spec["head_dim"], spec["n_heads"], spec["n_kv_heads"]
    qd, kvd = nh * hd, nkv * hd
    r = spec["lora"]["rank"]
    dims = {"q": (d, qd), "k": (d, kvd), "v": (d, kvd), "o": (qd, d)}
    base = 2 * d * (qd + 2 * kvd) + 2 * qd * d
    if spec["n_experts"]:
        ffn = 2 * d * spec["n_experts"] + spec["top_k"] * 3 * 2 * d * f
    else:
        ffn = 3 * 2 * d * f
    lora = sum(2 * di * r + 2 * r * do for t, (di, do) in dims.items()
               if t in spec["lora"]["targets"])
    per_token_layer = base + ffn  # forward; the activation gradients repeat it
    tokens = n_clients * per_client * seq
    attn_fwd = 4 * nh * hd * kept_pairs(seq) * n_clients * per_client
    layers = spec["n_layers"]
    fwd = layers * (tokens * (per_token_layer + lora) + attn_fwd) + tokens * 2 * d * v
    bwd = (layers * (tokens * (per_token_layer + 2 * lora) + 2 * attn_fwd)
           + tokens * 2 * d * v)
    return float(local_steps * (fwd + bwd))
