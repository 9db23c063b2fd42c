"""Plain float32 decoder LM with LoRA on the attention projections, its
loss and a plain Adam: the reference that the federated round is judged
against.  Plain ``torch`` only; nothing of the program.

The model, as the configuration file states it:

* token embedding E (V, D); the output head x E^T where the file ties it,
  else x H with its own H (D, V);
* per layer, pre-norm: x += Attn(Norm1(x)), x += FFN(Norm2(x)); a final
  norm.  Norms are LayerNorm (population variance, scale and bias) or
  RMSNorm (scale), eps from the file, in float32;
* attention: q = h Wq + s (h Aq) Bq + bq, k = h Wk + bk, v = h Wv +
  s (h Av) Bv + bv (adapters on the targets the file lists, s = alpha /
  rank; the biases where the file sets ``qkv_bias``), heads of
  ``head_dim``, K and V shared by ``n_heads / n_kv_heads`` query heads,
  rotary embedding on the first ``rope_pct`` of each head (non-interleaved
  halves, theta from the file), causal softmax(q k^T / sqrt(head_dim)) v,
  then Wo;
* FFN: SwiGLU, silu(h Wg) * (h Wu) then Wd; or a mixture of SwiGLU
  experts: a float32 router softmax(h Wr), the top ``top_k`` experts by a
  stable descending sort (ties to the lower index), weights renormalized
  over the chosen with a 1e-9 floor; each expert takes at most C =
  max(8, 8 ceil(ceil(T k cf / E) / 8)) entries of the T tokens routed
  together, in token-major order, and drops the rest; the output is the sum
  of the kept entries' weighted expert outputs (every expert is evaluated
  on every token and the kept entries' outputs picked); the load-balance
  term is
  E sum_e f_e p_e (f_e the share of the T k entries sent to e, p_e the mean
  router probability), summed over layers and added to the loss times
  ``router_aux_weight``;
* loss: mean next-token cross-entropy over the client's tokens.

``quant="fp8"`` is the control: every product with a base weight (the
projections, the experts, the head) takes its two operands rounded to
float8 e4m3 with one scale a tensor (amax / 448), the step below the bf16
that the configuration states.  The adapters, norms, softmax and loss stay
float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _q8(t: torch.Tensor) -> torch.Tensor:
    if t.numel() == 0:
        return t
    scale = torch.clamp_min(t.detach().abs().amax(), 1e-30) / FP8_MAX
    q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()  # rounded forward, straight-through backward


def mm(x, w, quant):
    if quant == "fp8":
        return _q8(x) @ _q8(w)
    return x @ w


def norm(x, p, spec):
    if spec["norm_kind"] == "layernorm":
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + spec["norm_eps"]) * p["scale"] + p["bias"]
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + spec["norm_eps"]) * p["scale"]


def rope(x, theta: float, pct: float):
    """x (B, S, H, Dh); rotates the first ``pct`` of each head."""
    dh = x.shape[-1]
    rot = int(dh * pct) // 2 * 2
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot)
    ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * inv[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., : rot // 2], x[..., rot // 2: rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]], dim=-1)


def attention(h, w, lora, spec, quant):
    b, s, _ = h.shape
    hd, nh, nkv = spec["head_dim"], spec["n_heads"], spec["n_kv_heads"]
    sc = spec["lora"]["alpha"] / spec["lora"]["rank"]

    def proj(t):
        y = mm(h, w[t], quant)
        if t in lora:
            y = y + sc * ((h @ lora[t]["A"]) @ lora[t]["B"])
        if t + ".b" in w:
            y = y + w[t + ".b"]
        return y

    q = rope(proj("q").view(b, s, nh, hd), spec["rope_theta"], spec["rope_pct"])
    k = rope(proj("k").view(b, s, nkv, hd), spec["rope_theta"], spec["rope_pct"])
    v = proj("v").view(b, s, nkv, hd)
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, nh * hd)
    if "o" in lora:
        return mm(out, w["o"], quant) + sc * ((out @ lora["o"]["A"]) @ lora["o"]["B"])
    return mm(out, w["o"], quant)


def swiglu(h, g, u, d, quant):
    return mm(F.silu(mm(h, g, quant)) * mm(h, u, quant), d, quant)


def moe(h, w, spec, quant):
    """(output, load-balance term) of T = B S tokens routed together."""
    b, s, dm = h.shape
    x = h.reshape(-1, dm)
    t, e, k = x.shape[0], spec["n_experts"], spec["top_k"]
    probs = torch.softmax(x @ w["moe.router"], dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    cap = max(8, -(-int(math.ceil(t * k * spec["capacity_factor"] / e)) // 8) * 8)
    flat_e = top_e.reshape(-1)  # token-major entries
    onehot = F.one_hot(flat_e, e)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = pos < cap
    frac = onehot.reshape(t, k, e).sum(1).float().mean(0)
    aux = e * torch.sum(frac * probs.mean(0))
    # Every expert on every token, then each kept entry's output: more
    # products than routing needs, in a few large ones.
    ys = swiglu(x[None].expand(e, t, dm), w["moe.gate"], w["moe.up"], w["moe.down"], quant)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    picked = ys[flat_e, tok] * (top_p.reshape(-1) * keep)[:, None]
    return picked.view(t, k, dm).sum(1).reshape(b, s, dm), aux


def layer_weights(weights: dict, i: int) -> dict:
    p = f"layers.{i}."
    out = {}
    for name, t in weights.items():
        if name.startswith(p):
            key = name[len(p):]
            if key.startswith(("norm1", "norm2")):
                n, field = key.split(".")
                out.setdefault(n, {})[field] = t
            else:
                out[key] = t
    return out


def client_loss(weights: dict, lora: list, tokens, labels, spec, quant=None):
    """Mean next-token cross-entropy (plus the experts' load-balance term)
    of one client's (B, S) batch; ``lora[i]`` is layer i's
    {target: {"A", "B"}}."""
    x = weights["embed"][tokens]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(spec["n_layers"]):
        w = layer_weights(weights, i)
        x = x + attention(norm(x, w["norm1"], spec), w, lora[i], spec, quant)
        h = norm(x, w["norm2"], spec)
        if spec["n_experts"]:
            y, a = moe(h, w, spec, quant)
            aux = aux + a
        else:
            y = swiglu(h, w["ffn.gate"], w["ffn.up"], w["ffn.down"], quant)
        x = x + y
    fin = {"scale": weights["final_norm.scale"]}
    if spec["norm_kind"] == "layernorm":
        fin["bias"] = weights["final_norm.bias"]
    head = weights["lm_head"] if "lm_head" in weights else weights["embed"].T
    logits = mm(norm(x, fin, spec), head, quant)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
    return ce + spec["router_aux_weight"] * aux if spec["n_experts"] else ce


class Adam:
    """Plain Adam over a list of tensors (b1 0.9, b2 0.999, eps 1e-8, bias
    corrected)."""

    def __init__(self, params: list, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    def step(self, params: list, grads: list) -> list:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.m[i] = self.b1 * self.m[i] + (1 - self.b1) * g
            self.v[i] = self.b2 * self.v[i] + (1 - self.b2) * g * g
            out.append(p - self.lr * (self.m[i] / c1) / (torch.sqrt(self.v[i] / c2) + self.eps))
        return out
