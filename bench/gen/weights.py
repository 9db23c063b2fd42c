"""Random weights and LoRA adapters made by the benchmark from the seed, on
the device, in a few large draws, in the type they are served in.

``base_weights`` returns a flat dict of named tensors that both sides read:
the program gets them copied into its ``DecoderLM`` (``load_into``), and
the plain reference draws them again from the same seed after the program
has been freed.  Distributions: embeddings and an untied output head
U(-a, a) with a = 0.02 sqrt(3) (std 0.02), projections, their biases and
experts U(+-1/sqrt(fan-in)), norms ones and zeros (float32), the router
float32.  ``lora_init``: A ~ N(0, 1/d_in), B = 0
(a fresh adapter is a no-op), in the LoRA dtype.
"""
from __future__ import annotations

import math

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose, from the run's seed and a tag."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [ord(c) for c in tag]
    lo, hi = (int(w) for w in np.random.SeedSequence(words).generate_state(2, dtype=np.uint32))
    return (lo | (hi << 32)) & ((1 << 63) - 1)


def generator(device, seed: int, tag: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def q_dim(spec) -> int:
    return spec["n_heads"] * spec["head_dim"]


def kv_dim(spec) -> int:
    return spec["n_kv_heads"] * spec["head_dim"]


def matrix_shapes(spec) -> list:
    """(name, shape, fan_in) of every low-precision matrix, in draw order."""
    d, f = spec["d_model"], spec["d_ff"]
    out = [("embed", (spec["vocab_size"], d), None)]
    for i in range(spec["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "q", (d, q_dim(spec)), d), (p + "k", (d, kv_dim(spec)), d),
                (p + "v", (d, kv_dim(spec)), d), (p + "o", (q_dim(spec), d), q_dim(spec))]
        if spec["qkv_bias"]:
            out += [(p + "q.b", (q_dim(spec),), d), (p + "k.b", (kv_dim(spec),), d),
                    (p + "v.b", (kv_dim(spec),), d)]
        if spec["n_experts"]:
            e = spec["n_experts"]
            out += [(p + "moe.gate", (e, d, f), d), (p + "moe.up", (e, d, f), d),
                    (p + "moe.down", (e, f, d), f)]
        else:
            out += [(p + "ffn.gate", (d, f), d), (p + "ffn.up", (d, f), d),
                    (p + "ffn.down", (f, d), f)]
    if not spec["tie_embeddings"]:
        out.append(("lm_head", (d, spec["vocab_size"]), None))
    return out


def base_weights(spec, seed: int, device, dtype=None) -> dict:
    """Every base weight of ``spec`` (see the module docstring); ``dtype``
    overrides the matrices' type (the reference's float32 is an exact upcast
    of the same draws)."""
    mats = matrix_shapes(spec)
    total = sum(math.prod(s) for _, s, _ in mats)
    flat = torch.empty(total, dtype=DTYPES[spec["dtype"]], device=device)
    flat.uniform_(-1.0, 1.0, generator=generator(device, seed, "base"))
    out, off = {}, 0
    for name, shape, fan_in in mats:
        n = math.prod(shape)
        scale = 0.02 * math.sqrt(3.0) if fan_in is None else 1.0 / math.sqrt(fan_in)
        out[name] = (flat[off:off + n].view(shape) * scale).to(dtype or flat.dtype)
        off += n
    del flat
    d = spec["d_model"]
    if spec["n_experts"]:
        e = spec["n_experts"]
        routers = torch.empty((spec["n_layers"], d, e), dtype=torch.float32, device=device)
        routers.uniform_(-1.0, 1.0, generator=generator(device, seed, "router"))
        routers *= 1.0 / math.sqrt(d)
        for i in range(spec["n_layers"]):
            out[f"layers.{i}.moe.router"] = routers[i]
    ones = torch.ones((d,), dtype=torch.float32, device=device)
    zeros = torch.zeros((d,), dtype=torch.float32, device=device)
    for p in [f"layers.{i}.norm1" for i in range(spec["n_layers"])] + \
             [f"layers.{i}.norm2" for i in range(spec["n_layers"])] + ["final_norm"]:
        out[p + ".scale"] = ones
        if spec["norm_kind"] == "layernorm":
            out[p + ".bias"] = zeros
    return out


def lora_dims(spec) -> dict:
    dims = {"q": (spec["d_model"], q_dim(spec)), "k": (spec["d_model"], kv_dim(spec)),
            "v": (spec["d_model"], kv_dim(spec)), "o": (q_dim(spec), spec["d_model"])}
    return {t: dims[t] for t in spec["lora"]["targets"]}


def lora_init(spec, seed: int, device) -> dict:
    """{target: {"A": (L, d_in, r), "B": (L, r, d_out)}} of the global
    adapter at round 0."""
    r, n_l = spec["lora"]["rank"], spec["n_layers"]
    dt = DTYPES[spec["lora"]["dtype"]]
    dims = lora_dims(spec)
    total = sum(n_l * d_in * r for d_in, _ in dims.values())
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(0.0, 1.0, generator=generator(device, seed, "lora"))
    out, off = {}, 0
    for t, (d_in, d_out) in dims.items():
        n = n_l * d_in * r
        out[t] = {"A": (flat[off:off + n].view(n_l, d_in, r) / math.sqrt(d_in)).to(dt),
                  "B": torch.zeros((n_l, r, d_out), dtype=dt, device=device)}
        off += n
    return out


def program_lora(lora: dict) -> dict:
    """The program's adapter tree layout for a one-slot layer pattern."""
    return {"groups": ({"mixer": lora},), "tail": ()}


def from_program_lora(tree: dict) -> dict:
    return tree["groups"][0]["mixer"]


def modules(lora: dict, stacked: bool) -> list:
    """The client-delta matrices of a LoRA tree, one a (layer, target,
    factor): (vec, n_clients) when ``stacked`` (leaves (n, L, ...)), else
    (vec,) vectors; in target, factor, layer order."""
    out = []
    for t in sorted(lora):
        for f in ("A", "B"):
            leaf = lora[t][f]
            for i in range(leaf.shape[1] if stacked else leaf.shape[0]):
                if stacked:
                    out.append(leaf[:, i].reshape(leaf.shape[0], -1).T)
                else:
                    out.append(leaf[i].reshape(-1))
    return out


def program_names(spec) -> dict:
    """{program parameter name: bench weight name}."""
    out = {"embed": "embed", "final_norm.scale": "final_norm.scale"}
    if not spec["tie_embeddings"]:
        out["lm_head"] = "lm_head"
    if spec["norm_kind"] == "layernorm":
        out["final_norm.bias"] = "final_norm.bias"
    for i in range(spec["n_layers"]):
        p = f"layers.{i}."
        for t in ("q", "k", "v", "o"):
            out[f"{p}mixer.{t}.w"] = p + t
            if spec["qkv_bias"] and t != "o":
                out[f"{p}mixer.{t}.b"] = f"{p}{t}.b"
        for n in ("norm1", "norm2"):
            out[f"{p}{n}.scale"] = f"{p}{n}.scale"
            if spec["norm_kind"] == "layernorm":
                out[f"{p}{n}.bias"] = f"{p}{n}.bias"
        if spec["n_experts"]:
            out[f"{p}moe.router.w"] = p + "moe.router"
            for t in ("gate", "up", "down"):
                out[f"{p}moe.{t}"] = f"{p}moe.{t}"
        else:
            for t in ("gate", "up", "down"):
                out[f"{p}ffn.{t}.w"] = f"{p}ffn.{t}"
    return out


def load_into(model, spec, weights: dict) -> None:
    """Copy the bench's weights into the program's parameters; every
    parameter must be named (a new one would run uninitialised)."""
    names = program_names(spec)
    params = dict(model.named_parameters())
    missing = set(params) ^ set(names)
    if missing:
        raise RuntimeError(f"program parameters and bench weights differ: {sorted(missing)[:8]}")
    with torch.no_grad():
        for pname, bname in names.items():
            params[pname].copy_(weights[bname])
