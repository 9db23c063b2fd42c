#!/usr/bin/env python3
"""Drive the PyTorch port of FedRPCA on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

  1. Card: name and power limit (nvidia-smi), TF32 switched off.
  2. Build: the CUDA kernels of ``src/repro_torch/kernels/csrc`` from source.
  3. Kernel checks: ``admm_tail`` and ``subspace_apply`` against their plain
     PyTorch versions on the card at every bucket shape the main paths
     launch them at (path B's ViT-B/32 LoRA bucket: 48 modules x 4096 rows,
     3072 of them live, 40 dense clients and 20 of 32; path A's 2 x 4096 x
     20 bucket) and at ragged shapes; two launches give the same bits, and
     ``mask=None`` the bits of an all-ones mask.  Times by CUDA events.
  4. Main path A: ``run_simulation`` on a planted task at the width of one
     ViT-B/32 attention projection (768 x 768, LoRA rank 4), 20 clients,
     10 rounds of fedavg / fedrpca gram / fedrpca subspace; then 3 rounds of
     fedrpca on the card and on the CPU from the same weights and batches.
     Before it, a regime probe: zero-shot accuracy, saturated-feature share
     and 10-round fedavg accuracy at the backbone qualities 0.4 (the
     reference benchmarks'), 0.1 and 0.0 (path A's).
  5. Main path B: ``aggregate(engine="packed")`` of a planted delta tree of
     ``configs/paper_vit_b32.py``'s LoRA (q and v, 12 layers) at 40 dense
     clients and 20 clients padded to 32, both SVT modes, against the same
     call on the CPU.
  6. The ``kernels`` JSON line, then the result line.

Kernel launch counts are set to 0 just before phase 4 and read just after
phase 5; every kernel must have launched, exactly as often as the rounds,
ADMM iterations and buckets of those runs say.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Elementwise kernel outputs vs the plain version: fp32 FMA contraction and
# the dot-product order of L = X @ P differ, a few ulp of O(1) values.
ELEM_ATOL = 2e-5
# Residual sums and Gram matrices: sums over up to 1.6e5 terms in another
# order, relative to the largest entry of the tensor.
SUM_RTOL = 1e-5
# Card vs CPU after a whole run: eigh (cuSOLVER vs LAPACK) and matmul
# round-off compounded over 50 ADMM iterations, relative to max |delta|.
AGG_RTOL = 1e-4


def card_peaks(name: str) -> tuple[float, float]:
    """(device-memory bytes/s, fp32 non-tensor-core FLOP/s) of the card,
    from NVIDIA's data sheets."""
    if "H200" in name:
        return 4.8e12, 67e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12  # H100 SXM


def bench_ms(fn, reps: int = 20, batches: int = 5) -> float:
    """Median over ``batches`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(batches):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        per.append(e0.elapsed_time(e1) / reps)
    return statistics.median(per)


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_sum(got, want, what: str) -> float:
    err = max_abs(got, want)
    scale = float(want.double().abs().max()) if want.numel() else 0.0
    if err > SUM_RTOL * max(scale, 1e-30):
        raise AssertionError(f"{what}: max |err| {err} > {SUM_RTOL} * {scale}")
    return err


def check_elem(got, want, what: str) -> float:
    err = max_abs(got, want)
    if err > ELEM_ATOL:
        raise AssertionError(f"{what}: max |err| {err} > {ELEM_ATOL}")
    return err


def bucket_inputs(gen, b, vec, live_rows, d2, n_valid, device):
    """Bucket tensors as the ADMM loop sees them: rows past ``live_rows``
    zero, columns past ``n_valid`` of M zero."""
    import torch

    def t(scale=1.0):
        x = torch.randn((b, vec, d2), generator=gen) * scale
        x[:, live_rows:] = 0.0
        return x

    m, l, s, y = t(), t(), t(0.5), t(0.1)
    mask = None
    if n_valid is not None:
        mask = (torch.arange(d2) < n_valid).float()
        m = m * mask
    p = torch.randn((b, d2, d2), generator=gen) / d2**0.5
    rho = torch.rand((b,), generator=gen) + 0.5
    mu = 1.0 / rho
    th = 0.05 * rho
    out = dict(m=m, l=l, s=s, y=y, p=p, rho=rho, mu=mu, th=th, mask=mask)
    return {k: None if v is None else v.to(device).contiguous() for k, v in out.items()}


def check_kernels(device, bw, flops) -> dict:
    """Phase 3: both kernels against their plain versions; returns the
    per-kernel record at the main-path shape."""
    import torch
    from repro_torch.kernels import ref, rpca_admm, svt_subspace

    gen = torch.Generator().manual_seed(11)
    shapes = [
        # (B, vec, live rows, d2, n_valid, label)
        (48, 4096, 3072, 40, None, "main"),
        (48, 4096, 3072, 32, 20, "masked"),
        (2, 4096, 3072, 20, None, "path A"),
        (5, 1000, 1000, 1, None, "ragged"),
        (5, 1000, 999, 3, None, "ragged"),
        (3, 1000, 777, 128, 100, "ragged"),
        (3, 1000, 1000, 130, None, "ragged"),
    ]
    rec = {}
    for b, vec, live, d2, n_valid, label in shapes:
        x = bucket_inputs(gen, b, vec, live, d2, n_valid, device)
        msk = x["mask"]
        a_args = (x["m"], x["l"], x["y"], x["rho"], x["mu"], x["th"])
        s_args = (x["m"], x["s"], x["y"], x["p"], x["rho"], x["mu"], x["th"])
        a_run = lambda: rpca_admm.admm_tail(*a_args, mask=msk)
        a_ref = lambda: ref.rpca_admm_tail_ref(*a_args, mask=msk)
        s_run = lambda: svt_subspace.subspace_apply(*s_args, mask=msk)
        s_ref = lambda: ref.svt_subspace_apply_ref(*s_args, mask=msk)
        errs = {}
        for name, run, plain, n_elem in (("admm_tail", a_run, a_ref, 2),
                                         ("subspace_apply", s_run, s_ref, 3)):
            got, again, want = run(), run(), plain()
            torch.cuda.synchronize()
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"{name} {label}: two launches differ")
            err = max(check_elem(g, w, f"{name} {label}") for g, w in zip(got[:n_elem], want[:n_elem]))
            for g, w in zip(got[n_elem:], want[n_elem:]):
                check_sum(g, w, f"{name} {label} sums")
            if msk is not None:
                for g in got[n_elem - 2:n_elem]:  # S', Y': masked columns exactly zero
                    if bool((g[..., n_valid:] != 0).any()):
                        raise AssertionError(f"{name} {label}: masked column not zero")
            else:
                ones = torch.ones(d2, device=device)
                with_ones = (rpca_admm.admm_tail(*a_args, mask=ones) if name == "admm_tail"
                             else svt_subspace.subspace_apply(*s_args, mask=ones))
                if not all(torch.equal(u, v) for u, v in zip(got, with_ones)):
                    raise AssertionError(f"{name} {label}: mask=None differs from all-ones")
            errs[name] = err
        line = f"[kernels] {label} B={b} vec={vec} live={live} d2={d2} valid={n_valid}"
        print(line, " ".join(f"{k}_err={v:.3g}" for k, v in errs.items()), flush=True)
        if label != "main":
            continue
        n = b * vec * d2
        for name, run, plain, err in (("admm_tail", a_run, a_ref, errs["admm_tail"]),
                                      ("subspace_apply", s_run, s_ref, errs["subspace_apply"])):
            if name == "admm_tail":
                n_bytes = 4 * (5 * n + 3 * b + d2 + b)  # M, L, Y in; S, Y' out; scalars, mask, rsq
                n_ops = 12 * n
            else:
                n_bytes = 4 * (6 * n + 2 * b * d2 * d2 + 3 * b + d2 + b)  # + P in, G' out
                n_ops = 4 * n * d2 + 16 * n  # X @ P and X'^T X', plus the tail
            t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / flops * 1e3
            ms, plain_ms = bench_ms(run), bench_ms(plain)
            rec[name] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
                shape=[b, vec, d2], mbytes=n_bytes / 1e6,
            )
            print(f"[kernels] {name} main: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={rec[name]['bound_ms']:.4f} ({rec[name]['bound_by']}, "
                  f"{n_bytes / 1e6:.1f} MB) library_ms=null", flush=True)
    return rec


def make_task(device, pretrain_quality=0.0):
    from repro_torch.fed import synth

    # The paper regime of benchmarks/common.py::make_task (alpha 0.3, noise
    # 0.3, domain shift 4.0) at the width of one ViT-B/32 attention
    # projection, with one change: the "pretrained" backbone there (quality
    # 0.4) mixes in a pseudo-inverse of the square Gaussian generator, which
    # at 768 x 768 is so ill-conditioned that it saturates the tanh features
    # and no method learns (``regime_probe`` prints the evidence every run);
    # path A uses a random backbone, quality 0.
    return synth.make_synth_task(
        n_clients=20, n_classes=20, d_in=768, d_feat=768, n_per_client=64, n_test=1024,
        alpha=0.3, lora_rank=4, lora_alpha=8.0, pretrain_quality=pretrain_quality, noise=0.3,
        domain_shift_scale=4.0, seed=1, device=device,
    )


def regime_probe() -> None:
    """Zero-shot accuracy, the share of saturated test features
    (|tanh| > 0.99) and 10-round fedavg accuracy at three backbone
    qualities; fedavg launches no kernel."""
    from repro_torch.fed import synth

    for quality in (0.4, 0.1, 0.0):
        task = make_task("cuda", quality)
        lora0 = synth.init_lora(task, seed=0)
        zero_shot = float(synth.accuracy(task.base, lora0, task.test_x, task.test_y,
                                         task.lora_scale))
        feats = synth.features(task.base, lora0, task.test_x, task.lora_scale)
        saturated = float((feats.abs() > 0.99).float().mean())
        _, hist = run_fed(task, "fedavg", "gram", 10, "cuda")
        print(f"[regime] pretrain_quality={quality}: zero-shot {zero_shot:.4f}, saturated "
              f"features {saturated:.4f}, fedavg acc {[round(float(a), 4) for a in hist]}",
              flush=True)


def run_fed(task, method, svt_mode, rounds, device, log=None):
    from repro_torch.core import AggregatorConfig
    from repro_torch.fed import FedRunConfig, LocalSpec, run_simulation, synth
    from repro_torch.optim import make_optimizer

    local = LocalSpec(
        loss_fn=lambda base, lora, batch: synth.loss_fn(base, lora, batch, task.lora_scale),
        optimizer=make_optimizer("adam", 1e-2), local_steps=8, batch_size=32, lr=1e-2,
    )
    cfg = FedRunConfig(
        aggregator=AggregatorConfig(method=method, rpca_iters=50, svt_mode=svt_mode),
        local=local, rounds=rounds, seed=0,
    )
    evalf = lambda l: synth.accuracy(task.base, l, task.test_x, task.test_y, task.lora_scale)
    lora0 = synth.init_lora(task, seed=0)
    return run_simulation(task.base, lora0, task.client_x, task.client_y, cfg, evalf,
                          log_fn=log, device=device)


def main_path_a(counts) -> None:
    import numpy as np
    import torch
    from repro_torch.fed import synth

    task = make_task("cuda")
    zero_shot = float(synth.accuracy(task.base, synth.init_lora(task, seed=0), task.test_x,
                                     task.test_y, task.lora_scale))
    print(f"[path A] zero-shot accuracy {zero_shot:.4f}", flush=True)
    finals = {}
    for method, mode in (("fedavg", "gram"), ("fedrpca", "gram"), ("fedrpca", "subspace")):
        times = []
        before = counts()
        _, hist = run_fed(task, method, mode, 10, "cuda",
                          log=lambda r, d: times.append(d["t_round_s"]))
        launched = {k: v - before[k] for k, v in counts().items()}
        want = {"admm_tail": 0, "subspace_apply": 0}
        if method == "fedrpca":
            want["admm_tail" if mode == "gram" else "subspace_apply"] = 10 * 50 * 1
        if launched != want:
            raise AssertionError(f"{method}/{mode}: launches {launched} != {want}")
        if not np.isfinite(hist).all() or len(hist) != 10:
            raise AssertionError(f"{method}/{mode}: bad history {hist}")
        finals[f"{method}/{mode}"] = float(hist[-1])
        print(f"[path A] {method}/{mode} acc={np.round(hist, 4).tolist()} "
              f"round_s median={statistics.median(times):.4f} first={times[0]:.4f} "
              f"launches={launched}", flush=True)
    if finals["fedavg/gram"] <= zero_shot:
        raise AssertionError(f"fedavg did not learn: {finals['fedavg/gram']} <= {zero_shot}")
    print(f"[path A] final fedrpca - fedavg: gram "
          f"{finals['fedrpca/gram'] - finals['fedavg/gram']:+.4f}, subspace "
          f"{finals['fedrpca/subspace'] - finals['fedavg/gram']:+.4f}", flush=True)

    cpu_task = make_task("cpu")
    for mode in ("gram", "subspace"):
        gl, gh = run_fed(task, "fedrpca", mode, 3, "cuda")
        cl, ch = run_fed(cpu_task, "fedrpca", mode, 3, "cpu")
        for k in gl:
            torch.testing.assert_close(gl[k].cpu(), cl[k], rtol=1e-3, atol=1e-5)
        if np.max(np.abs(gh - ch)) > 2.0 / 1024 + 1e-9:
            raise AssertionError(f"card vs CPU accuracy {gh} vs {ch}")
        err = max(max_abs(gl[k].cpu(), cl[k]) for k in gl)
        print(f"[path A] card vs CPU fedrpca/{mode} 3 rounds: lora max|err|={err:.3g} "
              f"acc card={gh.tolist()} cpu={ch.tolist()}", flush=True)


def planted_vit_deltas(seed: int, nc: int, n_valid: int | None):
    """Stacked client deltas shaped like paper_vit_b32's LoRA: {q, v} x
    {A: (nc, L, d, r), B: (nc, L, r, d)}; each module a shared rank-2 core,
    client-sparse spikes and noise.  Slots from ``n_valid`` on are zero."""
    import numpy as np
    from repro_torch.configs.paper_vit_b32 import CONFIG

    rng = np.random.default_rng(seed)
    n_l, d, r = CONFIG.n_layers, CONFIG.d_model, CONFIG.lora.rank
    live = nc if n_valid is None else n_valid
    tree = {}
    for target in CONFIG.lora.targets:
        node = {}
        for part, shape in (("A", (n_l, d, r)), ("B", (n_l, r, d))):
            vec = d * r
            core = rng.standard_normal((n_l, vec, 2)) @ rng.standard_normal((n_l, 2, live))
            spikes = np.where(rng.random((n_l, vec, live)) < 0.01,
                              5.0 * rng.standard_normal((n_l, vec, live)), 0.0)
            noise = 0.05 * rng.standard_normal((n_l, vec, live))
            m = 1e-2 * (core + spikes + noise)
            leaf = np.zeros((nc,) + shape, np.float32)
            leaf[:live] = np.moveaxis(m, -1, 0).reshape((live,) + shape)
            node[part] = leaf
        tree[target] = node
    return tree


def main_path_b(counts) -> None:
    import torch
    from repro_torch.convert import from_jax_tree
    from repro_torch.core import AggregatorConfig, aggregate
    from repro_torch.utils.pytree import tree_leaves

    for nc, n_valid in ((40, None), (32, 20)):
        tree = planted_vit_deltas(5, nc, n_valid)
        mask = None if n_valid is None else (torch.arange(nc) < n_valid).float()
        scale = max(abs(x).max() for x in tree_leaves(tree))
        # The library eigh every gram-mode ADMM iteration (and every subspace
        # fallback) runs on the bucket's (48, nc, nc) Gram matrices.
        x = torch.randn((48, 4096, nc), device="cuda")
        gram = x.mT @ x
        eigh_ms = bench_ms(lambda: torch.linalg.eigh(gram), reps=5, batches=3)
        print(f"[path B] torch.linalg.eigh of a (48, {nc}, {nc}) Gram batch: "
              f"{eigh_ms:.3f} ms", flush=True)
        for mode in ("gram", "subspace"):
            cfg = AggregatorConfig(method="fedrpca", rpca_iters=50, svt_mode=mode)
            gpu_tree = from_jax_tree(tree, "cuda")
            gpu_mask = None if mask is None else mask.cuda()
            call = lambda: aggregate(gpu_tree, cfg, engine="packed", mask=gpu_mask)
            before = counts()
            out = call()
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in counts().items()}
            want = {"admm_tail": 50 if mode == "gram" else 0,
                    "subspace_apply": 50 if mode == "subspace" else 0}
            if launched != want:
                raise AssertionError(f"path B {mode}: launches {launched} != {want}")
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            t_call = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = aggregate(from_jax_tree(tree, "cpu"), cfg, engine="packed", mask=mask,
                            device="cpu")
            t_cpu = time.perf_counter() - t0
            err = 0.0
            for g, c in zip(tree_leaves(out), tree_leaves(cpu)):
                if g.shape != c.shape or not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"path B {mode}: bad update leaf {tuple(g.shape)}")
                err = max(err, max_abs(g.cpu(), c))
            if err > AGG_RTOL * scale:
                raise AssertionError(f"path B {mode} nc={nc}: card vs CPU {err} > {AGG_RTOL}*{scale}")
            print(f"[path B] nc={nc} valid={n_valid or nc} {mode}: call_s={t_call:.4f} "
                  f"cpu_call_s={t_cpu:.4f} card-vs-cpu max|err|={err:.3g} (max|delta|={scale:.3g}) "
                  f"launches={launched}", flush=True)


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: the repro_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2

    # Phase 1: card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] {kind} torch {torch.__version__} cuda {torch.version.cuda} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    bw, flops = card_peaks(smi)

    # Phase 2: build.
    from repro_torch.kernels import backend, rpca_admm, svt_subspace

    t0 = time.perf_counter()
    libs = backend.build_all()
    print(f"[build] {len(libs)} kernel libraries in {time.perf_counter() - t0:.2f} s", flush=True)

    # Phase 3: kernels against their plain versions.
    rec = check_kernels("cuda", bw, flops)

    regime_probe()

    wrappers = {"admm_tail": rpca_admm.admm_tail, "subspace_apply": svt_subspace.subspace_apply}
    counts = lambda: {k: w.launches for k, w in wrappers.items()}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    main_path_a(counts)
    main_path_b(counts)
    launches = counts()
    print(f"[main path] {time.perf_counter() - t0:.1f} s, launches {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main path")

    sources = {
        "admm_tail": ("src/repro_torch/kernels/csrc/admm_tail.cu",
                      "src/repro/kernels/rpca_admm.py:121"),
        "subspace_apply": ("src/repro_torch/kernels/csrc/subspace_apply.cu",
                           "src/repro/kernels/svt_subspace.py:154"),
    }
    kernels = []
    for name, r in rec.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
