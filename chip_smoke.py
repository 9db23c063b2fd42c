#!/usr/bin/env python3
"""Drive the PyTorch port of FedRPCA on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

  1. Card: name and power limit (nvidia-smi), TF32 switched off.
  2. Build: the CUDA kernels of ``src/repro_torch/kernels/csrc`` from source.
  3. Kernel checks, each kernel against its plain PyTorch version on the
     card, two launches bit for bit; times are device time per call from
     ``torch.profiler`` (``kernel_ms``, ``plain_ms``, ``library_ms``; by
     CUDA events behind a sleep kernel when three profiler captures come
     back empty), with the host-inclusive time per call by CUDA events
     beside them (``call_ms``):
     ``admm_tail`` and ``subspace_apply`` at every bucket shape paths A and
     B launch them at (path B's ViT-B/32 LoRA bucket: 48 modules x 4096
     rows, 3072 of them live, 40 dense clients, 20 of 32, and 32 slots
     with holes, slots 3, 7 and 20-31 off, as dropout, stragglers and the
     quarantine leave them; path A's 2 x 4096 x 20 bucket), timed there,
     and at ragged shapes (d2 = 130 dense and with holes),
     ``mask=None`` the bits of an all-ones mask, each shape's
     ``subspace_apply`` route printed and held to ``svt_subspace.route``
     (tensor cores in 3xTF32 up to d2 = 128, fp32 FMA above); ``lora_matmul`` and ``gathered_lora_matmul`` at
     (M, K, N, R) = (4096, 2048, 2048, 8) (prefill q and v), (8, ...)
     (decode) and (129, 513, 130, 8), float32 and bf16, on a layer's slice
     of an 8-slot pool with 4 tenants, slot -1 the bits of a zero adapter,
     one slot on every row equal to ``lora_matmul``, also at Mamba-2's
     ``in_proj`` (4096, 768, 3352) and ``out_proj`` (4096, 1536, 768), each
     bf16 shape timed beside cuBLAS ``x @ W``; ``local_attention`` at (BH,
     S, D) = (256, 512, 64), S = 300 and window 128, float32 and bf16,
     beside ``F.scaled_dot_product_attention`` (timed only), and
     ``causal=False`` at (256, 512, 64); at D = 256, path J's prefill (80,
     2560, 256) with window 2048, timed beside SDPA with the same boolean
     causal-window mask, S = 2100, and path L1's full-causal prefill (128,
     512, 256) beside SDPA ``is_causal=True``; path N's encoder (128, 1500,
     64) bidirectional beside SDPA ``is_causal=False`` and its decoder
     prefill (128, 416, 64), path O's prefill (96, 512, 128); the gathered
     LoRA kernel also at the q / v shapes of paths L and M (``LORA_LM``: K
     -> N of 3072 -> 4096, 5120 -> 5120, 5120 -> 1024, 8192 -> 8192, 8192
     -> 1024, 1024 -> 1024 and 1024 -> 512), each at prefill (M = 4096) and
     decode (M = 8, K split), and at those of paths N and O (``LORA_NO``:
     (M, K, N) = (3328, 1024, 1024), (12000, 1024, 1024), (4096, 1536,
     1536), (4096, 1536, 256), and each at M = 8).  Each checked
     shape prints its route (``lora_matmul.route``,
     ``local_attention.route``: bf16 on the tensor cores, float32 and the
     ragged bf16 LoRA shape on fp32 FMA) and its tensor-route launches must
     match it; each bf16 attention row also prints the route's geometry
     (``local_attention.tc_geometry``: BQ, BN, stages, shared bytes,
     registers), which must be ``tc_plan``'s; ``ssd_scan`` (y and the final state) at (BH, S, P, N) =
     (192, 512, 64, 128) and S = 300, the model's decays and weak ones, and
     at odd widths, its bound at a third of the TF32 tensor rate (3xTF32),
     the fp32-core bound printed beside it; ``soft_threshold`` at path B's bucket flattened to
     (196608, 40) and at (129, 130), float32 and bf16, equal bits, beside
     ``F.softshrink`` (timed only); ``subspace_apply_factored`` at path F's
     shard shape (B, vec, d2, r) = (48, 4096, 10, 8), at the last shard of 30
     clients padded to 32 (two zero-mask columns) and at (3, 1000, 7, 3).
     Then each kernel's autograd ``Function`` at path I's shapes
     (``TRAIN_FN_CASES``): its forward launches the kernel once with the
     no-grad bits, its plain backward's gradients hold to the plain
     version's autograd, and forward and backward device ms are printed.
  4. Main path A: ``run_simulation`` on a planted task at the width of one
     ViT-B/32 attention projection (768 x 768, LoRA rank 4), 20 clients,
     10 rounds of fedavg / task_arithmetic / ties / fedexp / dare / fedrpca
     gram / fedrpca subspace; then 3 rounds of fedrpca (both modes) on the
     card and on the CPU from the same weights and batches, as are ties and
     dare (dare's keep masks come from the same CPU generator); 3 rounds of
     fedexp held round by round, the CPU running each round from the card's
     previous state (FedExP's extrapolation compounds a difference from
     round to round), with the CPU's own chain printed beside it.
     Before it, a regime probe: zero-shot accuracy, saturated-feature share
     and 10-round fedavg accuracy at the backbone qualities 0.4 (the
     reference benchmarks'), 0.1 and 0.0 (path A's).
  5. Main path B: ``aggregate(engine="packed")`` of a planted delta tree of
     ``configs/paper_vit_b32.py``'s LoRA (q and v, 12 layers) at 40 dense
     clients and 20 clients padded to 32, both SVT modes, against the same
     call on the CPU, with the exact-eigh fallback counts of both.
  6. Main path C: multi-tenant serving of ``configs/stablelm_1_6b.py`` at
     full width (24 layers, bf16, random weights from a seed): 8 requests of
     4 tenants, prompt 512, 32 greedy tokens, through ``RequestScheduler``,
     ``serve_batch`` and an 8-slot ``AdapterPool``; the same prompts through
     the merged adapter; one tenant on every row against its 2-D adapter;
     a FedRPCA aggregate of 4 client deltas hot-swapped into tenant 0 with
     ``publish_round`` and decoded again (only tenant 0 moves, the pool keeps
     its storage); a profiled decode window and a profiled warm prefill; and
     the serving run at depth 2 in float32 on the card and on the CPU.
     Prefill seconds, decode tokens/s and peak memory beside the card's name
     and power limit.
  7. Main path D: the same serving of ``configs/mamba2_130m.py`` at full
     width (24 layers, bf16): pool, merged, one tenant, a profiled prefill
     and decode window; the state handoff (decoding token S+1 after a
     prefill of S tokens against a prefill of S+1, 24 layers in float32,
     and the same decode from a zeroed state, which must miss); depth 2 in
     float32 on the card and on the CPU.
  8. Path E: ``ops.soft_threshold`` at ranks 3, 2 and 1.
  9. Main path F: mesh-sharded ``aggregate(engine="packed",
     mesh=make_host_mesh(4))`` of path B's tree (4 shards on the card) at 40
     dense clients, 30 padded to 32 and 20 of 32 in subspace mode and 40 in
     gram mode, each against the unsharded call on the card and the same
     call on a CPU mesh; 2 shards against 4; ``mesh_overlap=True`` against
     False, bit for bit; ``run_simulation(mesh_shards=4)`` on path A's task
     against ``mesh_shards=0``.
 10. Main path G: cross-round aggregation sessions on the card, each
     against the same session on the CPU round by round (updates within
     1e-4 x max|delta|, equal fallbacks, hits and tiers): G1 ``AggSession``
     with subspace SVT and ``carry_mode="subspace"`` on path B's tree over 4
     drifting rounds (round r = 0.8 M_0 + 0.2 M_r), 50 iterations, at 40
     dense clients and 20 of 32, warm rounds all hits; G2
     ``carry_mode="full"`` in gram mode with the tolerance loop (3e-4),
     held module by module, and each round also from the card's state
     (``check_modules``); G3 G1's 40 and 30 (ragged) sessions on
     ``make_host_mesh(4)``, also against the unsharded card session, the
     30-client one within ``G_RITZ_RTOL`` from its first all-Ritz warm round
     on, beside three witnesses (the plain version on the card, the CPU's
     unsharded session, and a TF32 control that must fail that bound); G4
     re-tiering every 2 rounds; G5 ``run_simulation`` with the carry on path
     A's task, 3 rounds card vs CPU, then 10 rounds beside path A's
     stateless fedrpca.
 11. Main path H, the rest of the federated round, on path A's task at
     full width, each part also 3 rounds on the card against the CPU on the
     same inputs: H1 the client objectives of Table 1 and Fig. 5 (fedprox
     mu 0.01, scaffold and moon mu 0.1 under fedavg; fedrpca+fedprox and
     fedrpca+scaffold), 10 rounds each beside path A's fedavg; H2 partial
     participation, 20 of 40 clients in 32 slots, each sampler in both SVT
     modes on cohorts drawn ahead and given to both devices, and an
     ``n_active=12`` round; H3 the pipeline: ``pipeline=True, staleness=0``
     the bits of ``pipeline=False``, staleness 2 landing in order, with
     each round's ``t_local_s``, ``t_agg_s`` and ``t_overlap_s``; H4 faults
     at staleness 2 with the guard on (``nan:0.1,dropout:0.2`` and, with
     deadline cohorts, ``straggler:0.5``): ``screen_clean`` 1 every round,
     every injected fault caught, a finite global, and a forced non-finite
     aggregation taking the cold retry and then the masked-FedAvg fallback.
 11b. Main path I, federated LoRA fine-tuning of an LM through
     ``launch.train.main``: I1 StableLM-2-1.6B at full width and depth
     (bf16, LoRA r 8 on q and v), 8 clients x 2 x 256 tokens, 2 Adam steps,
     3 rounds of FedRPCA with subspace SVT and carry, the fused tail and the
     sketch uplink; I2 Mamba-2-130M the same with client ranks 8, 4, 2 and
     the pipeline at staleness 1; each prints its round times, uplink hit
     rate, bytes, eval loss before and after and peak memory, and fails
     unless the state is finite and the eval loss falls.  I3 one local phase
     card vs CPU from the card's LoRA (StableLM at 2 layers, Mamba-2 at full
     depth, float32; held with SGD, Adam printed beside a CPU witness), a
     profiled local phase of I1's shape (device-busy share, top kernels),
     and one warm session round on I1's tree and carry with
     the uplink ``sketch:64:1.0``, card vs CPU, the sketch taken on both.
 11c. Main path J, multi-tenant serving of ``configs/recurrentgemma_2b.py``
     at full width and depth (26 layers: 18 RG-LRU, 8 sliding-window
     attention, 2 of them tail layers; bf16, LoRA r 8): J1 8 requests of 4
     tenants in 8 slots, a 2560-token prompt past the 2048 window (the ring
     wraps), 32 greedy tokens, with prefill s, decode tokens/s, a profiled
     decode window and warm prefill, peak memory; J2 the merged adapter and
     one tenant on every row against its 2-D adapter; J3 a FedRPCA
     aggregate of planted client deltas (tail leaves included) published
     into tenant 0, decoded again (only tenant 0's rows move); J4 card vs
     CPU in float32 at depth 5 with the window set to 64, prompts 96 and 40,
     8 decode steps; J5 depth 5 in float32 at the real window, prompt 2100,
     each of 4 decode steps against the train-mode forward (and a zeroed
     ring, which must miss).  Path J's wall time is printed.
 11d. Main path K, federated LoRA training through ``launch.train.main``
     with path I1's flags: K1 ``configs/recurrentgemma_2b.py`` at full
     width and depth (26 layers, the RG-LRU scan differentiated by its
     reverse-scan Function, two recurrent tail layers), K2
     ``configs/granite_moe_1b_a400m.py`` at full width and depth (24 layers
     of 32 experts, top-8, routed per client); each prints its round times,
     peak memory and eval loss before and after (it must fall); K3 one local
     phase of each card vs CPU from the card's LoRA in float32
     (RecurrentGemma at depth 5, Granite at depth 2; SGD held at
     ``STATE_FRO_RTOL``, the experts chosen compared call by call).
 11e. Main path L, serving the dense configs of slice 11 as path C (8
     requests of 4 tenants, prompt 512, 32 tokens, bf16): L1
     ``configs/gemma_7b.py`` at full width and depth (28 layers, head width
     256, full causal), L2 ``configs/qwen1_5_32b.py`` at 32 of 64 layers,
     L3 ``configs/deepseek_67b.py`` at 24 of 95 (untied head); prefill s,
     decode tokens/s and peak memory; each also card vs CPU at depth 2 in
     float32, prompts 96 and 40, 8 decode steps.
 11f. Main path M, serving the MoE configs the same way: M1
     ``configs/granite_moe_1b_a400m.py`` at full width and depth, a profiled
     decode window and warm prefill with the MoE layers' host and device
     time marked (``moe_spans``), card vs CPU at depth 4 with the routing compared first
     (a flip fails with its probability gap); M2
     ``configs/llama4_maverick_400b_a17b.py`` at full width and depth 1
     (128 experts at d_ff 8192, 32 GB), its MoE layer against a float32
     loop over the experts on the same routing (``M_LOOP_RTOL``).  Each
     path's wall time is printed.
 11g. Main path N, serving ``configs/whisper_medium.py`` at full width
     and depth (24 encoder and 24 decoder layers, bf16, LoRA r 8 on the
     self- and cross-attention q and v): N1 8 requests of 4 tenants over
     stub frames (8, 1500, 1024), prompt 416, 32 tokens, prefill s, decode
     tokens/s, peak memory, the cross caches' bytes, a profiled decode
     window and warm prefill; N2 card vs CPU in float32 at encoder and
     decoder depth 2, prompt 96, 8 decode steps.
 11h. Main path O, serving ``configs/qwen2_vl_2b.py`` at full width and
     depth (28 layers, bf16): O1 path C's traffic with the first 256 of the
     512 prompt positions the vision stub's, a profiled decode window, card
     vs CPU at depth 2 (prompt 320) and a train-mode forward with explicit
     M-RoPE positions (a 16 x 16 grid, then text) card vs CPU; O2 the same
     traffic with the int8 KV cache (decode tokens/s, the cache's bytes
     against O1's, prefill logits equal to O1's, top-1 against O1's logits
     with O1's tokens fed, card vs CPU at depth 2 with the int8 values at
     most one step apart in at most ``KV_FLIP_SHARE`` of them); O3 one
     local phase of Whisper and of Qwen2-VL with the stubs through
     ``launch/steps.py`` at depth 2, card vs CPU as path K3.
 12. The card tests: ``pytest -m gpu tests/test_torch_cuda.py`` in a
     subprocess with its own time limit; any failure, error or skip fails
     the script, and the counts and wall time go on a ``[card tests]``
     line.
 13. A ``[train fn]`` line (each Function's forward and backward ms with
     path I's launches), the ``kernels`` JSON line (each kernel's launches
     on all paths and on paths J, K, L, M, N and O, ``local_attention``
     also at path J's, path L1's and path N's encoder prefill shapes,
     ``gathered_lora_matmul`` at the q / v shapes of paths L, M, N and O),
     the wall time, then the result line.

Kernel launch counts are set to 0 just before phase 4 and read just after
phase 5, and set to 0 again just before each of phases 6, 7, 8, 9, 10, 11,
11b, 11c, 11d, 11e, 11f, 11g and 11h and read just after it; every kernel must have launched, and
each phase exactly as often as its rounds, ADMM iterations, fallbacks,
shards, buckets, layers and decode steps say.  Beside them the
tensor-route launches of the subspace, LoRA and attention kernels are
counted: paths A and B must launch every ``subspace_apply`` call on the
tensor route, and paths C, D and J every bf16 call on it and every float32
one (the card-vs-CPU runs, the state handoff, J5) off it.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
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
# A 32-slot cohort with holes: slots 3, 7 and 20-31 off (dropout, stragglers,
# the quarantine and the trace sampler make such masks).
H_HOLES = (3, 7, *range(20, 32))
# Per-client round state (deltas, local models, SCAFFOLD's client variates)
# card vs CPU, relative to each leaf's norm: an element whose Adam second
# moment sits near eps moves with its gradient's last bits
# (tools/round_sensitivity.py: a 1e-7 perturbation of the backbone moves such
# elements of FedAvg's local models 7.9e-6 past rtol 1e-3 / atol 1e-5, and
# whole leaves 6.1e-6 of their norm).
STATE_FRO_RTOL = 1e-4


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


def bf16_peak(name: str) -> float:
    """Dense bf16 tensor-core FLOP/s of the card, from NVIDIA's data sheets."""
    if "H100" in name and "PCIe" in name:
        return 756e12
    if "H100" in name and "NVL" in name:
        return 835e12
    return 989e12  # H100 / H200 SXM


def bench_ms(fn, reps: int = 20, batches: int = 5) -> float:
    """Median over ``batches`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up: the time a caller waits per
    call, host dispatch included when it is slower than the device."""
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


PROFILER_TRIES = 3


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: the durations of the kernels it
    runs, from ``torch.profiler`` (device rows only), summed over ``reps``
    calls after a warm-up and divided by ``reps``.  Host dispatch that is
    slower than the kernels (a Python wrapper around a 20 us kernel) does
    not count, as it does in ``bench_ms``; gaps between the kernels of one
    call do not count either.

    The profiler's device trace now and then comes back empty.  The capture
    is then taken again, up to ``PROFILER_TRIES`` times, and after that the
    time comes from ``queued_ms`` (CUDA events), with a line saying so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(dev(e) for e in prof.key_averages() if e.device_type != DeviceType.CPU)
        if total > 0:
            return total / reps / 1e3
    ms = queued_ms(fn, reps)
    print(f"[timing] torch.profiler saw no device time in {PROFILER_TRIES} captures; "
          f"{ms:.6f} ms per call by CUDA events behind a sleep kernel", flush=True)
    return ms


def device_ms_by_kernel(fn, reps: int = 20) -> dict:
    """Device time per call of each kernel ``fn`` launches, by name (the
    first 40 characters), from one ``torch.profiler`` capture after a
    warm-up; empty when the trace comes back empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    return {e.key[:40]: round(dev(e) / reps / 1e3, 4) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and dev(e) > 0}


def queued_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` by CUDA events: a sleep kernel holds
    the stream while the host queues ``reps`` calls, so the events time the
    queued work and not its dispatch (gaps between kernels included)."""
    import torch

    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clock: room to queue
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


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


def client_mask(d2, n_valid):
    """None (dense), the first ``n_valid`` columns live, or, for a tuple,
    every column live but those it names (a mask with holes)."""
    import torch

    if n_valid is None:
        return None
    if isinstance(n_valid, tuple):
        mask = torch.ones(d2)
        mask[list(n_valid)] = 0.0
        return mask
    return (torch.arange(d2) < n_valid).float()


def bucket_inputs(gen, b, vec, live_rows, d2, n_valid, device):
    """Bucket tensors as the ADMM loop sees them: rows past ``live_rows``
    zero, the masked columns of M zero (``client_mask``)."""
    import torch

    def t(scale=1.0):
        x = torch.randn((b, vec, d2), generator=gen) * scale
        x[:, live_rows:] = 0.0
        return x

    m, l, s, y = t(), t(), t(0.5), t(0.1)
    mask = client_mask(d2, n_valid)
    if mask is not None:
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
        (48, 4096, 3072, 32, H_HOLES, "holes"),
        (2, 4096, 3072, 20, None, "path A"),
        (5, 1000, 1000, 1, None, "ragged"),
        (5, 1000, 999, 3, None, "ragged"),
        (3, 1000, 777, 128, 100, "ragged"),
        (3, 1000, 1000, 130, None, "ragged"),
        (3, 1000, 1000, 130, (0, 5, 64, *range(100, 130)), "ragged"),
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
        route = svt_subspace.route(d2)
        for name, run, plain, n_elem in (("admm_tail", a_run, a_ref, 2),
                                         ("subspace_apply", s_run, s_ref, 3)):
            tc_before = svt_subspace.subspace_apply.tc_launches
            got, again, want = run(), run(), plain()
            torch.cuda.synchronize()
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"{name} {label}: two launches differ")
            tc_got = svt_subspace.subspace_apply.tc_launches - tc_before
            if name == "subspace_apply" and tc_got != (2 if route == "tensor" else 0):
                raise AssertionError(f"subspace_apply {label}: launched off its route {route}")
            err = max(check_elem(g, w, f"{name} {label}") for g, w in zip(got[:n_elem], want[:n_elem]))
            for g, w in zip(got[n_elem:], want[n_elem:]):
                check_sum(g, w, f"{name} {label} sums")
            if msk is not None:
                off = msk == 0
                for g in got[n_elem - 2:n_elem]:  # S', Y': masked columns exactly zero
                    if bool((g[..., off] != 0).any()):
                        raise AssertionError(f"{name} {label}: masked column not zero")
            else:
                ones = torch.ones(d2, device=device)
                with_ones = (rpca_admm.admm_tail(*a_args, mask=ones) if name == "admm_tail"
                             else svt_subspace.subspace_apply(*s_args, mask=ones))
                if not all(torch.equal(u, v) for u, v in zip(got, with_ones)):
                    raise AssertionError(f"{name} {label}: mask=None differs from all-ones")
            errs[name] = err
        valid = n_valid if not isinstance(n_valid, tuple) else f"{d2 - len(n_valid)}(holes)"
        line = (f"[kernels] {label} B={b} vec={vec} live={live} d2={d2} valid={valid} "
                f"subspace_apply route={route}")
        print(line, " ".join(f"{k}_err={v:.3g}" for k, v in errs.items()), flush=True)
        if label not in ("main", "masked", "holes", "path A"):
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
            ms, plain_ms, call_ms = device_ms(run), device_ms(plain), bench_ms(run)
            out = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
            )
            if label == "main":
                rec[name] = out
            print(f"[kernels] {name} {label} ({b}, {vec}, {d2}): kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={out['bound_ms']:.4f} ({out['bound_by']}, "
                  f"{n_bytes / 1e6:.1f} MB) library_ms=null call_ms={call_ms:.4f}", flush=True)
    return rec

# (B, vec, live rows, d2, r, mask, label) of the factored tail: path F's shard of
# the ViT-B/32 bucket at 40 clients on 4 shards; the last shard of 30 clients
# padded to 32 (two zero-mask columns); a ragged shape.
FACTORED_SHAPES = [(48, 4096, 3072, 10, 8, None, "main"),
                   (48, 4096, 3072, 8, 8, [1.0] * 6 + [0.0] * 2, "padded shard"),
                   (3, 1000, 1000, 7, 3, None, "ragged")]


def check_factored_kernel(bw, flops) -> dict:
    """subspace_apply_factored against its plain version on the card: two
    launches bit for bit, ``mask=None`` the bits of an all-ones mask, masked
    columns of S' and Y' exactly zero; timed at path F's shard shape."""
    import torch
    from repro_torch.kernels import ref, svt_subspace

    gen = torch.Generator().manual_seed(17)
    rec = {}
    for b, vec, live, d2, r, mask, label in FACTORED_SHAPES:
        x = bucket_inputs(gen, b, vec, live, d2, None, "cuda")
        f = torch.randn((b, vec, r), generator=gen)
        f[:, live:] = 0.0  # rows of W = X V past the live rows are zero
        f = f.cuda()
        vr = (torch.randn((b, d2, r), generator=gen) / d2**0.5).cuda()
        msk = None if mask is None else torch.tensor(mask, device="cuda")
        m = x["m"] if msk is None else (x["m"] * msk).contiguous()
        args = (m, x["y"], f, vr, x["rho"], x["mu"], x["th"])
        run = lambda: svt_subspace.subspace_apply_factored(*args, mask=msk)
        plain = lambda: ref.svt_subspace_apply_factored_ref(*args, mask=msk)
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        tag = f"{label} (B, vec, d2, r)=({b}, {vec}, {d2}, {r}) mask={mask}"
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise AssertionError(f"subspace_apply_factored {tag}: two launches differ")
        err = max(check_elem(g, w, f"subspace_apply_factored {tag}")
                  for g, w in zip(got[:3], want[:3]))
        check_sum(got[3], want[3], f"subspace_apply_factored {tag} sums")
        if msk is None:
            ones = svt_subspace.subspace_apply_factored(*args, mask=torch.ones(d2, device="cuda"))
            if not all(torch.equal(u, v) for u, v in zip(got, ones)):
                raise AssertionError(f"subspace_apply_factored {tag}: mask=None differs from "
                                     "all-ones")
        elif bool((got[1][..., msk == 0] != 0).any() or (got[2][..., msk == 0] != 0).any()):
            raise AssertionError(f"subspace_apply_factored {tag}: masked column not zero")
        n = b * vec * d2
        # M, Y, F, Vr, scalars, mask in; L, S', Y', rsq out.
        n_bytes = 4 * (5 * n + b * vec * r + b * d2 * r + 3 * b + d2 + b)
        n_ops = n * (2 * r + 12)
        t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / flops * 1e3
        bound = max(t_bytes, t_ops)
        line = (f"[kernels] subspace_apply_factored {tag}: err={err:.3g} bound_ms={bound:.4f} "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}, {n_bytes / 1e6:.1f} MB, "
                f"{n_ops / 1e6:.1f} MFLOP)")
        if label != "main":
            print(line, flush=True)
            continue
        ms, plain_ms, call_ms = device_ms(run), device_ms(plain), bench_ms(run)
        rec["subspace_apply_factored"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
        )
        print(f"{line} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=null (no single "
              f"PyTorch call) call_ms={call_ms:.4f}", flush=True)
    return rec


# --- Serving kernels (phase 3) ------------------------------------------------
# lora_matmul / gathered_lora_matmul against their plain versions.  float32:
# sums of K products taken in two orders (scalar FMA kernel vs cuBLAS), so the
# error grows as sqrt(K) fp32 ulps of the largest output.  bfloat16: both round
# fp32 sums to bf16, once for x @ A and once for the output, so they may land
# one bf16 ulp apart in each; two ulps of the largest output.
LORA_F32_RTOL_PER_SQRT_K = 1e-6
LORA_BF16_RTOL = 2.0**-6
# local_attention: float32 online vs materialized softmax, O(1) outputs.
ATTN_F32_ATOL = 2e-5
# bfloat16: one ulp of the largest output of the whole tensor, and a bound
# entry by entry from the kernel's arithmetic: it rounds each p_j to bf16
# before P V (relative error at most u = 2^-8, bf16's unit roundoff), which
# moves an output sum_j p_j v_j / l by at most u sum_j p_j |v_j| / l (the
# plain version run on |v|); both fp32 sums over up to ~2048 keys add at most
# 2^-12 of that; each result then rounds to bf16 (at most u of itself).  The
# whole-tensor bound alone is ~30x too loose for the late rows of a long
# window, which average ~2048 values (row 0's output is v_0), and would not
# see a lost key tile there.
ATTN_BF16_RTOL = 2.0**-7
ATTN_BF16_U = 2.0**-8
ATTN_BF16_SUM_RTOL = 2.0**-12
# The controls that must fail the bf16 bound: the plain version with each
# row's window cut by one 32-key tile, and grown by one.
ATTN_CONTROL_KEYS = 32
LORA_SHAPES = [(4096, 2048, 2048, 8, "prefill"), (8, 2048, 2048, 8, "decode"),
               (129, 513, 130, 8, "ragged"), (4096, 768, 3352, 8, "mamba2 in_proj"),
               (8, 768, 3352, 8, "mamba2 in_proj decode"),
               (4096, 1536, 768, 8, "mamba2 out_proj"),
               (8, 1536, 768, 8, "mamba2 out_proj decode")]
# The q / v projections (K -> N) of paths L and M, each at prefill (8 x 512
# rows, the tensor route in one K pass) and at decode (8 rows, K split):
# Gemma-7B q and v; Qwen1.5-32B q and v and Llama-4-Maverick q; Llama-4 v;
# DeepSeek-67B q; DeepSeek v; Granite q; Granite v.  Each gathered call's
# times go into the kernels line under its label.
LORA_LM = {"gemma_qv": (3072, 4096), "qwen_qv": (5120, 5120), "llama4_v": (5120, 1024),
           "deepseek_q": (8192, 8192), "deepseek_v": (8192, 1024),
           "granite_q": (1024, 1024), "granite_v": (1024, 512)}
LORA_SLICE11 = [*LORA_LM, *(f"{key}_decode" for key in LORA_LM)]
LORA_SHAPES += [(4096, k, n, 8, key) for key, (k, n) in LORA_LM.items()]
LORA_SHAPES += [(8, k, n, 8, f"{key}_decode") for key, (k, n) in LORA_LM.items()]
# The adapted projections (M, K, N) of paths N and O at prefill, each also at
# decode (M = 8, K split): Whisper's self and cross q and v on the decoder's
# 8 x 416 rows, its cross v on the encoder's 8 x 1500 rows; Qwen2-VL's q and
# its v (N = 256, two kv heads of 128).
LORA_NO = {"whisper_qv": (3328, 1024, 1024), "whisper_cross_v": (12000, 1024, 1024),
           "qwen2vl_q": (4096, 1536, 1536), "qwen2vl_v": (4096, 1536, 256)}
LORA_SLICE12 = [*LORA_NO, *(f"{key}_decode" for key in LORA_NO)]
LORA_SHAPES += [(m, k, n, 8, key) for key, (m, k, n) in LORA_NO.items()]
LORA_SHAPES += [(8, k, n, 8, f"{key}_decode") for key, (m, k, n) in LORA_NO.items()]
# (BH, S, D, window, causal, label); "bidirectional" is the encoder's call
# (causal=False), checked and not timed.  "rg-prefill" is path J's prefill
# (8 requests x 10 heads, S 2560 past the window of 2048, D 256), "rg ragged"
# a length that is no multiple of the tiles (J5's prompt), "gemma-prefill"
# path L1's (8 requests x 16 heads, S 512, D 256, full causal).
ATTN_SHAPES = [(256, 512, 64, 0, True, "prefill"), (256, 300, 64, 0, True, "ragged"),
               (256, 512, 64, 128, True, "window"), (256, 512, 64, 0, False, "bidirectional"),
               (80, 2560, 256, 2048, True, "rg-prefill"), (80, 2100, 256, 2048, True, "rg ragged"),
               (128, 512, 256, 0, True, "gemma-prefill"),
               # Path N's encoder (8 requests x 16 heads over 1500 frames, no
               # mask, no multiple of the tiles) and decoder prefill (416
               # positions); path O's prefill (8 x 12 heads, K and V repeated
               # 6x for the 2 kv heads, D 128).
               (128, 1500, 64, 0, False, "whisper-encoder"),
               (128, 416, 64, 0, True, "whisper-decoder"),
               (96, 512, 128, 0, True, "qwen2vl-prefill")]
ATTN_UNTIMED = ("ragged", "bidirectional", "rg ragged")
# Where each timed row's numbers go: phase 3's record, and (past the first)
# the local_attention entry of the kernels line, under ATTN_KERNELS_KEY.
ATTN_RECORD = {"prefill": "local_attention", "window": "local_attention_window",
               "rg-prefill": "local_attention_rg", "gemma-prefill": "local_attention_gemma",
               "whisper-encoder": "local_attention_encoder",
               "whisper-decoder": "local_attention_whisper_dec",
               "qwen2vl-prefill": "local_attention_qwen2vl"}
ATTN_KERNELS_KEY = {"local_attention_window": "window_prefill",
                    "local_attention_rg": "rg_prefill",
                    "local_attention_gemma": "gemma_prefill",
                    "local_attention_encoder": "encoder_prefill",
                    "local_attention_whisper_dec": "whisper_dec_prefill",
                    "local_attention_qwen2vl": "qwen2vl_prefill"}
TENANT_SLOTS = (1, 3, 4, 6)  # 4 tenants resident in a pool of 8 slots


def check_close(got, want, tol, what: str) -> float:
    err = max_abs(got, want)
    if not err <= tol:
        raise AssertionError(f"{what}: max |err| {err} > {tol}")
    return err


def lora_tol(dtype, k, want) -> float:
    import torch

    scale = float(want.double().abs().max())
    if dtype == torch.float32:
        return LORA_F32_RTOL_PER_SQRT_K * k**0.5 * scale
    return LORA_BF16_RTOL * scale


def request_slots(m: int, n_requests: int, slots):
    """Row slots of ``m`` rows cut into ``n_requests`` requests in order,
    request r naming slots[r]."""
    import torch

    req = torch.arange(m) * n_requests // m
    return torch.as_tensor(slots, dtype=torch.int32)[req].cuda()


def check_lora_kernels(bw, fp32_flops, tensor_flops) -> dict:
    """Both LoRA kernels against their plain versions on a pool laid out as
    the serving pool is ((n_slots, n_layers, K, R), used through a layer's
    slice), bitwise repeatable, slot -1 equal to a zero adapter bit for bit,
    one slot on every row equal to ``lora_matmul`` with that adapter."""
    import torch
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ref

    rec = {}
    for m, k, n, r, label in LORA_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(m + k + n)
            x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
            w = ((torch.rand((k, n), generator=g, device="cuda") * 2 - 1) / k**0.5).to(dtype)
            a_pool = torch.randn((8, 3, k, r), generator=g, device="cuda") / k**0.5
            b_pool = torch.randn((8, 3, r, n), generator=g, device="cuda") / r**0.5
            a, b = a_pool[:, 1], b_pool[:, 1]  # layer 1's slice, slot stride 3*K*R
            scale = 2.0
            rs = request_slots(m, 8, [TENANT_SLOTS[i % 4] for i in range(8)])
            route = lm.route(k, n, dtype)
            splits = lm.k_splits(m, n, k, route)
            if route == "tensor" and (splits > 1) != (m == 8):
                raise AssertionError(f"{label}: {splits} K splits on the tensor route, where "
                                     f"decode (M = 8) and only decode splits K")
            tag = (f"{label} M={m} K={k} N={n} R={r} {str(dtype)[6:]} route={route} "
                   f"k_splits={splits}")
            tc_before = lm.lora_matmul.tc_launches + lm.gathered_lora_matmul.tc_launches

            run1 = lambda: lm.lora_matmul(x, w, a[3], b[3], scale)
            plain1 = lambda: ref.lora_matmul_ref(x, w, a[3], b[3], scale)
            got, again, want = run1(), run1(), plain1()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"lora_matmul {tag}: two launches differ")
            err1 = check_close(got, want, lora_tol(dtype, k, want), f"lora_matmul {tag}")

            rung = lambda: lm.gathered_lora_matmul(x, w, a, b, rs, scale)
            plaing = lambda: ref.gathered_lora_matmul_ref(x, w, a, b, rs, scale)
            gotg, againg, wantg = rung(), rung(), plaing()
            torch.cuda.synchronize()
            if not torch.equal(gotg, againg):
                raise AssertionError(f"gathered_lora_matmul {tag}: two launches differ")
            errg = check_close(gotg, wantg, lora_tol(dtype, k, wantg),
                               f"gathered_lora_matmul {tag}")
            # Requests 0 and 5 without an adapter == the same rows on an all-zero slot.
            rs_none = request_slots(m, 8, [-1 if i in (0, 5) else TENANT_SLOTS[i % 4]
                                           for i in range(8)])
            a_z, b_z = a_pool.clone(), b_pool.clone()
            a_z[7], b_z[7] = 0.0, 0.0
            no_adapter = lm.gathered_lora_matmul(x, w, a, b, rs_none, scale)
            zero = lm.gathered_lora_matmul(x, w, a_z[:, 1], b_z[:, 1],
                                           torch.where(rs_none < 0, 7, rs_none), scale)
            if not torch.equal(no_adapter, zero):
                raise AssertionError(f"gathered_lora_matmul {tag}: slot -1 != zero adapter")
            one = lm.gathered_lora_matmul(x, w, a, b, torch.full_like(rs, 3), scale)
            err_one = check_close(one, got, lora_tol(dtype, k, got),
                                  f"gathered (one slot) vs lora_matmul {tag}")
            tc = lm.lora_matmul.tc_launches + lm.gathered_lora_matmul.tc_launches - tc_before
            if tc != (7 if route == "tensor" else 0):
                raise AssertionError(f"{tag}: {tc} tensor-route launches of 7")
            print(f"[kernels] {tag}: lora_matmul_err={err1:.3g} gathered_err={errg:.3g} "
                  f"one_slot_vs_lora_matmul={err_one:.3g} slot-1==zero-adapter bitwise",
                  flush=True)
            if dtype != torch.bfloat16 or label == "ragged":
                continue
            peak = tensor_flops if dtype == torch.bfloat16 else fp32_flops
            elt = x.element_size()
            n_ops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n
            base_bytes = elt * (m * k + k * n + m * n)
            floor_ms = device_ms(lambda: x @ w)
            for name, run, plain, err, n_bytes in (
                ("lora_matmul", run1, plain1, err1, base_bytes + 4 * (k * r + r * n)),
                ("gathered_lora_matmul", rung, plaing, errg,
                 base_bytes + 4 * len(TENANT_SLOTS) * (k * r + r * n) + 4 * m),
            ):
                t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / peak * 1e3
                ms, plain_ms, call_ms = device_ms(run), device_ms(plain), bench_ms(run)
                out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           library_ms=None, base_gemm_ms=floor_ms)
                print(f"[kernels] {name} {tag}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"bound_ms={out['bound_ms']:.4f} ({out['bound_by']}, "
                      f"{n_ops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB) library_ms=null "
                      f"cublas_x@W_ms={floor_ms:.4f} call_ms={call_ms:.4f}", flush=True)
                if label == "prefill":
                    rec[name] = out
                elif label in LORA_SLICE11 + LORA_SLICE12 and name == "gathered_lora_matmul":
                    rec[f"{name}_{label}"] = out
            # Where a call's device time goes: x @ A, the base product with its
            # epilogue, and the split-K finish.
            print(f"[kernels] gathered_lora_matmul {tag}: device ms by kernel "
                  f"{device_ms_by_kernel(rung)}", flush=True)
    return rec


def attention_work(bh, s, d, window, causal, elem_bytes):
    """(operations, bytes) of attention over (BH, S, D): 4 D FLOP (q . k and
    p v) per (query, key) pair the mask keeps, the window's skip counted;
    q, k and v read once and the output written once."""
    import torch

    i = torch.arange(s)
    keep = torch.ones((s, s), dtype=torch.bool)
    if causal:
        keep &= i[:, None] >= i[None, :]
    if window:
        keep &= i[None, :] > i[:, None] - window
    return 4 * d * int(keep.sum()) * bh, 4 * bh * s * d * elem_bytes


def attn_bf16_excess(got, want, q, k, v, window, causal) -> float:
    """The largest |got - want| over its entry's bf16 bound (see
    ``ATTN_BF16_U``); at most 1 where the bound holds."""
    from repro_torch.kernels import ref

    mass = ref.local_attention_ref(q.float(), k.float(), v.float().abs(), window=window,
                                   causal=causal)
    got, want = got.float(), want.float()
    bound = ((ATTN_BF16_U + ATTN_BF16_SUM_RTOL) * mass
             + ATTN_BF16_U * (got.abs() + want.abs()))
    return float(((got - want).abs() / bound).max())


def check_attention_kernel(bw, fp32_flops, tensor_flops) -> dict:
    """local_attention against its plain version, bitwise repeatable, and
    timed beside ``F.scaled_dot_product_attention`` (``is_causal=True``, or
    an explicit boolean causal-window mask with a window)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import local_attention as la
    from repro_torch.kernels import ref

    rec = {}
    geometry = {}
    for bh, s, d, window, causal, label in ATTN_SHAPES:
        if d not in geometry:
            # The built kernel's geometry, held to the plan the CPU tests check.
            geometry[d] = la.tc_geometry(d)
            plan = la.tc_plan(s, d, window, causal)
            want = {k: plan[k] for k in ("bq", "bn", "stages", "smem_bytes")}
            if {k: geometry[d][k] for k in want} != want:
                raise AssertionError(f"local_attention D={d}: the kernel's geometry "
                                     f"{geometry[d]} is not tc_plan's {want}")
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(bh + s + window)
            q, k, v = (torch.randn((bh, s, d), generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            run = lambda: la.local_attention(q, k, v, window=window, causal=causal)
            plain = lambda: ref.local_attention_ref(q, k, v, window=window, causal=causal)
            route = la.route(d, dtype)
            tc_before = la.local_attention.tc_launches
            got, again, want = run(), run(), plain()
            torch.cuda.synchronize()
            tag = (f"{label} BH={bh} S={s} D={d} window={window} causal={causal} "
                   f"{str(dtype)[6:]} route={route}")
            if not torch.equal(got, again):
                raise AssertionError(f"local_attention {tag}: two launches differ")
            if la.local_attention.tc_launches - tc_before != (2 if route == "tensor" else 0):
                raise AssertionError(f"local_attention {tag}: launched off its route")
            if dtype == torch.float32:
                err = check_close(got, want, ATTN_F32_ATOL, f"local_attention {tag}")
                print(f"[kernels] local_attention {tag}: err={err:.3g}", flush=True)
            else:
                err = check_close(got, want, ATTN_BF16_RTOL * float(want.double().abs().max()),
                                  f"local_attention {tag}")
                excess = lambda x: attn_bf16_excess(x, want, q, k, v, window, causal)
                worst = excess(got)
                if not worst <= 1.0:
                    raise AssertionError(f"local_attention {tag}: |err| reaches {worst:.3g} x "
                                         f"its entry's bf16 bound")
                controls = []
                for w in ((window - ATTN_CONTROL_KEYS, window + ATTN_CONTROL_KEYS)
                          if window > ATTN_CONTROL_KEYS else ()):
                    ctl = excess(ref.local_attention_ref(q, k, v, window=w, causal=causal))
                    if not ctl > 1.0:
                        raise AssertionError(f"local_attention {tag}: the control at window "
                                             f"{w} passes the bound ({ctl:.3g} x)")
                    controls.append(f"window {w}: {ctl:.3g} x")
                g = geometry[d]
                print(f"[kernels] local_attention {tag}: err={err:.3g}, worst entry {worst:.3g} "
                      f"x its bound; controls that must fail it: "
                      f"{', '.join(controls) or 'none (window too short)'}; geometry BQ={g['bq']} "
                      f"BN={g['bn']} stages={g['stages']} smem={g['smem_bytes']} B, "
                      f"{g['registers']} registers a thread at launch (setmaxnreg: consumers "
                      f"{g['consumer_registers']}, producer {g['producer_registers']})",
                      flush=True)
            if dtype != torch.bfloat16 or label in ATTN_UNTIMED:
                continue
            n_ops, n_bytes = attention_work(bh, s, d, window, causal, q.element_size())
            t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / tensor_flops * 1e3
            ms, plain_ms, call_ms = device_ms(run), device_ms(plain), bench_ms(run)
            # SDPA on (1, BH, S, D): the four-dimensional layout its flash
            # backend takes; with a window, an explicit boolean mask of the
            # same keys.  Timed only; the port never calls it.
            q4, k4, v4 = (t[None] for t in (q, k, v))
            if window:
                i = torch.arange(s, device="cuda")
                mask = (i[:, None] >= i[None, :]) & (i[None, :] > i[:, None] - window)
                lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
            else:
                lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
            lib_ms = device_ms(lib)
            out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       library_ms=lib_ms)
            print(f"[kernels] local_attention {tag}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={out['bound_ms']:.4f} ({out['bound_by']}, {n_ops / 1e9:.2f} GFLOP, "
                  f"{n_bytes / 1e6:.1f} MB) "
                  f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
                  f"call_ms={call_ms:.4f}", flush=True)
            rec[ATTN_RECORD[label]] = out
    return rec


# ssd_scan against its plain sequential scan: the kernel sums each tile's
# terms (tile 64, cumulative decays inside the tile) where the plain version
# steps position by position, so fp32 sums of up to S * N products and exp of
# cumulative decays (|cum| up to ~1e3 at the model's decays) round elsewhere;
# held to 1e-4 of the largest output (y) or state entry (h).
SSD_RTOL = 1e-4
# (batch, heads, S, P, N, decay, label): B and C one group per batch row, as
# the model passes them; "model" decays are -softplus(N(0, 1)) * A with A the
# model's 1..16 per head, "weak" ones in [-1e-3, 0] (exp(cum) never
# underflows, so the carried state dominates the output).
SSD_CASES = [(8, 24, 512, 64, 128, "model", "prefill"), (8, 24, 512, 64, 128, "weak", "weak"),
             (8, 24, 300, 64, 128, "model", "ragged"), (8, 24, 300, 64, 128, "weak", "ragged weak"),
             (2, 3, 70, 40, 100, "weak", "odd widths")]
SOFT_SHAPES = [(48 * 4096, 40, "path B bucket"), (129, 130, "ragged")]


def ssd_inputs(bsz, heads, s, p, n, decay, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    bh = bsz * heads
    x = torch.randn((bh, s, p), generator=g, device="cuda")
    if decay == "weak":
        da = -1e-3 * torch.rand((bh, s), generator=g, device="cuda")
    else:
        dt = torch.nn.functional.softplus(torch.randn((bh, s), generator=g, device="cuda"))
        da = -dt * torch.linspace(1.0, 16.0, heads, device="cuda").repeat(bsz)[:, None]
    b, c = (torch.randn((bsz, s, n), generator=g, device="cuda") for _ in range(2))
    return x, da, b, c


def ssd_work(bh, s, p, n, groups):
    """(operations, bytes) of the scan as the kernel's tile-64 algorithm
    needs them for these shapes, per tile of L valid positions, the upper
    triangle skipped: the scores C B^T, 2 * L(L+1)/2 * N, once per group
    (every head of a group shares them); the intra product, 2 * L(L+1)/2 * P,
    and the inter and carry products, 2 * 2 L N P, once per head row.  x, da,
    B, C (once per group) read, y and the final state written, float32."""
    per_group = per_row = 0
    for start in range(0, s, 64):
        tile = min(64, s - start)
        tri = tile * (tile + 1) // 2
        per_group += 2 * tri * n
        per_row += 2 * (tri * p + 2 * tile * n * p)
    n_bytes = 4 * (2 * bh * s * p + bh * s + 2 * groups * s * n + bh * n * p)
    return groups * per_group + bh * per_row, n_bytes


def check_ssd_kernel(bw, fp32_flops, tf32_flops) -> dict:
    """ssd_scan against its plain version (y and the final state), two
    launches bit for bit; timed at the prefill shape.  Every product of the
    kernel runs in 3xTF32 on the tensor cores, so ``bound_ms`` counts the
    tile-64 operations at a third of the TF32 tensor rate, or the bytes at
    the memory rate, the larger; the same operations at the fp32 CUDA-core
    rate are printed beside it, the bound the fp32 FMA kernel was held to."""
    import torch
    from repro_torch.kernels import ref, ssd_scan

    rec = {}
    for bsz, heads, s, p, n, decay, label in SSD_CASES:
        x, da, b, c = ssd_inputs(bsz, heads, s, p, n, decay, s + p + n)
        run = lambda: ssd_scan.ssd_scan(x, da, b, c, chunk=256, return_state=True)
        plain = lambda: ref.ssd_scan_ref(x, da, b, c, 256, return_state=True)
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        tag = f"{label} (BH, S, P, N)=({bsz * heads}, {s}, {p}, {n}) {decay} decay"
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise AssertionError(f"ssd_scan {tag}: two launches differ")
        errs = [check_close(g, w, SSD_RTOL * float(w.abs().max()), f"ssd_scan {tag} {what}")
                for g, w, what in zip(got, want, ("y", "h"))]
        peaks = [float(w.abs().max()) for w in want]
        print(f"[kernels] ssd_scan {tag}: y err={errs[0]:.3g} (max {peaks[0]:.4g}), "
              f"h err={errs[1]:.3g} (max {peaks[1]:.4g}), bitwise repeat", flush=True)
        if label != "prefill":
            continue
        n_ops, n_bytes = ssd_work(bsz * heads, s, p, n, bsz)
        t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / (tf32_flops / 3) * 1e3
        ms, plain_ms, call_ms = device_ms(run), device_ms(plain, reps=3), bench_ms(run)
        rec["ssd_scan"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                               bound_ms=max(t_bytes, t_ops),
                               bound_by="bytes" if t_bytes >= t_ops else "operations",
                               library_ms=None)
        t_cores = max(t_bytes, n_ops / fp32_flops * 1e3)
        print(f"[kernels] ssd_scan {tag}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={rec['ssd_scan']['bound_ms']:.4f} ({rec['ssd_scan']['bound_by']}, "
              f"{n_ops / 1e9:.3f} GFLOP at {tf32_flops / 3e12:.0f} TFLOP/s, {n_bytes / 1e6:.1f} MB) "
              f"fp32-core bound_ms={t_cores:.4f} "
              f"library_ms=null (no single PyTorch call) call_ms={call_ms:.4f} "
              f"device ms by kernel {device_ms_by_kernel(run)}", flush=True)
    return rec


# ssd_scan from a given state h0 (the model's h_init): row 8's shape and the
# ragged S = 300, model decays, h0 ~ N(0, 1); the same bound as without it.
SSD_H0_CASES = [(8, 24, 512, 64, 128, "prefill"), (8, 24, 300, 64, 128, "ragged")]


def check_ssd_h0_kernel(bw, tf32_flops) -> dict:
    """ssd_scan from a state h0 against the plain scan from h0 (y and the
    final state), two launches bit for bit, h0 = 0 the bits of no h0; at
    row 8's shape timed beside the same call without h0 (one more (N, P)
    load a block: no time is claimed)."""
    import torch
    from repro_torch.kernels import ref, ssd_scan

    rec = {}
    for bsz, heads, s, p, n, label in SSD_H0_CASES:
        x, da, b, c = ssd_inputs(bsz, heads, s, p, n, "model", s + p + n)
        h0 = torch.randn((bsz * heads, n, p), generator=torch.Generator(device="cuda")
                         .manual_seed(s), device="cuda")
        run = lambda: ssd_scan.ssd_scan(x, da, b, c, chunk=256, return_state=True, h0=h0)
        bare = lambda: ssd_scan.ssd_scan(x, da, b, c, chunk=256, return_state=True)
        plain = lambda: ref.ssd_scan_ref(x, da, b, c, 256, h0=h0, return_state=True)
        got, again, want = run(), run(), plain()
        zero = ssd_scan.ssd_scan(x, da, b, c, chunk=256, return_state=True,
                                 h0=torch.zeros_like(h0))
        torch.cuda.synchronize()
        tag = f"h0 {label} (BH, S, P, N)=({bsz * heads}, {s}, {p}, {n}) model decay"
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise AssertionError(f"ssd_scan {tag}: two launches differ")
        if not all(torch.equal(u, v) for u, v in zip(zero, bare())):
            raise AssertionError(f"ssd_scan {tag}: h0 = 0 differs from no h0")
        errs = [check_close(g, w, SSD_RTOL * float(w.abs().max()), f"ssd_scan {tag} {what}")
                for g, w, what in zip(got, want, ("y", "h"))]
        print(f"[kernels] ssd_scan {tag}: y err={errs[0]:.3g}, h err={errs[1]:.3g} "
              f"(bound {SSD_RTOL:g} of max), bitwise repeat, h0 = 0 the bits of no h0",
              flush=True)
        if label != "prefill":
            continue
        n_ops, n_bytes = ssd_work(bsz * heads, s, p, n, bsz)
        n_bytes += 4 * bsz * heads * n * p  # h0 read
        t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / (tf32_flops / 3) * 1e3
        ms, bare_ms = device_ms(run), device_ms(bare)
        ms2 = device_ms(run)
        rec["ssd_scan_h0"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=device_ms(plain, reps=3),
                                  bound_ms=max(t_bytes, t_ops),
                                  bound_by="bytes" if t_bytes >= t_ops else "operations",
                                  library_ms=None, ms_without_h0=bare_ms)
        print(f"[kernels] ssd_scan {tag}: kernel_ms={ms:.4f} (again {ms2:.4f}) without h0 "
              f"{bare_ms:.4f} plain_ms={rec['ssd_scan_h0']['plain_ms']:.4f} "
              f"bound_ms={rec['ssd_scan_h0']['bound_ms']:.4f} ({rec['ssd_scan_h0']['bound_by']})",
              flush=True)
    return rec


def check_soft_threshold_kernel(bw, fp32_flops) -> dict:
    """soft_threshold against its plain version, bit for bit (both round the
    same fp32 difference once), with t a float and a 0-d tensor on the card;
    timed beside ``F.softshrink`` (the same function for t >= 0, timed
    only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, soft_threshold as st

    rec = {}
    for m, n, label in SOFT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(m + n)
            x = torch.randn((m, n), generator=g, device="cuda").to(dtype)
            for t in (0.05, torch.tensor(0.8, device="cuda")):
                got, again = st.soft_threshold(x, t), st.soft_threshold(x, t)
                want = ref.soft_threshold_ref(x, torch.as_tensor(t, dtype=dtype).cuda())
                torch.cuda.synchronize()
                tag = f"{label} ({m}, {n}) {str(dtype)[6:]} t={float(t)}"
                if not (torch.equal(got, again) and torch.equal(got, want)):
                    raise AssertionError(f"soft_threshold {tag}: {max_abs(got, want)} from the "
                                         "plain version or two launches differ")
            print(f"[kernels] soft_threshold {label} ({m}, {n}) {str(dtype)[6:]}: equal to the "
                  f"plain version bit for bit, t a float and a card tensor", flush=True)
            if label != "path B bucket":
                continue
            run = lambda: st.soft_threshold(x, 0.05)
            t_dev = torch.tensor(0.05, dtype=dtype, device="cuda")
            plain = lambda: ref.soft_threshold_ref(x, t_dev)
            n_bytes, n_ops = 2 * x.numel() * x.element_size(), 3 * x.numel()
            t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / fp32_flops * 1e3
            ms, plain_ms, call_ms = device_ms(run), device_ms(plain), bench_ms(run)
            lib_ms = device_ms(lambda: F.softshrink(x, 0.05))
            out = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=lib_ms)
            print(f"[kernels] soft_threshold {label} ({m}, {n}) {str(dtype)[6:]}: "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={out['bound_ms']:.4f} "
                  f"({out['bound_by']}, {n_bytes / 1e6:.1f} MB) library_ms={lib_ms:.4f} "
                  f"(F.softshrink) call_ms={call_ms:.4f}", flush=True)
            if dtype == torch.float32:
                rec["soft_threshold"] = out
    return rec


def make_task(device, pretrain_quality=0.0, n_clients=20):
    from repro_torch.fed import synth

    # The paper regime of benchmarks/common.py::make_task (alpha 0.3, noise
    # 0.3, domain shift 4.0) at the width of one ViT-B/32 attention
    # projection, with one change: the "pretrained" backbone there (quality
    # 0.4) mixes in a pseudo-inverse of the square Gaussian generator, which
    # at 768 x 768 is so ill-conditioned that it saturates the tanh features
    # and no method learns (``regime_probe`` prints the evidence every run);
    # path A uses a random backbone, quality 0.
    return synth.make_synth_task(
        n_clients=n_clients, n_classes=20, d_in=768, d_feat=768, n_per_client=64, n_test=1024,
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


def fed_config(task, method, svt_mode, rounds, seed=0, mesh_shards=0, local_kw=None,
               cfg_kw=None, **agg):
    """Path A's run configuration: Adam 1e-2, 8 local steps of 32 examples,
    50 ADMM iterations; ``local_kw`` (client objectives), ``cfg_kw`` (run
    options) and ``agg`` (aggregator fields) pass through."""
    from repro_torch.core import AggregatorConfig
    from repro_torch.fed import FedRunConfig, LocalSpec, synth
    from repro_torch.optim import make_optimizer

    local = LocalSpec(
        loss_fn=lambda base, lora, batch: synth.loss_fn(base, lora, batch, task.lora_scale),
        feature_fn=lambda base, lora, x: synth.features(base, lora, x, task.lora_scale),
        optimizer=make_optimizer("adam", 1e-2), local_steps=8, batch_size=32, lr=1e-2,
        **(local_kw or {}),
    )
    return FedRunConfig(
        aggregator=AggregatorConfig(method=method, rpca_iters=50, svt_mode=svt_mode, **agg),
        local=local, rounds=rounds, seed=seed, mesh_shards=mesh_shards, **(cfg_kw or {}),
    )


def run_fed(task, method, svt_mode, rounds, device, log=None, mesh_shards=0, lora0=None,
            batch_indices=None, seed=0, local_kw=None, cfg_kw=None, sim_kw=None, **agg):
    """``run_simulation`` of ``fed_config`` on a planted task; ``sim_kw``
    (``run_simulation`` arguments) passes through."""
    from repro_torch.fed import run_simulation, synth

    cfg = fed_config(task, method, svt_mode, rounds, seed, mesh_shards, local_kw, cfg_kw, **agg)
    evalf = lambda l: synth.accuracy(task.base, l, task.test_x, task.test_y, task.lora_scale)
    lora0 = synth.init_lora(task, seed=0) if lora0 is None else lora0
    return run_simulation(task.base, lora0, task.client_x, task.client_y, cfg, evalf,
                          log_fn=log, batch_indices=batch_indices, device=device,
                          **(sim_kw or {}))


def to_cpu(tree):
    from repro_torch.utils.pytree import tree_map

    return None if tree is None else tree_map(lambda x: x.cpu(), tree)


def rel_fro(got, want) -> float:
    """Largest leaf error relative to the leaf's norm."""
    from repro_torch.utils.pytree import tree_leaves

    return max((float((g.cpu().double() - w.double()).norm() / w.double().norm().clamp_min(1e-30))
                for g, w in zip(tree_leaves(got), tree_leaves(want))), default=0.0)


class PhaseCheck:
    """The card's split round (``fed.server.RoundPhases``), each phase also
    run on the CPU from the card's inputs and held to it, so a run checks
    every round whatever its schedule (synchronous or pipelined):

    * the local phase, from the card's whole round state (global LoRA,
      SCAFFOLD variates, previous local models, the generator's state): the
      server variate rtol 1e-3 / atol 1e-5, the per-client fields (deltas,
      local models, client variates) within ``STATE_FRO_RTOL`` of each
      leaf's norm, fault slots and masks equal;
    * the aggregation, on the card's bundle: the update within ``AGG_RTOL``
      of the largest finite |delta| (as paths B, F and G hold it), and the
      quarantine's and faults' counts equal.

    Phases are held one at a time because Adam turns an fp32 difference into
    one that grows from round to round and fedrpca scales a client's sparse
    entries by beta, so whole runs on two devices part ways
    (``tools/round_sensitivity.py``: a 1e-7 perturbation of the backbone
    moves FedAvg's LoRA 3.1e-6 in 3 rounds, FedProx's 2.0e-5, FedRPCA with
    FedProx's 1.7e-4).  Every other attribute is the card's."""

    COUNTS = ("fault_injected", "fault_caught", "guard_quarantined", "guard_nonfinite",
              "guard_norm_outliers", "screen_clean", "update_finite")

    def __init__(self, card, host, what):
        self.card, self.host, self.what = card, host, what
        self.local_errs, self.agg_errs = [], []
        for name in ("cohort_pad", "plan", "prep_state", "apply", "fallback", "cold_carry"):
            setattr(self, name, getattr(card, name))

    def local(self, state, n_active=None):
        import torch
        from repro_torch.utils.pytree import tree_leaves

        gen = torch.Generator()
        gen.set_state(state.rng.get_state())
        fields = ("lora_global", "scaffold_c", "scaffold_ci", "prev_local")
        host_state = state._replace(rng=gen, **{f: to_cpu(getattr(state, f)) for f in fields})
        r = state.round_idx
        state, bundle = self.card.local(state, n_active)
        host_state, want = self.host.local(host_state, n_active)
        for g, c in zip(tree_leaves(state.scaffold_c), tree_leaves(host_state.scaffold_c)):
            torch.testing.assert_close(g.cpu(), c, rtol=1e-3, atol=1e-5,
                                       msg=lambda m: f"{self.what} round {r} scaffold_c: {m}")
        # Corrupted deltas (the fault slots, held equal below) count as zeros.
        finite = lambda t: [x.nan_to_num(0.0, 0.0, 0.0) for x in tree_leaves(t)]
        err = max(rel_fro(finite(bundle.deltas), finite(want.deltas)),
                  rel_fro(state.prev_local, host_state.prev_local),
                  rel_fro(state.scaffold_ci, host_state.scaffold_ci))
        same = all((a is None and b is None) or torch.equal(a.cpu(), b)
                   for a, b in ((bundle.mask, want.mask), (bundle.fault_slots, want.fault_slots)))
        if err > STATE_FRO_RTOL or not same:
            raise AssertionError(f"{self.what} round {r}: local phase card vs CPU {err:.3g} of "
                                 f"the norm (bound {STATE_FRO_RTOL}), masks equal: {same}")
        self.local_errs.append(err)
        return state, bundle

    def agg(self, carry, bundle, scale):
        import torch
        from repro_torch.utils.pytree import tree_leaves

        out = self.card.agg(carry, bundle, scale)
        moved = bundle._replace(deltas=to_cpu(bundle.deltas), mask=to_cpu(bundle.mask),
                                weights=to_cpu(bundle.weights), loss_mean=to_cpu(bundle.loss_mean),
                                fault_slots=to_cpu(bundle.fault_slots))
        want = self.host.agg(to_cpu(carry) if carry else carry, moved, scale)
        big = max(float(d.nan_to_num(0.0, 0.0, 0.0).abs().max())
                  for d in tree_leaves(bundle.deltas))
        err = max(max_abs(g.cpu(), w) for g, w in zip(tree_leaves(out[0]),
                                                      tree_leaves(want[0])))
        counts = {k: (float(out[2][k]), float(want[2][k])) for k in self.COUNTS if k in out[2]}
        if not err <= AGG_RTOL * big or any(a != b for a, b in counts.values()):
            raise AssertionError(f"{self.what} round {bundle.agg_key[1]}: update card vs CPU "
                                 f"{err} (bound {AGG_RTOL} * {big}); counts {counts}")
        self.agg_errs.append(err / big)
        return out


def card_vs_cpu_states(task, cpu_task, method, what, rounds=3, mode="gram", local_kw=None,
                       cfg_kw=None, round_kw=None, n_active=None, chains=False):
    """``rounds`` rounds of ``fed_config`` on the card through ``PhaseCheck``
    (each phase also on the CPU), on the run's schedule (``cfg_kw``'s
    ``pipeline`` / ``staleness``); ``round_kw`` goes to
    ``make_round_phases``.  With ``chains`` the whole runs on both devices
    are compared too, and their difference is printed, not held."""
    from repro_torch.fed import init_round_state, make_round_phases, run_rounds, synth

    cfg = fed_config(task, method, mode, rounds, local_kw=local_kw, cfg_kw=cfg_kw)
    lora0 = synth.init_lora(task, seed=0)
    check = PhaseCheck(
        make_round_phases(task.base, task.client_x, task.client_y, cfg, lora_template=lora0,
                          **(round_kw or {})),
        make_round_phases(cpu_task.base, cpu_task.client_x, cpu_task.client_y, cfg,
                          lora_template=to_cpu(lora0), **(round_kw or {})),
        what)
    rows = []
    run_rounds(check, init_round_state(lora0, task.client_x.shape[0], cfg.seed), rounds,
               staleness=cfg.staleness if cfg.pipeline else 0, n_active=n_active,
               on_round=lambda r, st, d: rows.append(r))
    if rows != list(range(rounds)):
        raise AssertionError(f"{what}: rounds landed as {rows}")
    extra = ""
    if chains:
        sim_kw = dict(round_kw or {}, **({"n_active": n_active} if n_active else {}))
        gl, _ = run_fed(task, method, mode, rounds, "cuda", local_kw=local_kw, cfg_kw=cfg_kw,
                        sim_kw=sim_kw)
        cl, _ = run_fed(cpu_task, method, mode, rounds, "cpu", local_kw=local_kw, cfg_kw=cfg_kw,
                        sim_kw=sim_kw)
        extra = f"; the {rounds}-round runs differ by {max(max_abs(gl[k].cpu(), cl[k]) for k in gl):.3g}"
    print(f"[{what}] card vs CPU {method}/{mode} {rounds} rounds, each phase from the card's "
          f"inputs: local phase {[float(f'{e:.3g}') for e in check.local_errs]} of the norm "
          f"(bound {STATE_FRO_RTOL:g}), update {[float(f'{e:.3g}') for e in check.agg_errs]} "
          f"of max|delta| (bound {AGG_RTOL:g}){extra}", flush=True)
    return check.agg_errs


# Path A's 10-round methods: the baselines of benchmarks/table1_main.py that
# the port has, and fedrpca in both SVT modes.  Only fedrpca launches kernels.
A_METHODS = (("fedavg", "gram"), ("task_arithmetic", "gram"), ("ties", "gram"),
             ("fedexp", "gram"), ("dare", "gram"), ("fedrpca", "gram"), ("fedrpca", "subspace"))


def card_vs_cpu_rounds(task, cpu_task, method, mode, what, rounds=3, **kw):
    """``rounds`` rounds (3) on the card and on the CPU from the same
    weights, batches and cohorts: LoRA rtol 1e-3 / atol 1e-5, accuracy
    within 2 test examples.  ``kw`` goes to ``run_fed``."""
    import numpy as np
    import torch

    gl, gh = run_fed(task, method, mode, rounds, "cuda", **kw)
    cl, ch = run_fed(cpu_task, method, mode, rounds, "cpu", **kw)
    for k in gl:
        torch.testing.assert_close(gl[k].cpu(), cl[k], rtol=1e-3, atol=1e-5)
    if np.max(np.abs(gh - ch)) > 2.0 / 1024 + 1e-9:
        raise AssertionError(f"{what}: card vs CPU accuracy {gh} vs {ch}")
    err = max(max_abs(gl[k].cpu(), cl[k]) for k in gl)
    print(f"[{what}] card vs CPU {method}/{mode} {rounds} rounds: lora max|err|={err:.3g} "
          f"acc card={gh.tolist()} cpu={ch.tolist()}", flush=True)


def card_vs_cpu_by_round(task, cpu_task, method, rounds=3):
    """``rounds`` rounds on the card, each also run on the CPU from the
    card's previous global LoRA with the same batches (round r: run seed r):
    LoRA rtol 1e-3 / atol 1e-5 a round.  FedExP is held so, one round at a
    time, because it extrapolates every update by its eta and a card-vs-CPU
    difference compounds from round to round; the CPU's own chain is run
    too, and its drift from the card is printed."""
    import torch
    from repro_torch.fed import synth

    gen = torch.Generator().manual_seed(0)
    idx = torch.randint(0, task.client_x.shape[1], (rounds, task.client_x.shape[0], 8, 32),
                        generator=gen)
    card = cpu = synth.init_lora(cpu_task, seed=0)
    errs, drift = [], []
    for r in range(rounds):
        def one(t, dev, lora):
            return run_fed(t, method, "gram", 1, dev, lora0=lora, seed=r,
                           batch_indices=lambda _: idx[r])[0]

        nxt = one(task, "cuda", card)
        same_start = one(cpu_task, "cpu", {k: v.cpu() for k, v in card.items()})
        cpu = one(cpu_task, "cpu", cpu)
        for k in nxt:
            torch.testing.assert_close(nxt[k].cpu(), same_start[k], rtol=1e-3, atol=1e-5)
        errs.append(max(max_abs(nxt[k].cpu(), same_start[k]) for k in nxt))
        drift.append(max(max_abs(nxt[k].cpu(), cpu[k]) for k in nxt))
        card = nxt
    print(f"[path A] card vs CPU {method} {rounds} rounds, each from the card's state: lora "
          f"max|err| {[float(f'{e:.3g}') for e in errs]}; the CPU's own chain drifts "
          f"{[float(f'{e:.3g}') for e in drift]}", flush=True)


def main_path_a(counts) -> dict:
    """Returns each method's final accuracy after 10 rounds."""
    import numpy as np
    from repro_torch.fed import synth

    task = make_task("cuda")
    zero_shot = float(synth.accuracy(task.base, synth.init_lora(task, seed=0), task.test_x,
                                     task.test_y, task.lora_scale))
    print(f"[path A] zero-shot accuracy {zero_shot:.4f}", flush=True)
    finals = {}
    for method, mode in A_METHODS:
        times = []
        before = counts()
        _, hist = run_fed(task, method, mode, 10, "cuda",
                          log=lambda r, d: times.append(d["t_round_s"]))
        launched = {k: v - before[k] for k, v in counts().items()}
        want = dict.fromkeys(before, 0)
        if method == "fedrpca":
            want["admm_tail" if mode == "gram" else "subspace_apply"] = 10 * 50 * 1
            if mode == "subspace":
                want["subspace_apply_tc"] = 10 * 50 * 1
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
    print("[path A] final accuracy minus fedavg's: " + ", ".join(
        f"{k} {v - finals['fedavg/gram']:+.4f}" for k, v in finals.items()), flush=True)

    cpu_task = make_task("cpu")
    for mode in ("gram", "subspace"):
        card_vs_cpu_rounds(task, cpu_task, "fedrpca", mode, "path A")
    for method in ("ties", "dare"):
        card_vs_cpu_rounds(task, cpu_task, method, "gram", "path A")
    card_vs_cpu_by_round(task, cpu_task, "fedexp")
    return finals


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


def main_path_b(counts) -> dict:
    """Returns each call's seconds by (clients, live clients, mode)."""
    import torch
    from repro_torch.convert import from_jax_tree
    from repro_torch.core import AggregatorConfig, aggregate
    from repro_torch.utils.pytree import tree_leaves

    calls = {}
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
            with FallbackSpy("robust_pca_bucket") as spy:
                out = call()
                torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in counts().items()}
            want = dict(dict.fromkeys(before, 0), admm_tail=50 if mode == "gram" else 0,
                        subspace_apply=50 if mode == "subspace" else 0,
                        subspace_apply_tc=50 if mode == "subspace" else 0)
            if launched != want:
                raise AssertionError(f"path B {mode}: launches {launched} != {want}")
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            t_call = time.perf_counter() - t0
            calls[(nc, n_valid or nc, mode)] = t_call
            t0 = time.perf_counter()
            with FallbackSpy("robust_pca_bucket") as cpu_spy:
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
            # Subspace mode: the exact-eigh fallbacks read the kernel's G'.
            print(f"[path B] nc={nc} valid={n_valid or nc} {mode}: call_s={t_call:.4f} "
                  f"cpu_call_s={t_cpu:.4f} card-vs-cpu max|err|={err:.3g} (max|delta|={scale:.3g}) "
                  f"fallbacks card {spy.falls} cpu {cpu_spy.falls} of 50 iterations "
                  f"launches={launched}", flush=True)
    return calls

# --- Path F: mesh-sharded aggregation -------------------------------------------
# (svt_mode, clients, live clients): 40 dense, 30 padded to 32 on 4 shards, 20
# of 32 masked, and gram mode at 40 dense.
F_CASES = [("subspace", 40, None), ("subspace", 30, None), ("subspace", 32, 20),
           ("gram", 40, None)]
F_SHARDS = 4


class FallbackSpy:
    """Records ``n_fallback`` and the loop's iteration count (the largest
    ``n_iter``) of every ``core.rpca`` call of ``name`` the engine makes
    inside the ``with`` block (``aggregate`` does not return them): the
    sharded loop's, which the launch check needs, or the unsharded one's,
    whose exact-eigh fallbacks read ``subspace_apply``'s Gram.  A carrying
    call returns ``(result, carry)``; the result is read.  ``keep=True``
    also keeps each call's arguments and module iteration counts on the
    host, in ``calls``."""

    def __init__(self, name: str = "robust_pca_bucket_sharded", keep: bool = False):
        self.name, self.keep = name, keep

    def __enter__(self):
        from repro_torch.core import rpca

        self.falls, self.iters, self.calls = [], [], []
        self._rpca, self._fn = rpca, getattr(rpca, self.name)

        def spy(*args, **kw):
            out = self._fn(*args, **kw)
            res = out if isinstance(out, rpca.RPCAResult) else out[0]
            self.falls.append(res.n_fallback)
            self.iters.append(int(res.n_iter.max()))
            if self.keep:
                host = lambda t: t.cpu() if hasattr(t, "cpu") else t
                self.calls.append(dict(
                    args=[host(a) for a in args],
                    kw={k: v._replace(**{f: host(x) for f, x in v._asdict().items()})
                        if isinstance(v, rpca.BucketCarry) else host(v) for k, v in kw.items()},
                    n_iter=res.n_iter.cpu()))
            return out

        setattr(rpca, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self._rpca, self.name, self._fn)


def mesh_launches(mode, shards, chunks, iters, falls) -> dict:
    """Tail-kernel launches of one sharded call: every exact iteration runs
    ``admm_tail`` and every Ritz iteration ``subspace_apply_factored``, once a
    shard and B chunk (gram mode: every iteration is exact; its
    ``n_fallback`` is 0, as in the unsharded loop)."""
    exact = iters if mode == "gram" else falls
    return dict(admm_tail=shards * chunks * exact,
                subspace_apply_factored=shards * chunks * (iters - exact))


def main_path_f(counts, card: str) -> dict:
    """``aggregate(engine="packed", mesh=make_host_mesh(4))`` of path B's
    planted ViT-B/32 tree (one bucket of 48 modules x 4096 rows) in the
    cases of ``F_CASES``, each against the unsharded call on the card and the
    same sharded call on a CPU mesh; 2 shards against 4 and
    ``mesh_overlap=True`` against False; then ``run_simulation`` with
    ``mesh_shards=4`` on path A's task against ``mesh_shards=0``.  Every
    call's launches must equal the count its fallbacks give.  Returns the
    launch counts."""
    import numpy as np
    import torch
    from repro_torch.convert import from_jax_tree
    from repro_torch.core import AggregatorConfig, aggregate
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils.pytree import tree_leaves

    start = counts()
    launched, expect, phase = launch_checker(counts, "path F")
    mesh, cpu_mesh = make_host_mesh(F_SHARDS), make_host_mesh(F_SHARDS, device="cpu")

    def close(a, b, scale, what):
        err = 0.0
        for g, c in zip(tree_leaves(a), tree_leaves(b)):
            if g.shape != c.shape or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"path F {what}: bad update leaf {tuple(g.shape)}")
            err = max(err, max_abs(g.cpu(), c.cpu()))
        if err > AGG_RTOL * scale:
            raise AssertionError(f"path F {what}: {err} > {AGG_RTOL} * {scale}")
        return err

    def sharded(name, tree, cfg, mask, on, chunks=1):
        """One timed sharded call on the card; checks its launches."""
        torch.cuda.synchronize()
        before = counts()
        with FallbackSpy() as spy:
            t0 = time.perf_counter()
            out = aggregate(tree, cfg, engine="packed", mask=mask, mesh=on)
            torch.cuda.synchronize()
            t_call = time.perf_counter() - t0
        (falls,) = spy.falls
        expect(name, launched(before),
               **mesh_launches(cfg.svt_mode, on.shards, chunks, cfg.rpca_iters, falls))
        return out, t_call, falls

    for mode, nc, n_valid in F_CASES:
        tree = planted_vit_deltas(5, nc, n_valid)
        scale = max(abs(x).max() for x in tree_leaves(tree))
        mask = None if n_valid is None else (torch.arange(nc) < n_valid).float()
        gpu_tree = from_jax_tree(tree, "cuda")
        gpu_mask = None if mask is None else mask.cuda()
        cfg = AggregatorConfig(method="fedrpca", rpca_iters=50, svt_mode=mode)
        tag = f"{mode} nc={nc} valid={n_valid or nc}"
        sharded(f"{tag} warm-up", gpu_tree, cfg, gpu_mask, mesh)
        out, t_call, falls = sharded(tag, gpu_tree, cfg, gpu_mask, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = counts()
        base = aggregate(gpu_tree, cfg, engine="packed", mask=gpu_mask)
        torch.cuda.synchronize()
        t_base = time.perf_counter() - t0
        tail = (dict(admm_tail=50) if mode == "gram"
                else dict(subspace_apply=50, subspace_apply_tc=50))
        expect(f"{tag} unsharded", launched(before), **tail)
        with FallbackSpy() as spy:
            t0 = time.perf_counter()
            cpu = aggregate(from_jax_tree(tree, "cpu"), cfg, engine="packed", mask=mask,
                            mesh=cpu_mesh, device="cpu")
            t_cpu = time.perf_counter() - t0
        err_base = close(out, base, scale, f"{tag} sharded vs unsharded")
        err_cpu = close(out, cpu, scale, f"{tag} card mesh vs CPU mesh")
        print(f"[path F] {card} | {tag} on {F_SHARDS} shards: call_s={t_call:.4f} "
              f"unsharded call_s={t_base:.4f} cpu mesh call_s={t_cpu:.4f}; fallbacks card "
              f"{falls} cpu {spy.falls[0]} of 50; max|err| vs unsharded {err_base:.3g}, vs CPU "
              f"mesh {err_cpu:.3g} (max|delta| {scale:.3g}); launches {phase[tag]}", flush=True)
        before = counts()
        with FallbackSpy() as spy:
            wall, busy, top = profiled(
                lambda: aggregate(gpu_tree, cfg, engine="packed", mask=gpu_mask, mesh=mesh))
        expect(f"{tag} profiled", launched(before),
               **mesh_launches(mode, F_SHARDS, 1, cfg.rpca_iters, spy.falls[0]))
        print(f"[path F] {card} | {tag} profiled call: {wall:.4f} s, device busy "
              f"{'not measured' if busy is None else f'{busy / wall:.1%}'}; top kernels "
              f"(name, ms, calls) {top}", flush=True)
        if mode == "subspace" and n_valid is None:
            # mesh_overlap cuts every psum and tail kernel into 4 B chunks:
            # the same bits.
            over = cfg.replace(mesh_overlap=True)
            got, t_over, _ = sharded(f"{tag} overlap", gpu_tree, over, gpu_mask, mesh, chunks=4)
            if not all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(out))):
                raise AssertionError(f"path F {tag}: mesh_overlap changed the bits")
            print(f"[path F] {card} | {tag} mesh_overlap=True: equal bits, call_s={t_over:.4f}, "
                  f"launches {phase[tag + ' overlap']}", flush=True)
        if mode == "subspace" and nc == 40:
            got, t_two, _ = sharded(f"{tag} 2 shards", gpu_tree, cfg, gpu_mask, make_host_mesh(2))
            err = close(got, out, scale, f"{tag} 2 vs {F_SHARDS} shards")
            print(f"[path F] {card} | {tag} 2 shards vs {F_SHARDS}: max|err| {err:.3g}, "
                  f"call_s={t_two:.4f}", flush=True)

    # The round loop on path A's task, sharded against unsharded on the card.
    task = make_task("cuda")
    times = {}
    before = counts()
    with FallbackSpy() as spy:
        gl, gh = run_fed(task, "fedrpca", "subspace", 3, "cuda", mesh_shards=F_SHARDS,
                         log=lambda r, d: times.setdefault("sharded", []).append(d["t_agg_s"]))
    expect("round loop", launched(before),
           **mesh_launches("subspace", F_SHARDS, 1, 50 * 3, sum(spy.falls)))
    ul, uh = run_fed(task, "fedrpca", "subspace", 3, "cuda",
                     log=lambda r, d: times.setdefault("unsharded", []).append(d["t_agg_s"]))
    for k in gl:
        torch.testing.assert_close(gl[k], ul[k], rtol=1e-3, atol=1e-5)
    if np.max(np.abs(gh - uh)) > 2.0 / 1024 + 1e-9:
        raise AssertionError(f"path F round loop: accuracy {gh} vs {uh}")
    err = max(max_abs(gl[k], ul[k]) for k in gl)
    print(f"[path F] {card} | run_simulation mesh_shards={F_SHARDS} vs 0, 3 rounds fedrpca "
          f"subspace: lora max|err|={err:.3g} acc {gh.tolist()} vs {uh.tolist()}; agg s "
          f"{[round(t, 4) for t in times['sharded']]} vs "
          f"{[round(t, 4) for t in times['unsharded']]}; fallbacks {spy.falls}", flush=True)
    total = launched(start)
    print(f"[path F] {card} | launches {total} by phase {phase}", flush=True)
    return total


# --- Path G: cross-round aggregation sessions -------------------------------------
G_ROUNDS = 4
G_ITERS = 50


def drift_rounds(nc: int, n_valid: int | None) -> list:
    """Path B's planted tree over ``G_ROUNDS`` rounds: round 0 is M_0
    (``planted_vit_deltas`` seed 5), round r is 0.8 M_0 + 0.2 M_r (seed
    5 + r), the drift of the probe that chose this slice."""
    base = planted_vit_deltas(5, nc, n_valid)
    out = [base]
    for r in range(1, G_ROUNDS):
        m_r = planted_vit_deltas(5 + r, nc, n_valid)
        out.append({t: {p: 0.8 * base[t][p] + 0.2 * m_r[t][p] for p in base[t]} for t in base})
    return out


def run_session(trees, cfg, mask, device, counts=None, mesh=None, spy="robust_pca_bucket",
                keep=False):
    """One ``AggSession`` over ``trees`` on ``device``: per round the update,
    call seconds (host clock, ending in a synchronize on the card), the
    fallbacks and hit rate of the diagnostics, the RPCA calls' fallbacks and
    loop iterations (with ``keep``, also their arguments and results), and
    on the card the launches."""
    import torch
    from repro_torch.convert import from_jax_tree
    from repro_torch.core import AggSession

    sess = AggSession(cfg, mesh=mesh, device=device)
    on_card = torch.device(device).type == "cuda"
    m = None if mask is None else mask.to(device)
    rounds = []
    for tree in trees:
        t_tree = from_jax_tree(tree, device)
        if on_card:
            torch.cuda.synchronize()
        before = counts() if counts else None
        with FallbackSpy(spy, keep) as rec:
            t0 = time.perf_counter()
            out, diag = sess.step(t_tree, mask=m)
            if on_card:
                torch.cuda.synchronize()
            t_call = time.perf_counter() - t0
        rounds.append(dict(
            out=out, s=t_call, falls=int(diag.scalars["fallback_count"]),
            hit=float(diag.scalars["carry_hit_rate"]), calls=rec.falls, iters=rec.iters,
            records=rec.calls,
            launched=None if before is None else {k: v - before[k] for k, v in counts().items()},
            tiers={k: (t.low_idx, t.low_cap) for k, t in sess.plan.tiers.items()},
        ))
    return rounds


# Card vs CPU bound of a session's updates, over max|delta|, from the first
# warm round of G3's 30-client session that takes no exact-eigh step on.
# That round tracks the basis by Ritz steps alone for all 50 iterations, and
# there fp32 round-off of any order grows about a thousandfold: in round 1 on
# an H100 80GB HBM3 at 700 W, against the CPU mesh, the CPU's own unsharded
# session reads 2.9e-4 of max|delta|, the plain version on the card 8.27e-4,
# the kernels 8.98e-4 and the TF32 control (the plain version in single-pass
# TF32) 1.89e-3.  The limit is the geometric mean of the kernels' reading and
# the control's; the control must fail it.
G_RITZ_RTOL = 1.3e-3


def same_decisions(what, got, want) -> None:
    """Round by round: equal fallbacks, hits and tiers."""
    for i, (g, w) in enumerate(zip(got, want)):
        if (g["falls"], g["hit"], g["tiers"]) != (w["falls"], w["hit"], w["tiers"]):
            raise AssertionError(f"{what} round {i}: fallbacks, hits, tiers "
                                 f"{g['falls'], g['hit'], g['tiers']} vs "
                                 f"{w['falls'], w['hit'], w['tiers']}")


def round_errs(got, want, scale) -> list:
    """Each round's largest update error over max|delta|; a leaf of another
    shape or a non-finite one raises."""
    from repro_torch.utils.pytree import tree_leaves

    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        err = 0.0
        for a, b in zip(tree_leaves(g["out"]), tree_leaves(w["out"])):
            if a.shape != b.shape or not bool(a.isfinite().all()):
                raise AssertionError(f"round {i}: bad update leaf {tuple(a.shape)}")
            err = max(err, max_abs(a.cpu(), b.cpu()))
        errs.append(err / scale)
    return errs


def round_bounds(n: int, ritz_from: int | None) -> list:
    """AGG_RTOL a round, G_RITZ_RTOL from round ``ritz_from`` on."""
    return [G_RITZ_RTOL if ritz_from is not None and i >= ritz_from else AGG_RTOL
            for i in range(n)]


def check_rounds(what, got, want, scale, ritz_from=None):
    """Equal decisions, and each round's update within its bound of
    max|delta| (``round_bounds``).  Returns the errors over max|delta|."""
    same_decisions(what, got, want)
    errs = round_errs(got, want, scale)
    for i, (e, bound) in enumerate(zip(errs, round_bounds(len(errs), ritz_from))):
        if e > bound:
            raise AssertionError(f"{what} round {i}: {e} x max|delta| > {bound}")
    return [float(f"{e:.3g}") for e in errs]


def check_modules(what, got, want, scale, cfg):
    """The tolerance loop of G2, update row by update row, within AGG_RTOL
    of max|delta|.  Along the two sessions, the rows of the modules that
    stop at the same iteration on the card and the CPU.  And each round,
    every row of the card's update against the one the CPU's rerun of the
    call from the card's own inputs, its carry included, gives: a module
    whose residual crosses ``rpca_tol`` one iteration apart there is held
    against the CPU's run of the same call for the card's count without the
    tolerance, which gives a module the bits the loop gives it when it stops
    at that count.  Returns per round the largest error of each over
    max|delta| and the modules that stopped apart in the sessions,
    ``{module: (card, cpu)}``."""
    import torch
    from repro_torch.core import rpca
    from repro_torch.core.aggregators import sparse_energy_ratio
    from repro_torch.core.engine import pack
    from repro_torch.utils.pytree import tree_map

    def rows(out):
        """The update tree's module rows, in the bucket's order."""
        (bucket,) = pack(tree_map(lambda x: x[None].cpu(), out))[0].values()
        return bucket.data[:, :, 0]

    def update_rows(m, l, s):
        """The rows ``engine._fedrpca_bucket`` forms from L and S on G2's
        dense bucket: adaptive beta, no guard, no weights."""
        energy = sparse_energy_ratio(m, s)
        beta = torch.clamp(1.0 / torch.clamp_min(energy, 1e-12), cfg.beta_min, cfg.beta_max)
        return torch.mean(l, dim=-1) + beta[:, None] * torch.mean(s, dim=-1)

    def rerun(rec, n_iter=None):
        """The recorded call on the CPU, or without the tolerance for
        ``n_iter`` iterations, and whether its carry was taken."""
        kw = dict(rec["kw"], return_carry=True)
        if n_iter is not None:
            kw.update(n_iter=n_iter, tol=None)
        res, carry = rpca.robust_pca_bucket(*rec["args"][:2], **kw)
        return res, float(carry.hit)

    same_decisions(what, got, want)
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        (gc,), (wc,) = g["records"], w["records"]
        same = gc["n_iter"] == wc["n_iter"]
        e_session = max_abs(rows(g["out"])[same], rows(w["out"])[same])
        ref, hit = rerun(gc)
        if hit != g["hit"]:
            raise AssertionError(f"{what} round {i}: the CPU's gate decides otherwise")
        l_ref, s_ref = ref.low_rank.clone(), ref.sparse.clone()
        for n in set(gc["n_iter"][gc["n_iter"] != ref.n_iter].tolist()):
            at = gc["n_iter"] == n
            fixed, _ = rerun(gc, n)
            l_ref[at], s_ref[at] = fixed.low_rank[at], fixed.sparse[at]
        e_round = max_abs(rows(g["out"]), update_rows(gc["args"][0], l_ref, s_ref))
        if max(e_session, e_round) > AGG_RTOL * scale:
            raise AssertionError(f"{what} round {i}: session {e_session / scale}, from the "
                                 f"card's state {e_round / scale} x max|delta| > {AGG_RTOL}")
        out.append((float(f"{e_session / scale:.3g}"), float(f"{e_round / scale:.3g}"),
                    {k: (int(gc["n_iter"][k]), int(wc["n_iter"][k]))
                     for k in torch.nonzero(~same).flatten().tolist()}))
    return out


class PlainOnCard:
    """Inside the block the RPCA loops compute their plain PyTorch version
    on the card in place of the kernels (``backend.use_kernel`` answers
    False), with single-pass TF32 matmuls when ``tf32``: the witnesses of
    G3's 30-client session."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def __enter__(self):
        import torch
        from repro_torch.kernels import backend

        self._backend, self._use = backend, backend.use_kernel
        self._tf32 = torch.backends.cuda.matmul.allow_tf32
        backend.use_kernel = lambda t: False
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        import torch

        self._backend.use_kernel = self._use
        torch.backends.cuda.matmul.allow_tf32 = self._tf32


def main_path_g(counts, card: str, finals_a: dict) -> dict:
    """Cross-round sessions on the card, each against the same session on
    the CPU: G1 ``AggSession`` (subspace SVT, ``carry_mode="subspace"``) on
    path B's tree over drifting rounds at 40 dense clients and 20 of 32;
    G2 ``carry_mode="full"`` in gram mode with the tolerance loop; G3 G1's
    40 and 30 (ragged) sessions on ``make_host_mesh(4)``, also against the
    unsharded card session, with the 30-client session's witnesses; G4
    re-tiering every 2 rounds; G5
    ``run_simulation`` with the carry on path A's task.  Every launch count
    follows from the rounds, iterations and fallbacks.  Returns the launch
    counts."""
    import numpy as np
    import torch
    from repro_torch.core import AggregatorConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils.pytree import tree_leaves

    start = counts()
    launched, expect, phase = launch_checker(counts, "path G")
    sub_cfg = AggregatorConfig(method="fedrpca", rpca_iters=G_ITERS, svt_mode="subspace",
                               carry_mode="subspace")

    def report(tag, card_rounds, cpu_rounds, errs, extra=""):
        print(f"[path G] {card} | {tag}: call_s "
              f"{[round(r['s'], 4) for r in card_rounds]} (cpu "
              f"{[round(r['s'], 4) for r in cpu_rounds]}); fallbacks {[r['falls'] for r in card_rounds]} "
              f"of {G_ITERS} (cpu {[r['falls'] for r in cpu_rounds]}); hit "
              f"{[r['hit'] for r in card_rounds]}; card vs CPU max|err| / max|delta| by round "
              f"{errs}{extra}", flush=True)

    inputs = {}
    for nc, n_valid in ((40, None), (32, 20), (30, None)):
        trees = drift_rounds(nc, n_valid)
        mask = None if n_valid is None else (torch.arange(nc) < n_valid).float()
        inputs[nc] = (trees, mask, max(abs(x).max() for t in trees for x in tree_leaves(t)))

    # G1: the unsharded subspace session.
    card40 = None
    for nc in (40, 32):
        trees, mask, scale = inputs[nc]
        tag = f"G1 subspace nc={nc} valid={20 if nc == 32 else nc}"
        got = run_session(trees, sub_cfg, mask, "cuda", counts)
        want = run_session(trees, sub_cfg, mask, "cpu")
        errs = check_rounds(tag, got, want, scale)
        for i, r in enumerate(got):
            expect(f"{tag} round {i}", r["launched"], subspace_apply=G_ITERS,
                   subspace_apply_tc=G_ITERS)
            if i and r["hit"] != 1.0:
                raise AssertionError(f"{tag} round {i}: warm round missed ({r['hit']})")
        report(tag, got, want, errs, f" (bound {AGG_RTOL:g})")
        if nc == 40:
            card40 = got

    # G2: carry_mode="full" in gram mode, tolerance loop, held module by module.
    trees, mask, scale = inputs[40]
    full_cfg = AggregatorConfig(method="fedrpca", rpca_iters=G_ITERS, svt_mode="gram",
                                carry_mode="full", rpca_fixed_iters=False, rpca_tol=3e-4)
    got = run_session(trees, full_cfg, mask, "cuda", counts, keep=True)
    want = run_session(trees, full_cfg, mask, "cpu", keep=True)
    if full_cfg.guard_energy_k or full_cfg.weighting != "uniform" or not full_cfg.adaptive_beta:
        raise AssertionError("G2's check forms the update of a plain fedrpca bucket")
    per_round = check_modules("G2 full gram", got, want, scale, full_cfg)
    for i, g in enumerate(got):
        expect(f"G2 round {i}", g["launched"], admm_tail=sum(g["iters"]))
    report("G2 full gram nc=40 tol=3e-4", got, want, [e for e, _, _ in per_round],
           f" (the modules stopping at the same iteration; bound {AGG_RTOL:g}); each round "
           f"against the CPU's rerun from the card's state "
           f"{[e for _, e, _ in per_round]} (bound {AGG_RTOL:g}); modules stopping apart in the "
           f"sessions {{module: (card, cpu) iterations}} {[a for _, _, a in per_round]}; "
           f"whole-update error {[float(f'{e:.3g}') for e in round_errs(got, want, scale)]}; "
           f"ADMM iterations {[r['iters'][0] for r in got]} (cpu {[r['iters'][0] for r in want]})")

    # G3: the sharded sessions, against the unsharded card session and a CPU mesh.
    mesh, cpu_mesh = make_host_mesh(F_SHARDS), make_host_mesh(F_SHARDS, device="cpu")
    sharded = "robust_pca_bucket_sharded"
    for nc in (40, 30):
        trees, mask, scale = inputs[nc]
        tag = f"G3 subspace nc={nc} on {F_SHARDS} shards"
        got = run_session(trees, sub_cfg, mask, "cuda", counts, mesh=mesh, spy=sharded)
        unsharded = card40 if nc == 40 else run_session(trees, sub_cfg, mask, "cuda")
        want = run_session(trees, sub_cfg, mask, "cpu", mesh=cpu_mesh, spy=sharded)
        # The 30-client session: G_RITZ_RTOL from its first warm round that
        # takes no exact step on; every other session AGG_RTOL throughout.
        ritz_from = None
        if nc == 30:
            ritz_from = next((i for i, w in enumerate(want) if i and w["falls"] == 0), None)
        bounds = round_bounds(len(want), ritz_from)
        errs = check_rounds(tag, got, want, scale, ritz_from)
        errs_u = check_rounds(f"{tag} vs unsharded", got, unsharded, scale, ritz_from)
        for i, r in enumerate(got):
            expect(f"{tag} round {i}", r["launched"],
                   **mesh_launches("subspace", F_SHARDS, 1, G_ITERS, r["calls"][0]))
        report(tag, got, want, errs,
               f" (bounds {bounds}); vs unsharded card {errs_u}, unsharded call_s "
               f"{[round(r['s'], 4) for r in unsharded]}")
        if nc != 30:
            continue
        # Witnesses of the Ritz rounds: the plain version on the card, the
        # CPU's own unsharded session, and the TF32 control, which must fail.
        before = counts()
        with PlainOnCard():
            plain = run_session(trees, sub_cfg, mask, "cuda", mesh=mesh, spy=sharded)
        with PlainOnCard(tf32=True):
            tf32 = run_session(trees, sub_cfg, mask, "cuda", mesh=mesh, spy=sharded)
        expect(f"{tag} witnesses on the card", launched(before))
        cpu_u = run_session(trees, sub_cfg, mask, "cpu")
        w_errs = {name: (round_errs(r, want, scale), [x["falls"] for x in r])
                  for name, r in (("plain version on the card", plain),
                                  ("CPU unsharded", cpu_u), ("TF32 control", tf32))}
        print(f"[path G] {card} | {tag} witnesses, max|err| / max|delta| against the CPU "
              f"mesh by round (fallbacks): "
              f"{ {k: ([float(f'{e:.3g}') for e in v], f) for k, (v, f) in w_errs.items()} }; "
              f"kernels {errs}", flush=True)
        # The control must fail the bounds from the Ritz round on.
        first = ritz_from or 0
        tf32_errs, tf32_falls = w_errs["TF32 control"]
        over = [e > b for e, b in zip(tf32_errs, bounds)][first:]
        if tf32_falls == [r["falls"] for r in want] and not any(over):
            raise AssertionError(f"{tag}: the TF32 control passes the bounds {bounds[first:]}")

    # G4: re-tiering every 2 rounds.
    trees, mask, scale = inputs[40]
    tier_cfg = sub_cfg.replace(retier_every=2)
    got = run_session(trees, tier_cfg, mask, "cuda", counts)
    want = run_session(trees, tier_cfg, mask, "cpu")
    errs = check_rounds("G4 retier_every=2", got, want, scale)
    for i, r in enumerate(got):
        expect(f"G4 round {i}", r["launched"], subspace_apply=G_ITERS * len(r["calls"]),
               subspace_apply_tc=G_ITERS * len(r["calls"]))
    report("G4 retier_every=2 nc=40", got, want, errs,
           f" (bound {AGG_RTOL:g}); tiers (low modules, low cap) by round "
           f"{[{k[1]: (len(v[0]), v[1]) for k, v in r['tiers'].items()} for r in got]}")

    # G5: carrying rounds of run_simulation on path A's task.
    task, cpu_task = make_task("cuda"), make_task("cpu")
    before = counts()
    card_vs_cpu_rounds(task, cpu_task, "fedrpca", "subspace", "path G5",
                       carry_mode="subspace")
    # run_fed's rpca_iters is 50 (path A's).
    expect("G5 3 rounds card", launched(before), subspace_apply=3 * 50,
           subspace_apply_tc=3 * 50)
    logs = []
    before = counts()
    _, hist = run_fed(task, "fedrpca", "subspace", 10, "cuda", carry_mode="subspace",
                      log=lambda r, d: logs.append(d))
    expect("G5 10 rounds", launched(before), subspace_apply=10 * 50,
           subspace_apply_tc=10 * 50)
    if not np.isfinite(hist).all() or len(hist) != 10:
        raise AssertionError(f"G5: bad history {hist}")
    print(f"[path G] {card} | G5 run_simulation carry_mode=subspace 10 rounds: acc "
          f"{np.round(hist, 4).tolist()} (stateless fedrpca/subspace final "
          f"{finals_a['fedrpca/subspace']:.4f}); carry_hit_rate "
          f"{[d['carry_hit_rate'] for d in logs]}; fallback_count "
          f"{[int(d['fallback_count']) for d in logs]}; agg s "
          f"{[round(d['t_agg_s'], 4) for d in logs]}", flush=True)
    total = launched(start)
    print(f"[path G] {card} | launches {total} by phase {phase}", flush=True)
    return total


# --- Path H: client objectives, partial participation, the pipeline, faults ---
# H1: the client methods of Table 1 and Fig. 5, as benchmarks/common.py runs
# them: (label, aggregator, client objective).
H1_METHODS = (("fedprox", "fedavg", dict(fedprox_mu=0.01)),
              ("scaffold", "fedavg", dict(scaffold=True)),
              ("moon", "fedavg", dict(moon_mu=0.1)),
              ("fedrpca+fedprox", "fedrpca", dict(fedprox_mu=0.01)),
              ("fedrpca+scaffold", "fedrpca", dict(scaffold=True)))
# H2: 40 clients, 20 a round, so the canonical cohort has 32 slots.
H2_CLIENTS, H2_PER_ROUND, H2_PAD = 40, 20, 32
H_ROUNDS = 10
H_FAULTS = ("nan:0.1,dropout:0.2", "straggler:0.5")


def h_cohorts(kind, rounds, seed=0):
    """The port's own sampler, drawn ahead on a CPU generator, so the card
    and the CPU run on the same cohorts.  Returns ``(cohorts, weights,
    availability)``: ``availability`` cycles 36 and then 14 of 40 clients
    (a round whose trace leaves 6 of the 20 active slots empty)."""
    import numpy as np
    import torch
    from repro_torch.fed import make_sampler

    weights = np.linspace(1.0, 3.0, H2_CLIENTS)
    avail = np.ones((2, H2_CLIENTS), np.float32)
    avail[0, ::10] = 0.0
    avail[1, 14:] = 0.0
    sample = make_sampler(kind, H2_CLIENTS, H2_PAD, availability=avail, weights=weights)
    gen = torch.Generator().manual_seed(seed)
    draws = [sample(gen, r) for r in range(rounds)]
    return (lambda r: draws[r]), weights, avail


def check_finite(what, lora, hist=None):
    import numpy as np
    import torch

    if not all(bool(torch.isfinite(v).all()) for v in lora.values()):
        raise AssertionError(f"{what}: non-finite global LoRA")
    if hist is not None and not np.isfinite(hist).all():
        raise AssertionError(f"{what}: bad history {hist}")


def main_path_h(counts, card: str, finals_a: dict) -> dict:
    """H1 the client objectives, H2 partial participation with each sampler,
    H3 the pipeline, H4 faults and the quarantine, on path A's planted task
    at full width; each part also against the same run on the CPU.  Returns
    the launch counts."""
    import numpy as np
    import torch
    from repro_torch.fed import faults as faults_lib
    from repro_torch.fed import init_round_state, make_round_phases, run_rounds, synth
    from repro_torch.utils.pytree import tree_map

    start = counts()
    launched, expect, phase = launch_checker(counts, "path H")
    task, cpu_task = make_task("cuda"), make_task("cpu")
    fedavg = finals_a["fedavg/gram"]
    # Bytes of one client's dense float32 delta: A (d_in, r) and B (r, d_feat).
    per_client = 4.0 * task.lora_rank * sum(task.base["W0"].shape)

    # H1: each objective 10 rounds on the card, then 3 rounds card vs CPU.
    for label, method, local_kw in H1_METHODS:
        times, before = [], counts()
        lora, hist = run_fed(task, method, "gram", H_ROUNDS, "cuda", local_kw=local_kw,
                             log=lambda r, d: times.append(d["t_round_s"]))
        expect(f"H1 {label}", launched(before),
               admm_tail=H_ROUNDS * 50 if method == "fedrpca" else 0)
        check_finite(f"H1 {label}", lora, hist)
        print(f"[path H] {card} | H1 {label}: acc {np.round(hist, 4).tolist()} (final "
              f"{hist[-1] - fedavg:+.4f} vs fedavg's {fedavg:.4f}); round_s median "
              f"{statistics.median(times):.4f}", flush=True)
        card_vs_cpu_states(task, cpu_task, method, f"path H1 {label}", local_kw=local_kw,
                           chains=True)

    # H2: partial participation, every sampler, both SVT modes, on the same
    # injected cohorts on the card and the CPU.
    task40, cpu40 = make_task("cuda", n_clients=H2_CLIENTS), make_task("cpu", n_clients=H2_CLIENTS)
    for kind in ("uniform", "size_weighted", "trace"):
        cohorts, weights, avail = h_cohorts(kind, 3)
        sim_kw = dict(cohorts=cohorts, client_weights=weights, availability=avail)
        cfg_kw = dict(clients_per_round=H2_PER_ROUND, sampler=kind)
        for mode in ("gram", "subspace"):
            times, before = [], counts()
            kw = dict(cfg_kw=cfg_kw, sim_kw=sim_kw)
            lora, hist = run_fed(task40, "fedrpca", mode, 3, "cuda",
                                 log=lambda r, d: times.append((d["t_round_s"], d["bytes_up"])),
                                 **kw)
            kernel = "admm_tail" if mode == "gram" else "subspace_apply"
            extra = {"subspace_apply_tc": 150} if mode == "subspace" else {}
            expect(f"H2 {kind}/{mode}", launched(before), **{kernel: 150}, **extra)
            check_finite(f"H2 {kind}/{mode}", lora, hist)
            print(f"[path H] {card} | H2 {kind}/{mode} {H2_PER_ROUND} of {H2_CLIENTS} in "
                  f"{H2_PAD} slots: round_s {[round(t, 4) for t, _ in times]} live clients "
                  f"{[int(b / per_client) for _, b in times]} launches {kernel} 3 x 50",
                  flush=True)
            card_vs_cpu_states(task40, cpu40, "fedrpca", f"path H2 {kind}", mode=mode,
                               cfg_kw=cfg_kw, round_kw=sim_kw)
    # SCAFFOLD's masked variates and server variate, round by round.
    cohorts, _, _ = h_cohorts("uniform", 3, seed=2)
    card_vs_cpu_states(task40, cpu40, "fedrpca", "path H2 uniform+scaffold",
                       local_kw=dict(scaffold=True), cfg_kw=dict(clients_per_round=H2_PER_ROUND),
                       round_kw=dict(cohorts=cohorts), n_active=16)
    cohorts, _, _ = h_cohorts("uniform", 2, seed=1)
    rows, before = [], counts()
    kw = dict(cfg_kw=dict(clients_per_round=H2_PER_ROUND),
              sim_kw=dict(cohorts=cohorts, n_active=12))
    run_fed(task40, "fedrpca", "gram", 2, "cuda", log=lambda r, d: rows.append(d), **kw)
    expect("H2 n_active=12", launched(before), admm_tail=100)
    print(f"[path H] {card} | H2 n_active=12 of {H2_PAD} slots: round_s "
          f"{[round(d['t_round_s'], 4) for d in rows]} live clients "
          f"{[int(d['bytes_up'] / per_client) for d in rows]}", flush=True)
    card_vs_cpu_states(task40, cpu40, "fedrpca", "path H2 n_active=12", rounds=2,
                       cfg_kw=kw["cfg_kw"], round_kw=dict(cohorts=cohorts), n_active=12)

    # H3: the pipeline.  Staleness 0 gives the synchronous bits; staleness 2
    # lands in order, with the phase timers of each round.
    sync, hs = run_fed(task, "fedrpca", "subspace", 5, "cuda")
    pipe0, h0 = run_fed(task, "fedrpca", "subspace", 5, "cuda",
                        cfg_kw=dict(pipeline=True, staleness=0))
    if not (all(torch.equal(sync[k], pipe0[k]) for k in sync) and np.array_equal(hs, h0)):
        raise AssertionError("H3: staleness=0 differs from the synchronous rounds")
    for mode in ("gram", "subspace"):
        for staleness in (0, 2):
            rows = []
            lora, hist = run_fed(task, "fedrpca", mode, 6, "cuda",
                                 cfg_kw=dict(pipeline=True, staleness=staleness),
                                 log=lambda r, d: rows.append((r, d)))
            if [r for r, _ in rows] != list(range(6)):
                raise AssertionError(f"H3: rounds landed as {[r for r, _ in rows]}")
            check_finite(f"H3 {mode}", lora, hist)
            fmt = lambda k: [round(d[k], 4) for _, d in rows]
            print(f"[path H] {card} | H3 fedrpca/{mode} staleness={staleness}: acc "
                  f"{np.round(hist, 4).tolist()} t_local_s {fmt('t_local_s')} t_agg_s "
                  f"{fmt('t_agg_s')} t_overlap_s {fmt('t_overlap_s')} t_round_s "
                  f"{fmt('t_round_s')} (median {statistics.median(fmt('t_round_s')):.4f})",
                  flush=True)
    card_vs_cpu_states(task, cpu_task, "fedrpca", "path H3 staleness=2",
                       cfg_kw=dict(pipeline=True, staleness=2), rounds=4)
    print(f"[path H] {card} | H3 staleness=0 equals the synchronous rounds bit for bit "
          f"(5 rounds, fedrpca/subspace)", flush=True)

    # H4: faults at staleness 2, the guard on by default.
    for spec in H_FAULTS:
        fcfg = faults_lib.parse(spec, seed=1)
        partial = fcfg.straggler > 0
        t, cpu_t = (task40, cpu40) if partial else (task, cpu_task)
        cfg_kw = dict(pipeline=True, staleness=2, faults=fcfg,
                      **(dict(clients_per_round=H2_PER_ROUND) if partial else {}))
        rows = []
        lora, hist = run_fed(t, "fedrpca", "gram", 6, "cuda", cfg_kw=cfg_kw,
                             log=lambda r, d: rows.append(d))
        check_finite(f"H4 {spec}", lora, hist)
        clean = [d["screen_clean"] for d in rows]
        injected = [d["fault_injected"] for d in rows]
        caught = [d.get("fault_caught", 0.0) for d in rows]
        if clean != [1.0] * 6:
            raise AssertionError(f"H4 {spec}: screen_clean {clean}")
        if injected != caught:
            raise AssertionError(f"H4 {spec}: caught {caught} of injected {injected}")
        if fcfg.corrupt > 0 and sum(injected) == 0:
            raise AssertionError(f"H4 {spec}: no fault injected")
        print(f"[path H] {card} | H4 {spec} staleness=2: acc {np.round(hist, 4).tolist()} "
              f"screen_clean {clean} injected {injected} caught {caught} quarantined "
              f"{[d['guard_quarantined'] for d in rows]} live "
              f"{[int(d['bytes_up'] / per_client) for d in rows]}", flush=True)
        card_vs_cpu_states(t, cpu_t, "fedrpca", f"path H4 {spec}", cfg_kw=cfg_kw, rounds=4)

    # H4: a forced non-finite aggregation takes the cold retry, then the
    # masked-FedAvg fallback, and the run ends finite.
    from repro_torch.core import AggregatorConfig
    from repro_torch.fed import FedRunConfig, LocalSpec
    from repro_torch.optim import make_optimizer

    lora0 = synth.init_lora(task, seed=0)
    cfg = FedRunConfig(
        aggregator=AggregatorConfig(method="fedrpca", rpca_iters=50, svt_mode="subspace",
                                    carry_mode="subspace"),
        local=LocalSpec(loss_fn=lambda b, l, x: synth.loss_fn(b, l, x, task.lora_scale),
                        optimizer=make_optimizer("adam", 1e-2), local_steps=8, batch_size=32,
                        lr=1e-2),
        rounds=3)
    phases = make_round_phases(task.base, task.client_x, task.client_y, cfg, lora_template=lora0)
    real_agg, tries = phases.agg, []

    def poisoned(carry, bundle, scale):
        upd, c2, d = real_agg(carry, bundle, scale)
        tries.append(bundle.agg_key[1])
        if bundle.agg_key[1] == 1:
            upd = tree_map(lambda u: u * float("nan"), upd)
            d = {**d, "update_finite": torch.tensor(0.0)}
        return upd, c2, d

    phases.agg = poisoned
    rows = {}
    import warnings

    with warnings.catch_warnings(record=True) as caught_w:
        warnings.simplefilter("always")
        state = run_rounds(phases, init_round_state(lora0, task.client_x.shape[0], 0), 3,
                           staleness=2, on_round=lambda r, s, d: rows.__setitem__(r, d))
    said = [str(w.message) for w in caught_w if str(w.message).startswith("round ")]
    # Round 1 runs on the worker, then cold on landing (round 2's dispatch may
    # come between).
    if sorted(tries) != [0, 1, 1, 2] or rows[1].get("degraded") != 1.0 or \
            rows[1].get("supervisor_retry") != 1.0 or len(said) != 2:
        raise AssertionError(f"H4 ladder: tries {tries}, round 1 {rows[1]}, warnings {said}")
    check_finite("H4 ladder", state.lora_global)
    print(f"[path H] {card} | H4 forced non-finite round 1: agg tries by round {tries}, "
          f"cold retry then masked FedAvg (degraded={rows[1]['degraded']}); warnings {said}",
          flush=True)

    total = launched(start)
    for k in ("admm_tail", "subspace_apply", "subspace_apply_tc"):
        if not total[k]:
            raise AssertionError(f"path H never launched {k}")
    print(f"[path H] {card} | launches {total} by phase {phase}", flush=True)
    return total


# --- Phase 10: the card tests ----------------------------------------------------
CARD_TESTS = "tests/test_torch_cuda.py"
CARD_TESTS_TIMEOUT_S = 420


def run_card_tests() -> dict:
    """Runs the ``gpu`` tests of ``CARD_TESTS`` in a subprocess (pytest, its
    own time limit) and fails on any failure, error or skip: with a card
    present none of them may skip.  Returns the counts and the wall time."""
    import xml.etree.ElementTree as ET

    report = ROOT / "build" / "card_tests.xml"
    report.parent.mkdir(parents=True, exist_ok=True)
    report.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p", "no:cacheprovider",
           f"--junitxml={report}", CARD_TESTS]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=CARD_TESTS_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        raise AssertionError(f"card tests: over {CARD_TESTS_TIMEOUT_S} s") from exc
    wall = time.perf_counter() - t0
    if not report.exists():
        raise AssertionError(f"card tests wrote no report (exit {proc.returncode}):\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    suite = ET.parse(report).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    n = {k: int(suite.get(k, 0)) for k in ("tests", "failures", "errors", "skipped")}
    res = dict(passed=n["tests"] - n["failures"] - n["errors"] - n["skipped"],
               skipped=n["skipped"], failed=n["failures"], errors=n["errors"],
               wall_s=round(wall, 1))
    print(f"[card tests] {CARD_TESTS} -m gpu: passed={res['passed']} skipped={res['skipped']} "
          f"failed={res['failed']} errors={res['errors']} wall_s={res['wall_s']}", flush=True)
    if proc.returncode != 0 or res["failed"] or res["errors"] or res["skipped"] or not res["passed"]:
        raise AssertionError(f"card tests did not all pass (exit {proc.returncode}):\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    return res


# --- Path C: multi-tenant serving ---------------------------------------------
C_ARCH = "stablelm-1.6b"
DEVICE = "cuda"
C_BATCH, C_PROMPT, C_GEN, C_TENANTS, C_SLOTS = 8, 512, 32, 4, 8
# Adapter B ~ N(0, 0.05^2): the rank-8 correction is then of the order of
# the base q / v projection, so tenants visibly differ.
C_B_STD = 0.05
# Client deltas of the hot swap: 10x the adapter's size, so tenant 0's new
# adapter visibly moves its logits.
C_DELTA_SCALE = 10.0
C_PROFILE_STEPS = 4
# One tenant on every row through the pool (gathered kernel) against a plain
# forward with that tenant's 2-D adapter (lora_matmul): both kernels compute a
# row with the same fp32 arithmetic and round it once to bf16, so the logits
# should agree to the bit; the bound allows one bf16 ulp of the largest logit
# (2^-7 relative) should a layer's rounding land on the other side of a tie.
C_ONE_TENANT_RTOL = 2.0**-7
# Card vs CPU at depth 2 in float32: fp32 sums of up to 5632 products in other
# orders over 2 layers, relative to the largest logit.
C_CARD_CPU_RTOL = 2e-4


def tenant_adapter(cfg, seed: int, device=None):
    """A trained-looking adapter: the init's A, and B drawn from ``seed``,
    pattern slot by pattern slot (the mixer's adapters, then the
    cross-attention's where there are any), then the tail layers."""
    import torch
    from repro_torch.models import init_lora_params

    device = device or DEVICE
    tree = init_lora_params(cfg, seed=seed, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    for layer in (*tree["groups"], *tree["tail"]):
        for sub in layer.values():
            for node in sub.values():
                node["B"].normal_(0.0, C_B_STD, generator=g)
    return tree


def client_deltas(cfg, seed: int, n_clients: int = 4):
    """Stacked client deltas of one tenant's adapter: a shared direction plus
    per-client noise, drawn on the card from ``seed``."""
    import torch
    from repro_torch.utils.pytree import tree_map

    shared = tree_map(lambda x: C_DELTA_SCALE * x, tenant_adapter(cfg, seed))
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    return tree_map(lambda x: torch.stack([x + 0.2 * x.std() * torch.randn(
        x.shape, generator=g, device=DEVICE) for _ in range(n_clients)]), shared)


def serve_once(base, pool, cfg, adapter_ids, prompts, gen, keep_caches: bool = False,
               rng=None):
    """``serve_batch`` through a ``RequestScheduler``, recording the prefill
    and decode logits, the extended caches, the first token and the prefill
    batch (with the frontend stubs ``serve_batch`` draws from the numpy
    generator ``rng``); prefill time (the stubs drawn before it) and decode
    time on the host clock, each ending in a synchronise.

    Decode writes the caches in place.  With ``keep_caches`` the record
    holds a copy of them as the prefill left them, taken before the decode
    clock starts: a ring that wraps or a recurrent state is otherwise read
    after the run's own decode has moved it on.  Without it the record holds
    the live caches and the clock starts at the first decode call, which
    does for a KV cache whose decode rewrites each position it reads."""
    import torch
    from repro_torch.launch import serve

    sched = serve.RequestScheduler(pool, len(adapter_ids))
    for i, aid in enumerate(adapter_ids):
        sched.submit(serve.Request(i, aid, prompts[i]))
    prefill, decode = serve.make_serving_fns(cfg)
    rec = {"decode_logits": [], "t": {}, "prompt_len": len(prompts[0])}

    def timed_prefill(*args):
        rec["batch"] = args[-1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(*args)
        torch.cuda.synchronize()
        rec["t"]["prefill_s"] = time.perf_counter() - t0
        rec["prefill_logits"] = logits
        return logits, caches

    def recorded_decode(base_, pooled, slots, tok, caches, idx):
        if "caches" not in rec and keep_caches:
            rec.update(caches=clone_caches(caches), first_tok=tok, slots=slots)
            torch.cuda.synchronize()
            rec["t"]["decode_t0"] = time.perf_counter()
        elif "caches" not in rec:
            rec["t"]["decode_t0"] = time.perf_counter()
            rec.update(caches=caches, first_tok=tok, slots=slots)
        logits, caches = decode(base_, pooled, slots, tok, caches, idx)
        rec["decode_logits"].append(logits)
        return logits, caches

    _, tokens = serve.serve_batch(base, pool, sched, cfg, gen=gen, prefill_fn=timed_prefill,
                                  decode_fn=recorded_decode, rng=rng)
    torch.cuda.synchronize()
    rec["t"]["decode_s"] = time.perf_counter() - rec["t"].pop("decode_t0")
    rec["tokens"] = tokens
    return rec


def clone_caches(caches, device=None):
    """A copy of a cache tree (decode writes KV rings and recurrent states in
    place), self and cross caches alike, on ``device`` (default where it
    is)."""
    one = lambda c: {k: type(st)(*(x.to(device or x.device, copy=True) for x in st))
                     for k, st in c.items()}
    return {"groups": tuple(map(one, caches["groups"])), "tail": tuple(map(one, caches["tail"]))}


def decode_again(base, pool, cfg, rec, gen):
    """Greedy decode from a copy of the recorded caches (see ``serve_once``)
    and the first token."""
    import torch
    from repro_torch.launch import serve

    _, decode = serve.make_serving_fns(cfg)
    tok, caches = rec["first_tok"], clone_caches(rec["caches"])
    logits_out, toks = [], [rec["first_tok"]]
    prompt_len = rec["prompt_len"]
    for i in range(gen - 1):
        logits, caches = decode(base, pool.pooled, rec["slots"], tok, caches, prompt_len + i)
        tok = serve.greedy(logits)
        logits_out.append(logits)
        toks.append(tok)
    return logits_out, torch.cat(toks, dim=1)


def profiled(fn, spans: dict | None = None):
    """``fn()`` under ``torch.profiler``: (host seconds, device-busy seconds
    or None when the profiler sees no device time, the five kernels with the
    most device time as (name, ms, calls)).  Only device rows count: a CPU
    op's row carries the time of the kernels it launched, which have rows of
    their own.  For each key of ``spans``, a ``record_function`` range name,
    ``spans[name]`` becomes ``span_times`` of its ranges."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    # A record_function range also leaves a device row spanning its
    # kernels (a user annotation); it is not device time of its own.
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and dev(e) > 0 and e.key not in (spans or ())
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(dev(e) for e in events) / 1e6
    top = sorted(events, key=dev, reverse=True)[:5]
    for name in spans or ():
        spans[name] = span_times([e for e in prof.events()
                                  if e.name == name and e.device_type == DeviceType.CPU])
    return wall, (busy or None), [(e.key[:60], round(dev(e) / 1e3, 3), e.count) for e in top]


# Kernels of a GEMM library or of a hand-written GEMM, by name.
GEMM_KERNEL_TAGS = ("gemm", "nvjet", "xmma", "cutlass", "sm90_")


def span_times(ranges) -> dict:
    """The profiled ``record_function`` ranges ``ranges``: their calls, host
    seconds (the ranges' own CPU time) and device seconds of the kernels
    launched inside them (the launching ops' kernels, walked through the
    ranges' children), split into GEMM kernels (``GEMM_KERNEL_TAGS``) and
    the rest; the device numbers are None where the profiler links no
    kernel to a range."""
    def kernels(e):
        out = list(getattr(e, "kernels", ()))
        for ch in e.cpu_children:
            out += kernels(ch)
        return out

    ks = [k for e in ranges for k in kernels(e)]
    gemm = sum(k.duration for k in ks if any(t in k.name.lower() for t in GEMM_KERNEL_TAGS))
    total = sum(k.duration for k in ks)
    return dict(calls=len(ranges), host_s=sum(e.cpu_time_total for e in ranges) / 1e6,
                device_s=total / 1e6 if ks else None,
                gemm_device_s=gemm / 1e6 if ks else None)


def profile_decode(base, pool, cfg, rec, steps: int, spans: dict | None = None):
    """``steps`` greedy decode steps under ``torch.profiler`` (see
    ``profiled``, which fills ``spans``), from a copy of the recorded caches
    (see ``serve_once``) made before the profiled window."""
    from repro_torch.launch import serve

    _, decode = serve.make_serving_fns(cfg)
    caches = clone_caches(rec["caches"])

    def run():
        tok = rec["first_tok"]
        for i in range(steps):
            logits, _ = decode(base, pool.pooled, rec["slots"], tok, caches,
                               rec["prompt_len"] + i)
            tok = serve.greedy(logits)

    return profiled(run, spans)


def launch_checker(counts, path: str):
    """(launched, expect, phase) for a path: ``launched(since)`` is the
    launch counts since the snapshot ``since``; ``expect(name, got, **want)``
    raises unless ``got`` equals ``want`` (0 for every kernel not named) and
    records it in ``phase`` under ``name``."""
    phase = {}

    def launched(since):
        return {k: v - since[k] for k, v in counts().items()}

    def expect(name, got, **want):
        full = {k: want.get(k, 0) for k in got}
        if got != full:
            raise AssertionError(f"{path} {name}: launches {got} != {full}")
        phase[name] = got

    return launched, expect, phase


def check_routing(card_log, cpu_log, top_k: int, what: str, hold: bool = True) -> int:
    """The MoE experts chosen on the card against the CPU's, call by call
    (``moe.routing_log``; layer by layer in each forward): a flip moves
    every later capacity slot of its expert, so outputs are compared only
    where the routing agrees.  Returns the number of tokens whose experts
    differ; with ``hold`` any flip raises, naming the CPU's probability gap
    between the k-th and (k+1)-th expert at the flipped tokens."""
    import torch

    if len(card_log) != len(cpu_log):
        raise AssertionError(f"{what}: {len(card_log)} routed calls on the card, "
                             f"{len(cpu_log)} on the CPU")
    flips = 0
    for i, ((ce, _, _), (we, _, wprobs)) in enumerate(zip(card_log, cpu_log)):
        diff = (ce.cpu() != we).any(dim=-1)
        if not bool(diff.any()):
            continue
        flips += int(diff.sum())
        srt = torch.sort(wprobs, dim=-1, descending=True).values
        gap = (srt[..., top_k - 1] - srt[..., top_k])[diff] if srt.shape[-1] > top_k else srt[diff]
        msg = (f"{what}: routed call {i}: {int(diff.sum())} tokens pick other experts on the "
               f"card than on the CPU; the CPU's gap between expert {top_k} and {top_k + 1} "
               f"there: {[f'{float(x):.3g}' for x in gap[:8]]}")
        print(f"[routing] {msg}", flush=True)
        if hold:
            raise AssertionError(msg)
    return flips


# Card vs CPU with an int8 cache: the two devices' float32 K and V round
# apart, so a value that sits within rounding of a half int8 step may land one
# step apart; at most this share of the int8 values may, each by one step.
KV_FLIP_SHARE = 1e-3


def int8_flips(got, want, what: str) -> str:
    """The int8 caches (``QuantKVCache``) of ``got`` against ``want``: values
    at most one step apart and at most ``KV_FLIP_SHARE`` of them apart,
    float16 scales within one ulp.  Returns a summary."""
    from repro_torch.models.kvcache import QuantKVCache

    nodes = lambda t: [c["self"] for c in (*t["groups"], *t["tail"])
                       if isinstance(c["self"], QuantKVCache)]
    flipped = total = 0
    worst_scale = 0.0
    for a, b in zip(nodes(got), nodes(want)):
        for x, y in zip(a[:2], b[:2]):
            diff = (x.cpu().int() - y.cpu().int()).abs()
            if int(diff.max()) > 1:
                raise AssertionError(f"{what}: int8 cache values {int(diff.max())} steps apart")
            flipped, total = flipped + int((diff > 0).sum()), total + diff.numel()
        for x, y in zip(a[2:], b[2:]):
            rel = ((x.cpu().float() - y.cpu().float()).abs()
                   / y.cpu().float().abs().clamp_min(2.0**-24)).max()
            worst_scale = max(worst_scale, float(rel))
    if not total or flipped > KV_FLIP_SHARE * total or worst_scale > 2.0**-10:
        raise AssertionError(f"{what}: {flipped} of {total} int8 cache values one step apart "
                             f"(bound {KV_FLIP_SHARE:g}), float16 scales {worst_scale:.3g} "
                             f"apart (bound 2^-10)")
    return (f"int8 caches: {flipped} of {total} values one step apart, scales within "
            f"{worst_scale:.3g}")


def card_vs_cpu(cfg, rng, path: str, card: str, counts, launched, expect,
                prefill_launches: dict, *, n_layers: int = 2, n_requests: int = 4,
                prompt_lens=(64,), steps: int = 3, decode_per_layer: int = 2):
    """The serving run at full width, depth ``n_layers``, in float32, on the
    card and on the CPU from the same weights and adapters: ``n_requests``
    requests of as many tenants, for each prompt length a prefill, then
    ``steps`` decode steps of the card's greedy tokens on both devices;
    logits within ``C_CARD_CPU_RTOL`` of the largest.  The card's prefill
    launches ``prefill_launches`` and each decode step ``decode_per_layer``
    gathered launches a layer.  A config with a frontend takes its stubs,
    drawn once on the host for each prompt (``serve._make_batch``), on both
    devices.  With experts, each call's routing is compared first
    (``check_routing``): a flip fails with its probability gap.  With an
    int8 cache the card's prefill caches are held to the CPU's
    (``int8_flips``), and the card then decodes from a copy of the CPU's
    cache bits: one value a step apart moves the logits by more than float32
    rounding does."""
    import copy

    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import init_params, moe
    from repro_torch.serve import AdapterPool
    from repro_torch.utils.pytree import tree_to

    cfg2 = cfg.replace(n_layers=n_layers, n_encoder_layers=min(cfg.n_encoder_layers, n_layers),
                       dtype="float32")
    base2 = init_params(cfg2, seed=5, device=DEVICE)
    cpu_base = copy.deepcopy(base2).cpu()
    pools = {"card": AdapterPool(tenant_adapter(cfg2, 98), n_requests),
             "cpu": AdapterPool(tree_to(tenant_adapter(cfg2, 98), "cpu"), n_requests)}
    ids = [f"tenant-{i}" for i in range(n_requests)]
    for i, aid in enumerate(ids):
        tree = tenant_adapter(cfg2, 200 + i)
        pools["card"].publish(aid, tree)
        pools["cpu"].publish(aid, tree_to(tree, "cpu"))
    prefill, decode = serve.make_serving_fns(cfg2)
    runs = {"card": (DEVICE, base2), "cpu": ("cpu", cpu_base)}
    for prompt in prompt_lens:
        prompts2 = torch.as_tensor(rng.integers(0, cfg2.vocab_size, size=(n_requests, prompt)))
        batch = serve._make_batch(cfg2, prompts2, np.random.default_rng(prompt))
        logits_of, state = {"card": [], "cpu": []}, {}
        routes = {"card": [], "cpu": []}
        before = counts()
        for key, (dev, b_) in runs.items():
            slots = pools[key].acquire(ids)
            with moe.routing_log() as log:
                logits, caches = prefill(b_, pools[key].pooled, slots,
                                         {k: v.to(dev) for k, v in batch.items()})
            routes[key] += log
            logits_of[key].append(logits.cpu())
            state[key] = (slots, serve.extend_caches(caches, steps + 1, cfg2))
        expect(f"card vs CPU prefill {prompt}", launched(before), **prefill_launches)
        quant = ""
        if cfg2.kv_quant:
            quant = int8_flips(state["card"][1], state["cpu"][1],
                               f"{path} card vs CPU (prompt {prompt})") + (
                "; the card decodes from the CPU's cache bits, ")
            state["card"] = (state["card"][0], clone_caches(state["cpu"][1], DEVICE))
        before = counts()
        tok = serve.greedy(logits_of["card"][0])
        for i in range(steps):  # both devices decode the card's greedy tokens
            for key, (dev, b_) in runs.items():
                slots, caches = state[key]
                with moe.routing_log() as log:
                    logits, _ = decode(b_, pools[key].pooled, slots, tok.to(dev), caches,
                                       prompt + i)
                routes[key] += log
                logits_of[key].append(logits.cpu())
            tok = serve.greedy(logits_of["card"][-1])
        expect(f"card vs CPU decode {prompt}", launched(before),
               gathered_lora_matmul=decode_per_layer * n_layers * steps)
        check_routing(routes["card"], routes["cpu"], cfg2.top_k, f"{path} card vs CPU "
                      f"(prompt {prompt})")
        routed = (f"routing equal in {len(routes['card'])} routed calls, " if routes["card"]
                  else "")
        errs = []
        for g_, c_ in zip(logits_of["card"], logits_of["cpu"]):
            err, scale = max_abs(g_, c_), float(c_.abs().max())
            if not bool(torch.isfinite(g_).all()) or err > C_CARD_CPU_RTOL * scale:
                raise AssertionError(f"{path} card vs CPU (prompt {prompt}): {err} > "
                                     f"{C_CARD_CPU_RTOL} * {scale}")
            errs.append(err)
        print(f"[{path}] {card} | card vs CPU, depth {n_layers} float32, {n_requests} requests "
              f"x {prompt} prompt + {steps + 1} tokens: "
              f"{routed}{quant}"
              f"prefill and decode logits max|err| "
              f"{[f'{e:.3g}' for e in errs]} (max|logit| "
              f"{float(logits_of['cpu'][0].abs().max()):.4g})", flush=True)


def main_path_c(counts, card: str) -> dict:
    """Serve full-width StableLM-2-1.6B (24 layers, bf16) to 8 requests of 4
    tenants through the pool, then through the merged adapter; check one
    tenant on every row against its plain 2-D adapter; hot-swap a FedRPCA
    aggregate into tenant 0 and decode again; and the same serving run at
    depth 2 in float32 on the card and on the CPU.  Returns the launch
    counts of the run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import AggregatorConfig, aggregate
    from repro_torch.core.engine import pack
    from repro_torch.launch import serve
    from repro_torch.models import forward, init_params
    from repro_torch.models.model import param_count
    from repro_torch.serve import AdapterPool
    from repro_torch.utils.pytree import tree_leaves

    cfg = get_config(C_ARCH)
    n_l = cfg.n_layers
    start = counts()
    launched, expect, phase = launch_checker(counts, "path C")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = init_params(cfg, seed=0, device=DEVICE)
    trees = [tenant_adapter(cfg, 100 + i) for i in range(C_TENANTS)]
    pool = AdapterPool(tenant_adapter(cfg, 99), C_SLOTS)
    for i, tree in enumerate(trees):
        pool.publish(f"tenant-{i}", tree)
    torch.cuda.synchronize()
    print(f"[path C] {card} | {C_ARCH}: {param_count(base) / 1e9:.3f} B parameters "
          f"({cfg.dtype}), {n_l} layers, pool {len(pool)}/{pool.n_slots} slots, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(C_BATCH, C_PROMPT))
    ids = [f"tenant-{i % C_TENANTS}" for i in range(C_BATCH)]

    before = counts()
    rec = serve_once(base, pool, cfg, ids, prompts, C_GEN)
    expect("pool", launched(before), gathered_lora_matmul=2 * n_l * C_GEN,
           gathered_lora_matmul_tc=2 * n_l * C_GEN, local_attention=n_l,
           local_attention_tc=n_l)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    all_logits = [rec["prefill_logits"]] + rec["decode_logits"]
    if not all(bool(torch.isfinite(x).all()) for x in all_logits):
        raise AssertionError("path C: non-finite logits on the pool path")
    t = rec["t"]
    tok_s = C_BATCH * (C_GEN - 1) / t["decode_s"]
    print(f"[path C] {card} | pool: prefill {C_BATCH}x{C_PROMPT} tokens {t['prefill_s']:.4f} s, "
          f"decode {C_GEN - 1} steps {t['decode_s']:.4f} s = {tok_s:.1f} tokens/s, peak memory "
          f"{peak_gb:.2f} GB, launches {phase['pool']}", flush=True)
    print(f"[path C] pool continuations (first 8 tokens): "
          f"{rec['tokens'][:, :8].tolist()}", flush=True)
    before = counts()
    wall, busy, top = profile_decode(base, pool, cfg, rec, C_PROFILE_STEPS)
    expect("profile", launched(before), gathered_lora_matmul=2 * n_l * C_PROFILE_STEPS,
           gathered_lora_matmul_tc=2 * n_l * C_PROFILE_STEPS)
    share = "not measured" if busy is None else f"{busy:.4f} s busy = {busy / wall:.3f}"
    print(f"[path C] {card} | {C_PROFILE_STEPS} decode steps under torch.profiler: host "
          f"{wall:.4f} s, device {share} of it; top kernels by device ms (name, ms, "
          f"calls): {top}", flush=True)

    # A warm prefill of the same batch: the pool run's prefill is the model's
    # first, and its host time carries first-call costs.
    toks = torch.as_tensor(prompts, device=DEVICE)
    prefill = serve.make_serving_fns(cfg)[0]
    slots = pool.acquire(ids)
    before = counts()
    wall, busy, top = profiled(lambda: prefill(base, pool.pooled, slots, {"tokens": toks}))
    expect("profile prefill", launched(before), gathered_lora_matmul=2 * n_l,
           gathered_lora_matmul_tc=2 * n_l, local_attention=n_l, local_attention_tc=n_l)
    share = "not measured" if busy is None else f"{busy:.4f} s busy = {busy / wall:.3f}"
    print(f"[path C] {card} | one prefill under torch.profiler: host {wall:.4f} s, device "
          f"{share} of it; top kernels by device ms (name, ms, calls): {top}", flush=True)

    merged = pool.merged()
    before = counts()
    t1 = time.perf_counter()
    merged_tokens = serve.serve_merged(base, merged, toks, cfg, gen=C_GEN)
    torch.cuda.synchronize()
    t_merged = time.perf_counter() - t1
    merged_logits = forward(base, merged, {"tokens": toks}, cfg, mode="prefill")[0]
    expect("merged", launched(before), lora_matmul=2 * n_l * (C_GEN + 1),
           lora_matmul_tc=2 * n_l * (C_GEN + 1), local_attention=2 * n_l,
           local_attention_tc=2 * n_l)
    gaps = [float((rec["prefill_logits"][i] - merged_logits[i]).abs().max())
            for i in range(C_BATCH)]
    if not bool(torch.isfinite(merged_logits).all()) or min(gaps) <= 0.0:
        raise AssertionError(f"path C: per-tenant logits do not differ from merged: {gaps}")
    same_tokens = int((merged_tokens == rec["tokens"]).all(dim=1).sum())
    print(f"[path C] {card} | merged: {C_GEN} tokens in {t_merged:.4f} s; per-request max "
          f"|pool - merged| prefill logit {min(gaps):.4g}..{max(gaps):.4g}; requests with "
          f"identical continuations {same_tokens}/{C_BATCH}; launches {phase['merged']}",
          flush=True)

    before = counts()
    one_pool = prefill(base, pool.pooled, pool.acquire(["tenant-1"] * C_BATCH),
                       {"tokens": toks})[0]
    one_plain = forward(base, trees[1], {"tokens": toks}, cfg, mode="prefill")[0]
    expect("one tenant", launched(before), gathered_lora_matmul=2 * n_l,
           gathered_lora_matmul_tc=2 * n_l, lora_matmul=2 * n_l, lora_matmul_tc=2 * n_l,
           local_attention=2 * n_l, local_attention_tc=2 * n_l)
    err = max_abs(one_pool, one_plain)
    scale = float(one_plain.abs().max())
    if err > C_ONE_TENANT_RTOL * scale:
        raise AssertionError(f"path C: one tenant via pool vs 2-D adapter {err} > "
                             f"{C_ONE_TENANT_RTOL} * {scale}")
    print(f"[path C] {card} | one tenant on every row, pool (gathered) vs 2-D adapter "
          f"(lora_matmul): "
          f"max|err| {err:.4g} (max|logit| {scale:.4g}, bitwise {bool(err == 0.0)})", flush=True)

    # Hot swap: FedRPCA over 4 client deltas of tenant 0, published in place.
    ptrs = [x.data_ptr() for x in tree_leaves(pool.pooled)]
    deltas = client_deltas(cfg, 7)
    n_buckets = len(pack(deltas)[0])
    before = counts()
    t1 = time.perf_counter()
    update = aggregate(deltas, AggregatorConfig(method="fedrpca", rpca_iters=5), device=DEVICE)
    pool.publish_round("tenant-0", trees[0], update)
    torch.cuda.synchronize()
    t_swap = time.perf_counter() - t1
    new_logits, new_tokens = decode_again(base, pool, cfg, rec, C_GEN)
    expect("hot swap", launched(before), admm_tail=5 * n_buckets,
           gathered_lora_matmul=2 * n_l * (C_GEN - 1),
           gathered_lora_matmul_tc=2 * n_l * (C_GEN - 1))
    if [x.data_ptr() for x in tree_leaves(pool.pooled)] != ptrs:
        raise AssertionError("path C: publish_round moved the pooled tensors")
    tenant0 = torch.tensor([i % C_TENANTS == 0 for i in range(C_BATCH)], device=DEVICE)
    moved = max(float((a[tenant0] - b[tenant0]).abs().max())
                for a, b in zip(new_logits, rec["decode_logits"]))
    others_same = all(torch.equal(a[~tenant0], b[~tenant0])
                      for a, b in zip(new_logits, rec["decode_logits"]))
    if moved <= 0.0 or not others_same or not torch.equal(new_tokens[~tenant0],
                                                         rec["tokens"][~tenant0]):
        raise AssertionError(f"path C hot swap: tenant-0 logits moved {moved}, other tenants "
                             f"bitwise unchanged {others_same}")
    changed = int((new_tokens[tenant0] != rec["tokens"][tenant0]).any(dim=1).sum())
    print(f"[path C] {card} | hot swap: aggregate ({n_buckets} bucket, 5 ADMM iterations) + "
          f"publish_round {t_swap:.4f} s; tenant-0 decode logits moved by up to {moved:.4g}, "
          f"tenant-0 continuations changed {changed}/{int(tenant0.sum())}, other tenants "
          f"bitwise unchanged; pooled data_ptr unchanged; launches {phase['hot swap']}",
          flush=True)
    del base, pool, trees, rec, new_logits, deltas, update

    card_vs_cpu(cfg, rng, "path C", card, counts, launched, expect,
                dict(gathered_lora_matmul=4, local_attention=2))
    total = launched(start)
    print(f"[path C] {card} | launches {total} by phase {phase}", flush=True)
    return total


# --- Path D: multi-tenant serving of Mamba-2 -----------------------------------
D_ARCH = "mamba2-130m"
D_BATCH, D_PROMPT, D_GEN, D_TENANTS, D_SLOTS = 8, 512, 32, 4, 8
# State handoff: a prefill of D_HANDOFF tokens (not a multiple of the kernel's
# 64-position tile), then one decode step, against a prefill of one token
# more, all 24 layers in float32 through the pool.  The last position is
# computed by the chunked kernel in one run and by the plain decode
# recurrence from the kernel's final state in the other: fp32 sums in other
# orders over 24 layers, held to 1e-4 of the largest logit.  The same decode
# from a zeroed state must fail that bound, or the check could not see a
# broken state.
D_HANDOFF = 300
D_HANDOFF_RTOL = 1e-4


def main_path_d(counts, card: str) -> dict:
    """Serve full-width Mamba-2-130M (24 layers, bf16) to 8 requests of 4
    tenants through the pool, then through the merged adapter; check one
    tenant on every row against its plain 2-D adapter; hand the prefill's
    final state to decode and compare with a longer prefill; and the same
    serving run at depth 2 in float32 on the card and on the CPU.  Returns
    the launch counts of the run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import forward, init_params
    from repro_torch.models.model import param_count
    from repro_torch.serve import AdapterPool

    cfg = get_config(D_ARCH)
    n_l = cfg.n_layers
    start = counts()
    launched, expect, phase = launch_checker(counts, "path D")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = init_params(cfg, seed=0, device=DEVICE)
    trees = [tenant_adapter(cfg, 300 + i) for i in range(D_TENANTS)]
    pool = AdapterPool(tenant_adapter(cfg, 299), D_SLOTS)
    for i, tree in enumerate(trees):
        pool.publish(f"tenant-{i}", tree)
    torch.cuda.synchronize()
    print(f"[path D] {card} | {D_ARCH}: {param_count(base) / 1e6:.1f} M parameters "
          f"({cfg.dtype}), {n_l} layers, pool {len(pool)}/{pool.n_slots} slots, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, size=(D_BATCH, D_PROMPT))
    ids = [f"tenant-{i % D_TENANTS}" for i in range(D_BATCH)]

    before = counts()
    rec = serve_once(base, pool, cfg, ids, prompts, D_GEN)
    expect("pool", launched(before), gathered_lora_matmul=2 * n_l * D_GEN,
           gathered_lora_matmul_tc=2 * n_l * D_GEN, ssd_scan=n_l)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    all_logits = [rec["prefill_logits"]] + rec["decode_logits"]
    if not all(bool(torch.isfinite(x).all()) for x in all_logits):
        raise AssertionError("path D: non-finite logits on the pool path")
    t = rec["t"]
    tok_s = D_BATCH * (D_GEN - 1) / t["decode_s"]
    print(f"[path D] {card} | pool: prefill {D_BATCH}x{D_PROMPT} tokens {t['prefill_s']:.4f} s, "
          f"decode {D_GEN - 1} steps {t['decode_s']:.4f} s = {tok_s:.1f} tokens/s, peak memory "
          f"{peak_gb:.3f} GB, launches {phase['pool']} (ssd_scan = {n_l} layers x 1 prefill)",
          flush=True)
    print(f"[path D] pool continuations (first 8 tokens): {rec['tokens'][:, :8].tolist()}",
          flush=True)

    toks = torch.as_tensor(prompts, device=DEVICE)
    prefill, _ = serve.make_serving_fns(cfg)
    slots = pool.acquire(ids)
    before = counts()
    wall, busy, top = profiled(lambda: prefill(base, pool.pooled, slots, {"tokens": toks}))
    expect("profile prefill", launched(before), gathered_lora_matmul=2 * n_l,
           gathered_lora_matmul_tc=2 * n_l, ssd_scan=n_l)
    share = "not measured" if busy is None else f"{busy:.4f} s busy = {busy / wall:.3f}"
    print(f"[path D] {card} | one prefill under torch.profiler: host {wall:.4f} s, device "
          f"{share} of it; top kernels by device ms (name, ms, calls): {top}", flush=True)
    before = counts()
    wall, busy, top = profile_decode(base, pool, cfg, rec, C_PROFILE_STEPS)
    expect("profile decode", launched(before), gathered_lora_matmul=2 * n_l * C_PROFILE_STEPS,
           gathered_lora_matmul_tc=2 * n_l * C_PROFILE_STEPS)
    share = "not measured" if busy is None else f"{busy:.4f} s busy = {busy / wall:.3f}"
    print(f"[path D] {card} | {C_PROFILE_STEPS} decode steps under torch.profiler: host "
          f"{wall:.4f} s, device {share} of it; top kernels by device ms (name, ms, "
          f"calls): {top}", flush=True)

    merged = pool.merged()
    before = counts()
    t1 = time.perf_counter()
    merged_tokens = serve.serve_merged(base, merged, toks, cfg, gen=D_GEN)
    torch.cuda.synchronize()
    t_merged = time.perf_counter() - t1
    merged_logits = forward(base, merged, {"tokens": toks}, cfg, mode="prefill")[0]
    expect("merged", launched(before), lora_matmul=2 * n_l * (D_GEN + 1),
           lora_matmul_tc=2 * n_l * (D_GEN + 1), ssd_scan=2 * n_l)
    gaps = [float((rec["prefill_logits"][i] - merged_logits[i]).abs().max())
            for i in range(D_BATCH)]
    if not bool(torch.isfinite(merged_logits).all()) or min(gaps) <= 0.0:
        raise AssertionError(f"path D: per-tenant logits do not differ from merged: {gaps}")
    same_tokens = int((merged_tokens == rec["tokens"]).all(dim=1).sum())
    print(f"[path D] {card} | merged: {D_GEN} tokens in {t_merged:.4f} s; per-request max "
          f"|pool - merged| prefill logit {min(gaps):.4g}..{max(gaps):.4g}; requests with "
          f"identical continuations {same_tokens}/{D_BATCH}; launches {phase['merged']}",
          flush=True)

    before = counts()
    one_pool = prefill(base, pool.pooled, pool.acquire(["tenant-1"] * D_BATCH),
                       {"tokens": toks})[0]
    one_plain = forward(base, trees[1], {"tokens": toks}, cfg, mode="prefill")[0]
    expect("one tenant", launched(before), gathered_lora_matmul=2 * n_l,
           gathered_lora_matmul_tc=2 * n_l, lora_matmul=2 * n_l, lora_matmul_tc=2 * n_l,
           ssd_scan=2 * n_l)
    err = max_abs(one_pool, one_plain)
    scale = float(one_plain.abs().max())
    if err > C_ONE_TENANT_RTOL * scale:
        raise AssertionError(f"path D: one tenant via pool vs 2-D adapter {err} > "
                             f"{C_ONE_TENANT_RTOL} * {scale}")
    print(f"[path D] {card} | one tenant on every row, pool (gathered) vs 2-D adapter "
          f"(lora_matmul): max|err| {err:.4g} (max|logit| {scale:.4g}, bitwise "
          f"{bool(err == 0.0)})", flush=True)
    del base, pool, trees, rec, merged, merged_logits

    # State handoff at full depth in float32.
    cfg32 = cfg.replace(dtype="float32")
    base32 = init_params(cfg32, seed=3, device=DEVICE)
    pool32 = AdapterPool(tenant_adapter(cfg32, 399), 4)
    for i in range(4):
        pool32.publish(f"tenant-{i}", tenant_adapter(cfg32, 400 + i))
    slots32 = pool32.acquire([f"tenant-{i}" for i in range(4)])
    long_toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4, D_HANDOFF + 1)),
                                device=DEVICE)
    prefill32, decode32 = serve.make_serving_fns(cfg32)
    before = counts()
    _, caches = prefill32(base32, pool32.pooled, slots32, {"tokens": long_toks[:, :-1]})
    caches = serve.extend_caches(caches, 1, cfg32)
    kept = clone_caches(caches)
    step = decode32(base32, pool32.pooled, slots32, long_toks[:, -1:], kept, D_HANDOFF)[0]
    whole = prefill32(base32, pool32.pooled, slots32, {"tokens": long_toks})[0]
    for g in caches["groups"]:
        g["self"].h.zero_()
    no_state = decode32(base32, pool32.pooled, slots32, long_toks[:, -1:], caches,
                        D_HANDOFF)[0]
    expect("state handoff", launched(before), gathered_lora_matmul=2 * n_l * 4,
           ssd_scan=2 * n_l)
    err, scale = max_abs(step, whole), float(whole.abs().max())
    miss = max_abs(no_state, whole)
    if not bool(torch.isfinite(step).all()) or err > D_HANDOFF_RTOL * scale:
        raise AssertionError(f"path D state handoff: {err} > {D_HANDOFF_RTOL} * {scale}")
    if miss <= D_HANDOFF_RTOL * scale:
        raise AssertionError(f"path D state handoff: a zeroed state passes too ({miss})")
    print(f"[path D] {card} | state handoff, 24 layers float32: decode of token "
          f"{D_HANDOFF + 1} after a {D_HANDOFF}-token prefill vs a {D_HANDOFF + 1}-token "
          f"prefill: max|err| {err:.4g} (max|logit| {scale:.4g}); from a zeroed state "
          f"{miss:.4g}", flush=True)
    del base32, pool32, caches, kept

    card_vs_cpu(cfg, rng, "path D", card, counts, launched, expect,
                dict(gathered_lora_matmul=4, ssd_scan=2))
    total = launched(start)
    print(f"[path D] {card} | launches {total} by phase {phase}", flush=True)
    return total


# --- Path J: multi-tenant serving of RecurrentGemma-2B ------------------------------
J_ARCH = "recurrentgemma-2b"
# A prompt past the 2048-token window: the window binds at prefill and the
# ring wraps (decode writes slot t % 2048 over keys that left the window).
J_BATCH, J_PROMPT, J_GEN, J_TENANTS, J_SLOTS = 8, 2560, 32, 4, 8
# J4: card vs CPU at full width, depth 5 (one pattern unit and the two tail
# layers), with the window replaced by 64 so the CPU side is cheap and the
# ring still wraps: a prompt past it and one short of it (the ring then
# grows to min(window, prompt + steps), extend_caches).
J4_LAYERS, J4_WINDOW, J4_PROMPTS, J4_STEPS = 5, 64, (96, 40), 8
# J5: on the card alone, depth 5 in float32 at the real window, each decode
# step's logits against the train-mode forward's at that position: the
# prefill runs the window kernel and the doubling scan, decode the ring and
# the stepwise recurrence, fp32 sums in other orders over 5 layers; 1e-4 of
# the largest logit, as path D's state handoff.  The same step from a
# zeroed ring must miss it, or the check could not see a broken ring.
J5_PROMPT, J5_STEPS, J5_RTOL = 2100, 4, 1e-4


def main_path_j(counts, card: str) -> dict:
    """Serve full-width RecurrentGemma-2B (26 layers, bf16) to 8 requests of
    4 tenants at a 2560-token prompt through the pool (J1), through the
    merged adapter and one tenant on every row against its 2-D adapter
    (J2); hot-swap a FedRPCA aggregate of planted client deltas (tail leaves
    included) into tenant 0 and decode again (J3); card against CPU at depth
    5 with a 64-token window at prompts past and short of it (J4); decode
    against the train-mode forward at the real window (J5).  Returns the
    launch counts of the run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import AggregatorConfig, aggregate
    from repro_torch.core.engine import pack
    from repro_torch.launch import serve
    from repro_torch.models import forward, init_params
    from repro_torch.models.model import param_count
    from repro_torch.serve import AdapterPool, adapter_view
    from repro_torch.utils.pytree import tree_leaves

    t_path = time.perf_counter()
    cfg = get_config(J_ARCH)
    n_l = cfg.n_layers
    n_attn = sum(cfg.layer_pattern[i % len(cfg.layer_pattern)] == "local_attn"
                 for i in range(n_l))
    start = counts()
    launched, expect, phase = launch_checker(counts, "path J")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = init_params(cfg, seed=0, device=DEVICE)
    trees = [tenant_adapter(cfg, 500 + i) for i in range(J_TENANTS)]
    pool = AdapterPool(tenant_adapter(cfg, 499), J_SLOTS)
    for i, tree in enumerate(trees):
        pool.publish(f"tenant-{i}", tree)
    torch.cuda.synchronize()
    print(f"[path J] {card} | {J_ARCH}: {param_count(base) / 1e9:.3f} B parameters "
          f"({cfg.dtype}), {n_l} layers ({cfg.n_tail_layers} tail, {n_attn} local_attn, window "
          f"{cfg.window_size}), pool {len(pool)}/{pool.n_slots} slots, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, size=(J_BATCH, J_PROMPT))
    ids = [f"tenant-{i % J_TENANTS}" for i in range(J_BATCH)]

    # J1: the pool.
    before = counts()
    rec = serve_once(base, pool, cfg, ids, prompts, J_GEN, keep_caches=True)
    expect("J1 pool", launched(before), gathered_lora_matmul=2 * n_l * J_GEN,
           gathered_lora_matmul_tc=2 * n_l * J_GEN, local_attention=n_attn,
           local_attention_tc=n_attn)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    all_logits = [rec["prefill_logits"]] + rec["decode_logits"]
    if not all(bool(torch.isfinite(x).all()) for x in all_logits):
        raise AssertionError("path J: non-finite logits on the pool path")
    t = rec["t"]
    tok_s = J_BATCH * (J_GEN - 1) / t["decode_s"]
    print(f"[path J] {card} | J1 pool: prefill {J_BATCH}x{J_PROMPT} tokens {t['prefill_s']:.4f} "
          f"s, decode {J_GEN - 1} steps {t['decode_s']:.4f} s = {tok_s:.1f} tokens/s, peak "
          f"memory {peak_gb:.2f} GB, launches {phase['J1 pool']}", flush=True)
    print(f"[path J] pool continuations (first 8 tokens): {rec['tokens'][:, :8].tolist()}",
          flush=True)
    before = counts()
    wall, busy, top = profile_decode(base, pool, cfg, rec, C_PROFILE_STEPS)
    expect("J1 profile decode", launched(before),
           gathered_lora_matmul=2 * n_l * C_PROFILE_STEPS,
           gathered_lora_matmul_tc=2 * n_l * C_PROFILE_STEPS)
    share = "not measured" if busy is None else f"{busy:.4f} s busy = {busy / wall:.3f}"
    print(f"[path J] {card} | {C_PROFILE_STEPS} decode steps under torch.profiler: host "
          f"{wall:.4f} s, device {share} of it; top kernels by device ms (name, ms, "
          f"calls): {top}", flush=True)
    toks = torch.as_tensor(prompts, device=DEVICE)
    prefill = serve.make_serving_fns(cfg)[0]
    slots = pool.acquire(ids)
    before = counts()
    wall, busy, top = profiled(lambda: prefill(base, pool.pooled, slots, {"tokens": toks}))
    expect("J1 profile prefill", launched(before), gathered_lora_matmul=2 * n_l,
           gathered_lora_matmul_tc=2 * n_l, local_attention=n_attn, local_attention_tc=n_attn)
    share = "not measured" if busy is None else f"{busy:.4f} s busy = {busy / wall:.3f}"
    print(f"[path J] {card} | one warm prefill under torch.profiler: host {wall:.4f} s, device "
          f"{share} of it; top kernels by device ms (name, ms, calls): {top}", flush=True)

    # J2: the merged adapter; one tenant on every row.
    merged = pool.merged()
    before = counts()
    t1 = time.perf_counter()
    merged_tokens = serve.serve_merged(base, merged, toks, cfg, gen=J_GEN)
    torch.cuda.synchronize()
    t_merged = time.perf_counter() - t1
    merged_logits = forward(base, merged, {"tokens": toks}, cfg, mode="prefill")[0]
    expect("J2 merged", launched(before), lora_matmul=2 * n_l * (J_GEN + 1),
           lora_matmul_tc=2 * n_l * (J_GEN + 1), local_attention=2 * n_attn,
           local_attention_tc=2 * n_attn)
    gaps = [float((rec["prefill_logits"][i] - merged_logits[i]).abs().max())
            for i in range(J_BATCH)]
    if not bool(torch.isfinite(merged_logits).all()) or min(gaps) <= 0.0:
        raise AssertionError(f"path J: per-tenant logits do not differ from merged: {gaps}")
    same_tokens = int((merged_tokens == rec["tokens"]).all(dim=1).sum())
    print(f"[path J] {card} | J2 merged: {J_GEN} tokens in {t_merged:.4f} s; per-request max "
          f"|pool - merged| prefill logit {min(gaps):.4g}..{max(gaps):.4g}; requests with "
          f"identical continuations {same_tokens}/{J_BATCH}; launches {phase['J2 merged']}",
          flush=True)
    del merged, merged_logits
    before = counts()
    one_pool = prefill(base, pool.pooled, pool.acquire(["tenant-1"] * J_BATCH),
                       {"tokens": toks})[0]
    one_plain = forward(base, trees[1], {"tokens": toks}, cfg, mode="prefill")[0]
    expect("J2 one tenant", launched(before), gathered_lora_matmul=2 * n_l,
           gathered_lora_matmul_tc=2 * n_l, lora_matmul=2 * n_l, lora_matmul_tc=2 * n_l,
           local_attention=2 * n_attn, local_attention_tc=2 * n_attn)
    err, scale = max_abs(one_pool, one_plain), float(one_plain.abs().max())
    if err > C_ONE_TENANT_RTOL * scale:
        raise AssertionError(f"path J: one tenant via pool vs 2-D adapter {err} > "
                             f"{C_ONE_TENANT_RTOL} * {scale}")
    print(f"[path J] {card} | J2 one tenant on every row, pool (gathered) vs 2-D adapter "
          f"(lora_matmul): max|err| {err:.4g} (max|logit| {scale:.4g}, bitwise "
          f"{bool(err == 0.0)})", flush=True)

    # J3: FedRPCA over 4 client deltas of tenant 0 (group and tail leaves),
    # published in place, then decode again from the prefill's caches.
    ptrs = [x.data_ptr() for x in tree_leaves(pool.pooled)]
    deltas = client_deltas(cfg, 9)
    n_buckets = len(pack(deltas)[0])
    before = counts()
    t1 = time.perf_counter()
    update = aggregate(deltas, AggregatorConfig(method="fedrpca", rpca_iters=5), device=DEVICE)
    pool.publish_round("tenant-0", trees[0], update)
    torch.cuda.synchronize()
    t_swap = time.perf_counter() - t1
    new_logits, new_tokens = decode_again(base, pool, cfg, rec, J_GEN)
    expect("J3 hot swap", launched(before), admm_tail=5 * n_buckets,
           gathered_lora_matmul=2 * n_l * (J_GEN - 1),
           gathered_lora_matmul_tc=2 * n_l * (J_GEN - 1))
    if [x.data_ptr() for x in tree_leaves(pool.pooled)] != ptrs:
        raise AssertionError("path J: publish_round moved the pooled tensors")
    tail_moved = float((pool.pooled["tail"][0]["mixer"]["q"]["B"][pool.slot_map()["tenant-0"]]
                        - trees[0]["tail"][0]["mixer"]["q"]["B"]).abs().max())
    tenant0 = torch.tensor([i % J_TENANTS == 0 for i in range(J_BATCH)], device=DEVICE)
    moved = max(float((a[tenant0] - b[tenant0]).abs().max())
                for a, b in zip(new_logits, rec["decode_logits"]))
    others_same = all(torch.equal(a[~tenant0], b[~tenant0])
                      for a, b in zip(new_logits, rec["decode_logits"]))
    if (moved <= 0.0 or tail_moved <= 0.0 or not others_same
            or not torch.equal(new_tokens[~tenant0], rec["tokens"][~tenant0])):
        raise AssertionError(f"path J hot swap: tenant-0 logits moved {moved}, its tail adapter "
                             f"{tail_moved}, other tenants bitwise unchanged {others_same}")
    changed = int((new_tokens[tenant0] != rec["tokens"][tenant0]).any(dim=1).sum())
    print(f"[path J] {card} | J3 hot swap: aggregate ({n_buckets} buckets, 5 ADMM iterations) "
          f"+ publish_round {t_swap:.4f} s; tenant-0 tail adapter moved by up to "
          f"{tail_moved:.4g}, decode logits by up to {moved:.4g}, continuations changed "
          f"{changed}/{int(tenant0.sum())}, other tenants bitwise unchanged; pooled data_ptr "
          f"unchanged; launches {phase['J3 hot swap']}", flush=True)
    del base, pool, trees, rec, new_logits, deltas, update, one_pool, one_plain
    torch.cuda.empty_cache()

    # J4: card vs CPU at depth 5 with a 64-token window.
    card_vs_cpu(cfg.replace(window_size=J4_WINDOW), rng, "path J", card, counts, launched,
                expect, dict(gathered_lora_matmul=2 * J4_LAYERS, local_attention=1),
                n_layers=J4_LAYERS, n_requests=2, prompt_lens=J4_PROMPTS, steps=J4_STEPS)

    # J5: decode against the train-mode forward at the real window.
    cfg5 = cfg.replace(n_layers=J4_LAYERS, dtype="float32")
    base5 = init_params(cfg5, seed=7, device=DEVICE)
    pool5 = AdapterPool(tenant_adapter(cfg5, 599), 2)
    for i in range(2):
        pool5.publish(f"tenant-{i}", tenant_adapter(cfg5, 600 + i))
    slots5 = pool5.acquire(["tenant-0", "tenant-1"])
    toks5 = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, J5_PROMPT + J5_STEPS)),
                            device=DEVICE)
    prefill5, decode5 = serve.make_serving_fns(cfg5)
    before = counts()
    with torch.no_grad():
        train = forward(base5, adapter_view(pool5.pooled, slots5), {"tokens": toks5}, cfg5,
                        mode="train")[0]
        _, caches = prefill5(base5, pool5.pooled, slots5, {"tokens": toks5[:, :J5_PROMPT]})
        caches = serve.extend_caches(caches, J5_STEPS, cfg5)
        ring = caches["groups"][2]["self"].k
        if ring.shape[-3] != cfg5.window_size:
            raise AssertionError(f"path J5: ring of {ring.shape[-3]} slots, not the window")
        blank = clone_caches(caches)
        blank["groups"][2]["self"].k.zero_()
        blank["groups"][2]["self"].v.zero_()
        miss = decode5(base5, pool5.pooled, slots5, toks5[:, J5_PROMPT:J5_PROMPT + 1], blank,
                       J5_PROMPT)[0]
        errs, scale = [], float(train[:, J5_PROMPT:].abs().max())
        for i in range(J5_STEPS):
            pos = J5_PROMPT + i
            step = decode5(base5, pool5.pooled, slots5, toks5[:, pos:pos + 1], caches, pos)[0]
            errs.append(max_abs(step[:, 0], train[:, pos]))
        miss_err = max_abs(miss[:, 0], train[:, J5_PROMPT])
    expect("J5 ring at the real window", launched(before),
           gathered_lora_matmul=2 * J4_LAYERS * (3 + J5_STEPS), local_attention=2)
    if max(errs) > J5_RTOL * scale or miss_err <= J5_RTOL * scale:
        raise AssertionError(f"path J5: decode vs train-mode forward {errs} (bound {J5_RTOL} * "
                             f"{scale}); from a zeroed ring {miss_err}")
    print(f"[path J] {card} | J5 depth {J4_LAYERS} float32, window {cfg5.window_size}, prompt "
          f"{J5_PROMPT}: decode steps vs the train-mode forward max|err| "
          f"{[f'{e:.3g}' for e in errs]} (bound {J5_RTOL:g} x max|logit| {scale:.4g}); from a "
          f"zeroed ring {miss_err:.4g}", flush=True)
    del base5, pool5, train, caches, blank
    torch.cuda.empty_cache()

    total = launched(start)
    print(f"[path J] {card} | launches {total} by phase {phase}; wall "
          f"{time.perf_counter() - t_path:.1f} s", flush=True)
    return total


# --- Path E: the ops.soft_threshold entry point ---------------------------------
def main_path_e(counts) -> dict:
    """``ops.soft_threshold``, the only caller of the soft-threshold kernel in
    the reference, at ranks 3, 2 and 1 on path B's bucket shape, float32 and
    bf16, t a float and a 0-d tensor on the card; equal bits to the plain
    version.  Returns the launch counts."""
    import torch
    from repro_torch.kernels import ops, ref

    start = counts()
    g = torch.Generator(device="cuda").manual_seed(13)
    x3 = torch.randn((48, 4096, 40), generator=g, device="cuda")
    calls = [(x3, 0.05), (x3.reshape(-1, 40).to(torch.bfloat16), 0.05),
             (x3.reshape(-1), torch.tensor(0.5, device="cuda"))]
    for x, t in calls:
        got = ops.soft_threshold(x, t)
        want = ref.soft_threshold_ref(x, torch.as_tensor(t, dtype=x.dtype).cuda())
        if got.shape != x.shape or not torch.equal(got, want):
            raise AssertionError(f"path E: ops.soft_threshold at {tuple(x.shape)} "
                                 f"{x.dtype}: {max_abs(got, want)} from the plain version")
    total = {k: v - start[k] for k, v in counts().items()}
    want = {k: (len(calls) if k == "soft_threshold" else 0) for k in total}
    if total != want:
        raise AssertionError(f"path E: launches {total} != {want}")
    print(f"[path E] ops.soft_threshold at ranks 3, 2, 1 of (48, 4096, 40), float32 and "
          f"bf16: equal to the plain version bit for bit; launches {total}", flush=True)
    return total


# --- Training: the kernels' autograd Functions (phase 3) -------------------------
# Each Function at path I's shapes: its forward is the kernel (one launch, the
# bits of the no-grad call), its backward plain PyTorch.  Gradients against
# the plain version's autograd on the card: LoRA dx within two bf16 ulps of
# its largest entry (g W^T is rounded to bf16 first, where the plain version
# takes it in fp32), dA and dB within 1e-4 of their largest entry (fp32 sums
# over 4096 rows in other orders); attention within one bf16 ulp of the
# largest gradient (the backward recomputes the same plain operations); the
# SSD's chunked recompute against the sequential scan's autograd within 1e-4
# of the largest gradient entry.
# (name, kind, shape, dtype, label): I1's q / v projections over 8 clients x
# 2 x 256 tokens and its evaluation (8 x 256 tokens through one adapter),
# I2's in_proj and out_proj, I1's attention (16 x 32 heads) and I2's scan
# (16 x 24 heads, one B / C group per sequence).
TRAIN_FN_CASES = [
    ("gathered_lora_matmul", "lora", (4096, 2048, 2048, 8, 8), "bf16", "I1 q/v"),
    ("gathered_lora_matmul", "lora", (4096, 768, 3352, 8, 8), "bf16", "I2 in_proj"),
    ("gathered_lora_matmul", "lora", (4096, 1536, 768, 8, 8), "bf16", "I2 out_proj"),
    ("lora_matmul", "lora", (2048, 2048, 2048, 8, 0), "bf16", "I1 evaluate"),
    ("local_attention", "attn", (16, 256, 32, 64), "bf16", "I1 attention"),
    ("ssd_scan", "ssd", (16, 24, 256, 64, 128), "fp32", "I2 scan"),
]


def train_fn_case(kind, shape, dtype):
    """(forward fn, its plain version, inputs, output gradient, tolerance
    function) of one Function case on the card."""
    import torch
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")
    ulp = lambda w: 2.0**-7 * float(w.float().abs().max())
    rel = lambda w: 1e-4 * float(w.float().abs().max())
    if kind == "lora":
        m, k, n, r, slots = shape
        x, w = rnd(m, k).to(dt), (rnd(k, n) / k**0.5).to(dt)
        a, b = rnd(max(slots, 1), k, r) / k**0.5, rnd(max(slots, 1), r, n) * 0.05
        gy = rnd(m, n).to(dt)
        if slots:
            rows = (torch.arange(m, device="cuda") * slots // m).to(torch.int32)
            fn = lambda x_, a_, b_: lm.gathered_lora_matmul(x_, w, a_, b_, rows, 2.0)
            plain = lambda x_, a_, b_: ref.gathered_lora_matmul_ref(x_, w, a_, b_, rows, 2.0)
            ins = (x, a, b)
        else:
            fn = lambda x_, a_, b_: lm.lora_matmul(x_, w, a_, b_, 2.0)
            plain = lambda x_, a_, b_: ref.lora_matmul_ref(x_, w, a_, b_, 2.0)
            ins = (x, a[0], b[0])
        return fn, plain, ins, gy, (lambda w_: 2 * ulp(w_), rel, rel)
    if kind == "attn":
        bsz, s, h, d = shape
        q, k_, v = (rnd(bsz, s, h, d).to(dt) for _ in range(3))
        gy = rnd(bsz, s, h, d).to(dt)

        def plain(q_, kk, vv):
            fold = lambda t: t.transpose(1, 2).reshape(bsz * h, s, d)
            out = ref.local_attention_ref(fold(q_), fold(kk), fold(vv), window=0)
            return out.reshape(bsz, h, s, d).transpose(1, 2)

        return lambda *t: ops.local_attention(*t), plain, (q, k_, v), gy, (ulp, ulp, ulp)
    bsz, heads, s, p, n = shape
    x = rnd(bsz * heads, s, p)
    da = -0.5 * torch.rand((bsz * heads, s), generator=g, device="cuda")
    b, c = rnd(bsz, s, n), rnd(bsz, s, n)
    gy = rnd(bsz * heads, s, p)
    return (lambda *t: ops.ssd_scan(*t, chunk=256), lambda *t: ref.ssd_scan_ref(*t),
            (x, da, b, c), gy, (rel, rel, rel, rel))


def check_training_functions() -> dict:
    """Phase 3 for training: every Function's forward launches its kernel
    once and gives the no-grad bits; its gradients hold to the plain
    version's autograd; forward and backward device ms.  Returns
    {label: row}."""
    import torch
    from repro_torch.kernels import local_attention, lora_matmul, ssd_scan

    counters = {"gathered_lora_matmul": lora_matmul.gathered_lora_matmul,
                "lora_matmul": lora_matmul.lora_matmul,
                "local_attention": local_attention.local_attention,
                "ssd_scan": ssd_scan.ssd_scan}
    rows = {}
    for name, kind, shape, dtype, label in TRAIN_FN_CASES:
        fn, plain, ins, gy, tols = train_fn_case(kind, shape, dtype)
        live = [t.clone().requires_grad_() for t in ins]
        before = counters[name].launches
        out = fn(*live)
        if counters[name].launches - before != 1:
            raise AssertionError(f"{label}: the Function's forward did not launch {name} once")
        with torch.no_grad():
            if not torch.equal(out.detach(), fn(*ins)):
                raise AssertionError(f"{label}: the Function's forward is not the kernel's bits")
        got = torch.autograd.grad(out, live, gy, retain_graph=True)
        plain_live = [t.clone().requires_grad_() for t in ins]
        want = torch.autograd.grad(plain(*plain_live), plain_live, gy)
        errs = []
        for i, (gg, ww, tol) in enumerate(zip(got, want, tols)):
            err, bound = max_abs(gg, ww), tol(ww)
            if not bool(torch.isfinite(gg).all()) or err > bound:
                raise AssertionError(f"{label}: gradient {i} {err} > {bound}")
            errs.append(err)
        fwd_ms = device_ms(lambda: fn(*ins), reps=10)
        bwd_ms = device_ms(lambda: torch.autograd.grad(out, live, gy, retain_graph=True),
                           reps=5)
        plain_bwd_ms = device_ms(lambda: torch.autograd.grad(plain(*plain_live), plain_live,
                                                             gy), reps=3)
        rows[label] = dict(kernel=name, fwd_ms=round(fwd_ms, 4), bwd_ms=round(bwd_ms, 4),
                           plain_fwd_bwd_ms=round(plain_bwd_ms, 4),
                           grad_err=[float(f"{e:.3g}") for e in errs])
        print(f"[train fn] {label} {name} {shape} {dtype}: forward (kernel) {fwd_ms:.4f} ms, "
              f"backward (plain) {bwd_ms:.4f} ms, plain forward+backward {plain_bwd_ms:.4f} ms; "
              f"gradient max|err| vs plain autograd {rows[label]['grad_err']}", flush=True)
        del out, got, want, live, plain_live
    return rows


# --- Path I: federated LoRA fine-tuning of an LM ------------------------------------
# The learning rate of I1 and I2: the synthetic corpus uses 512 of the
# vocabulary, so a step of Adam at this rate moves the random model's
# uniform next-token distribution toward it within 3 rounds.
I_LR = 1e-2
I_ROUNDS = 3
I_COMMON = ["--clients", "8", "--per-client-batch", "2", "--seq", "256", "--local-steps", "2",
            "--local-optimizer", "adam", "--rounds", str(I_ROUNDS), "--aggregator", "fedrpca",
            "--svt-mode", "subspace", "--carry-mode", "subspace", "--rpca-fused-tail",
            "--uplink", "sketch", "--local-lr", str(I_LR)]
I2_EXTRA = ["--client-ranks", "8,4,2", "--pipeline", "--staleness", "1"]
# I3: the warm session round's uplink, whose tolerance 1.0 takes every valid
# carry's sketch (energy_frac is at most 1).
I3_UPLINK = "sketch:64:1.0"


def run_train_cli(arch, extra, counts, launched, expect, card, label, tag="path I"):
    """``launch.train.main`` at full width; prints the round times, hit rates,
    bytes and eval losses, checks finite state and a falling eval loss and
    the launch counts.  Returns the CLI's result."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.utils.pytree import tree_leaves

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    before = counts()
    t0 = time.perf_counter()
    out = train.main(["--arch", arch, *I_COMMON, *extra])
    wall = time.perf_counter() - t0
    n_l, steps_ = cfg.n_layers, I_ROUNDS * 2
    kinds = [cfg.layer_pattern[i % len(cfg.layer_pattern)] for i in range(n_l)]
    n_attn = sum(k in ("attn", "local_attn") for k in kinds)
    # Local phase: one gathered launch per adapted projection per step; the
    # two evaluations: lora_matmul; the attention and SSD mixers once a layer
    # in both (the RG-LRU scan and the MoE are plain PyTorch).
    mixer = {k: n * (steps_ + 2) for k, n in (("local_attention", n_attn),
                                              ("ssd_scan", kinds.count("ssd"))) if n}
    got = launched(before)
    agg = got["admm_tail"] + got["subspace_apply"]
    expect(label, {k: v for k, v in got.items() if k not in ("admm_tail", "subspace_apply",
                                                               "subspace_apply_tc")},
           gathered_lora_matmul=2 * n_l * steps_, gathered_lora_matmul_tc=2 * n_l * steps_,
           lora_matmul=2 * n_l * 2, lora_matmul_tc=2 * n_l * 2,
           local_attention_tc=mixer.get("local_attention", 0), **mixer)
    if agg == 0:
        raise AssertionError(f"{label}: the aggregation launched no tail kernel")
    rounds = out["rounds"]
    if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(out["lora"])):
        raise AssertionError(f"{label}: non-finite LoRA")
    if not out["final_eval_loss"] < out["initial_eval_loss"]:
        raise AssertionError(f"{label}: eval loss {out['initial_eval_loss']:.4f} -> "
                             f"{out['final_eval_loss']:.4f} did not fall")
    keys = ("t_local_s", "t_agg_s", "t_overlap_s", "mean_local_loss", "uplink_hit_rate",
            "bytes_up", "bytes_down", "fallback_count", "carry_hit_rate")
    for r in rounds:
        print(f"[{tag}] {card} | {label} round {r['round']}: "
              + ", ".join(f"{k}={r[k]:.4g}" for k in keys if k in r), flush=True)
    print(f"[{tag}] {card} | {label} {arch}: eval loss {out['initial_eval_loss']:.4f} -> "
          f"{out['final_eval_loss']:.4f}; round_s median "
          f"{statistics.median(r['t_local_s'] + r['t_agg_s'] for r in rounds):.4f} "
          f"(t_local_s {[round(r['t_local_s'], 4) for r in rounds]}, t_agg_s "
          f"{[round(r['t_agg_s'], 4) for r in rounds]}); wall {wall:.1f} s; peak device memory "
          f"{out['peak_gib']:.3f} GiB; launches {got}", flush=True)
    return out


# I3's local phases: card vs CPU per-client deltas relative to each leaf's
# norm.  Held with SGD, whose deltas are linear in the gradients, so the
# bound sees the kernels and the backward passes; printed with Adam beside a
# CPU witness (the same phase on the CPU from weights perturbed by 1e-7):
# Adam normalizes each element's step, so an element whose gradient is
# round-off sized takes a full step either way, and on these models the CPU
# moves its own Adam deltas 1.2e-3 (StableLM, 2 layers) and 3.3e-3 (Mamba-2)
# of the norm under that perturbation, SGD's 8.7e-6.
I3_PERTURB = 1e-7


def vision_grid_positions(b: int, s: int, rows: int, cols: int):
    """(3, B, S) M-RoPE positions of a ``rows x cols`` vision grid followed
    by text: the grid at temporal 0, height its row, width its column; each
    text token one past the largest position so far on all three streams."""
    import torch

    pos = torch.zeros((3, b, s), dtype=torch.int64)
    n = rows * cols
    pos[1, :, :n] = torch.arange(rows).repeat_interleave(cols)
    pos[2, :, :n] = torch.arange(cols).repeat(rows)
    pos[:, :, n:] = max(rows, cols) + torch.arange(s - n)
    return pos


def client_stubs(cfg, m: int, per: int, seq: int, seed: int = 23) -> dict:
    """The frontend inputs of a federated batch of ``m`` clients x ``per``
    sequences of ``seq`` tokens, on the host: ``encoder_frames`` (m, per,
    S_enc, D) for an audio config; ``vision_embeds`` (m, per, n_vision, D)
    and M-RoPE ``positions`` (m, 3, per, seq), a square vision grid then
    text, for a VLM; nothing otherwise."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    if cfg.frontend == "audio":
        return {"encoder_frames": torch.randn((m, per, cfg.encoder_seq, cfg.d_model),
                                              generator=gen)}
    if cfg.frontend == "vision":
        side = int(cfg.n_vision_tokens**0.5)
        pos = vision_grid_positions(per, seq, side, cfg.n_vision_tokens // side)
        return {"vision_embeds": torch.randn((m, per, cfg.n_vision_tokens, cfg.d_model),
                                             generator=gen),
                "positions": torch.stack([pos + c for c in range(m)])}
    return {}


def i3_local_phase(arch, n_layers, lora, card, label, tag="path I", seq=64):
    """One local phase (2 steps, 2 clients x 1 x ``seq`` tokens, with the
    config's frontend stubs, ``client_stubs``) of ``arch`` at full width and
    ``n_layers`` layers in float32 on the card and on the CPU, from the same
    weights and the card's global LoRA (its first layers): with SGD the
    per-client deltas within ``STATE_FRO_RTOL`` of each leaf's norm and the
    loss within 1e-5; with Adam printed beside the CPU's own difference
    under an ``I3_PERTURB`` perturbation."""
    import copy

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import init_params, moe
    from repro_torch.utils.pytree import tree_map

    full = get_config(arch)
    cfg = full.replace(n_layers=n_layers, n_encoder_layers=min(full.n_encoder_layers, n_layers),
                       dtype="float32")
    model = init_params(cfg, seed=0, device=DEVICE)
    cpu_model = copy.deepcopy(model).cpu()
    # The first pattern groups of the card's LoRA, and its tail layers
    # (RecurrentGemma's two recurrent tail layers at every depth 3 g + 2).
    lora = {"groups": tree_map(lambda x: x[:cfg.n_pattern_groups].contiguous(),
                               lora["groups"]),
            "tail": tree_map(lambda x: x.contiguous(), lora["tail"])}
    toks = torch.randint(0, 512, (2, 1, seq + 1), generator=torch.Generator().manual_seed(19))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             **client_stubs(cfg, 2, 1, seq)}
    res = {}
    for opt in ("sgd", "adam"):
        step = steps.make_local_step(cfg, local_lr=I_LR, local_steps=2, local_optimizer=opt,
                                     remat=False)
        with moe.routing_log() as card_route:
            got, loss, _ = step(model, lora, tree_map(lambda t: t.to(DEVICE), batch))
        with moe.routing_log() as cpu_route:
            want, cpu_loss, _ = step(cpu_model, to_cpu(lora), batch)
        flips = check_routing(card_route, cpu_route, cfg.top_k, f"{label} {opt}",
                              hold=opt == "sgd")
        if flips:
            print(f"[{tag}] {card} | {label} {opt}: {flips} routing flips card vs CPU (not "
                  f"held under Adam)", flush=True)
        res[opt] = (rel_fro(got, want), abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss)))
        if opt == "adam":
            gen = torch.Generator().manual_seed(29)
            with torch.no_grad():
                for p in cpu_model.parameters():
                    p.mul_(1 + I3_PERTURB * torch.randn(p.shape, generator=gen))
            res["witness"] = rel_fro(step(cpu_model, to_cpu(lora), batch)[0], want)
    err, lerr = res["sgd"]
    if err > STATE_FRO_RTOL or max(lerr, res["adam"][1]) > 1e-5:
        raise AssertionError(f"{label}: SGD local phase card vs CPU {err:.3g} of the norm (bound "
                             f"{STATE_FRO_RTOL}), losses {lerr:.3g} / {res['adam'][1]:.3g}")
    stubs = "".join(f", {k} {tuple(v.shape)}" for k, v in batch.items()
                    if k not in ("tokens", "labels"))
    print(f"[{tag}] {card} | {label}: one local phase of {arch} ({n_layers} layers, float32, "
          f"2 clients x {seq} tokens{stubs}) card vs CPU from the card's LoRA: SGD deltas "
          f"{err:.3g} of the "
          f"norm (bound {STATE_FRO_RTOL:g}), loss {lerr:.3g} relative; Adam deltas "
          f"{res['adam'][0]:.3g}, loss {res['adam'][1]:.3g} (not held; the CPU against itself "
          f"under a {I3_PERTURB:g} weight perturbation: {res['witness']:.3g})", flush=True)


def profile_local_phase(cfg, lora, card, label, tag):
    """Where a local phase's time goes: one of path I1's shape (8 clients x
    2 x 256 tokens, 2 Adam steps) of ``cfg`` at full width from ``lora``,
    after a warm-up call, under ``torch.profiler`` (device-busy share and
    top kernels).  Returns the model it built."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import init_params

    model = init_params(cfg, seed=0, device=DEVICE)
    toks = torch.randint(0, 512, (8, 2, 257), generator=torch.Generator().manual_seed(21))
    big = {"tokens": toks[..., :-1].to(DEVICE), "labels": toks[..., 1:].to(DEVICE)}
    phase = steps.make_local_step(cfg, local_lr=I_LR, local_steps=2, local_optimizer="adam",
                                  remat=False)
    phase(model, lora, big)
    wall, busy, top = profiled(lambda: phase(model, lora, big))
    share = "not measured" if busy is None else f"{busy:.4f} s busy = {busy / wall:.3f}"
    print(f"[{tag}] {card} | one {label} local phase (8 x 2 x 256 tokens, 2 Adam steps) under "
          f"torch.profiler: host {wall:.4f} s, device {share} of it; top kernels by device ms "
          f"(name, ms, calls): {top}", flush=True)
    return model


def i3_warm_sketch_round(out, card):
    """A profiled local phase of I1's shape from I1's global (device-busy
    share and top kernels); then one warm session round on I1's LoRA tree and
    final carry, card vs CPU,
    with ``I3_UPLINK``: the deltas of one local phase of the full model from
    I1's global (8 clients x 1 x 64 tokens); updates within ``AGG_RTOL`` of
    max|delta|, the sketch taken (``uplink_hit_rate`` 1) on both devices."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import AggregatorConfig
    from repro_torch.core import engine as engine_lib
    from repro_torch.core.aggregators import rpca_diag_summary
    from repro_torch.launch import steps
    from repro_torch.utils.pytree import tree_leaves, tree_map

    cfg = get_config("stablelm-1.6b")
    model = profile_local_phase(cfg, out["lora"], card, "I1", "path I")
    toks = torch.randint(0, 512, (8, 1, 65), generator=torch.Generator().manual_seed(23))
    batch = {"tokens": toks[..., :-1].to(DEVICE), "labels": toks[..., 1:].to(DEVICE)}
    step = steps.make_local_step(cfg, local_lr=I_LR, local_steps=1, local_optimizer="adam",
                                 remat=False)
    deltas, _, _ = step(model, out["lora"], batch)
    del model
    agg = AggregatorConfig(method="fedrpca", rpca_iters=30, svt_mode="subspace",
                           carry_mode="subspace", rpca_fused_tail=True)
    res = {}
    for dev, d, c in (("card", deltas, out["agg_carry"]),
                      ("cpu", to_cpu(deltas), tree_map(lambda x: x.cpu(), out["agg_carry"]))):
        plan = engine_lib.plan_aggregation(d, agg, uplink=I3_UPLINK)
        if set(engine_lib.init_agg_carry(plan)) != set(c):
            raise AssertionError("path I3: I1's carry does not fit the warm round's plan")
        upd, _, diag = engine_lib.aggregate_planned(plan, d, c, with_diagnostics=True)
        res[dev] = (upd, {k: float(v) for k, v in rpca_diag_summary(diag).items()})
    big = max(float(x.abs().max()) for x in tree_leaves(deltas))
    err = max(max_abs(g.cpu(), w) for g, w in zip(tree_leaves(res["card"][0]),
                                                  tree_leaves(res["cpu"][0])))
    hits = (res["card"][1]["uplink_hit_rate"], res["cpu"][1]["uplink_hit_rate"])
    if hits != (1.0, 1.0) or err > AGG_RTOL * big:
        raise AssertionError(f"path I3: warm sketch round card vs CPU {err} (bound {AGG_RTOL} * "
                             f"{big}), uplink_hit_rate card/CPU {hits}")
    sc = res["card"][1]
    print(f"[path I] {card} | I3 warm session round on I1's LoRA and carry, uplink "
          f"{I3_UPLINK}: update card vs CPU {err:.3g} (bound {AGG_RTOL:g} x max|delta| "
          f"{big:.4g}); uplink_hit_rate card {hits[0]:g}, CPU {hits[1]:g}; bytes_up "
          f"{sc['bytes_up']:.6g} vs dense {4.0 * sum(x[0].numel() for x in tree_leaves(deltas)) * 8:.6g}; "
          f"fallbacks card {sc['fallback_count']:g} CPU {res['cpu'][1]['fallback_count']:g}",
          flush=True)


def main_path_i(counts, card: str) -> dict:
    """I1 ``launch.train.main`` on StableLM-2-1.6B at full width and depth
    (bf16, LoRA r 8 on q and v), 8 clients x 2 x 256 tokens, 2 Adam steps,
    3 rounds of FedRPCA (subspace SVT and carry, fused tail, sketch uplink);
    I2 the same on Mamba-2-130M with client ranks 8, 4, 2 and the pipeline at
    staleness 1; I3 one local phase of each model card vs CPU from the card's
    LoRA, and one warm sketch session round on I1's tree card vs CPU.
    Returns the launch counts."""
    import torch

    start = counts()
    launched, expect, phase = launch_checker(counts, "path I")
    out1 = run_train_cli("stablelm-1.6b", [], counts, launched, expect, card, "I1")
    out2 = run_train_cli("mamba2-130m", I2_EXTRA, counts, launched, expect, card, "I2")
    before = counts()
    i3_local_phase("stablelm-1.6b", 2, out1["lora"], card, "I3 StableLM")
    i3_local_phase("mamba2-130m", 24, out2["lora"], card, "I3 Mamba-2")
    del out2
    torch.cuda.empty_cache()
    i3_warm_sketch_round(out1, card)
    got = launched(before)
    for name in ("gathered_lora_matmul", "local_attention", "ssd_scan", "subspace_apply"):
        if not got[name]:
            raise AssertionError(f"path I3: {name} never launched")
    phase["I3"] = got
    total = launched(start)
    print(f"[path I] {card} | launches {total} by phase {phase}", flush=True)
    return total


# --- Path K: federated LoRA training of RecurrentGemma and Granite-MoE ---------
# K3's depths: RecurrentGemma one pattern unit plus its two recurrent tail
# layers (as J4), Granite-MoE two layers.
K_ARCHS = (("recurrentgemma-2b", "K1", 5), ("granite-moe-1b-a400m", "K2", 2))


def main_path_k(counts, card: str) -> dict:
    """K1 ``launch.train.main`` on RecurrentGemma-2B and K2 on
    Granite-3.0-1B-A400M at full width and depth (bf16, LoRA r 8), with path
    I1's flags (8 clients x 2 x 256 tokens, 2 Adam steps, 3 rounds of FedRPCA
    with subspace SVT and carry, the fused tail, the sketch uplink): round
    times, peak memory, eval loss before and after (it must fall); K3 one
    local phase of each, card vs CPU from the card's LoRA in float32 (SGD
    held at ``STATE_FRO_RTOL``, the MoE's routing compared call by call).
    Returns the launch counts."""
    import torch

    start = counts()
    launched, expect, phase = launch_checker(counts, "path K")
    from repro_torch.configs import get_config

    for arch, label, depth in K_ARCHS:
        t0 = time.perf_counter()
        out = run_train_cli(arch, [], counts, launched, expect, card, label, tag="path K")
        profile_local_phase(get_config(arch), out["lora"], card, label, "path K")
        torch.cuda.empty_cache()
        before = counts()
        i3_local_phase(arch, depth, out["lora"], card, f"K3 {arch}", tag="path K")
        phase[f"K3 {arch}"] = launched(before)
        del out
        torch.cuda.empty_cache()
        print(f"[path K] {card} | {label} {arch} with its K3 check: wall "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    total = launched(start)
    print(f"[path K] {card} | launches {total} by phase {phase}", flush=True)
    return total


# --- Paths L and M: serving the dense and MoE configs of slice 11 --------------
# (arch, label, depth or None for the full depth).  Depths of L2 and L3 are
# cut so that each fits about 33 GB of bf16 weights beside its activations;
# M2's one layer holds 128 experts at d_ff 8192, 32 GB.
L_CELLS = (("gemma-7b", "L1", None), ("qwen1.5-32b", "L2", 32), ("deepseek-67b", "L3", 24))
M_CELLS = (("granite-moe-1b-a400m", "M1", None), ("llama4-maverick-400b-a17b", "M2", 1))
# Card vs CPU in float32 (``card_vs_cpu``): depth 2 for L, 4 for M1, prompts
# of 96 and 40 tokens, 8 decode steps; M2 takes the expert loop below.
LM_CPU_PROMPTS, LM_CPU_STEPS = (96, 40), 8
# M2's MoE layer against a plain float32 loop over the experts on the same
# routing: the bf16 path rounds x W_gate, x W_up, their SiLU product, h W_down
# and each weighted term to bf16 (2^-9 relative each); the rounding of h
# enters a d_ff-long sum of random-signed terms, so the output moves by about
# 2^-8 of its scale.  Held at 2^-6 of the largest output, 4x that.
M_LOOP_RTOL = 2.0**-6


def serve_cell(arch, label, depth, counts, launched, expect, card, path, *, prompt=C_PROMPT,
               launches=None, **change):
    """Serve ``arch`` at full width (``depth`` layers, or all; ``change``
    replaces config fields, e.g. ``kv_quant=True``) in bf16 to 8 requests of
    4 tenants through the pool (prompt ``prompt``, 512 as path C, 32 greedy
    tokens), the frontend stubs drawn after the prompts from the same numpy
    generator; expects ``launches`` (by default 2 gathered launches a layer
    and step, one attention launch a layer, all on the tensor route); prints
    prefill s, decode tokens/s and peak memory, and returns (base, pool,
    rec, cfg)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import param_count
    from repro_torch.serve import AdapterPool

    cfg = get_config(arch).replace(**change)
    if depth:
        cfg = cfg.replace(n_layers=depth)
    n_l = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = init_params(cfg, seed=0, device=DEVICE)
    pool = AdapterPool(tenant_adapter(cfg, 99), C_SLOTS)
    for i in range(C_TENANTS):
        pool.publish(f"tenant-{i}", tenant_adapter(cfg, 100 + i))
    torch.cuda.synchronize()
    n_par = param_count(base)
    print(f"[{path}] {card} | {label} {arch}: {n_par / 1e9:.3f} B parameters ({cfg.dtype}, "
          f"{2 * n_par / 1e9:.1f} GB), {n_l} of {get_config(arch).n_layers} layers, pool "
          f"{len(pool)}/{pool.n_slots} slots, init {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(C_BATCH, prompt))
    ids = [f"tenant-{i % C_TENANTS}" for i in range(C_BATCH)]
    before = counts()
    rec = serve_once(base, pool, cfg, ids, prompts, C_GEN, rng=rng)
    rec["prompts"] = prompts
    expect(label, launched(before), **(launches or dict(
        gathered_lora_matmul=2 * n_l * C_GEN, gathered_lora_matmul_tc=2 * n_l * C_GEN,
        local_attention=n_l, local_attention_tc=n_l)))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(bool(torch.isfinite(x).all()) for x in [rec["prefill_logits"]]
               + rec["decode_logits"]):
        raise AssertionError(f"{path} {label}: non-finite logits")
    t = rec["t"]
    tok_s = C_BATCH * (C_GEN - 1) / t["decode_s"]
    print(f"[{path}] {card} | {label} {arch} pool: prefill {C_BATCH}x{prompt} tokens "
          f"{t['prefill_s']:.4f} s, decode {C_GEN - 1} steps {t['decode_s']:.4f} s = "
          f"{tok_s:.1f} tokens/s, peak memory {peak_gb:.2f} GB", flush=True)
    rec.update(peak_gb=peak_gb, tok_s=tok_s)
    return base, pool, rec, cfg


def main_path_l(counts, card: str) -> dict:
    """L1 Gemma-7B at full width and depth, L2 Qwen1.5-32B at 32 of 64
    layers, L3 DeepSeek-67B at 24 of 95 (with its untied head), each served
    as ``serve_cell`` and then card vs CPU at depth 2 in float32.  Returns
    the launch counts."""
    import numpy as np
    import torch

    start = counts()
    launched, expect, phase = launch_checker(counts, "path L")
    for arch, label, depth in L_CELLS:
        t0 = time.perf_counter()
        base, pool, rec, cfg = serve_cell(arch, label, depth, counts, launched, expect, card,
                                          "path L")
        del base, pool, rec
        torch.cuda.empty_cache()
        card_vs_cpu(cfg, np.random.default_rng(1), f"path L {label}", card, counts, launched,
                    expect, dict(gathered_lora_matmul=4, local_attention=2),
                    prompt_lens=LM_CPU_PROMPTS, steps=LM_CPU_STEPS)
        torch.cuda.empty_cache()
        print(f"[path L] {card} | {label} {arch}: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
    total = launched(start)
    print(f"[path L] {card} | launches {total} by phase {phase}", flush=True)
    return total


def moe_expert_loop(params, x, top_k, capacity_factor):
    """The MoE layer as a plain float32 loop over the experts: each expert's
    kept entries (its first ``capacity`` in token-major order) through its
    own SwiGLU, weighted and added to their tokens; the routing from
    ``moe.route``.  Returns (output, number of dropped entries)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe

    b, s, d = x.shape
    xt = x.reshape(-1, d).float()
    _, top_e, top_p = moe.route(params, x.reshape(1, -1, d), top_k)
    flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
    cap = moe._capacity(xt.shape[0], top_k, params["gate"].shape[0], capacity_factor)
    out = torch.zeros_like(xt)
    dropped = 0
    for e in range(params["gate"].shape[0]):
        entries = torch.nonzero(flat_e == e).flatten()
        dropped += max(0, entries.numel() - cap)
        entries = entries[:cap]
        tok = entries // top_k
        h = xt[tok]
        y = (F.silu(h @ params["gate"][e].float()) * (h @ params["up"][e].float())
             ) @ params["down"][e].float()
        out[tok] += y * flat_p[entries, None]  # an expert's tokens are distinct
    return out.reshape(b, s, d), dropped


MOE_SPAN = "moe.apply_moe"


@contextlib.contextmanager
def moe_spans():
    """While active, every ``moe.apply_moe`` call runs inside a
    ``record_function(MOE_SPAN)`` range (``Block.forward`` calls it through
    the module)."""
    from torch.profiler import record_function
    from repro_torch.models import moe

    inner = moe.apply_moe

    def spanned(*args, **kw):
        with record_function(MOE_SPAN):
            return inner(*args, **kw)

    moe.apply_moe = spanned
    try:
        yield
    finally:
        moe.apply_moe = inner


def moe_share(spans, wall, busy) -> str:
    """The MoE layers' share of a profiled window (see ``span_times``)."""
    m = spans[MOE_SPAN]
    if m["device_s"] is None or busy is None:
        dev = "device not measured (no kernel linked to the ranges)"
    else:
        dev = (f"device {m['device_s']:.4f} s of {busy:.4f} s busy = "
               f"{m['device_s'] / busy:.3f}, of it GEMM kernels {m['gemm_device_s']:.4f} s "
               f"and routing, dispatch and combine {m['device_s'] - m['gemm_device_s']:.4f} s")
    return (f"MoE layers ({m['calls']} apply_moe calls): host {m['host_s']:.4f} s of "
            f"{wall:.4f} s = {m['host_s'] / wall:.3f}; {dev}")


def main_path_m(counts, card: str) -> dict:
    """M1 Granite-3.0-1B-A400M at full width and depth served as
    ``serve_cell``, a profiled decode window and warm prefill (the MoE
    layers' share of each, ``moe_share``), and
    card vs CPU at depth 4 in float32 with the routing compared first; M2
    Llama-4-Maverick at full width and depth 1 served the same, and its MoE
    layer on the card against ``moe_expert_loop`` at ``M_LOOP_RTOL``.
    Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import layers, moe

    start = counts()
    launched, expect, phase = launch_checker(counts, "path M")
    for arch, label, depth in M_CELLS:
        t0 = time.perf_counter()
        base, pool, rec, cfg = serve_cell(arch, label, depth, counts, launched, expect, card,
                                          "path M")
        if label == "M1":
            # A decode window and a warm prefill (the pool run's was the
            # model's first) with the MoE layers' ranges marked.
            prefill = serve.make_serving_fns(cfg)[0]
            toks = torch.as_tensor(rec["prompts"], device=DEVICE)
            n_l, before = cfg.n_layers, counts()
            dec, pre = {MOE_SPAN: None}, {MOE_SPAN: None}
            with moe_spans():
                windows = (
                    (f"{C_PROFILE_STEPS} decode steps", dec,
                     profile_decode(base, pool, cfg, rec, C_PROFILE_STEPS, dec)),
                    ("one warm prefill", pre, profiled(
                        lambda: prefill(base, pool.pooled, rec["slots"], {"tokens": toks}), pre)))
            expect("M1 profile", launched(before),
                   gathered_lora_matmul=2 * n_l * (C_PROFILE_STEPS + 1),
                   gathered_lora_matmul_tc=2 * n_l * (C_PROFILE_STEPS + 1),
                   local_attention=n_l, local_attention_tc=n_l)
            for what, spans, (wall, busy, top) in windows:
                share = ("not measured" if busy is None
                         else f"{busy:.4f} s busy = {busy / wall:.3f}")
                print(f"[path M] {card} | M1 {what} under torch.profiler: host {wall:.4f} s, "
                      f"device {share} of it; {moe_share(spans, wall, busy)}; top kernels by "
                      f"device ms (name, ms, calls): {top}", flush=True)
            del base, pool, rec
            torch.cuda.empty_cache()
            card_vs_cpu(cfg, np.random.default_rng(2), "path M M1", card, counts, launched,
                        expect, dict(gathered_lora_matmul=8, local_attention=4), n_layers=4,
                        prompt_lens=LM_CPU_PROMPTS, steps=LM_CPU_STEPS)
        else:
            blk = base.layers[0]
            x = layers.apply_norm(blk.norm2, torch.randn(
                (C_BATCH, C_PROMPT, cfg.d_model), generator=torch.Generator(
                    device=DEVICE).manual_seed(3), device=DEVICE).to(torch.bfloat16),
                cfg.norm_eps)
            with torch.no_grad():
                got, aux = moe.apply_moe(blk.moe, x, top_k=cfg.top_k,
                                         capacity_factor=cfg.capacity_factor)
                want, dropped = moe_expert_loop(blk.moe, x, cfg.top_k, cfg.capacity_factor)
            err, scale = max_abs(got.float(), want), float(want.abs().max())
            if not bool(torch.isfinite(got).all()) or err > M_LOOP_RTOL * scale:
                raise AssertionError(f"path M M2: the MoE layer against the expert loop {err} > "
                                     f"{M_LOOP_RTOL} * {scale}")
            print(f"[path M] {card} | M2 MoE layer ({C_BATCH}x{C_PROMPT} tokens, "
                  f"{cfg.n_experts} experts, top-{cfg.top_k}, capacity "
                  f"{moe._capacity(C_BATCH * C_PROMPT, cfg.top_k, cfg.n_experts, cfg.capacity_factor)}"
                  f", {dropped} entries dropped) bf16 on the card vs a float32 loop over the "
                  f"experts: max|err| {err:.4g} (bound {M_LOOP_RTOL:g} x max|out| {scale:.4g}); "
                  f"aux {float(aux):.4g}", flush=True)
            del base, pool, rec, x, got, want
        torch.cuda.empty_cache()
        print(f"[path M] {card} | {label} {arch}: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
    total = launched(start)
    print(f"[path M] {card} | launches {total} by phase {phase}", flush=True)
    return total


# --- Paths N and O: Whisper-medium and Qwen2-VL-2B (slice 12) ------------------
N_ARCH, O_ARCH = "whisper-medium", "qwen2-vl-2b"
# Whisper's decoder context is 448 positions (``max_target_positions`` of the
# published config): a prompt of 416 and 32 generated tokens fill it.
N_PROMPT = 416
# Card vs CPU in float32 at encoder and decoder depth 2 (the 1500 stub frames
# at full width): prompt 96, 8 decode steps.  Qwen2-VL at depth 2: a prompt of
# 320, the 256 vision positions and 64 of text, 8 decode steps.
N_CPU_PROMPTS, O_CPU_PROMPTS, NO_CPU_STEPS = (96,), (320,), 8
# O1's train-mode forward with explicit M-RoPE positions: a 16 x 16 grid for
# the 256 vision positions, then 64 of text, 2 requests, depth 2, float32.
O_GRID, O_POS_SEQ = 16, 320
# O3: one local phase card vs CPU at depth 2 and full width, 2 clients x one
# sequence of 64 tokens (Whisper, over its 1500 stub frames) or 320 (Qwen2-VL).
O3_CASES = ((N_ARCH, 64), (O_ARCH, O_POS_SEQ))


def cache_bytes(caches, key: str = "self") -> int:
    """Bytes of the ``key`` caches of a cache tree (every tensor of them)."""
    return sum(t.numel() * t.element_size() for c in (*caches["groups"], *caches["tail"])
               if key in c for t in c[key])


def busy_line(what, wall, busy, top) -> str:
    share = "not measured" if busy is None else f"{busy:.4f} s busy = {busy / wall:.3f}"
    return (f"{what} under torch.profiler: host {wall:.4f} s, device {share} of it; top kernels "
            f"by device ms (name, ms, calls): {top}")


def forced_decode(base, pool, cfg, rec, tokens):
    """Decode logits from a copy of the recorded caches (``serve_once``),
    fed ``tokens`` (B, gen) one step at a time instead of the greedy ones:
    step i reads ``tokens[:, i]`` at position prompt + i."""
    from repro_torch.launch import serve

    _, decode = serve.make_serving_fns(cfg)
    caches = clone_caches(rec["caches"])
    out = []
    for i in range(tokens.shape[1] - 1):
        logits, _ = decode(base, pool.pooled, rec["slots"], tokens[:, i:i + 1], caches,
                           rec["prompt_len"] + i)
        out.append(logits)
    return out


def main_path_n(counts, card: str) -> dict:
    """N1: serve Whisper-medium at full width and depth (24 encoder and 24
    decoder layers, bf16, LoRA r 8 on q and v of self- and cross-attention)
    to 8 requests of 4 tenants over stub frames (8, 1500, 1024): prompt 416,
    32 greedy tokens; prefill s, decode tokens/s, peak memory and the cross
    caches' bytes; a profiled decode window and warm prefill.  N2: card vs
    CPU in float32 at encoder and decoder depth 2.  Returns the launch
    counts."""
    import numpy as np
    import torch
    from repro_torch.launch import serve

    start = counts()
    launched, expect, phase = launch_checker(counts, "path N")
    t0 = time.perf_counter()
    from repro_torch.configs import get_config

    full = get_config(N_ARCH)
    n_l, n_enc = full.n_layers, full.n_encoder_layers
    # Prefill: self q, v, cross q, v (on the encoder's rows) a layer; the
    # cross k and the encoder are plain products (no adapter).  Decode: self
    # q, v and cross q; the cross K and V come from the cache.
    pre, dec = 4 * n_l, 3 * n_l
    base, pool, rec, cfg = serve_cell(
        N_ARCH, "N1", None, counts, launched, expect, card, "path N", prompt=N_PROMPT,
        launches=dict(gathered_lora_matmul=pre + dec * (C_GEN - 1),
                      gathered_lora_matmul_tc=pre + dec * (C_GEN - 1),
                      local_attention=n_enc + n_l, local_attention_tc=n_enc + n_l))
    cross, own = cache_bytes(rec["caches"], "cross"), cache_bytes(rec["caches"], "self")
    print(f"[path N] {card} | N1 caches: cross {cross / 1e9:.4f} GB ({n_l} layers x K and V "
          f"of {C_BATCH} x {cfg.encoder_seq} x {cfg.kv_dim}, bf16, projected once at prefill), "
          f"self {own / 1e9:.4f} GB ({N_PROMPT} + {C_GEN} positions)", flush=True)
    before = counts()
    window = profile_decode(base, pool, cfg, rec, C_PROFILE_STEPS)
    expect("N1 profile decode", launched(before), gathered_lora_matmul=dec * C_PROFILE_STEPS,
           gathered_lora_matmul_tc=dec * C_PROFILE_STEPS)
    print(f"[path N] {card} | N1 {busy_line(f'{C_PROFILE_STEPS} decode steps', *window)}",
          flush=True)
    prefill = serve.make_serving_fns(cfg)[0]
    before = counts()
    window = profiled(lambda: prefill(base, pool.pooled, rec["slots"], rec["batch"]))
    expect("N1 profile prefill", launched(before), gathered_lora_matmul=pre,
           gathered_lora_matmul_tc=pre, local_attention=n_enc + n_l,
           local_attention_tc=n_enc + n_l)
    print(f"[path N] {card} | N1 {busy_line('one warm prefill (encoder included)', *window)}",
          flush=True)
    del base, pool, rec
    torch.cuda.empty_cache()
    card_vs_cpu(cfg, np.random.default_rng(3), "path N N2", card, counts, launched, expect,
                dict(gathered_lora_matmul=8, local_attention=4), prompt_lens=N_CPU_PROMPTS,
                steps=NO_CPU_STEPS, decode_per_layer=3)
    torch.cuda.empty_cache()
    total = launched(start)
    print(f"[path N] {card} | wall {time.perf_counter() - t0:.1f} s, launches {total} by phase "
          f"{phase}", flush=True)
    return total


def o1_positions_card_vs_cpu(cfg, card, counts, launched, expect) -> None:
    """A train-mode forward of Qwen2-VL at full width and depth 2 in float32
    with explicit (3, B, S) M-RoPE positions (``vision_grid_positions``: a
    16 x 16 grid for the vision stub, then text) and a 2-D adapter, card vs
    CPU within ``C_CARD_CPU_RTOL`` of the largest logit; the same forward
    with the default positions (three equal streams) must move the vision
    prefix's logits by far more than that bound, or the sections would not
    be exercised."""
    import copy

    import torch
    from repro_torch.models import forward, init_params

    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    base2 = init_params(cfg2, seed=6, device=DEVICE)
    cpu_base = copy.deepcopy(base2).cpu()
    lora = tenant_adapter(cfg2, 301)
    gen = torch.Generator().manual_seed(31)
    batch = {"tokens": torch.randint(0, cfg2.vocab_size, (2, O_POS_SEQ), generator=gen),
             "vision_embeds": torch.randn((2, cfg2.n_vision_tokens, cfg2.d_model),
                                          generator=gen),
             "positions": vision_grid_positions(2, O_POS_SEQ, O_GRID, O_GRID)}
    with torch.no_grad():
        before = counts()
        got = forward(base2, lora, {k: v.to(DEVICE) for k, v in batch.items()}, cfg2,
                      mode="train")[0]
        expect("O1 positions", launched(before), lora_matmul=4, local_attention=2)
        want = forward(cpu_base, to_cpu(lora), batch, cfg2, mode="train")[0]
        plain = forward(base2, lora, {k: v.to(DEVICE) for k, v in batch.items()
                                      if k != "positions"}, cfg2, mode="train")[0]
    err, scale = max_abs(got.cpu(), want), float(want.abs().max())
    moved = float((plain - got)[:, :cfg2.n_vision_tokens].abs().max())
    if not bool(torch.isfinite(got).all()) or err > C_CARD_CPU_RTOL * scale:
        raise AssertionError(f"path O O1 positions: card vs CPU {err} > {C_CARD_CPU_RTOL} * "
                             f"{scale}")
    if not moved > 100 * C_CARD_CPU_RTOL * scale:
        raise AssertionError(f"path O O1 positions: the grid moves the vision logits by only "
                             f"{moved}")
    print(f"[path O] {card} | O1 train-mode forward, depth 2 float32, 2 x {O_POS_SEQ} tokens "
          f"with a {O_GRID} x {O_GRID} vision grid of M-RoPE positions: card vs CPU max|err| "
          f"{err:.3g} (max|logit| {scale:.4g}); the default positions move the vision logits by "
          f"{moved:.4g}", flush=True)


def main_path_o(counts, card: str) -> dict:
    """O1: serve Qwen2-VL-2B at full width and depth (28 layers, bf16, tied
    head) with path C's traffic, the first 256 of the 512 prompt positions
    the vision stub's; card vs CPU at depth 2 serving and a train-mode
    forward with explicit M-RoPE positions.  O2: O1's traffic with the int8
    KV cache: decode tokens/s, the cache's bytes against O1's, the prefill
    logits equal to O1's and O2's top-1 against O1's logits with O1's
    tokens fed; card vs CPU at depth 2.  O3: one local phase of Whisper and
    of Qwen2-VL with the stubs through ``launch/steps.py`` at depth 2, card
    vs CPU.  Returns the launch counts."""
    import numpy as np
    import torch

    start = counts()
    launched, expect, phase = launch_checker(counts, "path O")
    t0 = time.perf_counter()
    base, pool, rec, cfg = serve_cell(O_ARCH, "O1", None, counts, launched, expect, card,
                                      "path O")
    n_l = cfg.n_layers
    o1 = dict(prefill=rec["prefill_logits"], decode=rec["decode_logits"], tokens=rec["tokens"],
              bytes=cache_bytes(rec["caches"]))
    before = counts()
    window = profile_decode(base, pool, cfg, rec, C_PROFILE_STEPS)
    expect("O1 profile decode", launched(before), gathered_lora_matmul=2 * n_l * C_PROFILE_STEPS,
           gathered_lora_matmul_tc=2 * n_l * C_PROFILE_STEPS)
    print(f"[path O] {card} | O1 {busy_line(f'{C_PROFILE_STEPS} decode steps', *window)}",
          flush=True)
    del base, pool, rec
    torch.cuda.empty_cache()
    card_vs_cpu(cfg, np.random.default_rng(4), "path O O1", card, counts, launched, expect,
                dict(gathered_lora_matmul=4, local_attention=2), prompt_lens=O_CPU_PROMPTS,
                steps=NO_CPU_STEPS)
    o1_positions_card_vs_cpu(cfg, card, counts, launched, expect)
    torch.cuda.empty_cache()

    base, pool, rec, cfg_q = serve_cell(O_ARCH, "O2", None, counts, launched, expect, card,
                                        "path O", kv_quant=True)
    ratio = cache_bytes(rec["caches"]) / o1["bytes"]
    if not torch.equal(rec["prefill_logits"], o1["prefill"]):
        raise AssertionError("path O O2: prefill logits differ from O1's (the int8 cache enters "
                             "only at decode)")
    before = counts()
    forced = forced_decode(base, pool, cfg_q, rec, o1["tokens"])
    expect("O2 forced decode", launched(before), gathered_lora_matmul=2 * n_l * (C_GEN - 1),
           gathered_lora_matmul_tc=2 * n_l * (C_GEN - 1))
    agree = [float((torch.argmax(a[:, -1], -1) == torch.argmax(b[:, -1], -1)).float().mean())
             for a, b in zip(forced, o1["decode"])]
    gap = max(float((a - b).abs().max()) for a, b in zip(forced, o1["decode"]))
    same_tokens = int((rec["tokens"] == o1["tokens"]).all(dim=1).sum())
    print(f"[path O] {card} | O2 int8 KV cache: {rec['tok_s']:.1f} tokens/s against O1's bf16 "
          f"cache; cache {cache_bytes(rec['caches']) / 1e6:.2f} MB = {ratio:.4f} x O1's "
          f"{o1['bytes'] / 1e6:.2f} MB; prefill logits equal to O1's; with O1's tokens fed, top-1 "
          f"equal to O1's at {sum(agree) / len(agree):.4f} of {C_BATCH} x {C_GEN - 1} decode "
          f"positions (max |logit - O1's| {gap:.4g}); greedy continuations equal to O1's "
          f"{same_tokens}/{C_BATCH}", flush=True)
    before = counts()
    window = profile_decode(base, pool, cfg_q, rec, C_PROFILE_STEPS)
    expect("O2 profile decode", launched(before), gathered_lora_matmul=2 * n_l * C_PROFILE_STEPS,
           gathered_lora_matmul_tc=2 * n_l * C_PROFILE_STEPS)
    print(f"[path O] {card} | O2 {busy_line(f'{C_PROFILE_STEPS} decode steps', *window)}",
          flush=True)
    del base, pool, rec, forced, o1
    torch.cuda.empty_cache()
    card_vs_cpu(cfg_q, np.random.default_rng(5), "path O O2", card, counts, launched, expect,
                dict(gathered_lora_matmul=4, local_attention=2), prompt_lens=O_CPU_PROMPTS,
                steps=NO_CPU_STEPS)
    torch.cuda.empty_cache()

    from repro_torch.configs import get_config

    for arch, seq in O3_CASES:
        full = get_config(arch)
        cfg3 = full.replace(n_layers=2, n_encoder_layers=min(full.n_encoder_layers, 2),
                            dtype="float32")
        lora = tenant_adapter(cfg3, 302)
        # Two phases on the card (SGD, then Adam), 2 steps each.
        per = 4 if full.encoder_decoder else 2
        attn = 4 if full.encoder_decoder else 2
        before = counts()
        i3_local_phase(arch, 2, lora, card, f"O3 {arch}", tag="path O", seq=seq)
        expect(f"O3 {arch}", launched(before), gathered_lora_matmul=4 * 2 * per,
               local_attention=4 * attn)
        torch.cuda.empty_cache()
    total = launched(start)
    print(f"[path O] {card} | wall {time.perf_counter() - t0:.1f} s, launches {total} by phase "
          f"{phase}", flush=True)
    return total


# --- Path P: the one-card dry run -------------------------------------------------
def dry_record(rec: dict) -> dict:
    """The fields of a dry-run record that path P prints."""
    keep = ("arch", "shape", "mesh", "kv_quant", "variant", "status", "reason", "error", "step_s",
            "mfu", "model_flops", "n_params", "n_active_params", "useful_flops_ratio")
    out = {k: rec[k] for k in keep if k in rec}
    if "roofline" in rec:
        out["roofline"] = rec["roofline"]
    if "memory" in rec:
        out["memory_gib"] = {k: (None if v is None else round(v / 2**30, 3))
                             for k, v in rec["memory"].items()}
    return out


def p_lora_launches(cfg) -> tuple[int, int]:
    """(lora_matmul launches, those on the tensor route) of one decode
    step with a 2-D adapter: each adapted projection of every layer (a
    cross-attention sub-block projects only q at decode)."""
    import torch
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.models import blocks

    dims = []
    unit = len(cfg.layer_pattern)
    for i in range(cfg.n_layers):
        dims += list(blocks.lora_dims(cfg, cfg.layer_pattern[i % unit]).values())
        if cfg.encoder_decoder and "q" in cfg.lora.targets:
            dims.append(blocks.lora_dims(cfg, "cross")["q"])
    dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    return len(dims), sum(lm.route(k, n, dtype) == "tensor" for k, n in dims)


def main_path_p(counts, card: str) -> dict:
    """The one-card dry run (``launch/dryrun.py``) of every arch x shape,
    the decode shapes also with the int8 KV cache: one line per record.
    Every case whose reckoned bytes fit in 90% of the card runs (twice,
    the second timed) and must come back ``ok``, with one ``lora_matmul``
    launch a decode step for each adapted projection; the rest are
    ``skipped``; an ``error`` fails the path.  Then one line of the
    analytic records of the (16, 16) production mesh.  Returns the launch
    counts."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import dryrun

    start = counts()
    launched, expect, phase = launch_checker(counts, "path P")
    ran = []
    for arch in configs.ARCH_IDS:
        for name, shape in configs.SHAPES.items():
            for kvq in ((False, True) if shape.kind == "decode" else (False,)):
                before = counts()
                rec = dryrun.run_case(arch, name, "card", kv_quant=kvq, device="cuda")
                print(f"[path P] {card} | {json.dumps(dry_record(rec), default=str)}", flush=True)
                label = f"{arch} x {name}{' kv int8' if kvq else ''}"
                if rec["status"] == "error":
                    raise AssertionError(f"path P {label}: {rec['error']}\n{rec['trace']}")
                mem = rec.get("memory", {})
                admitted = "reckoned_bytes" in mem and mem["reckoned_bytes"] <= mem["budget_bytes"]
                if admitted != (rec["status"] == "ok"):
                    raise AssertionError(f"path P {label}: admitted={admitted} but status "
                                         f"{rec['status']}")
                if rec["status"] != "ok":
                    continue
                ran.append((label, rec))
                if shape.kind == "decode":
                    cfg = configs.config_for_shape(configs.get_config(arch), shape)
                    n_lora, n_tc = p_lora_launches(cfg.replace(kv_quant=kvq))
                    expect(label, launched(before), lora_matmul=2 * n_lora,
                           lora_matmul_tc=2 * n_tc)
    if not ran:
        raise AssertionError("path P: no case ran on the card")
    for label, rec in ran:
        mem = rec["memory"]
        print(f"[path P] {card} | ran {label}: peak {mem['peak_bytes'] / 2**30:.3f} GiB "
              f"(reckoned {mem['reckoned_bytes'] / 2**30:.3f}), step_s {rec['step_s']:.6f}, "
              f"mfu {rec['mfu']:.3e}", flush=True)
    single = []
    for arch in configs.ARCH_IDS:
        for name in configs.SHAPES:
            rec = dryrun.run_case(arch, name, "single")
            if rec["status"] == "error":
                raise AssertionError(f"path P single {arch} x {name}: {rec['error']}")
            if rec["status"] == "analytic":
                r = rec["roofline"]
                single.append(f"{arch}/{name}: {r['dominant']} "
                              f"{max(r['compute_s'], r['memory_s'], r['collective_s']):.3e}s "
                              f"{rec['memory']['argument_size_in_bytes'] / 2**30:.2f}GiB/chip")
    print(f"[path P] single 16x16 (analytic, tp): {'; '.join(single)}", flush=True)
    torch.cuda.empty_cache()
    total = launched(start)
    print(f"[path P] {card} | launches {total}", flush=True)
    return total


# --- Path Q: the examples ---------------------------------------------------------
def main_path_q(counts, card: str) -> dict:
    """The port's four examples at their defaults on the card, each with
    its output and the kernels it must launch: quickstart and
    compare_aggregators (FedRPCA's ADMM tail), fed_finetune_lm (the
    client-stacked LoRA projections, attention and the ADMM tail) and
    serve_lora (the pool's gathered projections, the merged adapter's and
    attention; its own assertions hold the merged-baseline gap and that
    only tenant 0 moves after the hot swap).  Returns the launch counts."""
    import contextlib
    import io

    from repro_torch.examples import compare_aggregators, fed_finetune_lm, quickstart, serve_lora

    start = counts()
    launched, _, _ = launch_checker(counts, "path Q")
    runs = (("quickstart", lambda: quickstart.main(), ("admm_tail",)),
            ("compare_aggregators", lambda: compare_aggregators.main([]), ("admm_tail",)),
            ("fed_finetune_lm", lambda: fed_finetune_lm.main([]),
             ("admm_tail", "gathered_lora_matmul", "local_attention")),
            ("serve_lora", lambda: serve_lora.main(),
             ("gathered_lora_matmul", "lora_matmul", "local_attention")))
    for name, fn, kernels in runs:
        before = counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fn()
        wall = time.perf_counter() - t0
        got = launched(before)
        for line in buf.getvalue().splitlines():
            if line.strip():
                print(f"[path Q] {name}: {line}", flush=True)
        missing = [k for k in kernels if got[k] == 0]
        if missing:
            raise AssertionError(f"path Q {name}: launched no {missing} ({got})")
        print(f"[path Q] {card} | {name}: {wall:.1f} s, launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
    total = launched(start)
    print(f"[path Q] {card} | launches {total}", flush=True)
    return total


# --- The cost model's card constants ----------------------------------------------
def host_loop(fn, reps: int = 100, loops: int = 5) -> tuple[float, float]:
    """(device ms, host us) per call of ``fn``: the medians over ``loops``
    of ``tools/kernel_call_costs.py``'s loop of ``reps`` calls queued behind
    a sleep kernel, so the host's time is its dispatch alone."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("kernel_call_costs",
                                                  ROOT / "tools" / "kernel_call_costs.py")
    costs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(costs)
    for _ in range(3):
        fn()
    out = [costs.loop_times(fn, reps) for _ in range(loops)]
    return statistics.median(o[0] for o in out), statistics.median(o[1] for o in out)


def card_constants(card: str, b_calls: dict) -> dict:
    """The cost model's host costs on this card (``costmodel.KERNEL_CALL_US``
    and ``AGG_CALL_US``), and its predictions at the card's rates beside
    path B's aggregation calls and path C's gathered projection.  Records,
    not gates."""
    import torch
    from repro_torch.core import AggregatorConfig, AggSession
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.launch import costmodel as cm

    out = {}
    for m, label in ((8, "decode"), (4096, "prefill")):
        g = torch.Generator(device="cuda").manual_seed(m)
        k = n = 2048
        x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
        w = ((torch.rand((k, n), generator=g, device="cuda") * 2 - 1) / k**0.5).bfloat16()
        a = torch.randn((8, k, 8), generator=g, device="cuda") / k**0.5
        b = torch.randn((8, 8, n), generator=g, device="cuda") / 8**0.5
        rs = request_slots(m, 8, [TENANT_SLOTS[i % 4] for i in range(8)])
        call = lambda: lm.gathered_lora_matmul(x, w, a, b, rs, 2.0)
        dev_ms, host_us = host_loop(call)
        out[label] = dict(device_ms=dev_ms, host_us=host_us, call_ms=bench_ms(call))
    kernel_us = out["decode"]["host_us"]

    gen = torch.Generator(device="cuda").manual_seed(17)
    tiny = lambda: {"q": {"A": torch.randn((8, 64, 4), generator=gen, device="cuda"),
                          "B": torch.randn((8, 4, 64), generator=gen, device="cuda")}}
    sess = AggSession(AggregatorConfig(method="fedrpca", rpca_iters=G_ITERS, svt_mode="subspace",
                                       carry_mode="subspace"), device="cuda")
    walls = []
    for i in range(8):
        tree = tiny()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.step(tree)
        torch.cuda.synchronize()
        if i >= 3:
            walls.append((time.perf_counter() - t0) * 1e6)
    agg_us = statistics.median(walls)
    print(f"[constants] {card} | host cost of a kernel call (gathered_lora_matmul, path C "
          f"decode (8, 2048) x (2048, 2048), r 8): {kernel_us:.2f} us; of a warm aggregation "
          f"call (AggSession, fedrpca subspace carry, {G_ITERS} iterations, one 64 x 4 module "
          f"of 8 clients): {agg_us:.1f} us (warm calls {[round(t, 1) for t in walls]})",
          flush=True)
    for (nc, live, mode), t in sorted(b_calls.items()):
        pred = cm.mesh_agg_costs(n_modules=48, padded_vec=4096, cohort=nc, shards=1,
                                 rpca_iters=50, warm=False, coll_overhead_us=kernel_us,
                                 dispatch_us=agg_us)
        print(f"[constants] {card} | path B {mode} nc={nc} valid={live}: measured "
              f"{t * 1e6:.0f} us, cost model (cold, one shard, card rates) {pred['us']:.0f} us "
              f"(compute {pred['compute_us']:.1f}, dispatch {agg_us:.0f})", flush=True)
    for label, seq in (("decode", 1), ("prefill", 512)):
        pred = cm.serve_gather_costs(n_requests=8, seq_len=seq, n_adapters=4, d_in=2048,
                                     d_out=2048, rank=8, overhead_per_req=kernel_us,
                                     overhead_gathered=kernel_us)
        o = out[label]
        print(f"[constants] {card} | path C gathered projection {label} ({8 * seq}, 2048) x "
              f"(2048, 2048), r 8: measured device {o['device_ms'] * 1e3:.2f} us, host "
              f"{o['host_us']:.2f} us, call {o['call_ms'] * 1e3:.2f} us; cost model gathered "
              f"{pred['gathered']['us']:.2f} us (adapter side only; the fused base product is "
              f"not in the model)", flush=True)
    return dict(kernel_call_us=kernel_us, agg_call_us=agg_us, **out)


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
    tensor_flops = bf16_peak(smi)

    # Phase 2: build.
    from repro_torch.kernels import (backend, local_attention, lora_matmul, rpca_admm,
                                     soft_threshold, ssd_scan, svt_subspace)

    t0 = time.perf_counter()
    libs = backend.build_all()
    print(f"[build] {len(libs)} kernel libraries in {time.perf_counter() - t0:.2f} s", flush=True)

    # Phase 3: kernels against their plain versions.
    rec = check_kernels("cuda", bw, flops)
    rec.update(check_lora_kernels(bw, flops, tensor_flops))
    rec.update(check_attention_kernel(bw, flops, tensor_flops))
    rec.update(check_ssd_kernel(bw, flops, tensor_flops / 2))  # TF32: half the bf16 rate
    rec.update(check_ssd_h0_kernel(bw, tensor_flops / 2))
    rec.update(check_soft_threshold_kernel(bw, flops))
    rec.update(check_factored_kernel(bw, flops))
    train_fns = check_training_functions()

    regime_probe()

    wrappers = {"admm_tail": rpca_admm.admm_tail, "subspace_apply": svt_subspace.subspace_apply,
                "lora_matmul": lora_matmul.lora_matmul,
                "gathered_lora_matmul": lora_matmul.gathered_lora_matmul,
                "local_attention": local_attention.local_attention,
                "ssd_scan": ssd_scan.ssd_scan, "soft_threshold": soft_threshold.soft_threshold,
                "subspace_apply_factored": svt_subspace.subspace_apply_factored}
    # Beside each kernel's launches, the tensor-route launches of the four
    # kernels that have two routes ("<name>_tc"): paths C and D expect every
    # bf16 launch there and every float32 launch off it, paths A and B every
    # subspace_apply launch there (their cohorts are 20 to 40 wide).
    routed = ("subspace_apply", "lora_matmul", "gathered_lora_matmul", "local_attention")
    counts = lambda: {**{k: w.launches for k, w in wrappers.items()},
                      **{f"{k}_tc": wrappers[k].tc_launches for k in routed}}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0
        for k in routed:
            wrappers[k].tc_launches = 0

    def run_path(name, fn, *args):
        """Counts set to 0 just before the path and read just after it."""
        zero_counts()
        t0 = time.perf_counter()
        out = fn(*args)
        total = counts()
        print(f"[main path {name}] {time.perf_counter() - t0:.1f} s, launches {total}", flush=True)
        return out, total

    paths = {}
    finals_a = {}
    b_calls = {}

    def path_ab():  # A and B share one count window
        finals_a.update(main_path_a(counts))
        b_calls.update(main_path_b(counts))

    _, paths["A+B"] = run_path("A+B", path_ab)
    _, paths["C"] = run_path("C", main_path_c, counts, smi)
    _, paths["D"] = run_path("D", main_path_d, counts, smi)
    _, paths["E"] = run_path("E", main_path_e, counts)
    _, paths["F"] = run_path("F", main_path_f, counts, smi)
    _, paths["G"] = run_path("G", main_path_g, counts, smi, finals_a)
    _, paths["H"] = run_path("H", main_path_h, counts, smi, finals_a)
    _, paths["I"] = run_path("I", main_path_i, counts, smi)
    _, paths["J"] = run_path("J", main_path_j, counts, smi)
    _, paths["K"] = run_path("K", main_path_k, counts, smi)
    _, paths["L"] = run_path("L", main_path_l, counts, smi)
    _, paths["M"] = run_path("M", main_path_m, counts, smi)
    _, paths["N"] = run_path("N", main_path_n, counts, smi)
    _, paths["O"] = run_path("O", main_path_o, counts, smi)
    _, paths["P"] = run_path("P", main_path_p, counts, smi)
    _, paths["Q"] = run_path("Q", main_path_q, counts, smi)
    card_constants(smi, b_calls)
    launches = {k: sum(p[k] for p in paths.values()) for k in wrappers}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main path")

    # Phase 10: the card tests, in their own process.
    run_card_tests()

    csrc = "src/repro_torch/kernels/csrc/"
    sources = {
        "admm_tail": (csrc + "admm_tail.cu", "src/repro/kernels/rpca_admm.py:121"),
        "subspace_apply": (csrc + "subspace_apply.cu", "src/repro/kernels/svt_subspace.py:154"),
        "lora_matmul": (csrc + "lora_matmul.cu", "src/repro/kernels/lora_matmul.py:98"),
        "gathered_lora_matmul": (csrc + "lora_matmul.cu", "src/repro/kernels/lora_matmul.py:271"),
        "local_attention": (csrc + "local_attention.cu",
                            "src/repro/kernels/local_attention.py:99"),
        "ssd_scan": (csrc + "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:78"),
        "soft_threshold": (csrc + "soft_threshold.cu", "src/repro/kernels/soft_threshold.py:46"),
        "subspace_apply_factored": (csrc + "subspace_apply_factored.cu",
                                    "src/repro/kernels/svt_subspace.py:272"),
    }
    kernels = []
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name in wrappers:
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            **{k: r[k] for k in timed}, "launches_path_j": paths["J"][name],
            **{f"launches_path_{p.lower()}": paths[p][name] for p in "KLMNOPQ"},
        })
        if name == "local_attention":
            # The same kernel at the other timed shapes: the window of 128,
            # path J's prefill (D = 256, window 2048), path L1's (D = 256,
            # full causal), path N's encoder (bidirectional over 1500 frames)
            # and decoder prefill, and path O's prefill (D = 128).
            for key, out_key in ATTN_KERNELS_KEY.items():
                kernels[-1][out_key] = {k: rec[key][k] for k in timed}
        if name == "ssd_scan":
            # From a given state h0 at row 8's shape (row 8b).
            kernels[-1]["h0"] = {k: rec["ssd_scan_h0"][k] for k in (*timed, "ms_without_h0")}
        if name == "gathered_lora_matmul":
            # At the q / v shapes of paths L, M, N and O, prefill and decode
            # (LORA_LM, LORA_NO).
            for key in LORA_SLICE11 + LORA_SLICE12:
                kernels[-1][key] = {k: rec[f"{name}_{key}"][k] for k in timed}
    print(f"[train fn] {smi} | forward (kernel) and backward (plain) per Function, with "
          f"path I's launches: " + json.dumps(
              {k: {**v, "launches_path_i": paths["I"][v["kernel"]]}
               for k, v in train_fns.items()}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[wall] {time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
