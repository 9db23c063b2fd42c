"""Device and host time per call of the port's kernels, for comparing
source trees of the port on one card.

    python3 tools/kernel_call_costs.py --src SRC [--reps N]

imports ``repro_torch`` from SRC (this tree's ``src``, or the ``src`` of an
older commit unpacked with ``git archive``), builds that tree's kernels, and
prints one line per call at the main paths' shapes: ``gathered_lora_matmul``
with bf16 activations and a float32 pool of 8 slots, 8 requests of 4
tenants, at prefill (M = 4096) and decode (M = 8) of StableLM-2-1.6B's q / v
and Mamba-2-130M's in_proj and out_proj; ``local_attention`` at (256,
512, 64) bf16 causal; ``subspace_apply`` at path B's (48, 4096, 40) and
(48, 4096, 32) with 20 live columns and path A's (2, 4096, 20) float32
buckets (3072 live rows of 4096, as ViT-B/32's LoRA packs); and
``ssd_scan`` at path D's prefill, (BH, S, P, N) = (192, 512, 64, 128) with
8 groups, the final state returned.  Each line has

- ``device_ms``: device time per call, CUDA events around REPS calls queued
  behind a sleep kernel (the host's dispatch is hidden; gaps between a
  call's kernels count), the median of 5 such loops;
- ``host_us``: host time per call of the same loops (the wrapper's Python,
  its allocations and the C launcher, while the card is still asleep);
- ``by_kernel``: device ms per call of each kernel, by function name (its
  template instances added together), from ``torch.profiler`` (empty when
  its trace comes back empty);
- ``digest``: a SHA-256 prefix of the output's bits (every output of a
  call that returns several).

To compare trees, run them in the order A, B, B, A on one card; equal
digests mean equal bits.  The first line names the card and its power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

LORA_SHAPES = [(4096, 2048, 2048, "stablelm q/v prefill"),
               (8, 2048, 2048, "stablelm q/v decode"),
               (4096, 768, 3352, "mamba2 in_proj prefill"),
               (8, 768, 3352, "mamba2 in_proj decode"),
               (4096, 1536, 768, "mamba2 out_proj prefill"),
               (8, 1536, 768, "mamba2 out_proj decode")]
RANK = 8
TENANT_SLOTS = (1, 3, 4, 6)  # 4 tenants resident in a pool of 8 slots
LOOPS = 5
# (B, d2, live columns, label) of the subspace tail's main-path buckets.
SUBSPACE_SHAPES = [(48, 40, None, "path B 40 clients"), (48, 32, 20, "path B 20 of 32"),
                   (2, 20, None, "path A")]


def loop_times(fn, reps: int) -> tuple[float, float]:
    """(device ms, host us) per call of ``fn`` over ``reps`` calls queued
    behind a sleep kernel."""
    import torch

    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s: the host queues every call meanwhile
    e0.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps, host / reps * 1e6


def by_kernel(fn, reps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    ms: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU and dev(e) > 0:
            key = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
            name = re.split(r"[<(]", key)[0]
            ms[name] = ms.get(name, 0.0) + dev(e) / reps / 1e3
    return {k: round(v, 4) for k, v in ms.items()}


def report(name: str, fn, reps: int) -> None:
    import torch

    out = fn()
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.contiguous().view(torch.int16).cpu().numpy().tobytes())
    digest = h.hexdigest()[:16]
    for _ in range(3):
        fn()
    times = [loop_times(fn, reps) for _ in range(LOOPS)]
    dev_ms = statistics.median(t[0] for t in times)
    host_us = statistics.median(t[1] for t in times)
    print(f"[calls] {name}: device_ms={dev_ms:.4f} host_us={host_us:.1f} "
          f"by_kernel={by_kernel(fn, reps)} digest={digest}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="directory that holds repro_torch")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"no repro_torch package under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import local_attention as la
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import svt_subspace as sub

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[calls] tree {src}; card {smi.strip().splitlines()[0] if smi.strip() else '?'}",
          flush=True)
    for m, k, n, label in LORA_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(m + k + n)
        x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
        w = ((torch.rand((k, n), generator=g, device="cuda") * 2 - 1) / k**0.5).bfloat16()
        a_pool = torch.randn((8, 3, k, RANK), generator=g, device="cuda") / k**0.5
        b_pool = torch.randn((8, 3, RANK, n), generator=g, device="cuda") / RANK**0.5
        a, b = a_pool[:, 1], b_pool[:, 1]  # a layer's slice, as the serving pool is used
        req = torch.arange(m) * 8 // m
        rs = torch.as_tensor([TENANT_SLOTS[i % 4] for i in range(8)],
                             dtype=torch.int32)[req].cuda()
        report(f"gathered_lora_matmul {label} M={m} K={k} N={n} R={RANK}",
               lambda: lm.gathered_lora_matmul(x, w, a, b, rs, 2.0), args.reps)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, kk, v = (torch.randn((256, 512, 64), generator=g, device="cuda").bfloat16()
                for _ in range(3))
    report("local_attention prefill BH=256 S=512 D=64 causal",
           lambda: la.local_attention(q, kk, v), args.reps)
    for b, d2, n_valid, label in SUBSPACE_SHAPES:
        x = bucket(b, d2, n_valid)
        report(f"subspace_apply {label} B={b} vec=4096 d2={d2} valid={n_valid or d2}",
               lambda: sub.subspace_apply(*x[:7], mask=x[7]), args.reps)
    g = torch.Generator(device="cuda").manual_seed(1)
    bsz, heads, s, p, n = 8, 24, 512, 64, 128
    xs = torch.randn((bsz * heads, s, p), generator=g, device="cuda")
    dt = torch.nn.functional.softplus(torch.randn((bsz * heads, s), generator=g, device="cuda"))
    da = -dt * torch.linspace(1.0, 16.0, heads, device="cuda").repeat(bsz)[:, None]
    bb, cc = (torch.randn((bsz, s, n), generator=g, device="cuda") for _ in range(2))
    report(f"ssd_scan prefill BH={bsz * heads} S={s} P={p} N={n} G={bsz}",
           lambda: ssd.ssd_scan(xs, da, bb, cc, chunk=256, return_state=True), args.reps)
    return 0


def bucket(b: int, d2: int, n_valid):
    """(M, S, Y, P, rho, mu, thresh, mask) of a bucket as the ADMM loop sees
    it: rows from 3072 on zero, columns of M past ``n_valid`` zero."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(b + d2)
    t = lambda scale: torch.randn((b, 4096, d2), generator=g, device="cuda") * scale
    m, s, y = t(1.0), t(0.5), t(0.1)
    for a in (m, s, y):
        a[:, 3072:] = 0.0
    mask = None
    if n_valid is not None:
        mask = (torch.arange(d2, device="cuda") < n_valid).float()
        m *= mask
    p = torch.randn((b, d2, d2), generator=g, device="cuda") / d2**0.5
    rho = torch.rand((b,), generator=g, device="cuda") + 0.5
    return m, s, y, p, rho, 1.0 / rho, 0.05 * rho, mask


if __name__ == "__main__":
    sys.exit(main())
