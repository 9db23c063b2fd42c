"""Where ``ssd_scan``'s device time goes, for one source tree of the port on
one card.

    python3 tools/ssd_scan_breakdown.py --src SRC [--clock]

imports ``repro_torch`` from SRC (this tree's ``src``, or the ``src`` of an
older commit unpacked with ``git archive``) and prints, at path D's prefill
(BH, S, P, N) = (192, 512, 64, 128) with 8 groups, model decays, the final
state returned:

- ``by_kernel``: device ms per call of the first pass and of the scan
  (``torch.profiler``);
- ``slope``: device ms per call at S = 64, 128, 256, 512 and the least
  squares line through them: its slope over the 8 tiles of S = 512 is the
  time a tile-step adds to a call, its intercept the cost of a call with no
  tile; the same at one wave (BH = 66, 11 groups: 132 blocks of 32 columns,
  one an SM), where the slope is one block's time per tile-step;
- with ``--clock``: a copy of the tree's ``csrc/ssd_scan.cu`` with
  ``tools/ssd_scan_clock.patch`` applied, built beside the kernels, and the
  per-phase cycles it records (``clock64`` on lane 0 of each warpgroup,
  averaged over the blocks and tiles; see the patch).  The kernel itself
  carries no instrumentation; where the patch no longer applies, the tool
  says which hunk failed and stops.

Times are CUDA events around 50 calls queued behind a sleep kernel, the
median of 5 such loops.  The first line names the card and its power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

LOOPS = 5
REPS = 50


def loop_ms(fn, reps: int = REPS) -> float:
    import torch

    times = []
    for _ in range(LOOPS):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def inputs(bsz, heads, s, p=64, n=128, seed=1):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((bsz * heads, s, p), generator=g, device="cuda")
    dt = torch.nn.functional.softplus(torch.randn((bsz * heads, s), generator=g, device="cuda"))
    da = -dt * torch.linspace(1.0, 16.0, heads, device="cuda").repeat(bsz)[:, None]
    b, c = (torch.randn((bsz, s, n), generator=g, device="cuda") for _ in range(2))
    return x, da, b, c


def fit(xs, ys):
    """Least-squares (slope, intercept)."""
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    sxx = sum((x - mx) ** 2 for x in xs)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    return slope, my - slope * mx


def slope_line(ssd, bsz, heads, label):
    rows = []
    for s in (64, 128, 256, 512):
        x, da, b, c = inputs(bsz, heads, s)
        rows.append((s // 64, loop_ms(lambda: ssd.ssd_scan(x, da, b, c, return_state=True))))
    slope, icpt = fit([r[0] for r in rows], [r[1] for r in rows])
    pts = " ".join(f"S={64 * t}:{ms:.4f}" for t, ms in rows)
    print(f"[ssd breakdown] slope {label} (BH={bsz * heads}): {pts} ms; "
          f"per tile-step {slope * 1e3:.3f} us, intercept {icpt * 1e3:.3f} us", flush=True)


def apply_patch(text: str, patch: str) -> str:
    """``text`` with each hunk of the unified diff ``patch`` applied: the
    hunk's old lines (context and removed) must occur exactly once."""
    hunks, cur = [], None
    for line in patch.splitlines():
        if line.startswith("@@"):
            cur = ([], [])
            hunks.append(cur)
        elif cur is not None and line[:1] in (" ", "-", "+", ""):
            body = line[1:] + "\n"
            if line[:1] != "+":
                cur[0].append(body)
            if line[:1] != "-":
                cur[1].append(body)
    for i, (old, new) in enumerate(hunks):
        old_s, new_s = "".join(old), "".join(new)
        if text.count(old_s) != 1:
            raise SystemExit(f"ssd_scan_clock.patch: hunk {i + 1} matches {text.count(old_s)} "
                             "places of ssd_scan.cu, not one; update the patch")
        text = text.replace(old_s, new_s)
    return text


def clock_breakdown(src: Path, ssd, backend) -> None:
    """Build ``csrc/ssd_scan.cu`` with ``ssd_scan_clock.patch`` applied and
    print its per-phase cycle counts at row 8's shape."""
    import torch

    cu = src / "repro_torch" / "kernels" / "csrc" / "ssd_scan.cu"
    patch = (Path(__file__).resolve().parent / "ssd_scan_clock.patch").read_text()
    backend.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    clocked = backend.BUILD_DIR / "ssd_scan_clock.cu"
    clocked.write_text(apply_patch(cu.read_text(), patch))
    out = backend.BUILD_DIR / "libssd_scan_clock.so"
    cmd = [backend._nvcc(), *backend.NVCC_FLAGS, f"-I{cu.parent}", "-o", str(out), str(clocked)]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out))
    lib.repro_ssd_clock_names.restype = ctypes.c_char_p
    names = lib.repro_ssd_clock_names().decode().split(",")
    lib.repro_ssd_scan.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.repro_ssd_clock_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.repro_ssd_clock_read.restype = ctypes.c_int
    x, da, b, c = inputs(8, 24, 512)
    bh, s, p = x.shape
    n = b.shape[-1]
    y = torch.empty_like(x)
    h = torch.empty((bh, n, p), device="cuda")
    scratch = torch.empty((ssd.scratch_floats(bh, s, 8),), device="cuda")
    for _ in range(3):
        err = lib.repro_ssd_scan(x.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(), None,
                                 y.data_ptr(), h.data_ptr(), scratch.data_ptr(), bh, s, p, n,
                                 bh // 8, 1, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
    torch.cuda.synchronize()
    vals = (ctypes.c_double * len(names))()
    assert lib.repro_ssd_clock_read(vals, len(names)) == 0
    parts = " ".join(f"{k}={v:.0f}" for k, v in zip(names, vals))
    print(f"[ssd breakdown] clock (cycles, mean over blocks and tiles): {parts}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="directory that holds repro_torch")
    ap.add_argument("--clock", action="store_true", help="also the clock64 phase breakdown")
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
    from repro_torch.kernels import backend
    from repro_torch.kernels import ssd_scan as ssd

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from kernel_call_costs import by_kernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[ssd breakdown] tree {src}; card {smi.strip().splitlines()[0] if smi else '?'}",
          flush=True)
    t0 = time.perf_counter()
    x, da, b, c = inputs(8, 24, 512)
    run = lambda: ssd.ssd_scan(x, da, b, c, return_state=True)
    run()
    torch.cuda.synchronize()
    print(f"[ssd breakdown] row 8 (192, 512, 64, 128): device_ms={loop_ms(run):.4f} "
          f"by_kernel={by_kernel(run, REPS)} (build and first call "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    slope_line(ssd, 8, 24, "row 8")
    slope_line(ssd, 11, 6, "one wave")
    if args.clock:
        clock_breakdown(src, ssd, backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
