"""Run one cell of the benchmark of the PyTorch port on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration file and a traffic mix; the mix names its driver.  The run
makes its inputs and weights from ``--seed``, warms up the cell's own
shapes, measures for ``--seconds``, checks the checked steps against the
plain reference, and prints one JSON line last on standard output: the
end-to-end metrics with ``--trace 0``, the per-layer metrics (and a
profiled tail after the window) with ``--trace 1``.  Each number compared
is also printed, beside its limit, in the last lines of standard error.

Exits 2 on bad arguments, 3 without enough CUDA cards, 4 when the JAX
stack or the JAX package is loaded; a failing run raises (exit 1).
"""
from __future__ import annotations

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def prepare() -> None:
    """The process's environment, before torch is imported: build and
    kernel caches at fixed places inside the checkout (the kernels' own
    build directory, ``build/repro_torch_kernels``, is fixed by the
    program), and the checkout's packages on the path."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def metrics_of(cell: dict, out: dict, trace_on: bool, device_name: str) -> dict:
    """The result's metrics: the cell's end-to-end ones, or with the trace
    its per-layer ones whose readers found something to read.  An
    end-to-end metric ``<name>.<suffix>`` is the driver's ``<name>`` under
    a bound of its own (``round_s.moe``: the rounds of the cells whose
    spread sets it)."""
    from bench.harness import manifest, peaks

    if not trace_on:
        vals = dict(out["e2e"], setup_s=out["setup_s"],
                    peak_mem_gib=out["memory_peak_bytes"] / 2**30)
        return {m["name"]: {"value": vals[m["name"].split(".")[0]], "unit": m["unit"]}
                for m in cell["end_to_end"]}
    record = dict(out["record"], e2e=out["e2e"], peaks=peaks.card_peaks(device_name))
    res = {}
    for m in cell["per_layer"]:
        v = manifest.metric_reader(m["name"])(record)
        if v is not None:
            res[m["name"]] = {"value": v, "unit": m["unit"]}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.harness import checks, guard, manifest

    cell = manifest.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = manifest.driver(cell["mix"]["driver"]).run(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", CLOCK0)
    bad = guard.forbidden_modules()
    if bad:
        print(f"no result: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    name = torch.cuda.get_device_name(0)
    line = {
        "correct": bool(out["correct"]),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics_of(cell, out, bool(args.trace), name),
        "device": {"platform": "gpu", "kind": name, "count": chips,
                   "memory_peak_bytes": int(out["memory_peak_bytes"])},
    }
    tr = out["record"].get("trace")
    if args.trace and tr is not None:
        line["device"]["busy_s"] = tr["busy_s"]
        line["device"]["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": [list(kv) for kv in tr["device_ops"][:10]],
                             "idle_gaps": [list(kv) for kv in tr["idle_gaps"][:10]]}
    line["checks"] = out["checks"]
    for k, v in out.get("notes", {}).items():
        print(f"{k}: {v!r}", flush=True)
    print(json.dumps(line), flush=True)
    checks.print_checks(out["checks"])
    return 0


if __name__ == "__main__":
    prepare()
    sys.exit(main())
