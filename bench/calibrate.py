"""Readings that the limits of ``correct`` are set from, on the card, at a
cell's own size, in one process:

    python3 bench/calibrate.py --workload <cell> --seeds 12 --control 3 --faults 3

* the program's numbers on each of ``--seeds`` seeds (its checked steps
  against the plain reference, one round or call of window);
* the control's on ``--control`` seeds: the reference put in the program's
  place at the precision below the configuration's (training: the base's
  products in float8 e4m3; aggregation: float32 with TF32 products), held
  to the same reference;
* each fault of the driver's ``FAULTS`` (or of ``--fault-names``) planted
  under the timed path, on ``--faults`` seeds.

Each reading is a JSON line on standard output and in
``chiprun_out/calibrate/<cell>.jsonl``.  The benchmark's own runs never
run this.
"""
from __future__ import annotations

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def control(drv, cell, seed, device, want):
    """The control's readings against the reference outputs ``want``."""
    from bench.reference import rpca as ref_rpca

    if cell["mix"]["driver"] == "fedround":
        got = drv.follow(cell, seed, device, len(want), quant="fp8")
        return drv.compare(got, want)
    import torch

    with ref_rpca.tf32(True):
        got = drv.follow(cell, seed, device, len(want), dtype=torch.float32)
    return {"update_gap": drv.compare(got, want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--fault-names", default=None,
                    help="comma list of the driver's FAULTS to plant (default all)")
    ap.add_argument("--first-seed", type=int, default=3_000_000_011)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from bench.harness import manifest

    cell = manifest.cell(args.workload)
    drv = manifest.driver(cell["mix"]["driver"])
    out_dir = ROOT / "chiprun_out" / "calibrate"
    out_dir.mkdir(parents=True, exist_ok=True)
    sink = open(out_dir / f"{args.workload}.jsonl", "a")

    def emit(**rec):
        line = json.dumps(rec)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    for i in range(max(args.seeds, args.control, args.faults)):
        seed = args.first_seed + 7919 * i
        if i < args.seeds or i < args.control:
            t = time.perf_counter()
            res = drv.run(cell, seed, 0.0, False, args.device, time.perf_counter())
            if i < args.seeds:
                emit(kind="program", seed=seed, readings=res["readings"],
                     seconds=time.perf_counter() - t, notes=res["notes"])
            if i < args.control:
                emit(kind="control", seed=seed,
                     readings=control(drv, cell, seed, args.device, res["want"]))
            del res
        if i < args.faults:
            for fault in (args.fault_names.split(",") if args.fault_names else drv.FAULTS):
                res = drv.run(cell, seed, 0.0, False, args.device, time.perf_counter(),
                              fault=fault)
                emit(kind="fault", fault=fault, seed=seed, readings=res["readings"])
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    sink.close()
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    sys.exit(main())
