"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout,
and the files it names.  A cell names a configuration (its file in
``configs``) and a traffic mix (``mixes/<traffic>.json``); the mix names
the driver (``drivers/<driver>.py``); each per-layer metric is read by
``metrics/<name>.py``; each cell's limits of ``correct`` are in
``checks/<cell>.json``."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, manifest: dict | None = None, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration, mix, limits and metrics."""
    man = manifest or load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    return {
        "workload": w,
        "config": json.loads((root / conf["file"]).read_text()),
        "mix": json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text()),
        "checks": json.loads((BENCH / "checks" / f"{name}.json").read_text()),
        "end_to_end": [m for m in man["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in man["per_layer"] if name in m.get("workloads", [name])],
    }


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return _load(BENCH / "drivers" / f"{kind}.py", f"bench_driver_{kind}")


def metric_reader(name: str):
    """``read(record) -> float | None`` of the per-layer metric ``name``."""
    return _load(BENCH / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_")).read
