"""The manifest and the files it names, against the benchmark's rules."""
from __future__ import annotations

import json
import re

import pytest

from bench.harness import manifest

MAN = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"][:1] == ["python3"] and len(MAN["command"]) <= 32
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.endswith("_torch")
    for word in MAN["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert any(word.startswith(p + "/") for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[section]
    entries = MAN[section]
    assert len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        assert set(e) - {"workloads"} == keys, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_metrics_and_cells_agree():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        c = manifest.cell(w["name"], MAN)
        assert len(c["end_to_end"]) >= 2 and c["per_layer"]
        have = {m["name"] for m in c["end_to_end"]}
        for m in c["per_layer"]:
            assert m["moves"] in have, (w["name"], m["name"])
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) == len(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_found_by_name(cell):
    c = manifest.cell(cell, MAN)
    manifest.driver(c["mix"]["driver"])
    for m in c["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))
    assert set(c["checks"]["limits"]) and all(v > 0 for v in c["checks"]["limits"].values())


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_configuration_files(conf):
    spec = json.loads((manifest.ROOT / conf["file"]).read_text())
    assert spec["name"] == conf["name"] and spec["source"] == conf["source"]
    assert spec["reduced"] == conf["reduced"]
    widths = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion",
              "experts_per_tok", "top_k")
    for k in conf["reduced"]:
        assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
        assert not any(w in k for w in widths)
    assert {w["config"] for w in MAN["workloads"]} >= {conf["name"]}


@pytest.mark.parametrize("cell", CELLS)
def test_every_end_to_end_metric_of_a_cell_is_reported(cell):
    from bench import run as bench_run

    c = manifest.cell(cell, MAN)
    out = {"e2e": {"round_s": 2.5, "agg_s": 1.5}, "setup_s": 20.0, "memory_peak_bytes": 2**33}
    got = bench_run.metrics_of(c, out, False, "NVIDIA H100 80GB HBM3")
    assert list(got) == [m["name"] for m in c["end_to_end"]]
    assert got["peak_mem_gib"]["value"] == 8.0 and all(v["value"] > 0 for v in got.values())


def test_device_ms_reads_busy_time_per_traced_call():
    read = manifest.metric_reader("device_ms.agg")
    assert read({"trace": {"busy_s": 4.5}, "traced_calls": 2}) == 2250.0
    assert read({"window": {}}) is None
