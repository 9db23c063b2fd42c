"""What a run may load, and what the reference may import."""
from __future__ import annotations

import ast

import pytest

from bench.harness import guard, manifest


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("repro", True), ("repro.core.engine", True), ("repro_torch", False),
    ("repro_torch.core", False), ("reprox", False), ("jaxtyping", False), ("bench.run", False),
])
def test_forbidden_by_whole_top_level_name(name, bad):
    assert guard.forbidden_modules([name]) == ([name] if bad else [])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("sub", ["reference", "work", "gen"])
def test_yardstick_imports_nothing_of_the_program(sub):
    for path in sorted((manifest.BENCH / sub).glob("*.py")):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("repro_torch", "repro", "jax", "jaxlib", "flax"), \
                (path.name, mod)


def test_nothing_in_bench_reads_the_jax_benchmarks():
    for path in manifest.BENCH.rglob("*.py"):
        if path.name == "test_bench_guard.py":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "BENCH_agg" not in text, path
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("repro", "jax", "benchmarks"), (path, mod)


def test_run_without_a_card_prints_no_result(capsys, monkeypatch):
    import torch

    from bench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "stablelm-2-1.6b.agg40", "--seed", "2147483659",
                     "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""
