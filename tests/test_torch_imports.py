"""The port stands alone: it imports neither JAX nor the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_every_module_imports_with_jax_blocked():
    """With ``jax`` and ``repro`` made unimportable, every module of the
    port — the serving slice's models, kernels, pool and launcher, the
    client mesh, the shapes, sharding rules, roofline, cost model and dry
    run, and the examples among them — still imports."""
    serving = {"repro_torch.models.model", "repro_torch.serve.pool", "repro_torch.launch.serve",
               "repro_torch.kernels.lora_matmul", "repro_torch.kernels.local_attention",
               "repro_torch.kernels.ops", "repro_torch.configs.stablelm_1_6b",
               "repro_torch.models.ssd", "repro_torch.kernels.ssd_scan",
               "repro_torch.kernels.soft_threshold", "repro_torch.configs.mamba2_130m",
               "repro_torch.launch.mesh", "repro_torch.configs.shapes",
               "repro_torch.models.partitioning", "repro_torch.launch.roofline",
               "repro_torch.launch.costmodel", "repro_torch.launch.dryrun",
               "repro_torch.examples.quickstart", "repro_torch.examples.compare_aggregators",
               "repro_torch.examples.fed_finetune_lm", "repro_torch.examples.serve_lora"}
    assert serving <= set(MODULES)
    code = (
        "import importlib, sys\n"
        "for blocked in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[blocked] = None\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
