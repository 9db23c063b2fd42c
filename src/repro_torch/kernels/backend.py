"""Device policy and kernel builder shared by every hand-written kernel.

Policy, in one place: a kernel wrapper handed a CPU tensor computes the
kernel's plain PyTorch version (the twin of the jnp oracle in
``repro_torch.kernels.ref``); handed a CUDA tensor it launches the CUDA
kernel or raises.  There is no fallback from one to the other, and no flag
that selects it: the tensor's device decides.

Kernels are CUDA C++ sources under ``kernels/csrc/``.  They are compiled at
first use with ``nvcc`` into one shared library per source (plain C
interface, loaded with ``ctypes``), all sources started together, into
``build/repro_torch_kernels/`` at the repository root — a directory that
``.gitignore`` lists.  A library's file name carries a hash of its sources
and flags, so an edited source rebuilds and an unchanged one is reused.
Nothing is compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (compute the plain version).  Any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain path for device {t.device}")


def needs_grad(*ts: torch.Tensor) -> bool:
    """True when autograd records this call: grad mode is on and an input
    requires a gradient.  The wrappers then run through their
    ``torch.autograd.Function`` (the same kernel forward, a plain backward)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def resolve_device(device) -> torch.device:
    """Entry-point device policy: ``"cuda"`` unless the caller asks for
    the CPU.  A CUDA request on a machine without CUDA raises; nothing moves
    to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Returns
    {source stem: library path}; raises with the compiler's output when a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _lib_path(src)) for src in sorted(CSRC.glob("*.cu"))}
    procs = []
    for stem, (src, out) in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(src)]
        procs.append((stem, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for stem, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {stem} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {stem: out for stem, (_, out) in targets.items()}


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building all kernels on
    the first call."""
    with _LOCK:
        if stem not in _LIBS:
            paths = build_all()
            if stem not in paths:
                raise KeyError(f"no kernel source csrc/{stem}.cu")
            for name, path in paths.items():
                if name not in _LIBS:
                    _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[stem]


def check_launch(err: int, name: str) -> None:
    """Raise when a launch returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the raw pointer the C
    launchers take."""
    return torch.cuda.current_stream(t.device).cuda_stream
