"""Tree checkpoints: ``torch.save`` of the leaves beside a JSON index (port of
``repro/checkpoint/io.py``, whose msgpack container this replaces).

A step lives in ``<ckpt_dir>/step_<step:08d>/``: ``state.pt`` holds a flat
dict ``{"0000": tensor, ...}`` of the tree's leaves in ``tree_leaves``
order, and ``index.json`` the metadata, each leaf's shape, dtype and CRC32
of its bytes, and the leaf count.  Both files are written to a temporary
name, fsync'd and renamed into place, the index last, so a crash mid-save
never leaves a step whose index vouches for a torn payload.  ``load_pytree``
verifies every checksum; ``restore_checkpoint`` without an explicit
``step`` walks back to the newest intact step.  ``save_checkpoint`` keeps
the newest ``keep`` steps.  A ``metadata={"format": "session"}`` checkpoint
of ``{"lora": ..., "agg_carry": ...}`` carries an aggregation session's
``AggCarry`` (``rpca.BucketCarry`` NamedTuples) beside the LoRA tree.
"""
from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import warnings
import zlib
from typing import Any, Optional, Tuple

import torch

from repro_torch.utils.pytree import tree_leaves, tree_unflatten

Tree = Any

_STATE = "state.pt"
_INDEX = "index.json"


class CheckpointCorruptError(ValueError):
    """The checkpoint is unreadable, torn, or fails its checksum."""


def _crc(t: torch.Tensor) -> int:
    raw = t.detach().cpu().contiguous().reshape(-1)
    if raw.dtype == torch.bfloat16:
        raw = raw.view(torch.int16)
    return zlib.crc32(raw.numpy().tobytes())


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_pytree(tree: Tree, step_dir: str, metadata: Optional[dict] = None) -> None:
    """Write ``tree``'s tensor leaves and ``metadata`` into ``step_dir``."""
    leaves = [x.detach().cpu().contiguous() for x in tree_leaves(tree)]
    os.makedirs(step_dir, exist_ok=True)
    _write_atomic(os.path.join(step_dir, _STATE),
                  lambda f: torch.save({f"{i:04d}": x for i, x in enumerate(leaves)}, f))
    index = {
        "metadata": dict(metadata or {}),
        "n_leaves": len(leaves),
        "leaves": [{"shape": list(x.shape), "dtype": str(x.dtype).removeprefix("torch."),
                    "crc32": _crc(x)} for x in leaves],
    }
    _write_atomic(os.path.join(step_dir, _INDEX),
                  lambda f: f.write(json.dumps(index, indent=1).encode()))


def _read_index(step_dir: str) -> dict:
    try:
        with open(os.path.join(step_dir, _INDEX), "rb") as f:
            index = json.loads(f.read())
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"unreadable checkpoint index in {step_dir}: {e}") from e
    if not isinstance(index, dict) or "leaves" not in index:
        raise CheckpointCorruptError(f"malformed checkpoint index in {step_dir}")
    return index


def _read_payload(step_dir: str) -> Tuple[list, dict]:
    """The checksum-verified leaves and the metadata of one step; raises
    ``CheckpointCorruptError`` on an unreadable or torn step or a checksum
    mismatch."""
    index = _read_index(step_dir)
    try:
        flat = torch.load(os.path.join(step_dir, _STATE), map_location="cpu", weights_only=True)
    except (OSError, RuntimeError, EOFError, ValueError, pickle.UnpicklingError) as e:
        raise CheckpointCorruptError(f"unreadable checkpoint payload in {step_dir}: {e}") from e
    want = index["leaves"]
    if not isinstance(flat, dict) or len(flat) != len(want):
        raise CheckpointCorruptError(f"torn checkpoint payload in {step_dir}")
    leaves = []
    for i, meta in enumerate(want):
        x = flat.get(f"{i:04d}")
        if x is None or _crc(x) != meta["crc32"]:
            raise CheckpointCorruptError(
                f"checksum mismatch in {step_dir} (leaf {i}): the file is corrupted")
        leaves.append(x)
    return leaves, index.get("metadata", {})


def load_pytree(step_dir: str, like: Tree) -> Tuple[Tree, dict]:
    """Restore into the structure of ``like``; each leaf lands on the device
    of ``like``'s leaf, in the stored dtype.  Returns (tree, metadata)."""
    stored, meta = _read_payload(step_dir)
    tmpl = tree_leaves(like)
    if len(stored) != len(tmpl):
        raise ValueError(f"checkpoint has {len(stored)} leaves; template has {len(tmpl)}")
    for t, got in zip(tmpl, stored):
        if tuple(t.shape) != tuple(got.shape):
            raise ValueError(f"shape mismatch: {tuple(t.shape)} vs {tuple(got.shape)}")
    return tree_unflatten(like, [x.to(t.device) for t, x in zip(tmpl, stored)]), meta


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save_checkpoint(tree: Tree, ckpt_dir: str, step: int, *, keep: int = 3,
                    metadata: Optional[dict] = None) -> str:
    """Save ``tree`` as step ``step`` (metadata gains ``"step"``), then prune
    to the newest ``keep`` steps.  Returns the step's directory."""
    path = _step_dir(ckpt_dir, step)
    meta = dict(metadata or {})
    meta["step"] = step
    save_pytree(tree, path, meta)
    _prune(ckpt_dir, keep)
    return path


def restore_checkpoint(ckpt_dir: str, like: Tree, step: Optional[int] = None):
    """Restore the requested (or newest) step: (tree, metadata).

    Without an explicit ``step``, a corrupted or torn newest step falls
    back to the next-newest intact one, with a warning; an explicit
    ``step`` is strict."""
    steps = _list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    if step is not None:
        return load_pytree(_step_dir(ckpt_dir, step), like)
    errors = []
    for chosen in reversed(steps):
        try:
            return load_pytree(_step_dir(ckpt_dir, chosen), like)
        except CheckpointCorruptError as e:
            warnings.warn(f"skipping corrupted checkpoint step {chosen}: {e}")
            errors.append(str(e))
    raise CheckpointCorruptError(f"every checkpoint under {ckpt_dir} is corrupted: {errors}")


def checkpoint_metadata(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """A checkpoint's metadata without reading its tensors (the index
    only), so a resuming run can pick the template to restore into."""
    steps = _list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    chosen = step if step is not None else steps[-1]
    return _read_index(_step_dir(ckpt_dir, chosen)).get("metadata", {})


def _list_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = _list_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
