"""The bf16 attention route's plan on the CPU: ``local_attention.tc_plan``
mirrors the key tiles the CUDA kernel visits for each query tile and
warpgroup, and the tiles it masks entry by entry.  Held against the mask
itself on a grid of lengths (around the 64- and 128-row tiles, and the
main paths' 300, 416, 1500, 2100 and 2560), every head width, windows from
1 key to past S, causal and not:

- every kept (row, key) pair lies in a tile its warpgroup multiplies;
- every other tile of the query tile is masked for all the warpgroup's
  rows (so skipping it is exact);
- every tile multiplied without the entry-by-entry mask keeps every pair of
  the warpgroup's rows below S;
- the geometry is ``TC_GEOM``'s, its shared memory fits the H100's 227 KB,
  and the kernel source static_asserts the same numbers.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import local_attention as la

LENGTHS = (1, 63, 64, 65, 127, 128, 129, 300, 416, 1500, 2100, 2560)
WINDOWS = (0, 1, 9, 64, 100, 128, 2048)
CSRC = Path(la.__file__).resolve().parent / "csrc" / "local_attention.cu"


def keep_mask(s, window, causal):
    i = np.arange(s)
    keep = np.ones((s, s), dtype=bool)
    if causal:
        keep &= i[:, None] >= i[None, :]
    if window:
        keep &= i[None, :] > i[:, None] - window
    return keep


def tile_blocks(keep, s, bn):
    """Per 64-row warpgroup block and key tile: whether any pair is kept,
    and whether every pair of rows < S is kept (keys past S never are)."""
    rows = -(-s // 128) * 128
    cols = -(-s // bn) * bn
    pad = np.zeros((rows, cols), dtype=bool)
    pad[:s, :s] = keep
    real = np.zeros((rows, cols), dtype=bool)
    real[:s] = True
    blocks = lambda a: a.reshape(rows // 64, 64, cols // bn, bn)
    any_kept = blocks(pad).any(axis=(1, 3))
    all_kept = (blocks(pad) | ~blocks(real)).all(axis=(1, 3))
    return any_kept, all_kept


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", la.HEAD_DIMS)
@pytest.mark.parametrize("s", LENGTHS)
def test_plan_covers_the_mask(s, d, causal):
    for window in WINDOWS:
        plan = la.tc_plan(s, d, window, causal)
        bn = plan["bn"]
        any_kept, all_kept = tile_blocks(keep_mask(s, window, causal), s, bn)
        assert len(plan["query_tiles"]) == -(-s // 128)
        for qt in plan["query_tiles"]:
            first, last = qt["t_first"], qt["t_first"] + qt["n_tiles"]
            assert 0 <= first < last <= -(-s // bn)
            for g in qt["warpgroups"]:
                row_block = g["lo"] // 64
                lo, hi = g["t_lo"], g["t_hi"]
                assert first <= lo <= hi <= last
                visited = np.zeros(any_kept.shape[1], dtype=bool)
                visited[lo:hi] = True
                # Kept pairs only in tiles the warpgroup multiplies: the
                # tiles it skips are masked for all its rows.
                assert not (any_kept[row_block] & ~visited).any(), (window, qt["q0"], g)
                if g["lo"] >= s:
                    assert lo == hi
                    continue
                for t in range(lo, hi):
                    if t not in g["masked"]:
                        assert all_kept[row_block, t], (window, qt["q0"], g, t)


@pytest.mark.parametrize("d", la.HEAD_DIMS)
def test_plan_geometry_fits_and_matches_the_kernel(d):
    plan = la.tc_plan(300, d, 0, True)
    assert (plan["bq"], plan["bn"], plan["stages"], plan["q_buffers"]) == la.TC_GEOM[d]
    assert plan["bq"] == 128 and plan["bn"] % 64 == 0 and plan["stages"] >= 2
    assert plan["smem_bytes"] == la.tc_smem_bytes(d) <= la.SMEM_LIMIT
    asserted = {int(m[0]): tuple(map(int, m[1:])) for m in re.findall(
        r"static_assert\(Geom<(\d+)>::BN == (\d+) && Geom<\d+>::kStages == (\d+) &&\s*"
        r"Geom<\d+>::kSmem == (\d+)", CSRC.read_text())}
    assert asserted[d] == (plan["bn"], plan["stages"], plan["smem_bytes"])
