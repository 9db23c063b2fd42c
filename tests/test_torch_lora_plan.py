"""The LoRA kernels' plan on the CPU: ``lora_matmul.plan`` mirrors the
geometry ``csrc/lora_matmul.cu`` launches (the card checks the same numbers
against the built library, ``tests/test_torch_cuda.py``).  Across the main
paths' (M, K, N) and edge sizes (1, 63, 64, 65 and 129 rows; N of 8, 256,
264 and 3352):

- the persistent prefill GEMM's clusters of two visit every output tile
  exactly once, in balanced walks of the grouped raster, the two CTAs of a
  cluster on the same column tiles and the first round's clusters sharing
  W's column panels;
- the x @ A pass's blocks and warps cover every (row, k) exactly once;
- the shared memory fits the H100's 232,448 bytes, leaves room for one
  GEMM block an SM, and equals the kernel source's static_asserts;
- the K-split rule of decode and of the fp32 FMA route is the one the
  kernels had before the prefill GEMM became persistent.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import lora_matmul as lm

CSRC = Path(lm.__file__).resolve().parent / "csrc" / "lora_matmul.cu"
# chip_smoke.py's LORA_SHAPES (M, K, N): StableLM q / v, Mamba-2 in_proj and
# out_proj, the q / v of paths L-O, each at decode, and the ragged shape.
PREFILL = [(4096, 2048, 2048), (4096, 768, 3352), (4096, 1536, 768), (4096, 3072, 4096),
           (4096, 5120, 5120), (4096, 5120, 1024), (4096, 8192, 8192), (4096, 8192, 1024),
           (4096, 1024, 1024), (4096, 1024, 512), (3328, 1024, 1024), (12000, 1024, 1024),
           (4096, 1536, 1536), (4096, 1536, 256), (2048, 2048, 2048)]
MAIN = PREFILL + [(8, k, n) for _, k, n in PREFILL] + [(129, 513, 130), (5, 64, 40)]
EDGE = [(m, k, n) for m in (1, 63, 64, 65, 129) for k in (64, 520, 2048)
        for n in (8, 256, 264, 3352)]


def old_k_splits(m, n, k):
    """The split rule as the kernels had it (before this plan existed)."""
    tiles = ((m + 127) // 128) * ((n + 127) // 128)
    if tiles >= 264:
        return 1
    return max(1, min((264 + tiles - 1) // tiles, max(1, ((k + 7) // 8) // 16)))


@pytest.mark.parametrize("clusters", [66, 65])
@pytest.mark.parametrize("m,k,n", PREFILL + [s for s in EDGE if s[0] > 64])
def test_gemm_walks_visit_every_tile_once(m, k, n, clusters):
    """At the H100's 66 clusters of two, and at 65 (an SM left unpaired)."""
    p = lm.plan(m, n, k, clusters=clusters)
    assert p["kernel"] == "lora_gemm_wide" and p["dependent"] and p["splits"] == 1
    assert p["threads"] == 384 and p["tile"][0] == 128
    assert p["stages"] == lm.GEMM_STAGES[p["tile"][1]]
    tiles_m, tiles_n = p["tiles"]
    assert tiles_m == -(-m // 128) and tiles_n == -(-n // p["tile"][1])
    assert p["pairs"] == -(-tiles_m // 2) * tiles_n
    assert p["clusters"] == min(p["pairs"], clusters) and p["grid"] == (2 * p["clusters"],)
    seen = np.zeros((tiles_m, tiles_n), dtype=int)
    for block in range(p["grid"][0]):
        walk = lm.gemm_tiles(p, block)
        if block % 2:  # the two CTAs of a cluster share their column tiles (W)
            assert [tn for _, tn in walk] == [tn for _, tn in lm.gemm_tiles(p, block - 1)][
                :len(walk)]
        for tm, tn in walk:
            seen[tm, tn] += 1
    assert (seen == 1).all()
    pairs = [len(range(c, p["pairs"], p["clusters"])) for c in range(p["clusters"])]
    assert max(pairs) - min(pairs) <= 1 and min(pairs) >= 1
    assert p["rounds"] == pytest.approx(p["pairs"] / clusters)
    # The clusters of the first round share W panels: each column tile they
    # take is taken by up to GROUP_M / 2 of them (row-major order would
    # spread them over up to 66 column tiles).
    cols = {tn for block in range(0, p["grid"][0], 2) for _, tn in lm.gemm_tiles(p, block)[:1]}
    assert len(cols) <= -(-p["clusters"] // min(lm.GROUP_M // 2, -(-tiles_m // 2))) + 1


@pytest.mark.parametrize("m,k,n", MAIN + EDGE)
def test_xa_pass_covers_every_row_and_k_once(m, k, n):
    for dtype in (torch.bfloat16, torch.float32):
        p = lm.plan(m, n, k, dtype)
        rows, kw, planes = p["xa_rows"], p["xa_kw"], p["xa_planes"]
        assert rows in (16, 32) and p["xa_threads"] == 8 * rows and kw % 32 == 0
        assert p["xa_grid"] == (-(-m // rows), planes)
        row_hits = np.zeros(p["xa_grid"][0] * rows, dtype=int)
        for bx in range(p["xa_grid"][0]):
            row_hits[bx * rows:(bx + 1) * rows] += 1
        assert (row_hits[:m] == 1).all()
        k_hits = np.zeros(planes * lm.XA_WARPS_K * kw, dtype=int)
        for z in range(planes):
            for q in range(lm.XA_WARPS_K):
                lo = (z * lm.XA_WARPS_K + q) * kw
                k_hits[lo:lo + kw] += 1
            assert z * lm.XA_WARPS_K * kw < k  # every plane has work
        assert (k_hits[:k] == 1).all()
        # Partial planes appear only where the GEMM splits K too (lora_finish
        # adds them); up to 16 at decode.
        assert planes == 1 or (p["splits"] > 1 and planes <= 16)


def test_decode_spreads_k_over_more_than_eight_blocks():
    p = lm.plan(8, 2048, 2048)
    assert p["kernel"] == "lora_gemm_tc" and p["xa_grid"] == (1, 16) and p["splits"] == 16
    assert lm.plan(8, 8192, 8192)["xa_grid"] == (1, 16)


@pytest.mark.parametrize("m,k,n", MAIN + EDGE)
def test_split_rule_unchanged(m, k, n):
    for dtype in (torch.bfloat16, torch.float32):
        p = lm.plan(m, n, k, dtype)
        tensor = p["route"] == "tensor"
        want = 1 if tensor and m > 64 else old_k_splits(m, n, k)
        assert p["splits"] == want
        if not (tensor and m > 64):
            tile = lm.DECODE_TILE if tensor else lm.SCALAR_TILE
            assert p["tile"] == tile
            assert p["grid"] == (-(-n // tile[1]), -(-m // tile[0]), want)
    if (k, n) != (513, 130) and m == 8:
        assert lm.plan(m, n, k)["splits"] > 1  # the serving shapes split K at decode


@pytest.mark.parametrize("m,k,n,bn", [
    (4096, 2048, 2048, 256), (4096, 8192, 8192, 256), (4096, 3072, 4096, 256),
    (4096, 1536, 768, 128), (4096, 1536, 256, 128), (4096, 1024, 512, 128),
    (3328, 1024, 1024, 128), (4096, 768, 3352, 128), (4096, 1536, 1536, 128),
    (12000, 1024, 1024, 128),
])
def test_tile_width(m, k, n, bn):
    """128-wide tiles where 256-wide ones leave the 132 SMs short of one
    round (Mamba-2 out_proj, Qwen2-VL v, Granite v, Whisper q / v), take
    more rounds of 128 columns (Mamba-2 in_proj, Qwen2-VL q) or K < 2048
    (Whisper's cross v on 12000 rows)."""
    assert lm.plan(m, n, k)["tile"] == (128, bn)


def test_shared_memory_fits_and_matches_the_kernel():
    src = CSRC.read_text()
    assert lm.GEMM_SMEM <= lm.SMEM_LIMIT < 2 * lm.GEMM_SMEM  # one block an SM
    ring = re.search(r"static_assert\(Wide<256>::kStages == (\d+) && Wide<128>::kStages == (\d+) "
                     r"&& kWideSmem == (\d+)", src)
    assert (int(ring[1]), int(ring[2])) == (lm.GEMM_STAGES[256], lm.GEMM_STAGES[128])
    assert int(ring[3]) == lm.GEMM_SMEM == 214112
    xa = re.search(r"XaTc<8>::kBufBytes == (\d+) && XaTc<64>::kBufBytes == (\d+)", src)
    assert (int(xa[1]), int(xa[2])) == (lm.XA_SMEM[8], lm.XA_SMEM[64])
    # The pass's static shared memory (plus its 65 slot words) stays under 48 KB.
    assert max(lm.XA_SMEM.values()) + 4 * 65 <= 48 * 1024
    regs = re.search(r"kProducerRegs = (\d+), kConsumerRegs = (\d+);", src)
    assert (int(regs[1]), int(regs[2])) == (lm.PRODUCER_REGS, lm.CONSUMER_REGS)
    # setmaxnreg moves registers, it does not add any: 4 warps at the
    # producer's count and 8 at the consumers' hold a 384-thread launch's 168.
    assert 4 * lm.PRODUCER_REGS + 8 * lm.CONSUMER_REGS <= 12 * 168
    assert f"kGroupM = {lm.GROUP_M};" in src


@pytest.mark.parametrize("m,k,n", [(4096, 2048, 2048), (8, 2048, 2048), (129, 513, 130)])
def test_plan_routes(m, k, n):
    """float32 and the ragged bf16 shape take the FMA route; misaligned
    bf16 operands too; the prefill route is the pass's dependent."""
    assert lm.plan(m, n, k, torch.float32)["kernel"] == "lora_gemm"
    assert lm.plan(m, n, k, aligned=False)["kernel"] == "lora_gemm"
    want = ("lora_gemm" if (k, n) == (513, 130) else
            "lora_gemm_wide" if m > 64 else "lora_gemm_tc")
    assert lm.plan(m, n, k)["kernel"] == want
    assert lm.plan(m, n, k)["dependent"] == (want == "lora_gemm_wide")
