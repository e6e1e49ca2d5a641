"""K1's launch plan (``ops/gemm.py:gemm_plan``) and K6's tile rule
(``ops/gemm.py:w4a8_tile``), on the CPU.

``_block_work`` below mirrors the work each block of ``csrc/gemm.cu``'s
``w8a8_kernel`` takes: its output tile (the grid raster) and its K steps.
Over a launch, every (M tile, N tile, K step) must be taken exactly once,
and every row of a tile stored by exactly one block of its cluster.
``_w4a8_tiles`` mirrors ``w4a8_kernel``'s raster likewise. The kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from hydragen_torch.ops.gemm import (GEMM_BK, GEMM_GROUP_M, W4A8_BW, W4A8_GROUP_M, W4A8_TILES,
                                     GemmPlan, gemm_cluster_slots, gemm_plan, w4a8_blocks,
                                     w4a8_tile)

H100_SMS = 132

# (N, K) of every projection of the two models' decode layers.
DECODE_SHAPES = {
    "7b_qkvo": (4096, 4096), "7b_gate_up": (11264, 4096), "7b_down": (4096, 11264),
    "8b_qo": (4096, 4096), "8b_kv": (1024, 4096), "8b_gate_up": (14336, 4096),
    "8b_down": (4096, 14336),
}
RAGGED_SHAPES = {"130x96": (130, 96), "1026x4112": (1026, 4112), "11264x256": (11264, 256)}
ROWS = (1, 5, 256, 2048, 32768)


def _block_work(plan: GemmPlan, M: int, N: int, K: int):
    """Per block of the launch (arrays over the block index): M tile, N
    tile, first and end K step, and the cluster rank (the split)."""
    m_tiles, n_tiles = -(-M // plan.bm), -(-N // plan.bn)
    k_steps = -(-K // GEMM_BK)
    b = np.arange(plan.blocks(M, N))
    tile, split = b // plan.splits, b % plan.splits
    first_m = tile // (GEMM_GROUP_M * n_tiles) * GEMM_GROUP_M
    group_m = np.minimum(m_tiles - first_m, GEMM_GROUP_M)
    in_group = tile % (GEMM_GROUP_M * n_tiles)
    mt, nt = first_m + in_group % group_m, in_group // group_m
    kt0 = split * plan.split_steps
    kt1 = np.minimum(kt0 + plan.split_steps, k_steps)
    return mt, nt, kt0, kt1, split


def _check_cover(plan: GemmPlan, M: int, N: int, K: int):
    m_tiles, n_tiles = -(-M // plan.bm), -(-N // plan.bn)
    k_steps = -(-K // GEMM_BK)
    mt, nt, kt0, kt1, split = _block_work(plan, M, N, K)
    assert mt.min() >= 0 and mt.max() < m_tiles and nt.min() >= 0 and nt.max() < n_tiles
    # Each split's K range: a whole number of K steps of GEMM_BK bytes, the
    # last split ending at K (its last step ragged where K is).
    assert (kt1 > kt0).all()
    assert ((kt1 - kt0)[split < plan.splits - 1] == plan.split_steps).all()
    assert (kt1[split == plan.splits - 1] == k_steps).all()
    assert min(kt1.max() * GEMM_BK, K) == K
    cover = np.zeros((m_tiles, n_tiles, k_steps), dtype=np.int32)
    for s in range(plan.splits):
        sel = split == s
        lo, hi = int(kt0[sel][0]), int(kt1[sel][0])
        np.add.at(cover, (mt[sel], nt[sel], slice(lo, hi)), 1)
    assert (cover == 1).all()
    # The cluster's reduction: rank r stores rows [r bm / splits, (r + 1) bm
    # / splits) of its tile, so every row of a tile is stored once.
    assert plan.bm % plan.splits == 0
    rows = np.zeros(plan.bm, dtype=np.int32)
    for r in range(plan.splits):
        rows[r * plan.bm // plan.splits:(r + 1) * plan.bm // plan.splits] += 1
    assert (rows == 1).all()


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("shape", list(DECODE_SHAPES) + list(RAGGED_SHAPES))
def test_gemm_plan_covers_every_tile_and_k_step_once(shape, M):
    N, K = {**DECODE_SHAPES, **RAGGED_SHAPES}[shape]
    plan = gemm_plan(M, N, K, H100_SMS)
    # Split-K partials never reach device memory: a split is one cluster
    # (the kernel takes 1, 2 or 4 blocks), which sums them in its shared
    # memory.
    assert plan.bm in (128, 256) and plan.bn in (64, 128) and plan.splits in (1, 2, 4)
    _check_cover(plan, M, N, K)
    # At decode a weight tile is read by at most two blocks, whose M tiles
    # run side by side in the raster (block indices a cluster apart), so
    # the second read can find the tile in L2.
    if M <= 256:
        mt, nt, *_ = _block_work(plan, M, N, K)
        assert mt.max() <= 1
        if mt.max() == 1:
            b = np.arange(len(mt))
            first = b[(mt == 0)]
            assert (mt[first + plan.splits] == 1).all()
            assert (nt[first + plan.splits] == nt[first]).all()


@pytest.mark.parametrize("shape", list(DECODE_SHAPES))
def test_gemm_plan_keeps_the_card_busy_at_decode(shape):
    """At M = 256 every plan is one wave of 64 to 132 blocks: no tail wave.
    The card is not always full: at the 7B gate/up shape (88 weight tiles of
    128 rows) and Llama-3-8B's k/v (64 blocks) the fastest plans measured
    leave SMs idle, where filling them costs a second wave, a split's fixed
    costs or clusters of 4, which the card holds only 30 of (PERF.md §6).
    A split is taken only where the weight tiles alone leave SMs idle."""
    N, K = DECODE_SHAPES[shape]
    plan = gemm_plan(256, N, K, H100_SMS)
    clusters = plan.blocks(256, N) // plan.splits
    assert clusters <= gemm_cluster_slots(plan.splits, H100_SMS)
    assert 64 <= plan.blocks(256, N) <= H100_SMS
    if plan.splits > 1:
        assert clusters < H100_SMS


@pytest.mark.parametrize("M,N,K,want", [
    (256, 4096, 4096, GemmPlan(128, 64, 1, 32)),
    (256, 11264, 4096, GemmPlan(256, 128, 1, 32)),
    (256, 4096, 11264, GemmPlan(128, 128, 2, 44)),
    (256, 1024, 4096, GemmPlan(128, 128, 4, 8)),
    (256, 14336, 4096, GemmPlan(256, 128, 1, 32)),
    (256, 4096, 14336, GemmPlan(128, 128, 2, 56)),
    (2048, 4096, 4096, GemmPlan(256, 128, 1, 32)),
    (32768, 11264, 4096, GemmPlan(256, 128, 1, 32)),
], ids=["7b_qkvo", "7b_gate_up", "7b_down", "8b_kv", "8b_gate_up", "8b_down",
        "prefill_qkvo", "suffix_prefill_gate_up"])
def test_gemm_plan_at_the_paths_shapes(M, N, K, want):
    assert gemm_plan(M, N, K, H100_SMS) == want


def test_gemm_plan_is_memoized():
    gemm_plan.cache_clear()
    first = gemm_plan(256, 4096, 4096, H100_SMS)
    assert gemm_plan(256, 4096, 4096, H100_SMS) is first
    assert gemm_plan.cache_info().hits == 1


@settings(max_examples=80, deadline=None, database=None)
@given(M=st.integers(1, 5000), N=st.integers(1, 3000).map(lambda n: 2 * n),
       K=st.integers(1, 1200).map(lambda k: 16 * k), n_sm=st.sampled_from([8, 132]))
def test_gemm_plan_covers_random_shapes(M, N, K, n_sm):
    _check_cover(gemm_plan(M, N, K, n_sm), M, N, K)


# --- K6 ---------------------------------------------------------------------

# (N, K) of the 7B int4 layer's projections (the int4 path) and of the 8B's.
W4A8_SHAPES = {"7b_qkvo": (4096, 4096), "7b_gate_up": (11264, 4096),
               "7b_down": (4096, 11264), "8b_kv": (1024, 4096), "ragged": (130, 256)}


def _w4a8_tiles(M: int, N: int, ba: int):
    """Per block of a K6 launch (arrays over the block index): its M tile
    and N tile, as the kernel's raster computes them."""
    m_tiles, n_tiles = -(-M // ba), -(-N // W4A8_BW)
    b = np.arange(w4a8_blocks(M, N, ba))
    first_m = b // (W4A8_GROUP_M * n_tiles) * W4A8_GROUP_M
    group_m = np.minimum(m_tiles - first_m, W4A8_GROUP_M)
    in_group = b % (W4A8_GROUP_M * n_tiles)
    return first_m + in_group % group_m, in_group // group_m


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("shape", list(W4A8_SHAPES))
def test_w4a8_tile_covers_every_output_tile_once(shape, M):
    """Every (M tile, N tile) of the output is one block's, at the tile the
    rule picks; no K split, so a block owns its tile whole."""
    N, _ = W4A8_SHAPES[shape]
    ba = w4a8_tile(M, N, H100_SMS)
    assert ba in W4A8_TILES
    m_tiles, n_tiles = -(-M // ba), -(-N // W4A8_BW)
    mt, nt = _w4a8_tiles(M, N, ba)
    cover = np.zeros((m_tiles, n_tiles), dtype=np.int32)
    np.add.at(cover, (mt, nt), 1)
    assert (cover == 1).all()
    # Within a raster group the blocks of one weight tile are consecutive.
    first = np.flatnonzero(np.diff(nt, prepend=-1) != 0)
    assert len(first) == n_tiles * -(-m_tiles // W4A8_GROUP_M)


@pytest.mark.parametrize("shape,blocks", [("7b_qkvo", 128), ("7b_gate_up", 352),
                                          ("7b_down", 128), ("8b_kv", 32)])
def test_w4a8_tile_at_decode(shape, blocks):
    """At M = 256 a block is 64 weight rows x 128 activation rows: every 7B
    decode projection fills at least 128 of the 132 SMs without a K split,
    and the two blocks that read one weight tile are side by side, so the
    second read can find it in L2."""
    N, _ = W4A8_SHAPES[shape]
    ba = w4a8_tile(256, N, H100_SMS)
    assert ba == 128 and w4a8_blocks(256, N, ba) == blocks
    mt, nt = _w4a8_tiles(256, N, ba)
    assert (mt[0::2] == 0).all() and (mt[1::2] == 1).all()
    assert (nt[0::2] == nt[1::2]).all()


@pytest.mark.parametrize("M,N,want", [(1, 4096, 128), (256, 11264, 128), (2048, 4096, 256),
                                      (2048, 11264, 256), (32768, 11264, 256),
                                      (2048, 130, 128)])
def test_w4a8_tile_at_the_paths_shapes(M, N, want):
    """The wider activation tile only where it still gives every SM two
    blocks: the prefills, not decode."""
    ba = w4a8_tile(M, N, H100_SMS)
    assert ba == want
    if ba == 256:
        assert w4a8_blocks(M, N, 256) >= 2 * H100_SMS
