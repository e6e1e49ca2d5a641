"""The launch plans of the kernels of ``csrc/flash.cu``, on the CPU.

``flash_plan`` picks K2/K4's KV split; ``_block_keys`` below mirrors the key
range each block of the kernel walks. ``decode_splits`` picks K5's, and
``_decode_item_keys`` mirrors the keys each of K5's work items reads. The kernel itself runs only on the
card (``tests/test_torch_cuda.py``). The key ranges are held against the
plain version's own mask: ``attention_bhsd`` with all scores equal and V the
identity gives each query row weight > 0 on exactly its unmasked keys.
"""

import math

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hydragen_torch.ops.flash import (DECODE_CHUNK, DECODE_TILE, DECODE_WARPS_PER_SM, FLASH_BM,
                                     FLASH_BN, decode_splits, flash_plan)
from hydragen_torch.ops.reference import attention_bhsd

H100_SMS = 132


# (kv heads x batch, folded rows M, keys S) -> (splits, chunk)
@pytest.mark.parametrize("shape,want", [
    ((32, 256, 2048), (2, 1024)),      # Llama-2-7B decode: 256 rows x 1 query, 32 kv heads
    ((8, 1024, 2048), (2, 1024)),      # Llama-3-8B decode: 4 x 256 folded rows, 8 kv heads
    ((32, 32768, 2048), (1, 2048)),    # 7B request 2: 256 x 128-token suffixes
    ((8, 131072, 2048), (1, 2048)),    # 8B request 2: 4 x 256 x 128 folded rows
], ids=["7b_decode", "8b_decode", "7b_request2", "8b_request2"])
def test_flash_plan_at_the_paths_shapes(shape, want):
    BH, M, S = shape
    splits, chunk = flash_plan(BH, M, S, H100_SMS)
    assert (splits, chunk) == want
    assert chunk % FLASH_BN == 0 and splits * chunk >= S > (splits - 1) * chunk
    blocks = BH * math.ceil(M / FLASH_BM) * splits
    tiles = math.ceil(S / FLASH_BN)
    # The card stays busy: of the SM-time the grid's waves take (each block
    # walking its split's tiles), at least 90 % does work.
    waves = math.ceil(blocks / H100_SMS)
    busy = blocks / splits * tiles / (waves * H100_SMS * (chunk // FLASH_BN))
    assert busy >= 0.9
    # The causal prefills never split.
    assert flash_plan(BH, M, S, H100_SMS, causal=True) == (1, S)


def _block_keys(mb, split, *, M, q_len, S, limit, causal, chunk):
    """The keys ``[start, end)`` that the block of M block ``mb`` and split
    ``split`` walks, in tiles of ``FLASH_BN`` from ``start``: ``flash_kernel``'s
    own computation in ``csrc/flash.cu``. ``limit`` is the row's length
    clamped to ``[0, S]``; a causal block stops at the diagonal of its
    highest query position."""
    kv_end = limit
    if causal:
        lo = mb * FLASH_BM
        hi = min(lo + FLASH_BM, M) - 1
        max_qpos = hi % q_len if lo // q_len == hi // q_len else q_len - 1
        kv_end = max(0, min(kv_end, max_qpos + S - q_len + 1))
    start = split * chunk
    return start, max(start, min(start + chunk, kv_end))


def _plain_mask(group, q_len, S, limit, causal):
    """[M, S] bool: the keys each folded row of the plain version weighs."""
    q = torch.zeros(1, group, q_len, S)
    k = torch.zeros(1, 1, S, S)
    v = torch.eye(S)[None, None]
    out, _ = attention_bhsd(q, k, v, causal=causal,
                            kv_seq_lens=torch.tensor([limit]))
    return (out[0] > 0).reshape(group * q_len, S)


@settings(max_examples=60, deadline=None, database=None)
@given(group=st.integers(1, 4), q_len=st.integers(1, 300), S=st.integers(1, 700),
       limit_frac=st.floats(0, 1), causal=st.booleans(), BH=st.integers(1, 40),
       n_sm=st.sampled_from([8, 132]))
def test_flash_blocks_visit_each_unmasked_key_once(group, q_len, S, limit_frac, causal, BH,
                                                   n_sm):
    """Over every (M block, split) of a launch: each key the plain version
    weighs for a row lies in exactly one of its block's split ranges, and no
    block reads a tile that starts at or past its range's end (so none past
    the length or the causal diagonal of its last row)."""
    M = group * q_len
    limit = round(limit_frac * S)
    splits, chunk = flash_plan(BH, M, S, n_sm, causal)
    assert chunk % FLASH_BN == 0 and splits * chunk >= S
    mask = _plain_mask(group, q_len, S, limit, causal)
    for mb in range(math.ceil(M / FLASH_BM)):
        rows = slice(mb * FLASH_BM, min((mb + 1) * FLASH_BM, M))
        visits = torch.zeros(S, dtype=torch.int32)
        for split in range(splits):
            start, end = _block_keys(mb, split, M=M, q_len=q_len, S=S, limit=limit,
                                     causal=causal, chunk=chunk)
            n_tiles = math.ceil((end - start) / FLASH_BN)
            assert start + (n_tiles - 1) * FLASH_BN < end or n_tiles == 0
            assert end == start or end <= limit  # an empty split reads nothing
            visits[start:end] += 1
        block_mask = mask[rows]
        needed = block_mask.any(0)
        assert (visits[needed] == 1).all()
        assert (visits <= 1).all()
        # The last key a block walks is one some row of the block needs.
        walked = visits.nonzero()
        if len(walked):
            assert needed[int(walked.max())]


def _decode_item_keys(split, *, chunk, limit):
    """The keys ``[start, end)`` that K5's work item of split ``split`` reads
    for a row of length ``limit``, in tiles of ``DECODE_TILE`` from
    ``start``: ``flash_decode_kernel``'s own computation in ``csrc/flash.cu``
    (keys of the last tile at or past ``end`` are zero-filled, not read)."""
    start = split * chunk
    return start, max(start, min(start + chunk, limit))


@settings(max_examples=80, deadline=None, database=None)
@given(BH=st.integers(1, 1200), S=st.integers(0, 40000),
       lens=st.lists(st.floats(0, 1.2), min_size=1, max_size=6),
       n_sm=st.sampled_from([8, 132]), per_sm=st.sampled_from([2, 4]))
def test_decode_items_visit_each_key_below_the_length_once(BH, S, lens, n_sm, per_sm):
    """Over every (row, split) item of a K5 launch: each key below a row's
    length lies in exactly one item's range, none at or past it is read, no
    item reads a tile that starts at or past its range's end, and the grid
    splits only as far as it needs to keep ``per_sm`` items an SM (the
    values of DECODE_WARPS_PER_SM)."""
    assert per_sm in DECODE_WARPS_PER_SM.values()
    splits, chunk = decode_splits(BH, S, n_sm, per_sm)
    assert splits * chunk >= S and (splits - 1) * chunk < max(S, 1)
    if splits > 1:
        assert chunk % DECODE_TILE == 0
        assert BH * (splits - 1) < per_sm * n_sm
        assert splits <= -(-S // DECODE_CHUNK)
    for frac in lens:
        limit = min(max(round(frac * S), 0), S)  # the kernel clamps a length to [0, S]
        visits = torch.zeros(max(S, 1), dtype=torch.int32)
        for split in range(splits):
            start, end = _decode_item_keys(split, chunk=chunk, limit=limit)
            n_tiles = -(-(end - start) // DECODE_TILE)
            assert n_tiles == 0 or start + (n_tiles - 1) * DECODE_TILE < end
            visits[start:end] += 1
        assert (visits[:limit] == 1).all() and (visits[limit:] == 0).all()
