"""The attention forward kernel's schedule (kernel 2,
csrc/fp8_attention_fwd.cu), held against the plain version's mask.

`ops.fwd_tile_order`, `ops.fwd_live_blocks` and `ops.fwd_dead_warps` state
the rule the kernel implements: the order of its 128-row query tiles, the
kv blocks a tile visits, and the warps that skip their epilogue. Skipping
is exact only if nothing skipped is attended, so on seeded random causal,
window, full, kv and chunk (with and without window) masks every skipped (tile, kv block) pair and
every dead warp must hold no position that `ref.mask_block` admits, and
the causal tiles must launch longest span first. On the card,
tests/test_torch_gpu.py::test_attention_kernel_runs_the_stated_schedule
holds the schedule the kernel ran (its probe build's records) to this rule.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fp8_attention import ops
from repro_torch.kernels.fp8_attention import ref

LANE, BQ, WR = ops.LANE, ops.FWD_BQ, ops.FWD_WARP_ROWS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_case(mode, seed):
    """(q_rows, s_len, window, kv_mask, chunk_pos) for B = 3 batch rows."""
    rng = np.random.default_rng(seed)
    b = 3
    s_len = int(rng.integers(1, 7)) * LANE - int(rng.integers(0, 100))
    q_rows = s_len if mode in ("causal", "window") else int(
        rng.integers(1, 300))
    window = int(rng.integers(1, 300)) if "window" in mode else 0
    kv_mask = chunk_pos = None
    if mode == "kv":
        kv_mask = (rng.random((b, s_len)) < rng.random((b, 1))).astype(
            np.int32)
        kv_mask[0] = 0                              # a fully masked row
        nk = -(-s_len // LANE)
        if nk > 1:                                  # a fully masked block
            kv_mask[1, LANE:2 * LANE] = 0
    if mode.startswith("chunk"):
        # Gathered slots: a permutation of positions 0.. with holes, whole
        # 128-slot blocks of holes, and q positions that end early.
        kv_mask = np.full((b, s_len), -1, np.int32)
        chunk_pos = np.zeros((b, 2), np.int32)
        for i in range(b):
            n_pos = int(rng.integers(0, s_len + 1))
            slots = rng.permutation(s_len)[:n_pos]
            kv_mask[i, slots] = np.arange(n_pos)
            blk = int(rng.integers(0, -(-s_len // LANE)))
            kv_mask[i, blk * LANE:(blk + 1) * LANE] = -1
            n_valid = int(rng.integers(0, q_rows + 1))
            start = int(rng.integers(0, max(1, n_pos - n_valid + 1)))
            chunk_pos[i] = (start, n_valid)
        chunk_pos[0, 1] = 0                         # every warp dead
        if b > 1:
            chunk_pos[1, 1] = 1                     # a single live row
    return q_rows, s_len, window, kv_mask, chunk_pos


def attended(mode, q_rows, s_len, window, kv_mask, chunk_pos, b):
    """(q_rows, s_len) validity of batch row b by the plain version."""
    rows = torch.arange(q_rows)[:, None]
    cols = torch.arange(s_len)[None]
    kvm = qpos = None
    if kv_mask is not None:
        kvm = torch.from_numpy(kv_mask[b].astype(np.int64))[None]
    if mode.startswith("chunk"):
        start, n_valid = (int(x) for x in chunk_pos[b])
        qpos = torch.where(rows < n_valid, start + rows,
                           torch.full_like(rows, -1))
    return ref.mask_block(mask_mode_of(mode), rows, cols, s_len, window, kvm, qpos).numpy()


MODES = ("causal", "window", "full", "kv", "chunk", "chunk_window")


def mask_mode_of(mode):
    return {"window": "causal", "chunk_window": "chunk"}.get(mode, mode)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode", MODES)
def test_skipped_blocks_and_dead_warps_attend_nothing(mode, seed):
    q_rows, s_len, window, kv_mask, chunk_pos = random_case(mode, seed)
    mask_mode = mask_mode_of(mode)
    nk = -(-s_len // LANE)
    skipped = 0
    for b in range(3):
        valid = attended(mode, q_rows, s_len, window, kv_mask, chunk_pos, b)
        for iq in ops.fwd_tile_order(q_rows):
            rows = slice(iq * BQ, min((iq + 1) * BQ, q_rows))
            live = ops.fwd_live_blocks(
                iq, b, q_rows=q_rows, s_len=s_len, mask_mode=mask_mode,
                window=window, kv_mask=kv_mask, chunk_pos=chunk_pos)
            assert live == sorted(set(live)) and all(0 <= j < nk
                                                     for j in live)
            for j in set(range(nk)) - set(live):
                skipped += 1
                assert not valid[rows, j * LANE:(j + 1) * LANE].any(), (
                    f"tile {iq} skips attended kv block {j} of row {b}")
            dead = ops.fwd_dead_warps(iq, b, q_rows=q_rows,
                                      mask_mode=mask_mode,
                                      chunk_pos=chunk_pos)
            assert len(dead) == BQ // WR
            for w, d in enumerate(dead):
                r0 = iq * BQ + w * WR
                if d:
                    assert not valid[r0:r0 + WR].any(), (
                        f"dead warp {w} of tile {iq} attends (row {b})")
    if mask_mode in ("kv", "chunk"):
        assert skipped > 0       # the fixtures hold blocks to skip


def test_chunk_holes_and_late_slots_are_skipped():
    """A request whose slots fill only the first kv block (the rest holes
    or positions past its last query) visits that block alone; a request
    with no live row visits none and all its warps are dead; a single live
    row keeps warp 0 alone."""
    s_len, q_rows = 4 * LANE, 32
    cols = np.arange(s_len)
    kv_mask = np.stack([np.where(cols < 100, cols, -1), cols,
                        np.where((cols // LANE) % 2 == 0, cols, -1), cols])
    chunk_pos = np.array([[68, 32], [0, 0], [300, 1], [0, 20]])
    kw = dict(q_rows=q_rows, s_len=s_len, mask_mode="chunk",
              kv_mask=kv_mask, chunk_pos=chunk_pos)
    assert ops.fwd_live_blocks(0, 0, **kw) == [0]
    assert ops.fwd_live_blocks(0, 1, **kw) == []
    assert ops.fwd_live_blocks(0, 2, **kw) == [0, 2]
    assert ops.fwd_live_blocks(0, 3, **kw) == [0]
    dkw = dict(q_rows=q_rows, mask_mode="chunk", chunk_pos=chunk_pos)
    assert ops.fwd_dead_warps(0, 0, **dkw) == [False] * 2 + [True] * 6
    assert all(ops.fwd_dead_warps(0, 1, **dkw))
    assert ops.fwd_dead_warps(0, 2, **dkw) == [False] + [True] * 7


@pytest.mark.parametrize("window", [0, 200])
def test_causal_tiles_launch_longest_span_first(window):
    s = 1000
    order = ops.fwd_tile_order(s)
    assert sorted(order) == list(range(-(-s // BQ)))
    spans = [len(ops.fwd_live_blocks(iq, 0, q_rows=s, s_len=s,
                                     mask_mode="causal", window=window))
             for iq in order]
    assert spans == sorted(spans, reverse=True)
    assert spans[0] > spans[-1]
    for iq in order:
        assert ops.fwd_live_blocks(
            iq, 0, q_rows=s, s_len=s, mask_mode="causal",
            window=window) == list(range(*np.add(ref.kv_stripe_span(
                iq * BQ, BQ, block_kv=LANE, n_kv=-(-s // LANE),
                mask_mode="causal", window=window), (0, 1))))


def test_chunk_window_keeps_a_block_that_holds_only_the_first_position():
    """A sliding window's first attended position (q position - window + 1)
    alone in a kv block keeps that block live."""
    s_len, window = 2 * LANE, 73
    kv_mask = (np.arange(s_len) + 1)[None]           # positions 1 .. 256
    qpos = 200                                       # first attended: 128
    live = ops.fwd_live_blocks(0, 0, q_rows=1, s_len=s_len,
                               mask_mode="chunk", window=window,
                               kv_mask=kv_mask, chunk_pos=[[qpos, 1]])
    valid = attended("chunk_window", 1, s_len, window, kv_mask,
                     np.array([[qpos, 1]]), 0)
    assert np.flatnonzero(valid[0, :LANE]).tolist() == [LANE - 1]
    assert live == [0, 1]
