"""Public wrappers of the fused FP8 flash attention, forward and backward.

`fp8_attention_fwd(q8, k8, v8, seed, scal, ...)` is the counterpart of
`repro.kernels.fp8_attention.ops.fp8_attention_fwd`: fp8 payloads in,
bf16 output plus the scalar S / P amaxes (grid units, masked to the
attended region) out.

`fp8_attention_bwd(q8, k8, v8, do8, seed, scal, ...)` is the counterpart
of `repro.kernels.fp8_attention.ops.fp8_attention_bwd`: dq / dk / dv in
f32 plus the scalar dP / dS amaxes.

`with_counts=True` (training masks) runs the count variants of the forward
and of the dQ kernel (the reference's `_fwd_body_counts` and
`_bwd_dq_body_counts`) and also returns the precision-health counts of the
in-kernel quantized S / P (forward) or dP / dS (backward) values: a (2, 3)
int64 tensor, one row per tensor, [saturated, flushed, observed] over the
attended region. The dK/dV kernel counts nothing (it recomputes the dQ
kernel's dP / dS), as in the reference. Counting leaves every other output
bit for bit as it is.

Dispatch: CPU tensors take the plain versions (ref.py); CUDA tensors launch
the hand-written Hopper kernels (csrc/fp8_attention_fwd.cu,
csrc/fp8_attention_bwd.cu) or raise. `fp8_attention_fwd.launches`,
`fp8_attention_bwd_dq.launches` and `fp8_attention_bwd_dkv.launches`
count the launches of the three kernels (the forward's also by mask,
`launches_by_mask`; the forward's and the dQ kernel's count variants also
in `launches_with_counts`; the dQ kernel's also by variant,
`launches_by_variant`: 'stash' for spans of up to STASH_BLOCKS kv blocks,
'long' past them, chosen by `dq_variant`; each of the three also by the
build it ran, `launches_by_head_dim`: 128 or 256). `fwd_tile_order`,
`fwd_live_blocks` and `fwd_dead_warps` state the forward kernel's
schedule: its 128-row query tiles in launch order, the kv blocks each
visits and the warps that skip their epilogue; `dkv_block_order` and
`dkv_live_tiles` the dK/dV kernel's: its 64-row kv blocks in launch order
and the query tiles each block's chain visits.

Padding contract (the reference's): the head dim is zero-padded to the
next multiple of 128 the kernels are built for (128 or 256: `HEAD_DIMS`)
and the kv length to a multiple of 128 (slot positions pad with -1,
validity with 0); padded columns are masked and padded head lanes
contribute exact zeros, so outputs and amaxes do not depend on the
padding. A head dim above 256 raises on the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.fp8_formats import FP8_DTYPES, format_of_dtype
from repro_torch.kernels import build as _build
from repro_torch.kernels.fp8_attention import ref as _ref
from repro_torch.kernels.fused_quant_matmul.ops import aligned

LANE = _ref.LANE
HEAD_DIM = 128             # the narrowest build: smaller heads pad to it
HEAD_DIMS = (128, 256)     # the head dims the kernels are built for
_FMT_ID = {"e4m3": 0, "e5m2": 1}
_MASK_ID = {"causal": 0, "full": 1, "kv": 2, "chunk": 3}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 18
             + [ctypes.c_float] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p])


def padded_head_dim(d: int) -> int:
    """The build a head dim of d runs on: the next multiple of 128 among
    HEAD_DIMS (the reference's padding to a LANE multiple); ValueError
    above the widest."""
    for hd in HEAD_DIMS:
        if d <= hd:
            return hd
    raise ValueError(f"head dim {d} > {HEAD_DIMS[-1]} is not supported")


def _pad_bytes(x: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if not pad:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return F.pad(x.view(torch.uint8), widths).view(x.dtype)


def _pad_words(x, device, pad: int, value: int) -> torch.Tensor:
    """Per-column mask words as contiguous int32 on `device`, padded by
    `pad` columns of `value` (copied only where needed)."""
    x = torch.as_tensor(x, device=device).to(torch.int32)
    return (F.pad(x, (0, pad), value=value) if pad else x).contiguous()


def seed_tensor(seed, device) -> torch.Tensor:
    """The SR hash seed (a python int or an integer tensor, e.g. drawn by
    the caller's generator on the device) as a (1,) int32 or int64 tensor
    on `device`, of which the kernels read the low 32 bits from device
    memory: an int32 / int64 tensor already there is passed as it is (a
    seed drawn on the card costs no copy and no launch), another is
    converted, and an int seed is filled in on the device (no blocking
    host-to-device copy)."""
    if isinstance(seed, torch.Tensor):
        s = seed.reshape(1)
        if s.dtype not in (torch.int32, torch.int64) or s.device != device:
            s = s.to(device=device, dtype=torch.int64)
        return s.contiguous()
    v = int(seed) & 0xFFFFFFFF
    return torch.full((1,), v - (1 << 32) if v >= 1 << 31 else v,
                      dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# forward: the schedule of kernel 2 (csrc/fp8_attention_fwd.cu)
# ---------------------------------------------------------------------------

FWD_BQ = 128        # query rows per block: two warpgroups of 64
FWD_WARP_ROWS = 16  # query rows per warp
_NONE = np.iinfo(np.int32).max


def fwd_tile_order(q_rows: int) -> list:
    """Kernel 2's query tiles (FWD_BQ rows each) in launch order: blockIdx.z
    walks them from the last, so the longest causal kv spans start first.
    The wrapper sizes the per-tile amax outputs from it."""
    return list(range(-(-q_rows // FWD_BQ) - 1, -1, -1))


def _fwd_live_rows(q_rows, mask_mode, chunk_pos, b):
    """Rows [0, n) of batch row b that attend anything: rows past n_valid
    have q position -1 in 'chunk' mode."""
    if mask_mode == "chunk":
        return min(q_rows, int(chunk_pos[b][1]))
    return q_rows


def fwd_dead_warps(iq: int, b: int, *, q_rows: int, mask_mode: str,
                   chunk_pos=None) -> list:
    """Per warp of query tile iq of batch row b: True where all of its 16
    rows are dead (at or past Q, or q position -1). Such a warp skips its
    epilogue and stores zeros; a warpgroup of four also its products."""
    live = _fwd_live_rows(q_rows, mask_mode, chunk_pos, b)
    return [iq * FWD_BQ + w * FWD_WARP_ROWS >= live
            for w in range(FWD_BQ // FWD_WARP_ROWS)]


def fwd_live_blocks(iq: int, b: int, *, q_rows: int, s_len: int,
                    mask_mode: str, window: int = 0, kv_mask=None,
                    chunk_pos=None) -> list:
    """The kv blocks (LANE columns each, ascending) that query tile iq of
    batch row b visits: none without a live row; the causal (+ window)
    span (`kv_stripe_span` at the tile); every block for 'full'; for 'kv'
    and 'chunk' the blocks with a column whose key (0 for a valid 'kv'
    column, the slot position for 'chunk'; padding and holes have none)
    lies in the union of the tile's live row ranges ('chunk': q positions
    from the first live row's, less window - 1, to the last's). The kernel
    implements this rule; a skipped block is masked for every row."""
    nk = -(-s_len // LANE)
    row0 = iq * FWD_BQ
    live = _fwd_live_rows(q_rows, mask_mode, chunk_pos, b)
    if live <= row0:
        return []
    if mask_mode in ("causal", "full"):
        lo, hi = _ref.kv_stripe_span(row0, FWD_BQ, block_kv=LANE, n_kv=nk,
                                     mask_mode=mask_mode, window=window)
        return list(range(lo, hi + 1))
    mv = np.asarray(kv_mask[b]).astype(np.int64)
    if mask_mode == "kv":
        key, lo, hi = np.where(mv != 0, 0, _NONE), 0, 0
    else:
        start = int(chunk_pos[b][0])
        key = np.where(mv >= 0, mv, _NONE)
        lo = start + row0 - window + 1 if window else -_NONE
        hi = start + min(row0 + FWD_BQ, live) - 1
    key = np.concatenate([key, np.full(nk * LANE - s_len, _NONE)])
    hit = ((key >= lo) & (key <= hi)).reshape(nk, LANE).any(axis=1)
    return [int(j) for j in np.flatnonzero(hit)]


def _launch(q8, k8, v8, kvm, chunk_pos, seed, scal, *, mask_mode, window,
            s_len, fmt_s, fmt_p, rounding_s, rounding_p, saturate_s,
            saturate_p, lib=None, counts=False, heads=None):
    """Kernel 2 on padded CUDA payloads (D in HEAD_DIMS, S a multiple of
    128), through `lib` (a probe build) or the package's library. Returns (o,
    amaxes (2, B, H, tiles): the S and P amax of each query tile), and with
    `counts` (the count variant) also the (B, H, tiles, 2, 3) int32 S / P
    [saturated, flushed, observed] counts of each query tile. `heads`:
    `fp8_attention_fwd`'s."""
    b_, h_, q_rows, d = q8.shape
    hkv, s_pad = k8.shape[1], k8.shape[2]
    if d not in HEAD_DIMS or s_pad % LANE:
        raise ValueError(f"kernel needs D in {HEAD_DIMS}, S % {LANE} == 0")
    dev = q8.device
    o = torch.empty((b_, h_, q_rows, d), dtype=torch.bfloat16, device=dev)
    nq = len(fwd_tile_order(q_rows))
    amax = torch.empty((2, b_, h_, nq), dtype=torch.float32, device=dev)
    amax_s = amax.data_ptr()
    amax_p = amax_s + 4 * b_ * h_ * nq
    cnt = (torch.empty((b_, h_, nq, 2, 3), dtype=torch.int32, device=dev)
           if counts else None)
    fn = (lib or _build.load(_build.attention_lib("fp8_attention_fwd",
                                                   d))).attn_fwd_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    f_s, s_s, f_p, f_o = (float(np.float32(x)) for x in scal)
    seed_t = seed_tensor(seed, dev)
    hash_h, head0 = heads if heads is not None else (h_, 0)
    err = fn(q8.data_ptr(), k8.data_ptr(), v8.data_ptr(),
             kvm.data_ptr() if kvm is not None else None,
             chunk_pos.data_ptr() if chunk_pos is not None else None,
             o.data_ptr(), amax_s, amax_p,
             cnt.data_ptr() if cnt is not None else None,
             b_, h_, hkv, q_rows, s_pad, s_len, _MASK_ID[mask_mode],
             window, _FMT_ID[format_of_dtype(q8.dtype).name],
             _FMT_ID[format_of_dtype(k8.dtype).name],
             _FMT_ID[format_of_dtype(v8.dtype).name], _FMT_ID[fmt_s],
             _FMT_ID[fmt_p], int(rounding_s == "sr"), int(rounding_p == "sr"),
             int(saturate_s), int(saturate_p), d, f_s, s_s, f_p, f_o,
             seed_t.data_ptr(), hash_h, head0,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fp8_attention_fwd")
    fp8_attention_fwd.launches += 1
    fp8_attention_fwd.launches_by_mask[mask_mode] += 1
    fp8_attention_fwd.launches_by_head_dim[d] += 1
    fp8_attention_fwd.launches_with_counts += int(counts)
    if counts:
        return o, amax, cnt
    return o, amax


def _fwd_cuda(q8, k8, v8, seed, scal, *, mask_mode, window, kv_mask,
              chunk_pos, lib=None, **kw):
    """Kernel 2 on CUDA payloads of the wrapper's arguments, padded to
    D in HEAD_DIMS and S a multiple of 128, through `lib` (a probe build)
    or the package's library. Returns _launch's (o, per-tile amaxes[,
    per-tile counts])."""
    s_len = k8.shape[2]
    hd = padded_head_dim(q8.shape[3])
    qp = aligned(_pad_bytes(q8.contiguous(), 3, hd))
    kp = aligned(_pad_bytes(_pad_bytes(k8.contiguous(), 3, hd), 2, LANE))
    vp = aligned(_pad_bytes(_pad_bytes(v8.contiguous(), 3, hd), 2, LANE))
    kvm = cpos = None
    pad = kp.shape[2] - s_len
    if mask_mode == "kv":
        kvm = _pad_words(kv_mask, q8.device, pad, 0)
    elif mask_mode == "chunk":
        # Slot positions pad with -1: 0 is a valid position.
        kvm = _pad_words(kv_mask, q8.device, pad, -1)
        cpos = torch.as_tensor(chunk_pos, device=q8.device).to(
            torch.int32).contiguous()
    return _launch(qp, kp, vp, kvm, cpos, seed, scal, mask_mode=mask_mode,
                   window=window, s_len=s_len, lib=lib, **kw)


def fp8_attention_fwd(q8: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                      seed, scal, *, mask_mode: str = "causal",
                      window: int = 0, kv_mask=None, chunk_pos=None,
                      fmt_s: str = "e5m2", fmt_p: str = "e5m2",
                      rounding_s: str = "sr", rounding_p: str = "sr",
                      saturate_s: bool = True, saturate_p: bool = True,
                      with_counts: bool = False, heads=None):
    """Fused FP8 attention forward on logical payloads.

    q8 (B,H,Q,D); k8/v8 (B,Hkv,S,D), any fp8 dtypes; seed: int or integer
    tensor (SR hash);
    scal: 4 host f32 [f_s, s_s, f_p, f_o]. kv_mask (B,S): validity for
    mask_mode='kv', int slot positions (-1 = hole) for 'chunk', which also
    takes chunk_pos (B,2) int [start, n_valid]. Returns (o (B,H,Q,D) bf16,
    amax_s, amax_p) with 0-d f32 amaxes in grid units; with_counts=True
    (training masks only) also the (2, 3) int64 S / P counts (module
    docstring). heads: (H_whole, h0) when q holds heads h0.. of a tensor
    of H_whole heads (tensor parallelism): the SR hash reads each head's
    whole-tensor index, b * H_whole + h0 + h, as the one process's does;
    None: (H, 0)."""
    if mask_mode not in _MASK_ID:
        raise ValueError(f"unknown mask mode {mask_mode!r}")
    if with_counts and mask_mode not in ("causal", "full"):
        raise ValueError("with_counts supports the training masks "
                         f"(causal/full), not {mask_mode!r}")
    for x in (q8, k8, v8):
        if x.dtype not in FP8_DTYPES or x.dim() != 4:
            raise TypeError(f"fp8 (B,H,S,D) payloads required, got {x.dtype} "
                            f"{tuple(x.shape)}")
        if x.device != q8.device:
            raise ValueError("q8/k8/v8 on different devices")
    b_, h_, q_rows, d = q8.shape
    hkv, s_len = k8.shape[1], k8.shape[2]
    if h_ % hkv or k8.shape != v8.shape or k8.shape[0] != b_ \
            or k8.shape[3] != d:
        raise ValueError(f"shape mismatch q{tuple(q8.shape)} "
                         f"k{tuple(k8.shape)} v{tuple(v8.shape)}")
    if mask_mode in ("kv", "chunk") and kv_mask is None:
        raise ValueError(f"mask_mode={mask_mode!r} needs kv_mask")
    if mask_mode == "chunk" and chunk_pos is None:
        raise ValueError("mask_mode='chunk' needs chunk_pos")
    kw = dict(fmt_s=fmt_s, fmt_p=fmt_p, rounding_s=rounding_s,
              rounding_p=rounding_p, saturate_s=saturate_s,
              saturate_p=saturate_p, heads=heads)
    dev = q8.device.type
    if dev == "cpu":
        return _ref.fp8_attention_fwd_ref(
            q8, k8, v8, seed, scal, mask_mode=mask_mode, window=window,
            kv_mask=kv_mask, chunk_pos=chunk_pos, with_counts=with_counts,
            hash_heads=kw.pop("heads"), **kw)
    if dev != "cuda":
        raise ValueError(f"fp8_attention_fwd: unsupported device {q8.device}")
    hd = padded_head_dim(d)
    out = _fwd_cuda(q8, k8, v8, seed, scal, mask_mode=mask_mode,
                    window=window, kv_mask=kv_mask, chunk_pos=chunk_pos,
                    counts=with_counts, **kw)
    o, amax = out[:2]
    if d != hd:
        o = o[..., :d].contiguous()
    amax = torch.amax(amax.view(2, -1), dim=1)
    if with_counts:
        return o, amax[0], amax[1], tile_counts(out[2])
    return o, amax[0], amax[1]


def tile_counts(per_tile: torch.Tensor) -> torch.Tensor:
    """A kernel's per-tile (..., 2, 3) counts summed into the (2, 3)
    int64 totals (integer sums: the order does not matter)."""
    return per_tile.reshape(-1, 2, 3).sum(dim=0, dtype=torch.int64)


fp8_attention_fwd.launches = 0
fp8_attention_fwd.launches_by_mask = dict.fromkeys(_MASK_ID, 0)
fp8_attention_fwd.launches_with_counts = 0
fp8_attention_fwd.launches_by_head_dim = dict.fromkeys(HEAD_DIMS, 0)


# ---------------------------------------------------------------------------
# backward: the dQ kernel and the dK/dV kernel (csrc/fp8_attention_bwd.cu)
# ---------------------------------------------------------------------------

_BWD_DQ_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.POINTER(ctypes.c_int),
                                               ctypes.POINTER(ctypes.c_float),
                                               ctypes.c_void_p]
_BWD_DKV_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.POINTER(ctypes.c_int),
                                               ctypes.POINTER(ctypes.c_float),
                                               ctypes.c_void_p]


def _bwd_args(q8, k8, v8, do8, *, scal, q_len, s_len,
              mask_mode="causal", window=0, fmt_s="e5m2", fmt_p="e5m2",
              fmt_e="e5m2", rounding_s="sr", rounding_p="sr",
              rounding_e="sr", saturate_s=True, saturate_p=True,
              saturate_e=False, heads=None):
    b_, h_, q_rows, d = q8.shape
    hkv, s_pad = k8.shape[1], k8.shape[2]
    if d not in HEAD_DIMS or s_pad % LANE:
        raise ValueError(f"kernel needs D in {HEAD_DIMS}, S % {LANE} == 0")
    fid = [_FMT_ID[format_of_dtype(x.dtype).name] for x in (q8, k8, v8, do8)]
    hash_h, head0 = heads if heads is not None else (h_, 0)
    iv = (ctypes.c_int * 25)(
        b_, h_, hkv, q_rows, s_pad, q_len, s_len, int(mask_mode == "causal"),
        window, *fid, _FMT_ID[fmt_s], _FMT_ID[fmt_p], _FMT_ID[fmt_e],
        int(rounding_s == "sr"), int(rounding_p == "sr"),
        int(rounding_e == "sr"), int(saturate_s), int(saturate_p),
        int(saturate_e), d, hash_h, head0)
    fv = (ctypes.c_float * 10)(*(float(np.float32(x)) for x in scal))
    return iv, fv


# The dQ kernel's stash variant keeps a q tile's S8 / P8 and dP8 bytes for
# its whole kv span in shared memory: spans of up to STASH_BLOCKS kv blocks
# (LANE columns each) fit a budget of two blocks an SM. The kernel file
# has the same constant; its launch refuses a longer span.
STASH_BLOCKS = 4


def dq_span_blocks(q_rows: int, s_pad: int, mask_mode: str,
                   window: int = 0) -> int:
    """The most kv blocks the span of any q tile of the dQ kernel covers:
    `kv_stripe_span` at the tile's 128-row query tile and block_kv = LANE
    (the skip set of both backward kernels); every block for 'full'."""
    nk = s_pad // LANE
    if mask_mode != "causal":
        return nk
    return max(hi - lo + 1 for lo, hi in (
        _ref.kv_stripe_span(t0, _ref.TQ, block_kv=LANE, n_kv=nk,
                            mask_mode=mask_mode, window=window)
        for t0 in range(0, q_rows, _ref.TQ)))


def dq_variant(q_rows: int, s_pad: int, mask_mode: str,
               window: int = 0) -> str:
    """Which dQ kernel a launch takes, from its shape, mask and window
    alone: 'stash' (each product, SR hash and quantization once per score)
    when every span fits the stash, else 'long' (four passes that
    recompute the scores, for any span)."""
    return "stash" if dq_span_blocks(q_rows, s_pad, mask_mode, window) \
        <= STASH_BLOCKS else "long"


def fp8_attention_bwd_dq(q8, k8, v8, do8, seed, scal, variant=None,
                         counts=False, **kw):
    """Kernel 1 of the backward on padded CUDA payloads (D in HEAD_DIMS, S
    a multiple of 128): returns (dq (B,H,Q,D) f32, m, l, rd (B,H,Q) f32,
    amax_dp, amax_ds (B,H,ceil(Q/64)) f32 per q tile), and with `counts`
    (the count variant) also the (B,H,ceil(Q/64),2,3) int32 dP / dS
    [saturated, flushed, observed] counts per q tile. `kw`: mask_mode,
    window, q_len, s_len and the S/P/E format, rounding, saturate knobs.
    `variant` ('stash' / 'long') overrides `dq_variant`, for holding the
    two variants against each other; both compute the same function."""
    iv, fv = _bwd_args(q8, k8, v8, do8, scal=scal, **kw)
    b_, h_, q_rows, d = q8.shape
    if variant is None:
        variant = dq_variant(q_rows, k8.shape[2],
                             kw.get("mask_mode", "causal"),
                             kw.get("window", 0))
    dev = q8.device
    dq = torch.empty((b_, h_, q_rows, d), dtype=torch.float32, device=dev)
    m, l, rd = (torch.empty((b_, h_, q_rows), dtype=torch.float32,
                            device=dev) for _ in range(3))
    nq = -(-q_rows // 64)
    amax_dp, amax_ds = (torch.empty((b_, h_, nq), dtype=torch.float32,
                                    device=dev) for _ in range(2))
    cnt = (torch.empty((b_, h_, nq, 2, 3), dtype=torch.int32, device=dev)
           if counts else None)
    seed_t = seed_tensor(seed, dev)
    lib = _build.load(_build.attention_lib("fp8_attention_bwd", d))
    fn = {"stash": lib.attn_bwd_dq_stash_launch,
          "long": lib.attn_bwd_dq_launch}[variant]
    fn.argtypes = _BWD_DQ_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(q8.data_ptr(), k8.data_ptr(), v8.data_ptr(), do8.data_ptr(),
             seed_t.data_ptr(), dq.data_ptr(), m.data_ptr(), l.data_ptr(),
             rd.data_ptr(), amax_dp.data_ptr(), amax_ds.data_ptr(),
             cnt.data_ptr() if cnt is not None else None, iv, fv,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"fp8_attention_bwd_dq ({variant})")
    fp8_attention_bwd_dq.launches += 1
    fp8_attention_bwd_dq.launches_by_head_dim[d] += 1
    fp8_attention_bwd_dq.launches_by_variant[variant] += 1
    fp8_attention_bwd_dq.launches_with_counts += int(counts)
    if counts:
        return dq, m, l, rd, amax_dp, amax_ds, cnt
    return dq, m, l, rd, amax_dp, amax_ds


# The dK/dV kernel's schedule (csrc/fp8_attention_bwd.cu,
# attn_bwd_dkv_kernel_head): one block per (query head, batch row, DKV_ROWS
# kv rows); each runs its head's chain over the 128-row query tiles that
# attend its kv rows at the backward's skip set.
DKV_ROWS = 64


def dkv_live_tiles(kb: int, *, q_rows: int, s_pad: int, mask_mode: str,
                   window: int = 0) -> list:
    """The 128-row query tiles (ascending) whose kv span (`kv_stripe_span`
    at block_kv = LANE, the skip set of both backward kernels) holds kv
    block kb (DKV_ROWS rows): the chain of a dK/dV block, in its order."""
    j = kb * DKV_ROWS // LANE
    out = []
    for tq in range(-(-q_rows // _ref.TQ)):
        lo, hi = _ref.kv_stripe_span(tq * _ref.TQ, _ref.TQ, block_kv=LANE,
                                     n_kv=s_pad // LANE,
                                     mask_mode=mask_mode, window=window)
        if lo <= j <= hi:
            out.append(tq)
    return out


def dkv_block_order(s_pad: int) -> list:
    """The dK/dV kernel's kv blocks in launch order: blockIdx.z walks them
    ascending. Under the causal (+ window) and full masks a block's chain
    (`dkv_live_tiles`) never grows along this order, so the longest chains
    launch first (tests/test_torch_attn_bwd.py holds that)."""
    return list(range(s_pad // DKV_ROWS))


def fp8_attention_bwd_dkv(q8, k8, v8, do8, seed, scal, m, l, rd, lib=None,
                          **kw):
    """Kernel 2 of the backward on padded CUDA payloads, from kernel 1's
    row statistics, through `lib` (a probe build) or the package's library:
    returns (dk, dv) (B,Hkv,S,D) f32. With a GQA group of more than one,
    the kernel writes each query head's partials into a scratch allocated
    here, and a second kernel adds them in head order."""
    iv, fv = _bwd_args(q8, k8, v8, do8, scal=scal, **kw)
    dev = q8.device
    b_, h_ = q8.shape[:2]
    hkv, s_pad, d = k8.shape[1:]
    dk = torch.empty(k8.shape, dtype=torch.float32, device=dev)
    dv = torch.empty(k8.shape, dtype=torch.float32, device=dev)
    part = (torch.empty((2, b_, h_, s_pad, d), dtype=torch.float32,
                        device=dev) if h_ != hkv else None)
    seed_t = seed_tensor(seed, dev)
    fn = (lib or _build.load(_build.attention_lib(
        "fp8_attention_bwd", d))).attn_bwd_dkv_launch
    fn.argtypes = _BWD_DKV_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(q8.data_ptr(), k8.data_ptr(), v8.data_ptr(), do8.data_ptr(),
             seed_t.data_ptr(), m.data_ptr(), l.data_ptr(), rd.data_ptr(),
             dk.data_ptr(), dv.data_ptr(),
             part.data_ptr() if part is not None else None, iv, fv,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fp8_attention_bwd_dkv")
    fp8_attention_bwd_dkv.launches += 1
    fp8_attention_bwd_dkv.launches_by_head_dim[d] += 1
    return dk, dv


fp8_attention_bwd_dq.launches = 0
fp8_attention_bwd_dq.launches_by_variant = {"stash": 0, "long": 0}
fp8_attention_bwd_dq.launches_with_counts = 0
fp8_attention_bwd_dq.launches_by_head_dim = dict.fromkeys(HEAD_DIMS, 0)
fp8_attention_bwd_dkv.launches = 0
fp8_attention_bwd_dkv.launches_by_head_dim = dict.fromkeys(HEAD_DIMS, 0)


def fp8_attention_bwd(q8: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                      do8: torch.Tensor, seed, scal, *,
                      mask_mode: str = "causal", window: int = 0,
                      fmt_s: str = "e5m2", fmt_p: str = "e5m2",
                      fmt_e: str = "e5m2", rounding_s: str = "sr",
                      rounding_p: str = "sr", rounding_e: str = "sr",
                      saturate_s: bool = True, saturate_p: bool = True,
                      saturate_e: bool = False, with_counts: bool = False,
                      heads=None):
    """Fused FP8 attention backward (training masks 'causal' / 'full').

    q8/do8 (B,H,Q,D), k8/v8 (B,Hkv,S,D) fp8 payloads (do8: the
    error-quantized output cotangent); seed: int or integer tensor (the
    forward's); scal: 10 host f32 [f_s, s_s, f_p, s_p, f_dp, s_dp, f_ds,
    f_dq, f_dk, f_dv]. Returns (dq (B,H,Q,D), dk, dv (B,Hkv,S,D) f32,
    amax_dp, amax_ds) with 0-d f32 amaxes in grid units; with_counts=True
    also the (2, 3) int64 dP / dS counts (module docstring). heads: as
    `fp8_attention_fwd`'s.

    CPU tensors take the plain version (ref.py); CUDA tensors run the dQ
    kernel, then the dK/dV kernel (each counts its launches), or raise.
    Padding (the reference's): D to 128 or 256 (`padded_head_dim`) and S
    to a multiple of 128 with zeros, which contribute exact zeros and are
    masked out of the observations; Q needs none (the kernels guard ragged
    rows)."""
    if mask_mode not in ("causal", "full"):
        raise ValueError(f"fused attention backward supports causal/full, "
                         f"not {mask_mode!r}")
    for x in (q8, k8, v8, do8):
        if x.dtype not in FP8_DTYPES or x.dim() != 4:
            raise TypeError(f"fp8 (B,H,S,D) payloads required, got {x.dtype} "
                            f"{tuple(x.shape)}")
        if x.device != q8.device:
            raise ValueError("q8/k8/v8/do8 on different devices")
    b_, h_, q_rows, d = q8.shape
    hkv, s_len = k8.shape[1], k8.shape[2]
    if h_ % hkv or k8.shape != v8.shape or do8.shape != q8.shape \
            or k8.shape[0] != b_ or k8.shape[3] != d:
        raise ValueError(f"shape mismatch q{tuple(q8.shape)} "
                         f"k{tuple(k8.shape)} v{tuple(v8.shape)} "
                         f"do{tuple(do8.shape)}")
    kw = dict(mask_mode=mask_mode, window=window, fmt_s=fmt_s, fmt_p=fmt_p,
              fmt_e=fmt_e, rounding_s=rounding_s, rounding_p=rounding_p,
              rounding_e=rounding_e, saturate_s=saturate_s,
              saturate_p=saturate_p, saturate_e=saturate_e, heads=heads)
    dev = q8.device.type
    if dev == "cpu":
        return _ref.fp8_attention_bwd_ref(q8, k8, v8, do8, seed, scal,
                                          with_counts=with_counts,
                                          hash_heads=kw.pop("heads"), **kw)
    if dev != "cuda":
        raise ValueError(f"fp8_attention_bwd: unsupported device {q8.device}")
    hd = padded_head_dim(d)
    qp = aligned(_pad_bytes(q8.contiguous(), 3, hd))
    dop = aligned(_pad_bytes(do8.contiguous(), 3, hd))
    kp = aligned(_pad_bytes(_pad_bytes(k8.contiguous(), 3, hd), 2, LANE))
    vp = aligned(_pad_bytes(_pad_bytes(v8.contiguous(), 3, hd), 2, LANE))
    kw.update(q_len=q_rows, s_len=s_len)
    dq, m, l, rd, amax_dp, amax_ds, *cnt = fp8_attention_bwd_dq(
        qp, kp, vp, dop, seed, scal, counts=with_counts, **kw)
    dk, dv = fp8_attention_bwd_dkv(qp, kp, vp, dop, seed, scal, m, l, rd,
                                   **kw)
    if d != hd:
        dq = dq[..., :d].contiguous()
    if d != hd or kp.shape[2] != s_len:
        dk = dk[:, :, :s_len, :d].contiguous()
        dv = dv[:, :, :s_len, :d].contiguous()
    out = (dq, dk, dv, torch.amax(amax_dp), torch.amax(amax_ds))
    return out + (tile_counts(cnt[0]),) if with_counts else out


def reset_launches():
    """Set the launch counts of the three attention kernels to 0."""
    fp8_attention_fwd.launches = 0
    fp8_attention_fwd.launches_by_mask = dict.fromkeys(_MASK_ID, 0)
    fp8_attention_fwd.launches_with_counts = 0
    fp8_attention_fwd.launches_by_head_dim = dict.fromkeys(HEAD_DIMS, 0)
    fp8_attention_bwd_dq.launches = 0
    fp8_attention_bwd_dq.launches_by_variant = {"stash": 0, "long": 0}
    fp8_attention_bwd_dq.launches_with_counts = 0
    fp8_attention_bwd_dq.launches_by_head_dim = dict.fromkeys(HEAD_DIMS, 0)
    fp8_attention_bwd_dkv.launches = 0
    fp8_attention_bwd_dkv.launches_by_head_dim = dict.fromkeys(HEAD_DIMS, 0)
