"""Plain PyTorch versions of the fused FP8 flash attention, forward and
backward.

Counterpart of the forward half of `repro.kernels.fp8_attention.ref`:
`sr_hash_bits`, `_mask_block` (`mask_block`), `kv_stripe_span`, `_sblocks`
(`sblock`, one block) and the one-pass online softmax of
`fwd_stripe_online`, advanced per LANE (=128) column block in ascending
order. The reference runs one q tile against one kv stripe at a
time; this version runs every (batch, kv-head group, row) at once per
column block, which is the same recurrence: rows are independent, and a
block that is masked for a row leaves its carries bit-identical (its
rescale factor is exp(0) = 1 and it adds exact zeros), so the stripe
skipping of the reference and the kernel needs no counterpart here.

Semantics per column block j:
    S8 = Q_A((q8 . k8_j^T) * f_s);  x = valid ? S8 * s_s : -1e30
    m' = max(m, rowmax x);  c = exp(m - m');  e = valid ? exp(x - m') : 0
    E8 = Q_A(e * f_p);  l = l*c + rowsum e;  acc = acc*c + E8 . v8_j
    O = (acc * f_o) / (l > 0 ? l : 1)  -> bf16

The backward (`fp8_attention_bwd_ref`) is the counterpart of the
reference's `_pdp_blocks`, `bwd_stripe_rd`, `_ds_block`, `bwd_stripe_dq`,
`bwd_stripe_dkv`, `bwd_q_tile`, `bwd_tile_dkv_stripe` and
`fp8_attention_bwd_ref`: the softmax statistics recomputed from the fp8
residuals (m = row max, then l = sum of exp(x - m), both per column block
in ascending order), then per block
    P8  = Q_A(exp(x - m) / l * f_p)             P = P8 * s_p   (normalized)
    dP8 = Q_E((do8 . v8^T) * f_dp)              dP = dP8 * s_dp
    rd += rowsum(P * dP)
and, with the final rd, per block
    dS8 = Q_E(P * (dP - rd) * f_ds);  dq += dS8 . k8
    dk[blk] += dS8^T . q8,  dv[blk] += P8^T . do8  per 128-row query tile
with dq * f_dq, dk * f_dk, dv * f_dv applied once at the end, the dK/dV
parts added in (GQA member, query tile) order. SR bits: the counter hash
with SALT_P / SALT_DP / SALT_DS at the same coordinates as the forward's.

Skipped blocks: the kernels skip a (128-row query tile, 128-column kv
block) pair whose every position the causal (+ window) mask excludes, as
the reference skips fully masked kv stripes. Here such pairs contribute
exact zeros: a masked position has P = 0, but its dP is computed, and a
non-saturating dP that overflows would turn P * dP into NaN — so the
contributions of skipped pairs are zeroed explicitly (`_live`). The
reference skips at the granularity of its kv stripe (block_kv columns),
so it visits more masked blocks; results differ only where a masked,
visited position's dP overflows (ROADMAP.md queue 3).

Health counts (`with_counts=True`, the reference's `_health_counts` in its
count kernels): per quantized tensor — S and P (the forward's unnormalized
E8) in the forward, dP and dS in the backward — the number of observed
values that saturate (|q| at or above max normal, or not finite), that
flush (|q| below min normal, zeros included), and that are observed at
all, over the attended region (row < q_len and valid), as a (2, 3) int64
tensor [[sat, flush, observed] of the first tensor, of the second].
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.fp8_formats import get_format
from repro_torch.core.quantize import quantize_rne, sr_fp8_via_f16
from repro_torch.obs.counters import value_masks

LANE = 128
TQ = 128   # query rows per dK/dV contribution (the reference's TQ)
SALT_S, SALT_P, SALT_DP, SALT_DS = 0x51, 0x52, 0x53, 0x54
_GOLD = 0x9E3779B9
_M32 = 0xFFFFFFFF
MASK_MODES = ("causal", "full", "kv", "chunk")


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def sr_hash_bits(seed, salt: int, bh, rows, cols) -> torch.Tensor:
    """Counter-based SR bits (0..255, int64) from absolute coordinates —
    bitwise the reference's uint32 hash, computed in int64 (torch has no
    uint32 shifts on the CPU). seed/bh/rows/cols broadcast."""
    def u32(v):
        return torch.as_tensor(v, dtype=torch.int64) & _M32
    s = _fmix32((u32(seed) + salt * _GOLD) & _M32)
    s = _fmix32((s + _mul32(u32(bh), _GOLD)) & _M32)
    h = _fmix32((s + _mul32(u32(rows), _GOLD)) & _M32)
    h = _fmix32(h ^ _mul32(u32(cols), _GOLD))
    return h & 0xFF


def mask_block(mask_mode: str, rows, cols, s_len: int, window: int,
               kvmask=None, qpos=None) -> torch.Tensor:
    """Validity of score positions (`_mask_block`): kv padding always
    masked; causal (+ window) on absolute coordinates; kv ANDs a per-column
    validity; chunk compares slot positions with q positions (-1 = hole /
    inactive row)."""
    valid = cols < s_len
    if mask_mode == "causal":
        valid = valid & (cols <= rows)
        if window:
            valid = valid & (cols > rows - window)
    elif mask_mode == "kv":
        valid = valid & (kvmask != 0)
    elif mask_mode == "chunk":
        valid = valid & (kvmask >= 0) & (kvmask <= qpos)
        if window:
            valid = valid & (kvmask > qpos - window)
    elif mask_mode != "full":
        raise ValueError(f"unknown mask mode {mask_mode!r}")
    return valid


def kv_stripe_span(row0: int, bq: int, *, block_kv: int, n_kv: int,
                   mask_mode: str, window: int):
    """Inclusive [jmin, jmax] kv-stripe range a q tile of rows
    [row0, row0+bq) can attend; stripes outside are masked for every row."""
    if mask_mode != "causal":
        return 0, n_kv - 1
    jmax = min((row0 + bq - 1) // block_kv, n_kv - 1)
    jmin = max(row0 - window + 1, 0) // block_kv if window else 0
    return jmin, jmax


def _quant(y, bits, fmt_name, rounding, saturate):
    fmt = get_format(fmt_name)
    if rounding == "rne":
        return quantize_rne(y, fmt, saturate=saturate)
    return sr_fp8_via_f16(y, bits, fmt, saturate=saturate)


def sblock(qf, kf_blk, rows, cols, bh, qpos, kvm, *, seed, f_s, s_s,
           mask_mode, window, q_len, s_len, fmt_s, rounding_s, saturate_s):
    """One LANE-wide column block of quantized scores (the reference's
    `_sblocks` step): returns (S8 values, valid, x, obs) — x is S8 * s_s
    (-1e30 where masked), obs the observed region (row < q_len and valid)."""
    bits = sr_hash_bits(seed, SALT_S, bh, rows, cols) \
        if rounding_s == "sr" else None
    sv = _quant((qf @ kf_blk.transpose(-1, -2)) * f_s, bits, fmt_s,
                rounding_s, saturate_s).float()
    valid = mask_block(mask_mode, rows, cols, s_len, window, kvm, qpos)
    x = torch.where(valid, sv * s_s, torch.full_like(sv, -1e30))
    return sv, valid, x, (rows < q_len) & valid


def health_counts(vals: torch.Tensor, obs: torch.Tensor,
                  fmt_name: str) -> torch.Tensor:
    """(3,) int64 [saturated, flushed, observed] of quantized values
    `vals` (f32) over the observed positions `obs` (broadcast to vals),
    by `obs.counters.value_masks`' rule."""
    obs = obs.expand_as(vals)
    sat, flush = value_masks(vals, get_format(fmt_name))
    return torch.stack([(obs & sat).sum(), (obs & flush).sum(), obs.sum()])


def fwd_stripe_online(sv, valid, x, obs, vf_blk, carry, p_bits, *, f_p,
                      fmt_p, rounding_p, saturate_p, health=None):
    """One step of the one-pass online softmax over a column block:
    carry (m, l, acc, amax_s, amax_p) -> the updated carry, with the probs
    quantized unnormalized against the running max. `health`: None, or a
    (2, 3) int64 tensor to which the block's P counts add (row 1)."""
    m, l, acc, amax_s, amax_p = carry
    zero = torch.zeros_like(sv)
    amax_s = torch.maximum(amax_s, torch.where(obs, sv.abs(), zero).max())
    m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    e = torch.where(valid, torch.exp(x - m_new), zero)
    pf = _quant(e * f_p, p_bits, fmt_p, rounding_p, saturate_p).float()
    amax_p = torch.maximum(amax_p, torch.where(obs, pf.abs(), zero).max())
    if health is not None:
        health[1] += health_counts(pf, obs, fmt_p)
    l = l * corr + e.sum(dim=-1, keepdim=True)
    acc = acc * corr + pf @ vf_blk
    return m_new, l, acc, amax_s, amax_p


def fp8_attention_fwd_ref(q8, k8, v8, seed, scal, *, mask_mode="causal",
                          window: int = 0, kv_mask=None, chunk_pos=None,
                          fmt_s="e5m2", fmt_p="e5m2", rounding_s="sr",
                          rounding_p="sr", saturate_s=True, saturate_p=True,
                          q_len: Optional[int] = None,
                          with_counts: bool = False, hash_heads=None):
    """q8 (B,H,Q,D), k8/v8 (B,Hkv,S,D) fp8 payloads; seed int; scal 4 host
    f32 [f_s, s_s, f_p, f_o]. kv_mask (B,S): validity ('kv') or int slot
    positions ('chunk', -1 = hole) with chunk_pos (B,2) [start, n_valid].
    Returns (o (B,H,Q,D) bf16, amax_s, amax_p) — 0-d f32 amaxes in grid
    units over the attended region (row < q_len, default Q) — and,
    with_counts=True, the (2, 3) int64 S / P health counts. hash_heads:
    (H_whole, h0), the SR hash's head index b * H_whole + h0 + h (q holds
    heads h0.. of a tensor of H_whole heads); None: (H, 0)."""
    if mask_mode not in MASK_MODES:
        raise ValueError(f"unknown mask mode {mask_mode!r}")
    b_, h_, q_rows, d = q8.shape
    hkv, s_len = k8.shape[1], k8.shape[2]
    g = h_ // hkv
    dev = q8.device
    f_s, s_s, f_p, f_o = (float(np.float32(x)) for x in scal)
    # Heads h = hk*g + i: fold the group into the row dim so each kv head's
    # K/V is read once per column block (GQA without repeated copies).
    qf = q8.float().reshape(b_, hkv, g * q_rows, d)
    kf, vf = k8.float(), v8.float()
    r_idx = torch.arange(g * q_rows, device=dev)
    rows = (r_idx % q_rows).view(1, 1, -1, 1)
    heads = (torch.arange(hkv, device=dev).view(1, -1, 1, 1) * g
             + (r_idx // q_rows).view(1, 1, -1, 1))
    hash_h, head0 = (h_, 0) if hash_heads is None else hash_heads
    bh = torch.arange(b_, device=dev).view(-1, 1, 1, 1) * hash_h + head0 \
        + heads
    qpos = None
    if mask_mode == "chunk":
        cp = torch.as_tensor(chunk_pos, device=dev).long()
        start, n_valid = cp[:, 0].view(-1, 1, 1, 1), cp[:, 1].view(-1, 1, 1, 1)
        qpos = torch.where(rows < n_valid, start + rows,
                           torch.full_like(rows, -1))
    skw = dict(seed=seed, f_s=f_s, s_s=s_s, mask_mode=mask_mode,
               window=window, q_len=q_rows if q_len is None else q_len,
               s_len=s_len, fmt_s=fmt_s, rounding_s=rounding_s,
               saturate_s=saturate_s)
    pkw = dict(f_p=f_p, fmt_p=fmt_p, rounding_p=rounding_p,
               saturate_p=saturate_p)
    health = torch.zeros((2, 3), dtype=torch.int64, device=dev) \
        if with_counts else None
    m = torch.full((b_, hkv, g * q_rows, 1), -1e30, device=dev)
    carry = (m, torch.zeros_like(m),
             torch.zeros((b_, hkv, g * q_rows, d), device=dev),
             torch.zeros((), device=dev), torch.zeros((), device=dev))
    for c0 in range(0, s_len, LANE):
        c1 = min(c0 + LANE, s_len)
        cols = torch.arange(c0, c1, device=dev).view(1, 1, 1, -1)
        kvm = None if kv_mask is None else torch.as_tensor(
            kv_mask, device=dev)[:, c0:c1].reshape(b_, 1, 1, -1).long()
        sv, valid, x, obs = sblock(qf, kf[:, :, c0:c1], rows, cols, bh, qpos,
                                   kvm, **skw)
        if health is not None:
            health[0] += health_counts(sv, obs, fmt_s)
        p_bits = sr_hash_bits(seed, SALT_P, bh, rows, cols) \
            if rounding_p == "sr" else None
        carry = fwd_stripe_online(sv, valid, x, obs, vf[:, :, c0:c1], carry,
                                  p_bits, health=health, **pkw)
    _, l, acc, amax_s, amax_p = carry
    d_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = ((acc * f_o) / d_safe).to(torch.bfloat16)
    out = (o.reshape(b_, h_, q_rows, d), amax_s, amax_p)
    return out + (health,) if with_counts else out


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _live(rows, j: int, mask_mode: str, window: int):
    """Whether column block j is visited for each row: the kernels' skip
    set, kv_stripe_span of the row's 128-row query tile at block_kv =
    LANE. None when every block is visited ('full')."""
    if mask_mode != "causal":
        return None
    t0 = (rows // TQ) * TQ
    jmin, jmax = 0, (t0 + TQ - 1) // LANE
    live = j <= jmax
    if window:
        jmin = torch.clamp_min(t0 - window + 1, 0) // LANE
        live = live & (j >= jmin)
    return live


def _keep(live, x):
    return x if live is None else torch.where(live, x, torch.zeros_like(x))


def _ds_block(p_d, dp_d, rd, bits, *, f_ds, fmt_e, rounding_e, saturate_e):
    """dS8 = Q_E(P * (dP - rd) * f_ds): the softmax VJP of one block,
    quantized (the reference's `_ds_block`)."""
    return _quant((p_d * (dp_d - rd)) * f_ds, bits, fmt_e, rounding_e,
                  saturate_e)


def fp8_attention_bwd_ref(q8, k8, v8, do8, seed, scal, *,
                          mask_mode: str = "causal", window: int = 0,
                          fmt_s="e5m2", fmt_p="e5m2", fmt_e="e5m2",
                          rounding_s="sr", rounding_p="sr", rounding_e="sr",
                          saturate_s=True, saturate_p=True, saturate_e=False,
                          q_len: Optional[int] = None,
                          with_stats: bool = False,
                          with_counts: bool = False, hash_heads=None):
    """q8/do8 (B,H,Q,D), k8/v8 (B,Hkv,S,D) fp8 payloads; seed int or
    integer tensor; scal 10 host f32 [f_s, s_s, f_p, s_p, f_dp, s_dp,
    f_ds, f_dq, f_dk, f_dv]. Returns (dq (B,H,Q,D) f32, dk, dv (B,Hkv,S,D)
    f32, amax_dp, amax_ds) — 0-d f32 amaxes of the quantized dP / dS in
    grid units over the attended region — then, with_counts=True, the
    (2, 3) int64 dP / dS health counts, and, with_stats=True, the per-row
    statistics (m, l, rd), each (B,H,Q) f32. hash_heads: as
    `fp8_attention_fwd_ref`'s."""
    if mask_mode not in ("causal", "full"):
        raise ValueError(f"the attention backward supports causal/full, not "
                         f"{mask_mode!r}")
    b_, h_, q_rows, d = q8.shape
    hkv, s_len = k8.shape[1], k8.shape[2]
    g = h_ // hkv
    dev = q8.device
    (f_s, s_s, f_p, s_p, f_dp, s_dp, f_ds, f_dq, f_dk, f_dv) = (
        float(np.float32(x)) for x in scal)
    qf = q8.float().reshape(b_, hkv, g * q_rows, d)
    dof = do8.float().reshape(b_, hkv, g * q_rows, d)
    kf, vf = k8.float(), v8.float()
    r_idx = torch.arange(g * q_rows, device=dev)
    rows = (r_idx % q_rows).view(1, 1, -1, 1)
    heads = (torch.arange(hkv, device=dev).view(1, -1, 1, 1) * g
             + (r_idx // q_rows).view(1, 1, -1, 1))
    hash_h, head0 = (h_, 0) if hash_heads is None else hash_heads
    bh = torch.arange(b_, device=dev).view(-1, 1, 1, 1) * hash_h + head0 \
        + heads
    skw = dict(seed=seed, f_s=f_s, s_s=s_s, mask_mode=mask_mode,
               window=window, q_len=q_rows if q_len is None else q_len,
               s_len=s_len, fmt_s=fmt_s, rounding_s=rounding_s,
               saturate_s=saturate_s)

    def bits(salt, cols, rounding):
        return sr_hash_bits(seed, salt, bh, rows, cols) \
            if rounding == "sr" else None

    blocks = []
    for c0 in range(0, s_len, LANE):
        c1 = min(c0 + LANE, s_len)
        cols = torch.arange(c0, c1, device=dev).view(1, 1, 1, -1)
        _, valid, x, obs = sblock(qf, kf[:, :, c0:c1], rows, cols, bh, None,
                                  None, **skw)
        blocks.append((c0, c1, cols, valid, x, obs,
                       _live(rows, c0 // LANE, mask_mode, window)))

    # Softmax statistics, recomputed (the reference's fwd_stripe_m / _l).
    m = torch.full((b_, hkv, g * q_rows, 1), -1e30, device=dev)
    for c0, c1, cols, valid, x, obs, live in blocks:
        m = torch.maximum(m, x.amax(dim=-1, keepdim=True))
    l = torch.zeros_like(m)
    for c0, c1, cols, valid, x, obs, live in blocks:
        e = torch.where(valid, torch.exp(x - m), torch.zeros_like(x))
        l = l + e.sum(dim=-1, keepdim=True)
    d_safe = torch.where(l > 0, l, torch.ones_like(l))

    # Pass A: rd = rowsum(P * dP) and the dP observation.
    zero = torch.zeros((), device=dev)
    health = torch.zeros((2, 3), dtype=torch.int64, device=dev) \
        if with_counts else None
    rd = torch.zeros_like(m)
    amax_dp = zero
    pdp = []
    for c0, c1, cols, valid, x, obs, live in blocks:
        e = torch.where(valid, torch.exp(x - m), torch.zeros_like(x))
        p8 = _quant((e / d_safe) * f_p, bits(SALT_P, cols, rounding_p),
                    fmt_p, rounding_p, saturate_p)
        p_d = p8.float() * s_p
        dp = dof @ vf[:, :, c0:c1].transpose(-1, -2)
        dp8 = _quant(dp * f_dp, bits(SALT_DP, cols, rounding_e), fmt_e,
                     rounding_e, saturate_e)
        dp_d = dp8.float() * s_dp
        rd = rd + _keep(live, p_d * dp_d).sum(dim=-1, keepdim=True)
        amax_dp = torch.maximum(amax_dp, torch.where(
            obs, dp8.float().abs(), torch.zeros_like(dp_d)).max())
        if health is not None:
            health[0] += health_counts(dp8.float(), obs, fmt_e)
        pdp.append((p8, p_d, dp_d))

    # Pass B: dS, dq, and the dS observation.
    dq = torch.zeros_like(qf)
    amax_ds = zero
    ds_all, p_all = [], []
    for (c0, c1, cols, valid, x, obs, live), (p8, p_d, dp_d) in zip(blocks,
                                                                   pdp):
        ds8 = _ds_block(p_d, dp_d, rd, bits(SALT_DS, cols, rounding_e),
                        f_ds=f_ds, fmt_e=fmt_e, rounding_e=rounding_e,
                        saturate_e=saturate_e)
        amax_ds = torch.maximum(amax_ds, torch.where(
            obs, ds8.float().abs(), torch.zeros_like(p_d)).max())
        if health is not None:
            health[1] += health_counts(ds8.float(), obs, fmt_e)
        dsf = _keep(live, ds8.float())
        dq = dq + dsf @ kf[:, :, c0:c1]
        ds_all.append(dsf)
        p_all.append(_keep(live, p8.float()))

    # dK / dV in raw units, (GQA member, 128-row query tile) order, then
    # the scale once.
    ds_all = torch.cat(ds_all, dim=-1)
    p_all = torch.cat(p_all, dim=-1)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for i in range(g):
        for t0 in range(0, q_rows, TQ):
            r = slice(i * q_rows + t0, i * q_rows + min(t0 + TQ, q_rows))
            dk = dk + ds_all[:, :, r].transpose(-1, -2) @ qf[:, :, r]
            dv = dv + p_all[:, :, r].transpose(-1, -2) @ dof[:, :, r]
    out = ((dq * f_dq).reshape(b_, h_, q_rows, d), dk * f_dk, dv * f_dv,
           amax_dp, amax_ds)
    if health is not None:
        out += (health,)
    if with_stats:
        out += tuple(t.reshape(b_, h_, q_rows) for t in (m, l, rd))
    return out
