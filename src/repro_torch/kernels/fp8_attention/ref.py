"""Plain PyTorch version of the fused FP8 flash-attention forward.

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
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.fp8_formats import get_format
from repro_torch.core.quantize import quantize_rne, sr_fp8_via_f16

LANE = 128
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


def fwd_stripe_online(sv, valid, x, obs, vf_blk, carry, p_bits, *, f_p,
                      fmt_p, rounding_p, saturate_p):
    """One step of the one-pass online softmax over a column block:
    carry (m, l, acc, amax_s, amax_p) -> the updated carry, with the probs
    quantized unnormalized against the running max."""
    m, l, acc, amax_s, amax_p = carry
    zero = torch.zeros_like(sv)
    amax_s = torch.maximum(amax_s, torch.where(obs, sv.abs(), zero).max())
    m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    e = torch.where(valid, torch.exp(x - m_new), zero)
    pf = _quant(e * f_p, p_bits, fmt_p, rounding_p, saturate_p).float()
    amax_p = torch.maximum(amax_p, torch.where(obs, pf.abs(), zero).max())
    l = l * corr + e.sum(dim=-1, keepdim=True)
    acc = acc * corr + pf @ vf_blk
    return m_new, l, acc, amax_s, amax_p


def fp8_attention_fwd_ref(q8, k8, v8, seed, scal, *, mask_mode="causal",
                          window: int = 0, kv_mask=None, chunk_pos=None,
                          fmt_s="e5m2", fmt_p="e5m2", rounding_s="sr",
                          rounding_p="sr", saturate_s=True, saturate_p=True,
                          q_len: Optional[int] = None):
    """q8 (B,H,Q,D), k8/v8 (B,Hkv,S,D) fp8 payloads; seed int; scal 4 host
    f32 [f_s, s_s, f_p, f_o]. kv_mask (B,S): validity ('kv') or int slot
    positions ('chunk', -1 = hole) with chunk_pos (B,2) [start, n_valid].
    Returns (o (B,H,Q,D) bf16, amax_s, amax_p) — 0-d f32 amaxes in grid
    units over the attended region (row < q_len, default Q)."""
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
    bh = torch.arange(b_, device=dev).view(-1, 1, 1, 1) * h_ + heads
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
        p_bits = sr_hash_bits(seed, SALT_P, bh, rows, cols) \
            if rounding_p == "sr" else None
        carry = fwd_stripe_online(sv, valid, x, obs, vf[:, :, c0:c1], carry,
                                  p_bits, **pkw)
    _, l, acc, amax_s, amax_p = carry
    d_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = ((acc * f_o) / d_safe).to(torch.bfloat16)
    return o.reshape(b_, h_, q_rows, d), amax_s, amax_p
