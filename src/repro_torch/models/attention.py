"""GQA attention block with FP8 GEMMs, the fused FP8 flash kernel and KV
caches (counterpart of `repro.models.attention`, modes 'train', 'encode',
'cross', 'prefill', 'decode' and 'chunk').

The projections go through qeinsum. Under a kernel backend with delayed
scaling, attention goes through the fused kernel with K/V left unrepeated
(B, Hkv, S, dh) — GQA grouping happens inside the kernel. Otherwise (the
paper's recipe, or a disabled config) attention is the reference's
unfused composition `_sdpa`: K/V repeated over the GQA group (so each
repeat gets its own SR bits), the two 4-D contractions as qeinsum (sites
qk / pv), an f32 softmax between them; training and prefill sequences past
`attn_chunk_threshold` (or a window) go through
`chunked_causal_attention`'s static-prefix q chunks, each recomputed in the
training backward under `cfg.remat`, as the reference's are. Under delayed
scaling the two contractions quantize at their sites' scales and record
their amaxes, as the reference's do.

The encoder-decoder's modes attend without a mask ('full' in the kernel):
'encode' is the encoder's bidirectional self-attention (RoPE applied),
'cross' the decoder's attention to the encoder output `kv_x`, which
supplies K and V (no RoPE; the query and key lengths differ).

KV caches hold bf16, or FP8 (`policy.kv_cache_format` e5m2 / e4m3: RNE,
saturating, at the frozen '.../kv/{k,v}#A' scales). The fused serving
paths hand FP8 payloads to the kernel as they are; the unfused ones
dequantize them to bf16 first.

Fixed-slot serving ('prefill', 'decode'; `init_cache`, (B, C, Hkv, dh)
rows with per-slot positions): prefill attends the prompt's own K/V and
writes it into the cache in place (only the admitted slot's row, when
given); decode appends one token per row at slot pos % C, in place, and
attends the cache under the slot-validity mask ('kv' in the kernel).
The reference returns new caches from both instead.

Paged serving ('chunk'): the layer's KV pool is a flat slot array
(`init_paged_pool`). The chunk's K/V are written to their slots first —
IN PLACE, unlike the reference's functional update, to keep one pool per
layer in device memory — then the block-table-ordered view is gathered
and attended under the position mask, so in-chunk causality comes from
`slot_pos <= qpos` with no separate causal mask.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.precision_policy import ACT, QuantConfig
from repro_torch.core.qattention import (fp8_sdpa, fp8_sdpa_chunk,
                                         fp8_sdpa_decode, fuse_attention)
from repro_torch.core.qlinear import qeinsum
from repro_torch.distributed import tensor_parallel
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.models.remat import checkpointed
from repro_torch.scaling import context as scale_ctx


def init_attention(cfg: ModelConfig, *, generator, device):
    d, h, hkv, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    kw = dict(generator=generator, device=device)
    p = {"wq": dense_init(d, h * dh, **kw),
         "wk": dense_init(d, hkv * dh, **kw),
         "wv": dense_init(d, hkv * dh, **kw),
         "wo": dense_init(h * dh, d, scale=0.5, **kw)}
    if cfg.qkv_bias:
        for name, n in (("bq", h * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros((n,), dtype=torch.float32, device=device)
    return p


_CACHE_DTYPES = {None: torch.bfloat16, "e5m2": torch.float8_e5m2,
                 "e4m3": torch.float8_e4m3fn}
_CACHE_CLIP = {torch.float8_e5m2: 57344.0, torch.float8_e4m3fn: 448.0}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               window: int = 0):
    """One layer's fixed-slot KV cache: k / v (B, C, Hkv, dh) in the cache
    format, the absolute position held by each slot (-1 = empty) and the
    per-row fill count. C = max_len, or for a local layer (window > 0) a
    ring of min(window, max_len) slots, as in the reference."""
    cap = min(window, max_len) if window else max_len
    shape = (batch, cap, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = _CACHE_DTYPES[cfg.policy.kv_cache_format]
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "slot_pos": torch.full((batch, cap), -1, dtype=torch.int32,
                                   device=device),
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}


def init_paged_pool(cfg: ModelConfig, n_slots: int, *, device):
    """One layer's flat KV pool of `n_slots` token slots in the cache
    format. Slot 0 is on the allocator's reserved trash page."""
    shape = (n_slots, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = _CACHE_DTYPES[cfg.policy.kv_cache_format]
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _to_cache_dtype(x: torch.Tensor, dtype, scale: float = 1.0
                    ) -> torch.Tensor:
    """Store in the cache format: for FP8, x * (1 / scale) in f32 (the
    reciprocal rounded to f32, as the reference's weakly typed constant
    is), clipped to the format's max normal, then cast (RNE)."""
    lim = _CACHE_CLIP.get(dtype)
    if lim is None:
        return x.to(dtype)
    xs = x.float() * float(np.float32(1.0 / scale))
    return xs.clamp(-lim, lim).to(dtype)


def _from_cache_dtype(x: torch.Tensor, dtype=torch.bfloat16,
                      scale: float = 1.0) -> torch.Tensor:
    if scale == 1.0:
        return x.to(dtype)
    return (x.float() * float(np.float32(scale))).to(dtype)


def _kv_scales(cfg: ModelConfig) -> Tuple[float, float]:
    """Frozen KV-cache scales from the active context (1.0 outside frozen
    serving). Frozen serving with an FP8 cache refuses sites that were
    never calibrated: a silent unit scale would mis-scale every cached
    key and value."""
    ctx = scale_ctx.current()
    if ctx is None or cfg.policy.kv_cache_format is None:
        return 1.0, 1.0
    kk = ctx.site_key("kv/k") + "#A"
    vk = ctx.site_key("kv/v") + "#A"
    if ctx.mode == "frozen":
        missing = [key for key in (kk, vk) if not ctx.has_scale(key)]
        if missing:
            raise ValueError(
                f"frozen serving with kv_cache_format="
                f"{cfg.policy.kv_cache_format!r} but the KV-cache site(s) "
                f"{missing} have no calibrated scale — the cache would be "
                "quantized with a silent unit scale; calibrate with the FP8 "
                "KV cache enabled (the kv/* sites are observed during "
                "calibration) or serve without frozen scales")
    return ctx.frozen_scale(kk), ctx.frozen_scale(vk)


def _observe_kv(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor):
    """Register the KV-cache sites (FP8 cache only) and, when calibrating,
    record max|k| (after RoPE) and max|v|. Returns the frozen scales."""
    ctx = scale_ctx.current()
    if ctx is not None and cfg.policy.kv_cache_format is not None:
        kk, vk = ctx.site_key("kv/k") + "#A", ctx.site_key("kv/v") + "#A"
        ctx.register(kk)
        ctx.register(vk)
        if ctx.mode == "calibrate":
            ctx.record(kk, k.float().abs().amax())
            ctx.record(vk, v.float().abs().amax())
    return _kv_scales(cfg)


def _prefill_cache(cache_layer, k, v, positions, *, slot=None,
                   k_scale: float = 1.0, v_scale: float = 1.0):
    """Write the prompt's K/V (B, S, Hkv, dh) into the cache, in place:
    slots 0..S-1, or, when S exceeds the capacity C, the last C tokens at
    their ring slots pos % C (the invariant `_append_cache` relies on).
    Each written row's other slots keep their old payloads and read as
    empty (slot_pos -1), as in the reference's new cache. slot: write only
    batch row `slot` (the fixed-slot engine's admission; the other rows
    stay as they were). Returns the cache."""
    rows_ = slice(None) if slot is None else slice(slot, slot + 1)
    dst = {name: x[rows_] for name, x in cache_layer.items()}
    k, v, positions = k[rows_], v[rows_], positions[rows_].to(torch.int32)
    dtype = dst["k"].dtype
    b, s = k.shape[:2]
    cap = dst["k"].shape[1]
    dst["slot_pos"].fill_(-1)
    if s <= cap:
        dst["k"][:, :s] = _to_cache_dtype(k, dtype, k_scale)
        dst["v"][:, :s] = _to_cache_dtype(v, dtype, v_scale)
        dst["slot_pos"][:, :s] = positions
    else:
        keep = positions[:, -cap:]
        ring = (keep % cap).long()
        rows = torch.arange(b, device=k.device)[:, None]
        dst["k"].zero_()
        dst["v"].zero_()
        dst["k"][rows, ring] = _to_cache_dtype(k[:, -cap:], dtype, k_scale)
        dst["v"][rows, ring] = _to_cache_dtype(v[:, -cap:], dtype, v_scale)
        dst["slot_pos"][rows, ring] = keep
    dst["length"].fill_(min(s, cap))
    return cache_layer


def _append_cache(cache_layer, k, v, positions, *, k_scale: float = 1.0,
                  v_scale: float = 1.0):
    """Write one token per row (k / v (B, 1, Hkv, dh)) at slot pos % C, in
    place. Returns the cache."""
    dtype = cache_layer["k"].dtype
    cap = cache_layer["k"].shape[1]
    pos = positions[:, -1]
    idx = (pos % cap).long()
    rows = torch.arange(k.shape[0], device=k.device)
    cache_layer["k"][rows, idx] = _to_cache_dtype(k[:, 0], dtype, k_scale)
    cache_layer["v"][rows, idx] = _to_cache_dtype(v[:, 0], dtype, v_scale)
    cache_layer["slot_pos"][rows, idx] = pos.to(torch.int32)
    cache_layer["length"].copy_(torch.clamp_max(cache_layer["length"] + 1,
                                                cap))
    return cache_layer


def _qk_scores(q, k, qcfg: QuantConfig, qgen, role=None) -> torch.Tensor:
    """q: (B,H,Q,dh) x k: (B,H,K,dh) -> (B,H,Q,K) f32 (the product in the
    output dtype, then widened). role: qeinsum's tensor-parallel role
    ("heads" on a rank's heads)."""
    if qcfg.enabled and qcfg.quantize_attention:
        s = qeinsum("bhqd,bhkd->bhqk", q, k, cfg=qcfg, classes=(ACT, ACT),
                    site="qk", generator=qgen, tp=role)
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.bfloat16).float(),
                         k.to(torch.bfloat16).float())
    return s.float()


def _pv(probs, v, qcfg: QuantConfig, qgen, role=None) -> torch.Tensor:
    if qcfg.enabled and qcfg.quantize_attention:
        return qeinsum("bhqk,bhkd->bhqd", probs.to(torch.bfloat16), v,
                       cfg=qcfg, classes=(ACT, ACT), site="pv",
                       generator=qgen, tp=role)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(torch.bfloat16).float(),
                        v.to(torch.bfloat16).float()).to(torch.bfloat16)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B,Hkv,S,dh) -> (B,Hkv*groups,S,dh) for GQA."""
    if groups == 1:
        return k
    b, hkv, s, dh = k.shape
    return k[:, :, None].expand(b, hkv, groups, s, dh).reshape(
        b, hkv * groups, s, dh)


def _sdpa(q, k, v, mask, scale: float, qcfg: QuantConfig, qgen, role=None):
    """Dense scaled-dot-product attention on (B,H,S,dh); f32 softmax."""
    s = _qk_scores(q, k, qcfg, qgen, role) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    return _pv(torch.softmax(s, dim=-1), v, qcfg, qgen, role)


def chunked_causal_attention(q, k, v, *, chunk: int, scale: float,
                             qcfg: QuantConfig, qgen, window: int = 0,
                             remat: bool = False, role=None) -> torch.Tensor:
    """Causal attention over (B,H,S,dh) in q chunks of `chunk` rows, each
    against its static causal prefix (or window band); with `remat` each
    chunk is recomputed in the backward (`models.remat.checkpointed`)."""
    s = q.shape[2]
    outs = []
    for q0 in range(0, s, chunk):
        q1 = min(q0 + chunk, s)
        k0 = 0 if not window else max(0, q0 - window + 1)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, q1, device=q.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        args = (q[:, :, q0:q1], k[:, :, k0:q1], v[:, :, k0:q1],
                mask[None, None])
        if remat:
            outs.append(checkpointed(
                lambda g, *a: _sdpa(*a, scale, qcfg, g, role), qgen, *args))
        else:
            outs.append(_sdpa(*args, scale, qcfg, qgen, role))
    return torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]


def _sdpa_cached(q, k_cache, v_cache, mask, *, k_scale, v_scale,
                 scale: float, groups: int, qcfg: QuantConfig, qgen):
    """Unfused attention of q (B,H,T,dh) over cache rows (B,C,Hkv,dh):
    dequantized to bf16, repeated over the GQA group, `_sdpa` under
    `mask` (broadcast to (B,H,T,C))."""
    kt = _from_cache_dtype(k_cache, torch.bfloat16, k_scale).transpose(1, 2)
    vt = _from_cache_dtype(v_cache, torch.bfloat16, v_scale).transpose(1, 2)
    return _sdpa(q, _repeat_kv(kt, groups), _repeat_kv(vt, groups), mask,
                 scale, qcfg, qgen)


def attention(params, x: torch.Tensor, *, cfg: ModelConfig,
              qcfg: QuantConfig, positions: torch.Tensor, mode: str = "train",
              cache_layer=None, kv_x: Optional[torch.Tensor] = None,
              window: int = 0,
              page: Optional[dict] = None,
              qgen: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """modes:
      train   — causal self-attention, no cache;
      encode  — bidirectional self-attention (the encoder), no cache;
      cross   — queries from x, keys / values from kv_x (the encoder's
                output), no mask, no RoPE, no cache;
      prefill — causal self-attention; the prompt's K/V written into the
                `init_cache` cache `cache_layer` in place (only batch row
                page["slot"] when `page` is given);
      decode  — one token per row against `cache_layer`, appended in place;
      chunk   — T tokens per request against the paged pool `cache_layer`
                (updated in place), indirection in `page`: write_slots
                (B,T), read_slots/slot_pos (B,C), chunk_pos (B,2).
    qgen: the generator SR bits come from (training), or None.
    Returns (y, cache) — None in train, encode and cross modes."""
    b, sq, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    groups = h // hkv
    scale = 1.0 / (dh ** 0.5)
    fused = fuse_attention(qcfg)
    if mode not in ("train", "encode", "cross", "prefill", "decode",
                    "chunk"):
        raise ValueError(f"attention mode {mode!r} is not ported (train, "
                         "encode, cross, prefill, decode, chunk)")
    if mode in ("prefill", "decode", "chunk") and cache_layer is None or \
            mode == "chunk" and page is None:
        raise ValueError(f"mode {mode!r} needs cache_layer"
                         + (" and page" if mode == "chunk" else ""))
    if (mode == "cross") != (kv_x is not None):
        raise ValueError("kv_x is given with mode 'cross', and only then")
    tp = tensor_parallel.current()
    if tp is not None:
        if mode != "train":
            raise ValueError(f"mode {mode!r} under tensor parallelism: the "
                             "training step alone runs on a 'model' group")
        return _attention_tp(params, x, cfg=cfg, qcfg=qcfg,
                             positions=positions, window=window, qgen=qgen,
                             tp=tp), None

    q = qeinsum("bsd,dn->bsn", x, params["wq"], cfg=qcfg, site="wq",
                generator=qgen)
    src = x if kv_x is None else kv_x
    k = qeinsum("bsd,dn->bsn", src, params["wk"], cfg=qcfg, site="wk",
                generator=qgen)
    v = qeinsum("bsd,dn->bsn", src, params["wv"], cfg=qcfg, site="wv",
                generator=qgen)
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.reshape(b, sq, h, dh)
    k = k.reshape(b, -1, hkv, dh)
    v = v.reshape(b, -1, hkv, dh)
    if mode != "cross":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    k_scale, v_scale = _observe_kv(cfg, k, v)
    qt = q.transpose(1, 2)
    kv_kw = dict(k_scale=k_scale, v_scale=v_scale)
    new_cache = None

    if mode in ("train", "encode", "cross", "prefill"):
        if fused:
            mm = "full" if mode in ("encode", "cross") else "causal"
            o = fp8_sdpa(qt, k.transpose(1, 2), v.transpose(1, 2), cfg=qcfg,
                         sm_scale=scale, mask_mode=mm, window=window,
                         site="sdpa", generator=qgen)
        else:
            kt = _repeat_kv(k.transpose(1, 2), groups)
            vt = _repeat_kv(v.transpose(1, 2), groups)
            if mode in ("encode", "cross"):
                o = _sdpa(qt, kt, vt, None, scale, qcfg, qgen)
            elif sq > cfg.attn_chunk_threshold or window:
                o = chunked_causal_attention(
                    qt, kt, vt, chunk=min(cfg.attn_chunk_size, sq),
                    scale=scale, qcfg=qcfg, qgen=qgen, window=window,
                    remat=cfg.remat and mode == "train")
            else:
                pos = torch.arange(sq, device=x.device)
                mask = (pos[:, None] >= pos[None, :])[None, None]
                o = _sdpa(qt, kt, vt, mask, scale, qcfg, qgen)
        if mode == "prefill":
            new_cache = _prefill_cache(
                cache_layer, k, v, positions, **kv_kw,
                slot=None if page is None else page["slot"])
    elif mode == "decode":
        new_cache = _append_cache(cache_layer, k, v, positions, **kv_kw)
        slot_pos = new_cache["slot_pos"]                         # (B, C)
        cur = positions[:, -1:]
        valid = (slot_pos >= 0) & (slot_pos <= cur)
        if window:
            valid &= slot_pos > cur - window
        if fused:
            o = fp8_sdpa_decode(
                qt, new_cache["k"].transpose(1, 2),
                new_cache["v"].transpose(1, 2), valid, cfg=qcfg,
                sm_scale=scale, k_cache_scale=k_scale, v_cache_scale=v_scale,
                site="sdpa", generator=qgen)
        else:
            o = _sdpa_cached(qt, new_cache["k"], new_cache["v"],
                             valid[:, None, None, :], scale=scale,
                             groups=groups, qcfg=qcfg, qgen=qgen, **kv_kw)
    else:
        pool_k, pool_v = cache_layer["k"], cache_layer["v"]
        rows = torch.arange(sq, device=x.device)[None, :]
        row_ok = rows < page["chunk_pos"][:, 1:2]                # (B, T)
        # Rows past n_valid write zeros to slot 0 (the trash page), so the
        # duplicate writes agree and their order is irrelevant.
        okm = row_ok[..., None, None]
        kq = _to_cache_dtype(torch.where(okm, k, torch.zeros_like(k)),
                             pool_k.dtype, k_scale)
        vq = _to_cache_dtype(torch.where(okm, v, torch.zeros_like(v)),
                             pool_v.dtype, v_scale)
        wslots = torch.where(row_ok, page["write_slots"],
                             torch.zeros_like(page["write_slots"])).reshape(-1)
        pool_k[wslots] = kq.reshape(b * sq, hkv, dh)
        pool_v[wslots] = vq.reshape(b * sq, hkv, dh)
        kt = pool_k[page["read_slots"]]                         # (B,C,Hkv,dh)
        vt = pool_v[page["read_slots"]]
        slot_pos = page["slot_pos"]
        new_cache = cache_layer
        if fused:
            o = fp8_sdpa_chunk(qt, kt.transpose(1, 2), vt.transpose(1, 2),
                               slot_pos, page["chunk_pos"], cfg=qcfg,
                               sm_scale=scale, window=window,
                               k_cache_scale=k_scale, v_cache_scale=v_scale,
                               site="sdpa", generator=qgen)
        else:
            qpos = torch.where(row_ok, page["chunk_pos"][:, 0:1] + rows,
                               torch.full_like(rows, -1))
            sp = slot_pos[:, None, :]
            mask = (sp >= 0) & (sp <= qpos[:, :, None])
            if window:
                mask &= sp > qpos[:, :, None] - window
            o = _sdpa_cached(qt, kt, vt, mask[:, None], scale=scale,
                             groups=groups, qcfg=qcfg, qgen=qgen, **kv_kw)
    o = o.transpose(1, 2).reshape(b, sq, h * dh)
    y = qeinsum("bsn,nd->bsd", o, params["wo"], cfg=qcfg, site="wo",
                generator=qgen)
    return y, new_cache


def _attention_tp(params, x: torch.Tensor, *, cfg: ModelConfig,
                  qcfg: QuantConfig, positions: torch.Tensor, window: int,
                  qgen, tp) -> torch.Tensor:
    """Causal training self-attention on a 'model' group of m ranks, the
    rank's weights its shards where the group's layout splits them
    (`TPGroup.dim_of`: a projection's columns, wo's rows).

    Where H and Hkv both divide m, each rank projects, attends and
    projects out its own H/m query heads and Hkv/m kv heads (the GQA
    groups stay aligned: q head j reads kv head j // (H / Hkv) on every
    rank): wq / wk / wv column-parallel, kernels 2-4 (or the unfused
    contractions, "heads") on the rank's heads, wo row-parallel. Otherwise
    a column shard is not whole heads: each sharded projection's output is
    gathered whole over the ranks, attention runs whole on every rank (the
    reference's fallback to replication) and its output is sliced to the
    rank's rows of wo."""
    b, sq, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    aligned = h % tp.size == 0 and hkv % tp.size == 0
    scale = 1.0 / (dh ** 0.5)

    def project(name: str) -> torch.Tensor:
        col = tp.dim_of(params[name]) is not None
        y = qeinsum("bsd,dn->bsn", x, params[name], cfg=qcfg, site=name,
                    generator=qgen, tp="col" if col else None)
        if cfg.qkv_bias:
            y = y + params["b" + name[1]].to(y.dtype)
        return tensor_parallel.gather(y, -1, tp) if col and not aligned \
            else y

    q, k, v = project("wq"), project("wk"), project("wv")
    hl, hkvl = (h // tp.size, hkv // tp.size) if aligned else (h, hkv)
    q = apply_rope(q.reshape(b, sq, hl, dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, sq, hkvl, dh), positions, cfg.rope_theta)
    v = v.reshape(b, sq, hkvl, dh)
    _observe_kv(cfg, k, v)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if fuse_attention(qcfg):
        o = fp8_sdpa(qt, kt, vt, cfg=qcfg, sm_scale=scale,
                     mask_mode="causal", window=window, site="sdpa",
                     generator=qgen, tp=tp if aligned else None)
    else:
        role = "heads" if aligned else None
        kt, vt = _repeat_kv(kt, hl // hkvl), _repeat_kv(vt, hl // hkvl)
        if sq > cfg.attn_chunk_threshold or window:
            o = chunked_causal_attention(
                qt, kt, vt, chunk=min(cfg.attn_chunk_size, sq), scale=scale,
                qcfg=qcfg, qgen=qgen, window=window, remat=cfg.remat,
                role=role)
        else:
            pos = torch.arange(sq, device=x.device)
            mask = (pos[:, None] >= pos[None, :])[None, None]
            o = _sdpa(qt, kt, vt, mask, scale, qcfg, qgen, role)
    o = o.transpose(1, 2).reshape(b, sq, hl * dh)
    row = tp.dim_of(params["wo"]) is not None
    if row and not aligned:
        o = tensor_parallel.scatter(o, -1, tp)
    return qeinsum("bsn,nd->bsd", o, params["wo"], cfg=qcfg, site="wo",
                   generator=qgen, tp="row" if row else None)
