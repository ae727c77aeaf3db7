"""GQA attention block with FP8 GEMMs and the fused FP8 flash kernel
(counterpart of `repro.models.attention`, modes 'train' and 'chunk').

The projections go through qeinsum (fused quantize-in-epilogue GEMMs);
attention goes through the fused kernel with K/V left unrepeated
(B, Hkv, S, dh) — GQA grouping happens inside the kernel.

Paged serving ('chunk'): the layer's KV pool is a flat slot array
(`init_paged_pool`). The chunk's K/V are written to their slots first —
IN PLACE, unlike the reference's functional update, to keep one pool per
layer in device memory — then the block-table-ordered view is gathered
and attended under the position mask, so in-chunk causality comes from
`slot_pos <= qpos` with no separate causal mask.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.precision_policy import QuantConfig
from repro_torch.core.qattention import fp8_sdpa, fp8_sdpa_chunk, fuse_attention
from repro_torch.core.qlinear import qeinsum
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init


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


def init_paged_pool(cfg: ModelConfig, n_slots: int, *, device):
    """One layer's flat KV pool of `n_slots` token slots (bf16). Slot 0 is
    on the allocator's reserved trash page."""
    if cfg.policy.kv_cache_format is not None:
        raise NotImplementedError(
            "the FP8 KV cache is not ported yet (ROADMAP.md, slice 3)")
    shape = (n_slots, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def attention(params, x: torch.Tensor, *, cfg: ModelConfig,
              qcfg: QuantConfig, positions: torch.Tensor, mode: str = "train",
              cache_layer=None, window: int = 0,
              page: Optional[dict] = None,
              qgen: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """modes: train (causal self-attention, no cache) and chunk (T tokens
    per request against the paged pool `cache_layer`, indirection in
    `page`: write_slots (B,T), read_slots/slot_pos (B,C), chunk_pos (B,2)).
    qgen: the generator SR bits come from (training), or None.
    Returns (y, cache_layer) — the pool is updated in place in chunk mode."""
    b, sq, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    scale = 1.0 / (dh ** 0.5)
    if not fuse_attention(qcfg):
        raise NotImplementedError(
            "the port runs attention through the fused FP8 kernel only "
            "(kernel backend + delayed scaling); the unfused path is queued "
            "in ROADMAP.md")

    q = qeinsum("bsd,dn->bsn", x, params["wq"], cfg=qcfg, site="wq",
                generator=qgen)
    k = qeinsum("bsd,dn->bsn", x, params["wk"], cfg=qcfg, site="wk",
                generator=qgen)
    v = qeinsum("bsd,dn->bsn", x, params["wv"], cfg=qcfg, site="wv",
                generator=qgen)
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = apply_rope(q.reshape(b, sq, h, dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, sq, hkv, dh), positions, cfg.rope_theta)
    v = v.reshape(b, sq, hkv, dh)
    qt = q.transpose(1, 2)

    if mode == "train":
        o = fp8_sdpa(qt, k.transpose(1, 2), v.transpose(1, 2), cfg=qcfg,
                     sm_scale=scale, mask_mode="causal", window=window,
                     site="sdpa", generator=qgen)
    elif mode == "chunk":
        if cache_layer is None or page is None:
            raise ValueError("chunk mode needs cache_layer and page")
        pool_k, pool_v = cache_layer["k"], cache_layer["v"]
        rows = torch.arange(sq, device=x.device)[None, :]
        row_ok = rows < page["chunk_pos"][:, 1:2]                # (B, T)
        # Rows past n_valid write zeros to slot 0 (the trash page), so the
        # duplicate writes agree and their order is irrelevant.
        okm = row_ok[..., None, None]
        kq = torch.where(okm, k, torch.zeros_like(k)).to(pool_k.dtype)
        vq = torch.where(okm, v, torch.zeros_like(v)).to(pool_v.dtype)
        wslots = torch.where(row_ok, page["write_slots"],
                             torch.zeros_like(page["write_slots"])).reshape(-1)
        pool_k[wslots] = kq.reshape(b * sq, hkv, dh)
        pool_v[wslots] = vq.reshape(b * sq, hkv, dh)
        kt = pool_k[page["read_slots"]].transpose(1, 2)         # (B,Hkv,C,dh)
        vt = pool_v[page["read_slots"]].transpose(1, 2)
        o = fp8_sdpa_chunk(qt, kt, vt, page["slot_pos"], page["chunk_pos"],
                           cfg=qcfg, sm_scale=scale, window=window,
                           site="sdpa", generator=qgen)
    else:
        raise ValueError(f"attention mode {mode!r} is not ported "
                         "(train, chunk)")
    o = o.transpose(1, 2).reshape(b, sq, h * dh)
    y = qeinsum("bsn,nd->bsd", o, params["wo"], cfg=qcfg, site="wo",
                generator=qgen)
    return y, cache_layer
