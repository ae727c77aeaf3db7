"""GQA attention block with FP8 GEMMs and the fused FP8 flash kernel
(counterpart of `repro.models.attention`, modes 'train' and 'chunk').

The projections go through qeinsum. Under a kernel backend with delayed
scaling, attention goes through the fused kernel with K/V left unrepeated
(B, Hkv, S, dh) — GQA grouping happens inside the kernel. Otherwise (the
paper's recipe) training attention is the reference's unfused composition
`_sdpa`: K/V repeated over the GQA group (so each repeat gets its own SR
bits), the two 4-D contractions as qeinsum (sites qk / pv), an f32 softmax
between them; sequences past `attn_chunk_threshold` (or a window) go
through `chunked_causal_attention`'s static-prefix q chunks.

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

from repro_torch.core.precision_policy import ACT, QuantConfig
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


def _qk_scores(q, k, qcfg: QuantConfig, qgen) -> torch.Tensor:
    """q: (B,H,Q,dh) x k: (B,H,K,dh) -> (B,H,Q,K) f32 (the product in the
    output dtype, then widened)."""
    if qcfg.enabled and qcfg.quantize_attention:
        s = qeinsum("bhqd,bhkd->bhqk", q, k, cfg=qcfg, classes=(ACT, ACT),
                    site="qk", generator=qgen)
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.bfloat16).float(),
                         k.to(torch.bfloat16).float())
    return s.float()


def _pv(probs, v, qcfg: QuantConfig, qgen) -> torch.Tensor:
    if qcfg.enabled and qcfg.quantize_attention:
        return qeinsum("bhqk,bhkd->bhqd", probs.to(torch.bfloat16), v,
                       cfg=qcfg, classes=(ACT, ACT), site="pv",
                       generator=qgen)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(torch.bfloat16).float(),
                        v.to(torch.bfloat16).float()).to(torch.bfloat16)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B,Hkv,S,dh) -> (B,Hkv*groups,S,dh) for GQA."""
    if groups == 1:
        return k
    b, hkv, s, dh = k.shape
    return k[:, :, None].expand(b, hkv, groups, s, dh).reshape(
        b, hkv * groups, s, dh)


def _sdpa(q, k, v, mask, scale: float, qcfg: QuantConfig, qgen):
    """Dense scaled-dot-product attention on (B,H,S,dh); f32 softmax."""
    s = _qk_scores(q, k, qcfg, qgen) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    return _pv(torch.softmax(s, dim=-1), v, qcfg, qgen)


def chunked_causal_attention(q, k, v, *, chunk: int, scale: float,
                             qcfg: QuantConfig, qgen, window: int = 0,
                             remat: bool = False) -> torch.Tensor:
    """Causal attention over (B,H,S,dh) in q chunks of `chunk` rows, each
    against its static causal prefix (or window band). Recomputing the
    chunks in the backward (remat) is not ported."""
    if remat:
        raise NotImplementedError("activation recomputation (remat=True) is "
                                  "not ported (ROADMAP.md, queue 1)")
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
        outs.append(_sdpa(q[:, :, q0:q1], k[:, :, k0:q1], v[:, :, k0:q1],
                          mask[None, None], scale, qcfg, qgen))
    return torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]


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
    fused = fuse_attention(qcfg)
    if not fused and mode != "train":
        raise NotImplementedError(
            f"attention mode {mode!r} runs through the fused FP8 kernel "
            "only (kernel backend + delayed scaling); its unfused path is "
            "queued in ROADMAP.md")

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

    if mode == "train" and fused:
        o = fp8_sdpa(qt, k.transpose(1, 2), v.transpose(1, 2), cfg=qcfg,
                     sm_scale=scale, mask_mode="causal", window=window,
                     site="sdpa", generator=qgen)
    elif mode == "train":
        kt = _repeat_kv(k.transpose(1, 2), h // hkv)
        vt = _repeat_kv(v.transpose(1, 2), h // hkv)
        if sq > cfg.attn_chunk_threshold or window:
            o = chunked_causal_attention(
                qt, kt, vt, chunk=min(cfg.attn_chunk_size, sq), scale=scale,
                qcfg=qcfg, qgen=qgen, window=window, remat=cfg.remat)
        else:
            pos = torch.arange(sq, device=x.device)
            mask = (pos[:, None] >= pos[None, :])[None, None]
            o = _sdpa(qt, kt, vt, mask, scale, qcfg, qgen)
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
