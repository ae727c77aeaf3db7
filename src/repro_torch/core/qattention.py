"""Fused FP8 flash attention (counterpart of `repro.core.qattention`).

`fp8_sdpa` quantizes q/k/v at their sites and runs the fused kernel with
the score and prob Q nodes inside it (causal/full masks), as an autograd
Function: the fp8 payloads q8 / k8 / v8 and the SR seed are its backward
residuals, and the backward quantizes dO at #E and runs the two backward
kernels (dQ, then dK/dV) with the dP / dS Q nodes inside them.
`fp8_sdpa_chunk` is the paged serving step: T consecutive tokens per
request against a gathered KV view under the 'chunk' position mask;
`fp8_sdpa_decode` the fixed-slot engine's decode step, one query row per
request against its cache under the 'kv' validity mask. Both take FP8
cache payloads as they are, with their frozen cache scales.
Scale sites (scaling.context.attention_keys): operands {#q,#k,#v}.A,
in-kernel #qk.A / #p.A, and the error sites #E (dO), #dp.E, #ds.E.

The in-kernel SR seed is a uint32 drawn per call from the caller's
generator (on its device, so it never reaches the host); a config without
SR needs no generator and uses seed 0.

Under `track_health` (delayed scaling) `fp8_sdpa` runs the count variants
of the forward and the dQ kernel and records health pairs beside the
amaxes: q / k / v from their payload bits and S / P from the forward's
counts; dO from its payload, dP / dS from the dQ kernel's counts.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fp8_formats import FP8_DTYPES
from repro_torch.core.precision_policy import (ACT, ERROR, QuantConfig,
                                               dtype_of)
from repro_torch.core.qlinear import (_health, _observe, _quant_operand,
                                      _record_health, _track,
                                      kernel_backend)
from repro_torch.core.quantize import f32
from repro_torch.obs.counters import counts_to_frac
from repro_torch.scaling import context as scale_ctx

_ORDER = ("q", "k", "v", "s", "p", "do", "dp", "ds")


def fuse_attention(cfg: QuantConfig) -> bool:
    return (cfg.enabled and cfg.quantize_attention and cfg.delayed
            and cfg.fuse_attention and kernel_backend(cfg))


def _fwd_factors(s_q, s_k, s_v, s_s, s_p, sm_scale: float):
    """[f_s, s_s, f_p, f_o] in f32, evaluated in the reference's order."""
    f_s = f32(s_q) * f32(s_k) * f32(sm_scale) / f32(s_s)
    return [f_s, f32(s_s), f32(1.0) / f32(s_p), f32(s_p) * f32(s_v)]


def _bwd_factors(s, sm_scale: float):
    """[f_s, s_s, f_p, s_p, f_dp, s_dp, f_ds, f_dq, f_dk, f_dv] in f32 from
    the site scales {q, k, v, s, p, do, dp, ds}, in the reference's order
    of operations (`repro.core.qattention._bwd_factors`)."""
    q, k, v, ss, p, do, dp, ds = (f32(s[n]) for n in _ORDER)
    sm = f32(sm_scale)
    return [q * k * sm / ss, ss, f32(1.0) / p, p, do * v / dp, dp, sm / ds,
            ds * k, ds * q, p * do]


def _seed(cfg: QuantConfig, generator):
    """The per-call SR hash seed: a uint32 drawn from `generator` on its
    device, or 0 when the config rounds nothing stochastically."""
    if not cfg.needs_key:
        return 0
    if generator is None:
        raise ValueError("QuantConfig uses stochastic rounding; fp8_sdpa "
                         "needs a torch.Generator")
    return torch.randint(0, 1 << 32, (1,), dtype=torch.int64,
                         device=generator.device, generator=generator)


def _kernel_kwargs(cfg: QuantConfig):
    return dict(fmt_s=cfg.format_for(ACT), fmt_p=cfg.format_for(ACT),
                rounding_s=cfg.rounding_for(ACT),
                rounding_p=cfg.rounding_for(ACT),
                saturate_s=cfg.saturate_for(ACT),
                saturate_p=cfg.saturate_for(ACT))


def _heads_kw(heads):
    """The kernels' `heads` argument on a tensor-parallel rank's heads,
    and none otherwise (the wrappers' call as it is without TP)."""
    return {} if heads is None else {"heads": heads}


def _check_frozen_sites(ctx, keys):
    """Frozen serving refuses silent unit scales for the in-kernel sites."""
    if ctx.mode != "frozen":
        return
    missing = [keys[n] for n in ("q", "k", "v", "s", "p")
               if not ctx.has_scale(keys[n])]
    if missing:
        raise ValueError(
            f"frozen serving through the fused FP8 attention kernel, but "
            f"site(s) {missing} have no calibrated scale — the in-kernel "
            "S/P Q nodes would use silent unit scales; recalibrate with "
            "fuse_attention enabled or serve with "
            "QuantConfig(fuse_attention=False)")


class _FP8SDPA(torch.autograd.Function):
    """Custom gradient of the fused attention (the reference's
    `_fp8_sdpa_fwd` / `_fp8_sdpa_bwd`). `meta`: (cfg, sm_scale,
    mask_mode, window, scales, sctx, keys, generator)."""

    @staticmethod
    def forward(ctx, q, k, v, meta):
        from repro_torch.kernels.fp8_attention import ops as attn_ops
        (cfg, sm_scale, mask_mode, window, scales, sctx, keys, gen, heads,
         tp) = meta
        hd = 1 if tp is not None else None
        q8 = _quant_operand(q, ACT, cfg, scales["q"], gen, hd, tp)
        k8 = _quant_operand(k, ACT, cfg, scales["k"], gen, hd, tp)
        v8 = _quant_operand(v, ACT, cfg, scales["v"], gen, hd, tp)
        seed = _seed(cfg, gen)
        track = _track(cfg)
        o, amax_s, amax_p, *counts = attn_ops.fp8_attention_fwd(
            q8.data, k8.data, v8.data, seed,
            _fwd_factors(scales["q"], scales["k"], scales["v"], scales["s"],
                         scales["p"], sm_scale),
            mask_mode=mask_mode, window=window, with_counts=track,
            **_heads_kw(heads), **_kernel_kwargs(cfg))
        if keys is not None and sctx.mode in ("collect", "calibrate"):
            sctx.record(keys["q"], _observe(q8))
            sctx.record(keys["k"], _observe(k8))
            sctx.record(keys["v"], _observe(v8))
            sctx.record(keys["s"], amax_s * float(scales["s"]))
            sctx.record(keys["p"], amax_p * float(scales["p"]))
            if track:
                hs, hp = counts_to_frac(counts[0])
                sh = tp is not None
                for n, x in (("q", q8), ("k", k8), ("v", v8)):
                    _record_health(sctx, keys[n], _health(x, cfg, ACT), sh)
                _record_health(sctx, keys["s"], hs, sh)
                _record_health(sctx, keys["p"], hp, sh)
        ctx.save_for_backward(q8.data, k8.data, v8.data)
        ctx.meta = meta
        ctx.seed = seed
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        return o.to(dtype_of(cfg.output_dtype))

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.kernels.fp8_attention import ops as attn_ops
        q8, k8, v8 = ctx.saved_tensors
        (cfg, sm_scale, mask_mode, window, scales, sctx, keys, gen, heads,
         tp) = ctx.meta
        qdo = _quant_operand(dy, ERROR, cfg, scales["do"], gen,
                             1 if tp is not None else None, tp)
        track = _track(cfg)
        dq, dk, dv, amax_dp, amax_ds, *counts = attn_ops.fp8_attention_bwd(
            q8, k8, v8, qdo.data, ctx.seed, _bwd_factors(scales, sm_scale),
            mask_mode=mask_mode, window=window, fmt_e=cfg.format_for(ERROR),
            rounding_e=cfg.rounding_for(ERROR),
            saturate_e=cfg.saturate_for(ERROR), with_counts=track,
            **_heads_kw(heads), **_kernel_kwargs(cfg))
        if keys is not None and sctx.mode == "collect":
            sctx.record_bwd(keys["do"], _observe(qdo))
            sctx.record_bwd(keys["dp"], amax_dp * float(scales["dp"]))
            sctx.record_bwd(keys["ds"], amax_ds * float(scales["ds"]))
            if track:
                hdp, hds = counts_to_frac(counts[0])
                sh = tp is not None
                _record_health(sctx, keys["do"], _health(qdo, cfg, ERROR),
                               sh, bwd=True)
                _record_health(sctx, keys["dp"], hdp, sh, bwd=True)
                _record_health(sctx, keys["ds"], hds, sh, bwd=True)
        qd, kd, vd = ctx.dtypes
        return dq.to(qd), dk.to(kd), dv.to(vd), None


def fp8_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             cfg: QuantConfig, sm_scale: float, mask_mode: str = "causal",
             window: int = 0, site: Optional[str] = None,
             generator: Optional[torch.Generator] = None,
             tp=None) -> torch.Tensor:
    """Fused FP8 attention over (B,H,Q,dh) queries and unrepeated
    (B,Hkv,S,dh) keys/values, differentiable (mask_mode 'causal' or
    'full' for the backward). Under an active ScaleContext with a site,
    operand scales come from the context, the q/k/v and in-kernel S/P
    amaxes are recorded, and the backward records #E / #dp.E / #ds.E.
    SR bits (q/k/v, the per-call kernel seed, dO) come from `generator`.
    tp: the 'model' group (`distributed.tensor_parallel.TPGroup`) when q,
    k, v hold this rank's heads, chunk r of m of the whole tensor's: the
    operands' SR bits are their slices of the whole tensors', the
    kernels' in-kernel SR hash reads the heads' whole-tensor indices, and
    the health pairs are marked as read from a shard."""
    ctx = scale_ctx.current()
    keys = None
    scales = {n: f32(1.0) for n in _ORDER}
    if cfg.delayed and ctx is not None and site is not None:
        skey = ctx.site_key(site)
        keys = scale_ctx.attention_keys(skey)
        for kk in keys.values():
            ctx.register(kk)
        ctx.register_token_site(skey)
        _check_frozen_sites(ctx, keys)
        scales = {n: ctx.scale_for(keys[n]) for n in _ORDER}
    if generator is None and cfg.needs_key:
        raise ValueError("QuantConfig uses stochastic rounding; fp8_sdpa "
                         "needs a torch.Generator")
    heads = None if tp is None else (q.shape[1] * tp.size,
                                     q.shape[1] * tp.rank)
    meta = (cfg, sm_scale, mask_mode, window, scales, ctx, keys, generator,
            heads, tp)
    return _FP8SDPA.apply(q, k, v, meta)


def _serve_fwd(q, k_cached, v_cached, *, cfg: QuantConfig, sm_scale: float,
               k_cache_scale, v_cache_scale, site, generator, **mask):
    """The serving forward through kernel 2 (the reference's shared body of
    `fp8_sdpa_decode` / `fp8_sdpa_chunk`): q quantized at #q.A; FP8 cache
    payloads passed to the kernel as they are, with their frozen cache
    scales (no dequantize -> requantize round trip; q and the cache may
    hold different formats); a 16-bit cache quantized at #k.A / #v.A.
    `mask`: the kernel's mask arguments."""
    from repro_torch.kernels.fp8_attention import ops as attn_ops
    ctx = scale_ctx.current()
    keys = None
    one = f32(1.0)
    s_q = s_s = s_p = one
    if cfg.delayed and ctx is not None and site is not None:
        keys = scale_ctx.attention_keys(ctx.site_key(site))
        for n in ("q", "k", "v", "s", "p"):
            ctx.register(keys[n])
        _check_frozen_sites(ctx, keys)
        s_q, s_s, s_p = (ctx.scale_for(keys[n]) for n in ("q", "s", "p"))
    q8 = _quant_operand(q, ACT, cfg, s_q, generator)
    if k_cached.dtype in FP8_DTYPES:
        k8, v8 = k_cached, v_cached
        s_k, s_v = f32(k_cache_scale), f32(v_cache_scale)
    else:
        s_k = ctx.scale_for(keys["k"]) if keys is not None else one
        s_v = ctx.scale_for(keys["v"]) if keys is not None else one
        k8 = _quant_operand(k_cached, ACT, cfg, s_k, generator).data
        v8 = _quant_operand(v_cached, ACT, cfg, s_v, generator).data
    o, amax_s, amax_p = attn_ops.fp8_attention_fwd(
        q8.data, k8, v8, _seed(cfg, generator),
        _fwd_factors(s_q, s_k, s_v, s_s, s_p, sm_scale),
        **mask, **_kernel_kwargs(cfg))
    if keys is not None and ctx.mode == "calibrate":
        ctx.record(keys["q"], _observe(q8))
        ctx.record(keys["s"], amax_s * float(s_s))
        ctx.record(keys["p"], amax_p * float(s_p))
    return o.to(dtype_of(cfg.output_dtype))


def fp8_sdpa_decode(q: torch.Tensor, k_cached: torch.Tensor,
                    v_cached: torch.Tensor, valid: torch.Tensor, *,
                    cfg: QuantConfig, sm_scale: float,
                    k_cache_scale=1.0, v_cache_scale=1.0,
                    site: Optional[str] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Serving decode through the fused kernel ('kv' mask).

    q: (B,H,1,dh). k_cached/v_cached: (B,Hkv,C,dh) cache rows — FP8
    payloads with their frozen cache scales (k_cache_scale/v_cache_scale,
    the '.../kv/{k,v}#A' constants), or a bf16 cache quantized here at the
    #k.A/#v.A sites. valid: (B, C) slot validity."""
    return _serve_fwd(q, k_cached, v_cached, cfg=cfg, sm_scale=sm_scale,
                      k_cache_scale=k_cache_scale,
                      v_cache_scale=v_cache_scale, site=site,
                      generator=generator, mask_mode="kv",
                      kv_mask=valid)


def fp8_sdpa_chunk(q: torch.Tensor, k_cached: torch.Tensor,
                   v_cached: torch.Tensor, slot_pos: torch.Tensor,
                   chunk_pos: torch.Tensor, *, cfg: QuantConfig,
                   sm_scale: float, window: int = 0,
                   k_cache_scale=1.0, v_cache_scale=1.0,
                   site: Optional[str] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Serving chunk step through the fused kernel ('chunk' mask).

    q: (B,H,T,dh) — the chunk's queries. k_cached/v_cached: (B,Hkv,C,dh)
    gathered cache rows, FP8 payloads or bf16, as in `fp8_sdpa_decode`.
    slot_pos: (B,C) absolute position of each gathered column (-1 = hole).
    chunk_pos: (B,2) [start, n_valid]: q row r sits at start + r when
    r < n_valid and is fully masked (exact-zero output) otherwise."""
    return _serve_fwd(q, k_cached, v_cached, cfg=cfg, sm_scale=sm_scale,
                      k_cache_scale=k_cache_scale,
                      v_cache_scale=v_cache_scale, site=site,
                      generator=generator, mask_mode="chunk", window=window,
                      kv_mask=slot_pos, chunk_pos=chunk_pos)
