"""Fused FP8 flash attention, forward (counterpart of the forward of
`repro.core.qattention`).

`fp8_sdpa` quantizes q/k/v at their sites and runs the fused kernel with
the score and prob Q nodes inside it (causal/full masks; calibration runs
it in 'causal'). `fp8_sdpa_chunk` is the paged serving step: T consecutive
tokens per request against a gathered KV view under the 'chunk' position
mask. Scale sites (scaling.context.attention_keys): operands {#q,#k,#v}.A,
in-kernel #qk.A / #p.A.

The backward (dP/dS kernels) belongs to the training slice of the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision_policy import ACT, QuantConfig, dtype_of
from repro_torch.core.qlinear import _observe, _quant_operand, kernel_backend
from repro_torch.core.quantize import f32
from repro_torch.scaling import context as scale_ctx

_ORDER = ("q", "k", "v", "s", "p", "do", "dp", "ds")


def fuse_attention(cfg: QuantConfig) -> bool:
    return (cfg.enabled and cfg.quantize_attention and cfg.delayed
            and cfg.fuse_attention and kernel_backend(cfg))


def _fwd_factors(s_q, s_k, s_v, s_s, s_p, sm_scale: float):
    """[f_s, s_s, f_p, f_o] in f32, evaluated in the reference's order."""
    f_s = f32(s_q) * f32(s_k) * f32(sm_scale) / f32(s_s)
    return [f_s, f32(s_s), f32(1.0) / f32(s_p), f32(s_p) * f32(s_v)]


def _kernel_kwargs(cfg: QuantConfig):
    return dict(fmt_s=cfg.format_for(ACT), fmt_p=cfg.format_for(ACT),
                rounding_s=cfg.rounding_for(ACT),
                rounding_p=cfg.rounding_for(ACT),
                saturate_s=cfg.saturate_for(ACT),
                saturate_p=cfg.saturate_for(ACT))


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
            "fuse_attention enabled")


def fp8_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             cfg: QuantConfig, sm_scale: float, mask_mode: str = "causal",
             window: int = 0, site: Optional[str] = None,
             seed: int = 0) -> torch.Tensor:
    """Fused FP8 attention over (B,H,Q,dh) queries and unrepeated
    (B,Hkv,S,dh) keys/values. Under an active ScaleContext with a site,
    operand scales come from the context and, in calibration, the q/k/v and
    in-kernel S/P amaxes are recorded."""
    from repro_torch.kernels.fp8_attention import ops as attn_ops
    ctx = scale_ctx.current()
    keys = None
    scales = {n: f32(1.0) for n in _ORDER}
    if cfg.delayed and ctx is not None and site is not None:
        keys = scale_ctx.attention_keys(ctx.site_key(site))
        for kk in keys.values():
            ctx.register(kk)
        _check_frozen_sites(ctx, keys)
        scales = {n: ctx.scale_for(keys[n]) for n in _ORDER}
    q8 = _quant_operand(q, ACT, cfg, scales["q"])
    k8 = _quant_operand(k, ACT, cfg, scales["k"])
    v8 = _quant_operand(v, ACT, cfg, scales["v"])
    o, amax_s, amax_p = attn_ops.fp8_attention_fwd(
        q8.data, k8.data, v8.data, seed,
        _fwd_factors(scales["q"], scales["k"], scales["v"], scales["s"],
                     scales["p"], sm_scale),
        mask_mode=mask_mode, window=window, **_kernel_kwargs(cfg))
    if keys is not None and ctx.mode == "calibrate":
        ctx.record(keys["q"], _observe(q8))
        ctx.record(keys["k"], _observe(k8))
        ctx.record(keys["v"], _observe(v8))
        ctx.record(keys["s"], amax_s * float(scales["s"]))
        ctx.record(keys["p"], amax_p * float(scales["p"]))
    return o.to(dtype_of(cfg.output_dtype))


def fp8_sdpa_chunk(q: torch.Tensor, k_cached: torch.Tensor,
                   v_cached: torch.Tensor, slot_pos: torch.Tensor,
                   chunk_pos: torch.Tensor, *, cfg: QuantConfig,
                   sm_scale: float, window: int = 0,
                   site: Optional[str] = None, seed: int = 0) -> torch.Tensor:
    """Serving chunk step through the fused kernel ('chunk' mask).

    q: (B,H,T,dh) — the chunk's queries. k_cached/v_cached: (B,Hkv,C,dh)
    gathered bf16 cache rows, quantized here at the #k.A/#v.A sites.
    slot_pos: (B,C) absolute position of each gathered column (-1 = hole).
    chunk_pos: (B,2) [start, n_valid]: q row r sits at start + r when
    r < n_valid and is fully masked (exact-zero output) otherwise."""
    from repro_torch.kernels.fp8_attention import ops as attn_ops
    if k_cached.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise NotImplementedError(
            "FP8 KV-cache payloads are not ported yet (ROADMAP.md, next "
            "slice); serve with a bf16 cache")
    ctx = scale_ctx.current()
    keys = None
    one = f32(1.0)
    s_q = s_k = s_v = s_s = s_p = one
    if cfg.delayed and ctx is not None and site is not None:
        keys = scale_ctx.attention_keys(ctx.site_key(site))
        for n in ("q", "k", "v", "s", "p"):
            ctx.register(keys[n])
        _check_frozen_sites(ctx, keys)
        s_q, s_k, s_v, s_s, s_p = (ctx.scale_for(keys[n])
                                   for n in ("q", "k", "v", "s", "p"))
    q8 = _quant_operand(q, ACT, cfg, s_q)
    k8 = _quant_operand(k_cached, ACT, cfg, s_k)
    v8 = _quant_operand(v_cached, ACT, cfg, s_v)
    o, amax_s, amax_p = attn_ops.fp8_attention_fwd(
        q8.data, k8.data, v8.data, seed,
        _fwd_factors(s_q, s_k, s_v, s_s, s_p, sm_scale),
        mask_mode="chunk", window=window, kv_mask=slot_pos,
        chunk_pos=chunk_pos, **_kernel_kwargs(cfg))
    if keys is not None and ctx.mode == "calibrate":
        ctx.record(keys["q"], _observe(q8))
        ctx.record(keys["s"], amax_s * float(s_s))
        ctx.record(keys["p"], amax_p * float(s_p))
    return o.to(dtype_of(cfg.output_dtype))
