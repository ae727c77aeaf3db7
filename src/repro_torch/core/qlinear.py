"""Quantized einsum: the paper's Fig. 1a dataflow in PyTorch.

Counterpart of `repro.core.qlinear.qeinsum` on its fused path:

    forward:  Y  = Q_A(Q_A(a) . Q_W(b))        GEMM 'nn', Q node in epilogue
    backward: dA = Q_E(Q_E(dY) . Q_W(b)^T)     GEMM 'nt' (site #da.E)
              dW = Q_G(Q_A(a)^T . Q_E(dY))     GEMM 'tn' (site #G)

Under a kernel backend ("pallas*" in the reference's QuantConfig) with
delayed scaling, a '...k,kn->...n' projection with a weight operand runs
all three GEMMs through the fused quantize-in-epilogue kernel
(`kernels.fused_quant_matmul`): each writes fp8 straight from its f32
accumulator and observes its output amax in the same epilogue. The fp8
payloads qa / qb and their host scales are what the autograd Function
saves for the backward — not the bf16 activations. A disabled config (the
16-bit logits head) takes `_plain_einsum` through ordinary autograd.

Stochastic rounding draws its bits from the `generator` the caller passes
(the training step's), never from torch's global generator; a config
that asks for SR raises without one.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.fp8_formats import get_format
from repro_torch.core.precision_policy import (ACT, ERROR, GRAD, WEIGHT,
                                               PAPER_FP8, QuantConfig,
                                               dtype_of)
from repro_torch.core.quantize import QTensor, fp8_amax_bits, f32
from repro_torch.core.quantize import quantize as _quantize
from repro_torch.scaling import context as scale_ctx

N_SCALES = 6   # [a, b, E, G, Y, dA_err], the reference's scale layout


@functools.lru_cache(maxsize=None)
def parse_spec(spec: str) -> Tuple[str, str, str]:
    spec = spec.replace(" ", "")
    lhs, out = spec.split("->")
    a, b = lhs.split(",")
    if "." in spec:
        raise ValueError(f"qeinsum does not support ellipsis specs: {spec!r}")
    return a, b, out


def kernel_backend(cfg: QuantConfig) -> bool:
    """The reference's Pallas backends select the kernels; in the port they
    select the CUDA kernels (plain versions on CPU tensors)."""
    return cfg.backend.startswith("pallas")


def _quant_operand(x: torch.Tensor, cls: str, cfg: QuantConfig,
                   scale=None, generator: Optional[torch.Generator] = None
                   ) -> QTensor:
    """Quantize one operand: the history-derived per-site scale under
    delayed scaling (reciprocal multiply), the unit scale otherwise."""
    fmt = get_format(cfg.format_for(cls))
    if cfg.scaling == "jit_amax":
        raise NotImplementedError("jit_amax scaling is not ported yet "
                                  "(ROADMAP.md, queue 1)")
    if cfg.delayed:
        scale = f32(1.0) if scale is None else scale
    else:
        scale = None
    return _quantize(x, fmt, rounding=cfg.rounding_for(cls),
                     generator=generator, scale=scale,
                     saturate=cfg.saturate_for(cls))


def _pallas_matmul_spec(spec: str) -> bool:
    a, b, o = parse_spec(spec)
    return (len(b) == 2 and a[-1] == b[0] and o == a[:-1] + b[1]
            and b[1] not in a and b[0] not in o)


def _fused_epilogue(spec: str, classes: Tuple[str, str],
                    cfg: QuantConfig) -> bool:
    return (cfg.enabled and cfg.delayed and cfg.fuse_epilogue
            and kernel_backend(cfg) and WEIGHT in classes
            and _pallas_matmul_spec(spec))


def _fused_gemm(x8, w8, sx, sw, s_out, cfg: QuantConfig, out_cls: str,
                dims: str, generator=None):
    """One fused output-quantizing GEMM: out8 = Q((x8.w8) / (s_out/(sx*sw)))
    plus the output amax in real units (grid amax * s_out)."""
    from repro_torch.kernels.fused_quant_matmul import ops as fq_ops
    kscale = f32(s_out) / (f32(sx) * f32(sw))
    out8, amax_grid = fq_ops.fused_quant_matmul(
        x8, w8, kscale, dims=dims, out_format=cfg.format_for(out_cls),
        rounding=cfg.rounding_for(out_cls),
        saturate=cfg.saturate_for(out_cls), generator=generator,
        with_amax=True)
    return out8, amax_grid * float(f32(s_out))


def _fused_dequant(out8: torch.Tensor, s_out, cfg: QuantConfig) -> torch.Tensor:
    return (out8.float() * float(f32(s_out))).to(dtype_of(cfg.output_dtype))


def _plain_einsum(spec: str, a, b, cfg: QuantConfig) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    y = torch.einsum(spec, a.to(cd).float(), b.to(cd).float())
    return y.to(dtype_of(cfg.output_dtype))


def _observe(q: QTensor) -> torch.Tensor:
    """Observed amax of a quantized operand from its payload's bits."""
    return fp8_amax_bits(q.data) * float(q.scale)


class _QEinsum(torch.autograd.Function):
    """The fused-path custom gradient (`_qeinsum_fwd` / `_qeinsum_bwd_fused`
    of the reference). Non-tensor arguments ride in `meta`: (cfg, classes,
    scales, sctx, keys, fkeys, generator)."""

    @staticmethod
    def forward(ctx, a, b, meta):
        cfg, classes, scales, sctx, keys, fkeys, gen = meta
        qa = _quant_operand(a, classes[0], cfg, scales[0], gen)
        qb = _quant_operand(b, classes[1], cfg, scales[1], gen)
        a2 = qa.data.reshape((-1, qa.data.shape[-1]))
        y8, obs_y = _fused_gemm(a2, qb.data, qa.scale, qb.scale, scales[4],
                                cfg, ACT, "nn", gen)
        y = _fused_dequant(y8, scales[4], cfg).reshape(
            qa.data.shape[:-1] + (qb.data.shape[-1],))
        if keys is not None and sctx.mode in ("collect", "calibrate"):
            sctx.record(keys["a"], _observe(qa))
            sctx.record(keys["b"], _observe(qb))
            sctx.record(fkeys["y"], obs_y)
        ctx.save_for_backward(qa.data, qb.data)
        ctx.meta = meta
        ctx.qscales = (qa.scale, qb.scale)
        ctx.dtypes = (a.dtype, b.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        qa_data, qb_data = ctx.saved_tensors
        cfg, classes, scales, sctx, keys, fkeys, gen = ctx.meta
        sa, sb = ctx.qscales
        qdy = _quant_operand(dy, ERROR, cfg, scales[2], gen)
        dy2 = qdy.data.reshape((-1, qdy.data.shape[-1]))
        a2 = qa_data.reshape((-1, qa_data.shape[-1]))
        # The weight operand's gradient is FP8-stored (class G, site #G);
        # the activation operand receives the error-class dgrad (#da.E).
        cls_a = GRAD if classes[0] == WEIGHT else ERROR
        cls_b = GRAD if classes[1] == WEIGHT else ERROR
        s_da = scales[3] if cls_a == GRAD else scales[5]
        s_db = scales[3] if cls_b == GRAD else scales[5]
        # dA = Q(dY . W^T): (M, N) x (K, N) -> (M, K)
        da8, obs_da = _fused_gemm(dy2, qb_data, qdy.scale, sb, s_da, cfg,
                                  cls_a, "nt", gen)
        da = _fused_dequant(da8, s_da, cfg).reshape(qa_data.shape)
        # dW = Q(A^T . dY): (M, K) x (M, N) -> (K, N)
        db8, obs_db = _fused_gemm(a2, dy2, sa, qdy.scale, s_db, cfg, cls_b,
                                  "tn", gen)
        db = _fused_dequant(db8, s_db, cfg).reshape(qb_data.shape)
        if keys is not None and sctx.mode == "collect":
            zero = torch.zeros((), device=dy.device)
            obs_g, obs_err = zero, zero
            if cls_a == GRAD:
                obs_g = torch.maximum(obs_g, obs_da)
            else:
                obs_err = obs_da
            if cls_b == GRAD:
                obs_g = torch.maximum(obs_g, obs_db)
            else:
                obs_err = obs_db
            sctx.record_bwd(keys["E"], _observe(qdy))
            sctx.record_bwd(keys["G"], obs_g)
            if "err" in fkeys:
                sctx.record_bwd(fkeys["err"], obs_err)
        return da.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None


def qeinsum(spec: str, a: torch.Tensor, b: torch.Tensor, *,
            cfg: QuantConfig = PAPER_FP8,
            classes: Tuple[str, str] = (ACT, WEIGHT),
            site: Optional[str] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Quantized einsum with its custom gradient. A disabled config is the
    16-bit plain einsum; an enabled one must take the fused path. With an
    active ScaleContext and a site name, operand and output scales come
    from the context, forward amaxes are recorded (collect / calibrate) and
    the backward records the E / G / #da.E observations (collect). SR bits
    come from `generator`."""
    parse_spec(spec)
    if not cfg.enabled:
        return _plain_einsum(spec, a, b, cfg)
    if generator is None and cfg.needs_key:
        raise ValueError(f"QuantConfig uses stochastic rounding; qeinsum("
                         f"{spec!r}) needs a torch.Generator")
    classes = tuple(classes)
    if not _fused_epilogue(spec, classes, cfg):
        raise NotImplementedError(
            "the port runs the fused quantize-in-epilogue qeinsum only (a "
            "kernel backend, delayed scaling, a '...k,kn->...n' projection "
            "with a weight operand); the unfused path is queued in "
            "ROADMAP.md")
    ctx = scale_ctx.current()
    scales = [f32(1.0)] * N_SCALES
    keys = fkeys = None
    if ctx is not None and site is not None:
        skey = ctx.site_key(site)
        keys = scale_ctx.operand_keys(skey, classes)
        fkeys = scale_ctx.fused_output_keys(skey, classes)
        for key in (*keys.values(), *fkeys.values()):
            ctx.register(key)
        ctx.register_token_site(skey)
        scales = [ctx.scale_for(keys[n]) for n in ("a", "b", "E", "G")] + [
            ctx.scale_for(fkeys["y"]), ctx.scale_for(fkeys.get("err", ""))]
    meta = (cfg, classes, scales, ctx, keys, fkeys, generator)
    return _QEinsum.apply(a, b, meta)
