"""Quantized einsum, forward: the paper's Fig. 1a dataflow in PyTorch.

Counterpart of the forward of `repro.core.qlinear.qeinsum`:

    Y = Q_A(a) . Q_W(b)   (fp8 x fp8 -> f32 accumulate)

Under a kernel backend ("pallas*" in the reference's QuantConfig) with
delayed scaling, a '...k,kn->...n' projection takes the FUSED path: the
output Q node runs in the GEMM epilogue (`_fused_gemm`, kernel
fused_quant_matmul in layout 'nn'), the GEMM writes fp8 straight from the
accumulator, and the output amax is observed in the same epilogue. A
disabled config (the 16-bit logits head) takes `_plain_einsum`.

The backward GEMMs (dgrad 'nt', wgrad 'tn') and autograd belong to the
training slice of the port.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.fp8_formats import get_format
from repro_torch.core.precision_policy import (ACT, WEIGHT, PAPER_FP8,
                                               QuantConfig, dtype_of)
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
                                  "(ROADMAP.md, training slice)")
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


def _qeinsum_fwd(classes, cfg, a, b, scales, observe: bool, generator=None):
    qa = _quant_operand(a, classes[0], cfg, scales[0], generator)
    qb = _quant_operand(b, classes[1], cfg, scales[1], generator)
    a2 = qa.data.reshape((-1, qa.data.shape[-1]))
    y8, obs_y = _fused_gemm(a2, qb.data, qa.scale, qb.scale, scales[4],
                            cfg, ACT, "nn", generator)
    y = _fused_dequant(y8, scales[4], cfg).reshape(
        qa.data.shape[:-1] + (qb.data.shape[-1],))
    obs = [_observe(qa), _observe(qb), obs_y] if observe else []
    return y, obs


def qeinsum(spec: str, a: torch.Tensor, b: torch.Tensor, *,
            cfg: QuantConfig = PAPER_FP8,
            classes: Tuple[str, str] = (ACT, WEIGHT),
            site: Optional[str] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Quantized einsum (forward). A disabled config is the 16-bit plain
    einsum; an enabled one must take the fused path. With an active
    ScaleContext and a site name, operand and output scales come from the
    context and (in calibration) the observed amaxes are recorded back;
    otherwise unit scales. SR bits, where the config asks for SR, come from
    `generator`."""
    parse_spec(spec)
    if not cfg.enabled:
        return _plain_einsum(spec, a, b, cfg)
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
        scales = [ctx.scale_for(keys[n]) for n in ("a", "b", "E", "G")] + [
            ctx.scale_for(fkeys["y"]), ctx.scale_for(fkeys.get("err", ""))]
    observe = keys is not None and ctx.mode == "calibrate"
    y, obs = _qeinsum_fwd(classes, cfg, a, b, scales, observe, generator)
    if observe:
        ctx.record(keys["a"], obs[0])
        ctx.record(keys["b"], obs[1])
        ctx.record(fkeys["y"], obs[2])
    return y
