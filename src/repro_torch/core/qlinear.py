"""Quantized einsum: the paper's Fig. 1a dataflow in PyTorch.

Counterpart of `repro.core.qlinear.qeinsum`. Its fused path:

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

Every other enabled call takes the unfused path (`_qeinsum_fwd`'s unfused
branch and `_qeinsum_bwd` of the reference), any backend: the paper's own
recipe (scaling "none", unit scales); just-in-time amax scaling
("jit_amax": each class `QuantConfig.amax_for` selects quantizes at its
tensor's own amax scale, a 0-d device tensor that the GEMM's output scale
and the dequantize multiply by on the device); and delayed scaling off the
fused path (`fuse_epilogue=False`, an "xla" backend, the attention's 4-D
contractions), where, with a context and a site, the operands quantize at
their sites' scales (#a / #b, and #E / #G in the backward), the forward
records the payloads' amaxes, and the backward records the E / G amaxes
through `record_bwd` — summed over uses, read times 1/uses, as the
reference's token cotangent is. Its GEMMs return the f32 accumulator,
times the operand scales, cast to the output dtype:

    forward:  Y  = Q_A(a) . Q_W(b)              '...k,kn->...n' under a
                                                kernel backend: the fp8
                                                GEMM kernel (kernels.
                                                fp8_matmul); else plain
    backward: dA = Q_E(dY) . Q_W(b)^T           plain (adjoint spec)
              dW = Q_G(Q_A(a)^T . Q_E(dY))      plain, then fake-quant G

The adjoint specs are never '...k,kn->...n'-shaped, so the reference
computes them in XLA (bf16 operands, `preferred_element_type=f32`), as do
the 4-D attention contractions. Here they are f32 products of the f32
upcast fp8 payloads: each fp8 product is exact in f32, so that is the
reference's f32 accumulation — provided TF32 is off for f32 matmuls on the
card (`torch.backends.cuda.matmul.allow_tf32`, off by default).

Stochastic rounding draws its bits from the `generator` the caller passes
(the training step's), never from torch's global generator; a config
that asks for SR raises without one.

Under `track_health` (delayed scaling only, `_track`) the fused path also
records precision-health pairs beside its amaxes: the operands' from their
payload bits (`obs.counters.payload_health`), each GEMM output's from
kernel 1's count epilogue (`with_counts=True`) — forward at #a / #b / #y,
backward at #E, #G and #da.E.

Inside a data-parallel "full" step (`distributed.global_batch.current()`
active, and the weight operand a parameter of the step) the weight
gradient's Q node quantizes the sum over the ranks, as the reference's one
program over the global batch does: the backward takes the f32 product
(the fused path's wgrad on kernel 5, `fp8_matmul`, with A's payload
transposed contiguous, in place of kernel 1's tn epilogue), sums it in f32
over the group, and quantizes the sum at the site's #G scale through
`_fake_quant_grad` (the unfused path's own Q node; the unfused path casts
the sum to the output dtype first, as its product is):

    dW = Q_G(sum over ranks of Q_A(a)^T . Q_E(dY))
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
from repro_torch.core.quantize import random_bits
from repro_torch.core.quantize import dequantize as _dequantize
from repro_torch.core.quantize import quantize as _quantize
from repro_torch.distributed import comm
from repro_torch.distributed import global_batch
from repro_torch.distributed import tensor_parallel
from repro_torch.obs.counters import payload_health
from repro_torch.scaling import context as scale_ctx

N_SCALES = 6   # [a, b, E, G, Y, dA_err], the reference's scale layout

# Tensor-parallel roles of a site (`qeinsum(tp=)`): the dim each tensor of
# the site is split along over 'model', by role (absent: replicated).
# "col": a column-parallel projection ('...k,kn->...n', W's columns);
# "row": a row-parallel one (W's rows, a's last dim); "heads": a 4-D
# attention contraction on the rank's heads.
_A_DIM = {"row": -1, "heads": 1}
_B_DIM = {"col": -1, "row": 0, "heads": 1}
_Y_DIM = {"col": -1, "heads": 1}
# The dim of the input gradient dA: "col"'s is a partial over W's column
# shards, summed before its Q node, and whole; "row"'s is a's shard.
_DA_DIM = {"row": -1, "heads": 1}


@functools.lru_cache(maxsize=None)
def parse_spec(spec: str) -> Tuple[str, str, str]:
    spec = spec.replace(" ", "")
    lhs, out = spec.split("->")
    a, b = lhs.split(",")
    if "." in spec:
        raise ValueError(f"qeinsum does not support ellipsis specs: {spec!r}")
    return a, b, out


@functools.lru_cache(maxsize=None)
def adjoint_specs(spec: str) -> Tuple[str, str]:
    """The einsum specs of dA and dB for Y = einsum('A,B->O', a, b):
    'O,B->A' and 'A,O->B' (every index of an operand must appear in the
    output or the other operand)."""
    a, b, o = parse_spec(spec)
    for idx in a:
        if idx not in o and idx not in b:
            raise ValueError(f"index {idx!r} of lhs is summed-only in {spec!r}")
    for idx in b:
        if idx not in o and idx not in a:
            raise ValueError(f"index {idx!r} of rhs is summed-only in {spec!r}")
    return f"{o},{b}->{a}", f"{a},{o}->{b}"


def kernel_backend(cfg: QuantConfig) -> bool:
    """The reference's Pallas backends select the kernels; in the port they
    select the CUDA kernels (plain versions on CPU tensors)."""
    return cfg.backend.startswith("pallas")


def _quant_operand(x: torch.Tensor, cls: str, cfg: QuantConfig,
                   scale=None, generator: Optional[torch.Generator] = None,
                   dim: Optional[int] = None, tp=None) -> QTensor:
    """Quantize one operand: the history-derived per-site scale under
    delayed scaling (reciprocal multiply); otherwise the tensor's own amax
    scale for a class `amax_for` selects, else the unit scale. `x` this
    rank's shard along `dim` of a tensor split over `tp`: its SR bits are
    its slice of the whole tensor's."""
    fmt = get_format(cfg.format_for(cls))
    if cfg.delayed:
        scale = f32(1.0) if scale is None else scale
    else:
        scale = None
    rand = None
    if cfg.rounding_for(cls) == "sr" and tp is not None and dim is not None:
        rand = tensor_parallel.bits(
            lambda shape: random_bits(shape, x.device, generator), x.shape,
            dim, tp)
    return _quantize(x, fmt, rounding=cfg.rounding_for(cls), rand=rand,
                     generator=generator, scale=scale,
                     use_amax_scale=cfg.amax_for(cls),
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


def _track(cfg: QuantConfig) -> bool:
    """Precision-health counters on? (delayed scaling only: the counters
    ride the delayed-scaling observations.)"""
    return cfg.track_health and cfg.delayed


def _health(q: QTensor, cfg: QuantConfig, cls: str) -> torch.Tensor:
    """(sat_frac, flush_frac) of a quantized operand's payload."""
    return payload_health(q.data, cfg.format_for(cls))


def _rand8(shape, cfg: QuantConfig, out_cls: str, generator, dim=None,
           tp=None):
    """The uint8 SR bits of a GEMM output's Q node (None under RNE): the
    whole output's, drawn as the kernel's wrapper draws them, and this
    rank's slice along `dim` of an output split over `tp`."""
    if cfg.rounding_for(out_cls) != "sr":
        return None
    dev = generator.device if generator is not None else None
    return tensor_parallel.bits(
        lambda s: torch.randint(0, 256, s, dtype=torch.uint8, device=dev,
                                generator=generator), shape, dim, tp)


def _fused_gemm(x8, w8, sx, sw, s_out, cfg: QuantConfig, out_cls: str,
                dims: str, generator=None, rand8=None):
    """One fused output-quantizing GEMM: out8 = Q((x8.w8) / (s_out/(sx*sw)))
    plus the output amax in real units (grid amax * s_out), and the
    output's (2,) health pair from the kernel's count epilogue under
    `_track(cfg)` (else None). `rand8`: the SR bits (None: the kernel's
    wrapper draws them from `generator`)."""
    from repro_torch.kernels.fused_quant_matmul import ops as fq_ops
    kscale = f32(s_out) / (f32(sx) * f32(sw))
    res = fq_ops.fused_quant_matmul(
        x8, w8, kscale, dims=dims, out_format=cfg.format_for(out_cls),
        rounding=cfg.rounding_for(out_cls),
        saturate=cfg.saturate_for(out_cls), generator=generator,
        rand8=rand8, with_amax=True, with_counts=_track(cfg))
    health = res[2] if _track(cfg) else None
    return res[0], res[1] * float(f32(s_out)), health


def _shard_gemm(x8, w8, sx, sw, s_out, cfg: QuantConfig, out_cls: str,
                dims: str, generator, dim, tp):
    """`_fused_gemm` of a GEMM whose output is this rank's shard along
    `dim` of a tensor split over `tp` (dim or tp None: a whole output):
    its SR bits are its slice of the whole output's."""
    from repro_torch.kernels.fused_quant_matmul import ref as fq_ref
    if tp is None or dim is None:
        return _fused_gemm(x8, w8, sx, sw, s_out, cfg, out_cls, dims,
                           generator)
    m, n, _ = fq_ref.gemm_shape(x8.shape, w8.shape, dims)
    return _fused_gemm(x8, w8, sx, sw, s_out, cfg, out_cls, dims, generator,
                       rand8=_rand8((m, n), cfg, out_cls, generator, dim,
                                    tp))


def _q_node(acc: torch.Tensor, kscale, cfg: QuantConfig, out_cls: str,
            rand8=None):
    """A GEMM output's Q node on its f32 accumulator, as kernel 1's
    epilogue takes it: Q(acc * (1/kscale)) in the class's format and
    rounding (`rand8` its SR bits), the payload's amax in grid units, and
    its health pair under `_track(cfg)` (else None)."""
    fmt = cfg.format_for(out_cls)
    q = _quantize(acc, fmt, rounding=cfg.rounding_for(out_cls), rand=rand8,
                  scale=kscale, saturate=cfg.saturate_for(out_cls)).data
    health = payload_health(q, fmt) if _track(cfg) else None
    return q, fp8_amax_bits(q), health


def _summed_gemm(x8, w8, sx, sw, s_out, cfg: QuantConfig, out_cls: str,
                 generator, tp):
    """A GEMM whose contraction is split over `tp`: this rank's f32
    partial x8 (M, K/m) . w8 (K/m, N) on kernel 5 (`fp8_matmul`), summed
    over the ranks in rank order, then the output's Q node on the sum
    (`_q_node`): the one process's Q node on the whole product. Returns
    `_fused_gemm`'s triple. Quantizing each partial and summing the
    payloads instead is wrong: it is the planted fault the tests hold the
    step against."""
    from repro_torch.kernels.fp8_matmul import ops as mm_ops
    acc = tensor_parallel.rank_sum(mm_ops.fp8_matmul(x8, w8), tp)
    q, amax, health = _q_node(acc, f32(s_out) / (f32(sx) * f32(sw)), cfg,
                              out_cls, _rand8(acc.shape, cfg, out_cls,
                                              generator))
    return q, amax * float(f32(s_out)), health


def _fused_dequant(out8: torch.Tensor, s_out, cfg: QuantConfig) -> torch.Tensor:
    return (out8.float() * float(f32(s_out))).to(dtype_of(cfg.output_dtype))


def _product(spec: str, qa: QTensor, qb: QTensor,
             cfg: QuantConfig) -> torch.Tensor:
    """`_compute`'s f32 product, times the operand scales, before the cast
    to the output dtype."""
    sa, sb = qa.scale, qb.scale
    if isinstance(sa, torch.Tensor) or isinstance(sb, torch.Tensor):
        out_scale = torch.as_tensor(sa) * torch.as_tensor(sb)
    else:
        out_scale = float(f32(sa) * f32(sb))
    if kernel_backend(cfg) and _pallas_matmul_spec(spec):
        from repro_torch.kernels.fp8_matmul import ops as mm_ops
        a2 = qa.data.reshape((-1, qa.data.shape[-1]))
        y = mm_ops.fp8_matmul(a2, qb.data).reshape(
            qa.data.shape[:-1] + (qb.data.shape[-1],))
    else:
        with torch.profiler.record_function("qeinsum.einsum"):
            y = torch.einsum(spec, qa.data.float(), qb.data.float())
    return y * out_scale


def _compute(spec: str, qa: QTensor, qb: QTensor,
             cfg: QuantConfig) -> torch.Tensor:
    """fp8 x fp8 -> f32 accumulate -> times qa.scale * qb.scale ->
    output_dtype; a '...k,kn->...n' contraction under a kernel backend runs
    the fp8 GEMM kernel. Host scales multiply as host f32; a device scale
    (jit amax) makes the product a device f32 scalar. The plain einsum
    runs under the profiler range "qeinsum.einsum", so that a trace reads
    its device time apart (the mixture-of-experts' expert GEMMs, the
    adjoints and the 4-D attention contractions of the unfused path)."""
    return _product(spec, qa, qb, cfg).to(dtype_of(cfg.output_dtype))


def _summed_wgrad(spec: str, qa: QTensor, qb: QTensor, cfg: QuantConfig,
                  group, generator, scale, out_dtype=None, dim=None,
                  tp=None):
    """A weight gradient summed over the ranks of `group` before its Q
    node (module docstring): the f32 product, its f32 sum, cast to
    `out_dtype` (None: kept f32), then `_fake_quant_grad` (a tensor-
    parallel shard along `dim` of the whole gradient: its slice of the
    whole gradient's SR bits)."""
    g = comm.all_reduce(_product(spec, qa, qb, cfg), "sum", group)
    if out_dtype is not None:
        g = g.to(out_dtype)
    return _fake_quant_grad(g, cfg, generator, scale, dim, tp)


def _fake_quant_grad(g: torch.Tensor, cfg: QuantConfig,
                     generator: Optional[torch.Generator], scale=None,
                     dim=None, tp=None):
    """The weight gradient stored in FP8 (class G, at the site's #G scale
    under delayed scaling) and read back in g's dtype; the optimizer
    unscales in f32. Returns (gradient, its payload's amax, its health
    pair under `_track(cfg)` or None)."""
    q = _quant_operand(g, GRAD, cfg, scale, generator, dim, tp)
    obs = _observe(q) if cfg.delayed else None
    health = _health(q, cfg, GRAD) if _track(cfg) else None
    return _dequantize(q, dtype=g.dtype), obs, health


def _plain_einsum(spec: str, a, b, cfg: QuantConfig) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    y = torch.einsum(spec, a.to(cd).float(), b.to(cd).float())
    return y.to(dtype_of(cfg.output_dtype))


def _record_health(sctx, key: str, pair: torch.Tensor, sharded: bool,
                   bwd: bool = False):
    """Record a forward (or backward) health pair of `key`, marked as read
    from this rank's shard of a tensor-parallel payload (`sharded`)."""
    (sctx.record_bwd_health if bwd else sctx.record_health)(key, pair)
    if sharded:
        sctx.mark_sharded(key)


def _observe(q: QTensor) -> torch.Tensor:
    """Observed amax of a quantized operand from its payload's bits."""
    return fp8_amax_bits(q.data) * float(q.scale)


def _sum_group(w: torch.Tensor, cls: str):
    """The group a weight operand's gradient is summed over in the
    backward (module docstring), or None."""
    gb = global_batch.current()
    if cls != WEIGHT or gb is None or not gb.sums_weight(w):
        return None
    return gb.group


class _QEinsum(torch.autograd.Function):
    """The fused-path custom gradient (`_qeinsum_fwd` / `_qeinsum_bwd_fused`
    of the reference). Non-tensor arguments ride in `meta`: (cfg, classes,
    scales, sctx, keys, fkeys, generator, role, tp): role the site's
    tensor-parallel role ("col", "row" or None) over the group `tp`."""

    @staticmethod
    def forward(ctx, a, b, meta):
        cfg, classes, scales, sctx, keys, fkeys, gen, role, tp = meta
        qa = _quant_operand(a, classes[0], cfg, scales[0], gen,
                            _A_DIM.get(role), tp)
        qb = _quant_operand(b, classes[1], cfg, scales[1], gen,
                            _B_DIM.get(role), tp)
        a2 = qa.data.reshape((-1, qa.data.shape[-1]))
        if role == "row":
            y8, obs_y, h_y = _summed_gemm(a2, qb.data, qa.scale, qb.scale,
                                          scales[4], cfg, ACT, gen, tp)
        else:
            y8, obs_y, h_y = _shard_gemm(a2, qb.data, qa.scale, qb.scale,
                                         scales[4], cfg, ACT, "nn", gen,
                                         _Y_DIM.get(role), tp)
        y = _fused_dequant(y8, scales[4], cfg).reshape(
            qa.data.shape[:-1] + (qb.data.shape[-1],))
        if keys is not None and sctx.mode in ("collect", "calibrate"):
            sctx.record(keys["a"], _observe(qa))
            sctx.record(keys["b"], _observe(qb))
            sctx.record(fkeys["y"], obs_y)
            if _track(cfg):
                _record_health(sctx, keys["a"], _health(qa, cfg, classes[0]),
                               role in _A_DIM)
                _record_health(sctx, keys["b"], _health(qb, cfg, classes[1]),
                               role in _B_DIM)
                _record_health(sctx, fkeys["y"], h_y, role in _Y_DIM)
        ctx.save_for_backward(qa.data, qb.data)
        ctx.meta = meta
        ctx.qscales = (qa.scale, qb.scale)
        ctx.dtypes = (a.dtype, b.dtype)
        ctx.sum_group = _sum_group(b, classes[1])
        return y

    @staticmethod
    def backward(ctx, dy):
        qa_data, qb_data = ctx.saved_tensors
        cfg, classes, scales, sctx, keys, fkeys, gen, role, tp = ctx.meta
        sa, sb = ctx.qscales
        qdy = _quant_operand(dy, ERROR, cfg, scales[2], gen,
                             _Y_DIM.get(role), tp)
        dy2 = qdy.data.reshape((-1, qdy.data.shape[-1]))
        a2 = qa_data.reshape((-1, qa_data.shape[-1]))
        # The weight operand's gradient is FP8-stored (class G, site #G);
        # the activation operand receives the error-class dgrad (#da.E).
        cls_a = GRAD if classes[0] == WEIGHT else ERROR
        cls_b = GRAD if classes[1] == WEIGHT else ERROR
        s_da = scales[3] if cls_a == GRAD else scales[5]
        s_db = scales[3] if cls_b == GRAD else scales[5]
        if role == "col":
            # dA = Q(sum over ranks of dY_r . W_r^T): kernel 5 on W_r^T.
            da8, obs_da, h_da = _summed_gemm(
                dy2, qb_data.t().contiguous(), qdy.scale, sb, s_da, cfg,
                cls_a, gen, tp)
        else:
            # dA = Q(dY . W^T): (M, N) x (K, N) -> (M, K)
            da8, obs_da, h_da = _shard_gemm(dy2, qb_data, qdy.scale, sb,
                                            s_da, cfg, cls_a, "nt", gen,
                                            _DA_DIM.get(role), tp)
        da = _fused_dequant(da8, s_da, cfg).reshape(qa_data.shape)
        if ctx.sum_group is not None:
            # dW = Q(sum over ranks of A^T . dY): kernel 5 on A^T.
            db, obs_db, h_db = _summed_wgrad(
                "km,mn->kn", QTensor(a2.t().contiguous(), sa),
                QTensor(dy2, qdy.scale), cfg, ctx.sum_group, gen, s_db,
                dim=_B_DIM.get(role), tp=tp)
            db = db.to(dtype_of(cfg.output_dtype)).reshape(qb_data.shape)
        else:
            # dW = Q(A^T . dY): (M, K) x (M, N) -> (K, N)
            db8, obs_db, h_db = _shard_gemm(a2, dy2, sa, qdy.scale, s_db,
                                            cfg, cls_b, "tn", gen,
                                            _B_DIM.get(role), tp)
            db = _fused_dequant(db8, s_db, cfg).reshape(qb_data.shape)
        if keys is not None and sctx.mode == "collect":
            track = _track(cfg)
            zero = torch.zeros((), device=dy.device)
            obs_g, obs_err = zero, zero
            h_g = torch.zeros(2, device=dy.device) if track else None
            h_err = None
            if cls_a == GRAD:
                obs_g = torch.maximum(obs_g, obs_da)
                h_g = torch.maximum(h_g, h_da) if track else None
            else:
                obs_err, h_err = obs_da, h_da
            if cls_b == GRAD:
                obs_g = torch.maximum(obs_g, obs_db)
                h_g = torch.maximum(h_g, h_db) if track else None
            else:
                obs_err, h_err = obs_db, h_db
            sctx.record_bwd(keys["E"], _observe(qdy))
            sctx.record_bwd(keys["G"], obs_g)
            if "err" in fkeys:
                sctx.record_bwd(fkeys["err"], obs_err)
            if track:
                _record_health(sctx, keys["E"], _health(qdy, cfg, ERROR),
                               role in _Y_DIM, bwd=True)
                _record_health(sctx, keys["G"], h_g, role in _B_DIM,
                               bwd=True)
                if "err" in fkeys:
                    _record_health(sctx, fkeys["err"], h_err,
                                   role in _DA_DIM, bwd=True)
        return da.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None


class _QEinsumUnfused(torch.autograd.Function):
    """The unfused custom gradient (`_qeinsum_fwd`'s unfused branch and
    `_qeinsum_bwd` of the reference). `meta`: (spec, cfg, classes, scales,
    sctx, keys, generator, role, tp): scales [a, b, E, G] (None: unit
    scales, or the operand's amax scale under jit_amax); keys the delayed
    site's operand keys, or None; role the site's tensor-parallel role
    over `tp` (a "row" site's forward and a "col" site's dA are f32
    partials, summed over the ranks before the cast). Saves the fp8
    payloads qa, qb."""

    @staticmethod
    def forward(ctx, a, b, meta):
        spec, cfg, classes, scales, sctx, keys, gen, role, tp = meta
        qa = _quant_operand(a, classes[0], cfg, scales[0], gen,
                            _A_DIM.get(role), tp)
        qb = _quant_operand(b, classes[1], cfg, scales[1], gen,
                            _B_DIM.get(role), tp)
        if role == "row":
            y = tensor_parallel.rank_sum(_product(spec, qa, qb, cfg), tp).to(
                dtype_of(cfg.output_dtype))
        else:
            y = _compute(spec, qa, qb, cfg)
        if keys is not None and sctx.mode in ("collect", "calibrate"):
            sctx.record(keys["a"], _observe(qa))
            sctx.record(keys["b"], _observe(qb))
            if _track(cfg):
                _record_health(sctx, keys["a"], _health(qa, cfg, classes[0]),
                               role in _A_DIM)
                _record_health(sctx, keys["b"], _health(qb, cfg, classes[1]),
                               role in _B_DIM)
        ctx.save_for_backward(qa.data, qb.data)
        ctx.meta = meta
        ctx.qscales = (qa.scale, qb.scale)
        ctx.dtypes = (a.dtype, b.dtype)
        ctx.sum_groups = (_sum_group(a, classes[0]),
                          _sum_group(b, classes[1]))
        return y

    @staticmethod
    def backward(ctx, dy):
        qa_data, qb_data = ctx.saved_tensors
        spec, cfg, classes, scales, sctx, keys, gen, role, tp = ctx.meta
        qa = QTensor(qa_data, ctx.qscales[0])
        qb = QTensor(qb_data, ctx.qscales[1])
        qdy = _quant_operand(dy, ERROR, cfg, scales[2], gen,
                             _Y_DIM.get(role), tp)
        da_spec, db_spec = adjoint_specs(spec)
        out_dtype = dtype_of(cfg.output_dtype)
        # Weight gradients are stored in FP8 (class G, paper Fig. 1b); in
        # a "full" step summed over the ranks first.
        # A "col" site's dA is a partial over W's column shards.
        g_obs, grads = [], []
        for x, y, adj, cls, group, dim, partial in (
                (qdy, qb, da_spec, classes[0], ctx.sum_groups[0],
                 _A_DIM.get(role), role == "col"),
                (qa, qdy, db_spec, classes[1], ctx.sum_groups[1],
                 _B_DIM.get(role), False)):
            if group is not None:
                g, *obs = _summed_wgrad(adj, x, y, cfg, group, gen,
                                        scales[3], out_dtype, dim, tp)
            else:
                if partial:
                    g = tensor_parallel.rank_sum(
                        _product(adj, x, y, cfg), tp).to(out_dtype)
                else:
                    g = _compute(adj, x, y, cfg)
                if cls == WEIGHT:
                    g, *obs = _fake_quant_grad(g, cfg, gen, scales[3], dim,
                                               tp)
            if cls == WEIGHT:
                g_obs.append(obs)
            grads.append(g)
        da, db = grads
        if keys is not None and sctx.mode == "collect":
            sctx.record_bwd(keys["E"], _observe(qdy))
            if g_obs:
                sctx.record_bwd(keys["G"], functools.reduce(
                    torch.maximum, [o[0] for o in g_obs]))
            if _track(cfg):
                _record_health(sctx, keys["E"], _health(qdy, cfg, ERROR),
                               role in _Y_DIM, bwd=True)
                if g_obs:
                    _record_health(sctx, keys["G"], functools.reduce(
                        torch.maximum, [o[1] for o in g_obs]),
                        role in _B_DIM, bwd=True)
        return da.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None


def qeinsum(spec: str, a: torch.Tensor, b: torch.Tensor, *,
            cfg: QuantConfig = PAPER_FP8,
            classes: Tuple[str, str] = (ACT, WEIGHT),
            site: Optional[str] = None,
            generator: Optional[torch.Generator] = None,
            tp: Optional[str] = None) -> torch.Tensor:
    """Quantized einsum with its custom gradient. A disabled config is the
    16-bit plain einsum. Under delayed scaling with an active ScaleContext
    and a site name, the operand scales (and, on the fused path, the output
    scales) come from the context, forward amaxes are recorded (collect /
    calibrate) and the backward records the E / G (and #da.E)
    observations (collect). Without a context or a site delayed scaling
    runs at unit scales, as in the reference. SR bits come from
    `generator`.

    tp: the site's tensor-parallel role when a 'model' group is active
    (`distributed.tensor_parallel.current()`), the caller's operands this
    rank's shards: "col" (b's columns: y and dY split), "row" (a's last
    dim and b's rows: y a partial, summed over the ranks in f32 before
    its Q node), "heads" (a 4-D attention contraction on the rank's
    heads). A "col" site's dA is summed the same way before its Q node.
    Without an active group the role is ignored."""
    parse_spec(spec)
    if not cfg.enabled:
        return _plain_einsum(spec, a, b, cfg)
    if generator is None and cfg.needs_key:
        raise ValueError(f"QuantConfig uses stochastic rounding; qeinsum("
                         f"{spec!r}) needs a torch.Generator")
    classes = tuple(classes)
    group = tensor_parallel.current() if tp is not None else None
    role = tp if group is not None else None
    ctx = scale_ctx.current()
    fused = _fused_epilogue(spec, classes, cfg)
    keys = fkeys = None
    if cfg.delayed and ctx is not None and site is not None:
        skey = ctx.site_key(site)
        keys = scale_ctx.operand_keys(skey, classes)
        if WEIGHT not in classes:
            del keys["G"]
        fkeys = scale_ctx.fused_output_keys(skey, classes) if fused else {}
        for key in (*keys.values(), *fkeys.values()):
            ctx.register(key)
        ctx.register_token_site(skey)
    if not fused:
        scales = [None] * 4 if keys is None else [
            ctx.scale_for(keys.get(n, "")) for n in ("a", "b", "E", "G")]
        return _QEinsumUnfused.apply(
            a, b, (spec, cfg, classes, scales, ctx, keys, generator, role,
                   group))
    scales = [f32(1.0)] * N_SCALES
    if keys is not None:
        scales = [ctx.scale_for(keys[n]) for n in ("a", "b", "E", "G")] + [
            ctx.scale_for(fkeys["y"]), ctx.scale_for(fkeys.get("err", ""))]
    meta = (cfg, classes, scales, ctx, keys, fkeys, generator, role, group)
    return _QEinsum.apply(a, b, meta)
