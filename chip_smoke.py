#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (there is no CPU fallback):
  1. build the four CUDA libraries from src/repro_torch/csrc (one nvcc
     each, in parallel, beside probe builds of the attention forward and
     of the dK/dV kernel that record the schedule they ran) and print
     ptxas' register / shared-memory report;
  2. hold each kernel against its plain PyTorch version on the card, at
     the serving path's and the training path's shapes: outputs bitwise
     on exact-accumulation inputs, a grid-neighbour flip-rate bound (GEMM),
     a bf16-ulp bound (attention forward, every mask it takes, hole blocks
     and dead warps, and the training shape) or a rel-L2 bound that a
     planted fault exceeds (attention backward) on general inputs, amaxes
     equal; hold the attention forward's schedule (the q tile of each
     block, the kv blocks it visits, the warps that skip their epilogue,
     read from the probe build) and the dK/dV kernel's (each block's head,
     kv block and visited q tiles) to the rules the wrapper states; hold
     the backward bitwise on a fixture whose unsaturated dP overflows at
     masked positions (NaN included), and two dK/dV launches bitwise equal
     on every backward input; and time kernel, plain version, a library
     yardstick and the bound (the dK/dV kernel's main and group-sum
     kernels apart);
  3. calibrate qwen2-1.5b at full width and depth (random weights from a
     seed) on 2 seeded batches, and freeze the scales;
  4. serve 4 seeded requests through PagedServeEngine (greedy), with the
     kernels' launch counters reset just before and read just after;
  5. hold one serving step's logits (full width, 2 layers) against the
     same step run with the plain versions on the card (and show that two
     planted kernel faults fail that check), and against the plain
     versions on the CPU;
  6. train qwen2-1.5b at full width and depth for TRAIN_STEPS steps of
     B=4 x S=512 tokens (hybrid recipe, delayed scaling, enhanced loss
     scaling, fp16 master weights, Adam), with the launch counters reset
     just before and read just after; profile two more steps;
  7. hold one training step's loss and gradients (full width, 2 layers)
     against the plain versions on the card and, all-RNE, on the CPU, with
     two planted faults, and check two kernel runs are bitwise identical;
  8. train qwen2-1.5b at full width and depth for TRAIN_STEPS steps under
     the paper's own recipe (e5m2 W/A/E/G at unit scales, SR on A/E/G,
     enhanced loss scaling from 1024) on the unfused kernel path, counts
     reset just before and read just after; profile two more steps; then
     SR-quantize the model's projection weights through the stochastic-
     rounding op (its own path, counts reset around it);
  9. hold one paper-recipe step (full width, 2 layers) against the plain
     versions on the card and, all-RNE, on the CPU, with a planted fault
     in the unfused GEMM kernel.
Phase 2 also holds the unfused GEMM and both stochastic-rounding kernels
against their plain versions and times them, holds the GEMM in every
layout at ragged shapes that take each of its two tile widths (128x128,
128x256; the host picks one from the shape), and holds both variants of
the attention backward's dQ kernel (the stash variant for kv spans of up
to 512 columns, the four-pass one past them) against the plain version
and against each other. The start of the run prints the shared memory,
registers, spills and blocks per SM of the attention forward, of the dQ
stash variant, of the dK/dV kernel and of every GEMM variant (a forward or
dK/dV kernel that spills fails, as does one below its blocks per SM). The
line before the last is a JSON object with one entry per kernel (kernel
3's with its two variants, kernel 4's with its two kernels, the GEMM's and
kernel 5's with their tile widths; launches: the fused GEMM's and the attention
kernels' from phase 6, the unfused GEMM's from phase 8, the
stochastic-rounding kernels' from the op's path); the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
there is no CUDA device or the package is missing.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CARD = "unknown card"              # nvidia-smi name, power limit (set in main)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM (data sheet)
FP8_OPS_PER_S = 1979e12            # dense fp8 tensor-core peak
# Kernel-vs-plain limits, set from H100 readings (PERF.md): attention on
# general inputs read at most 1 ulp in at most 1.2e-5 of the elements; the
# 2-layer step read 1.8e-2 to 2.8e-2 between any two of kernels / plain on
# the card / plain on the CPU, and 0.12 to 0.16 with a planted fault.
ATTN_MAX_ULPS = 2
ATTN_MAX_DIFF_FRAC = 1e-4
STEP_TOL = 5e-2                    # rel L2 of the 2-layer step's logits


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms (CUDA events, after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, ops_rate: float):
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, ops / ops_rate
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def fp8_tensor(shape, fmt, gen, dev, exact: bool):
    """fp8 payload. exact=True draws exponents from {0, 1} only (every
    partial sum of a K <= 8960 GEMM is then exact in f32, in any order);
    otherwise a wide log-normal spread."""
    import torch
    from repro_torch.core.fp8_formats import get_format
    f = get_format(fmt)
    sign = torch.randint(0, 2, shape, generator=gen, device=dev) * 2 - 1
    if exact:
        mant = torch.randint(0, 1 << f.man_bits, shape, generator=gen,
                             device=dev).float() / (1 << f.man_bits)
        ex = torch.randint(0, 2, shape, generator=gen, device=dev).float()
        x = sign * (1 + mant) * torch.exp2(ex)
    else:
        x = sign * torch.exp(torch.randn(shape, generator=gen, device=dev))
    return x.clamp(-f.max_normal, f.max_normal).to(f.dtype)


def canon(q):
    """Payload bytes with every NaN as 0xFF (NaN sign and payload bits carry
    no meaning, and GPU arithmetic returns a canonical NaN)."""
    import torch
    u = q.view(torch.uint8).clone()
    u[torch.isnan(q.float())] = 0xFF
    return u


def bf16_ulps(a, b):
    """Per-element distance of two bf16 tensors in bf16 units in the last
    place (sign-magnitude bit patterns mapped onto an ordered integer line;
    +0 and -0 coincide)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def neighbour_flips(a, b, fmt):
    """(flip fraction, all flips between grid neighbours?) of two payloads."""
    from repro_torch.core.fp8_formats import get_format
    ia, ib = canon(a).int(), canon(b).int()
    diff = ia != ib
    same_sign = (ia & 0x80) == (ib & 0x80)
    near = same_sign & ((ia - ib).abs() <= 1)
    tiny = get_format(fmt).min_subnormal
    zeros = (a.float().abs() <= tiny) & (b.float().abs() <= tiny)
    ok = ~diff | near | zeros
    return diff.float().mean().item(), bool(ok.all())


def gemm_variant_info(lib):
    """Each GEMM variant's dynamic shared memory, registers, local (spill)
    bytes a thread and resident blocks per SM (fqmm_variant_info), beside
    the blocks per SM its tile is built for."""
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    info, out = (ctypes.c_int * 4)(), []
    for v, (epi, dims, bn) in enumerate(fq.GEMM_VARIANTS):
        err = lib.fqmm_variant_info(v, info)
        out.append(dict(name=f"{epi} {dims} 128x{bn}", out=epi, dims=dims,
                        bn=bn, smem=info[0], registers=info[1],
                        spill_bytes=info[2], blocks_per_sm=info[3],
                        blocks_wanted=2 if bn == 128 else 1, error=err))
    return out


def check_gemm(dev):
    import torch
    from repro_torch.core.fp8_formats import get_format
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    from repro_torch.kernels.fused_quant_matmul import ref as fq_ref
    gen = torch.Generator(device=dev).manual_seed(1)
    m = 128
    n_cases = worst_flip = 0
    for k, n in ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)):
        for fmt in ("e4m3", "e5m2"):
            for exact in (True, False):
                a = fp8_tensor((m, k), fmt, gen, dev, exact)
                w = fp8_tensor((k, n), fmt, gen, dev, exact)
                operands = {"nn": (a, w), "nt": (a, w.t().contiguous()),
                            "tn": (a.t().contiguous(), w)}
                # A power-of-two scale putting the largest outputs just past
                # the format's ceiling (saturation / overflow exercised).
                acc_amax = (a.float() @ w.float()).abs().max().item()
                scale = 2.0 ** round(math.log2(
                    max(acc_amax, 1e-30) / (1.3 * get_format(fmt).max_normal)))
                rand8 = torch.randint(0, 256, (m, n), dtype=torch.uint8,
                                      generator=gen, device=dev)
                for dims, (x, y) in operands.items():
                    for rounding in ("rne", "sr"):
                        for sat in (True, False):
                            kw = dict(dims=dims, out_format=fmt,
                                      rounding=rounding, saturate=sat,
                                      rand8=rand8, with_amax=True,
                                      with_counts=True)
                            qk, ak, hk = fq.fused_quant_matmul(x, y, scale,
                                                               **kw)
                            qp, ap, cp = fq_ref.fused_quant_matmul_ref(
                                x, y, rand8 if rounding == "sr" else None,
                                scale, dims=dims, out_format=fmt,
                                rounding=rounding, saturate=sat)
                            torch.cuda.synchronize()
                            tag = (f"gemm m={m} k={k} n={n} {fmt} {dims} "
                                   f"{rounding} sat={sat} exact={exact}")
                            same_amax = torch.equal(ak, ap) or (
                                ak.isnan().item() and ap.isnan().item())
                            if exact:
                                ok = torch.equal(canon(qk), canon(qp)) \
                                    and same_amax and torch.equal(
                                        hk, cp / torch.tensor(float(m * n),
                                                              device=dev))
                                if not ok:
                                    raise AssertionError(f"{tag}: not bitwise")
                            else:
                                rate, near = neighbour_flips(qk, qp, fmt)
                                worst_flip = max(worst_flip, rate)
                                if rate > 1e-3 or not near or not same_amax:
                                    raise AssertionError(
                                        f"{tag}: flip rate {rate:.2e} "
                                        f"neighbours={near} amax {ak.item()}"
                                        f" vs {ap.item()}")
                            n_cases += 1
    log(f"gemm: {n_cases} cases match the plain version (bitwise on exact "
        f"inputs; worst flip rate {worst_flip:.2e} on general inputs)")


def time_gemm(dev):
    """Kernel / plain / torch._scaled_mm times at the largest serving GEMM
    (M=128, K=1536, N=8960, e4m3, RNE)."""
    import torch
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    from repro_torch.kernels.fused_quant_matmul import ref as fq_ref
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for k, n in ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)):
        m = 128
        a = fp8_tensor((m, k), "e4m3", gen, dev, False)
        w = fp8_tensor((k, n), "e4m3", gen, dev, False)
        kw = dict(dims="nn", out_format="e4m3", rounding="rne",
                  saturate=True)
        ms = cuda_ms(lambda: fq.fused_quant_matmul(a, w, 64.0, **kw))
        plain = cuda_ms(lambda: fq_ref.fused_quant_matmul_ref(
            a, w, None, 64.0, **kw))
        one = torch.ones((), device=dev)
        wcol = w.t().contiguous().t()
        lib = cuda_ms(lambda: torch._scaled_mm(a, wcol, one, one,
                                               out_dtype=torch.bfloat16))
        q1, amax1 = fq.fused_quant_matmul(a, w, 64.0, with_amax=True, **kw)
        q2, amax2, _ = fq_ref.fused_quant_matmul_ref(a, w, None, 64.0, **kw)
        err = (q1.float() - q2.float()).abs().max().item()
        b_ms, b_by = bound(m * k + k * n + m * n, 2.0 * m * n * k,
                           FP8_OPS_PER_S)
        log(f"gemm time m={m} k={k} n={n}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, _scaled_mm {lib:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), max_abs_err {err} [{CARD}]")
        rows.append(dict(k=k, n=n, ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
    return rows


def holes_layout(dev, c):
    """Slot positions and [start, n_valid] of 4 chunk rows whose kv blocks
    the forward kernel skips or whose warps are dead: no live row (every
    warp dead); one live row whose later slots hold positions past it;
    150 live rows (the second 128-row tile keeps 22) over two kv blocks of
    holes; 20 live rows over one block of slots."""
    import torch
    cols = torch.arange(c, device=dev)
    blk = cols // 128
    none = torch.full_like(cols, -1)
    slot_pos = torch.stack([
        torch.where((cols < 300) & (blk != 1), cols, none),
        cols,
        torch.where((blk == 0) | (blk == 2), cols, none),
        torch.where(cols < 20, cols, none)]).int()
    chunk_pos = torch.tensor([[0, 0], [299, 1], [200, 150], [0, 20]],
                             device=dev).int()
    return slot_pos, chunk_pos


def attn_inputs(dev, gen, mode, fmt):
    """q, k, v and the mask arguments of a phase-2 attention case: 'chunk'
    (the serving shape), 'chunk_window' (the same with a 24-slot window),
    'holes' (holes_layout), or a 256-token batch under 'causal', 'window'
    (causal, window 100), 'full' or 'kv' (random column validity, one
    128-column block fully masked)."""
    import torch
    from repro_torch.core.fp8_formats import get_format
    dt = get_format(fmt).dtype
    if mode == "holes":
        b, h, hkv, t, c = 4, 12, 2, 160, 640
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((b, h, t, 128), (b, hkv, c, 128),
                                 (b, hkv, c, 128)))
        slot_pos, chunk_pos = holes_layout(dev, c)
        return q, k, v, dict(mask_mode="chunk", kv_mask=slot_pos,
                             chunk_pos=chunk_pos)
    if mode in ("chunk", "chunk_window"):
        window = 24 if mode == "chunk_window" else 0
        b, h, hkv, t, c = 4, 12, 2, 32, 512
        q = (torch.randn((b, h, t, 128), generator=gen, device=dev)).to(dt)
        k = (torch.randn((b, hkv, c, 128), generator=gen, device=dev)).to(dt)
        v = (torch.randn((b, hkv, c, 128), generator=gen, device=dev)).to(dt)
        # Ragged requests: prefill chunks and decode rows, holes past the
        # lengths, one fully masked row block (n_valid < T).
        lengths = torch.tensor([100, 37, 480, 5], device=dev)
        start = torch.tensor([68, 36, 479, 0], device=dev)
        n_valid = torch.tensor([32, 1, 1, 5], device=dev)
        cols = torch.arange(c, device=dev)[None]
        slot_pos = torch.where(cols < lengths[:, None], cols,
                               torch.full_like(cols, -1)).int()
        chunk_pos = torch.stack([start, n_valid], 1).int()
        return q, k, v, dict(mask_mode="chunk", kv_mask=slot_pos,
                             chunk_pos=chunk_pos, window=window)
    b, h, hkv, s = 2, 12, 2, 256
    q = torch.randn((b, h, s, 128), generator=gen, device=dev).to(dt)
    k = torch.randn((b, hkv, s, 128), generator=gen, device=dev).to(dt)
    v = torch.randn((b, hkv, s, 128), generator=gen, device=dev).to(dt)
    if mode == "window":
        return q, k, v, dict(mask_mode="causal", window=100)
    if mode == "kv":
        kvm = (torch.rand((b, s), generator=gen, device=dev) < 0.7).int()
        kvm[1, 128:] = 0
        return q, k, v, dict(mask_mode="kv", kv_mask=kvm)
    return q, k, v, dict(mask_mode=mode)


# Every mask kernel 2 takes, and the chunk layout with skipped kv blocks and
# dead warps.
ATTN_MODES = ("chunk", "chunk_window", "holes", "causal", "window", "full",
              "kv")


def stepped_keys(k, gen):
    """Keys whose dim 0 holds each column's 128-column kv block index j, or
    -224 (half of the columns, drawn from gen); with q = e_0 the scores are
    exactly these values. The running max then steps up by one per block,
    so l and acc are rescaled by exp(-1), while every exp is 0 or 1 and
    every sum stays exact."""
    import torch
    kf = k.float()
    blk = (torch.arange(k.shape[2], device=k.device) // 128).float()
    hi = torch.rand(k.shape[:3], generator=gen, device=k.device) < 0.5
    kf[..., 0] = torch.where(hi, blk, torch.full_like(blk, -224.0))
    return kf.to(k.dtype)


def check_attention_exact(dev):
    """Exact-accumulation fixtures at the serving shapes, on which the bf16
    output and both amaxes must match the plain version (run on the card,
    so both use the card's exp) bit for bit, for every mask kernel 2 takes
    (ATTN_MODES: chunk, causal, window, full, kv, and a chunk layout with
    hole blocks and dead warps):
      constant keys — every score of a row is equal, every exp is 1;
      stepped scores (stepped_keys) — the online softmax's running max
        rises across kv blocks, l and acc are rescaled, and P is quantized
        off the grid (f_p = 0.3), with RNE and with SR;
      overflow — stepped scores with f_s so large (64 e4m3, 512 e5m2) that
        the -224 scores pass the format's max normal, unsaturated: NaN (their
        rows and the S amax turn NaN) or -inf (masked in effect, S amax
        inf); the block steps of 64 / 512 have an exp negligible beside 1,
        so the sums stay exact; with RNE and with SR."""
    import torch
    from repro_torch.core.fp8_formats import get_format
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fp8_attention import ref as at_ref
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 0
    failed = []
    for mode in ATTN_MODES:
        for fmt in ("e4m3", "e5m2"):
            q, k, v, kw = attn_inputs(dev, gen, mode, fmt)
            dt = get_format(fmt).dtype
            v = fp8_tensor(v.shape, fmt, gen, dev, True)
            qc = (fp8_tensor(q.shape, fmt, gen, dev, True).float() / 4).to(dt)
            row = fp8_tensor(k.shape[:2] + (1, k.shape[3]), fmt, gen, dev,
                             True).float() / 4
            kc = row.to(dt).expand(k.shape).contiguous()
            qs = torch.zeros(q.shape, device=dev)
            qs[..., 0] = 1
            ks = stepped_keys(fp8_tensor(k.shape, fmt, gen, dev, True), gen)
            f_big = 64.0 if fmt == "e4m3" else 512.0
            cases = [("constant", qc, kc, [0.088388, 1, 1, 1], "rne", True)]
            cases += [("stepped", qs.to(dt), ks, [1.0, 1.0, 0.3, 1.5], r, True)
                      for r in ("rne", "sr")]
            cases += [("overflow", qs.to(dt), ks, [f_big, 1.0, 0.3, 1.5], r,
                       False) for r in ("rne", "sr")]
            for name, qq, kk_, scal, rnd, sat in cases:
                kk = dict(fmt_s=fmt, fmt_p=fmt, rounding_s=rnd,
                          rounding_p=rnd, saturate_s=sat, saturate_p=sat,
                          **kw)
                got = at.fp8_attention_fwd(qq, kk_, v, 7, scal, **kk)
                want = at_ref.fp8_attention_fwd_ref(qq, kk_, v, 7, scal, **kk)
                torch.cuda.synchronize()
                if not all(same_bits(x, y) for x, y in zip(got, want)):
                    diff = ~((got[0] == want[0])
                             | (torch.isnan(got[0]) & torch.isnan(want[0])))
                    failed.append(
                        f"attention {mode} {fmt} {name} {rnd}: exact-input "
                        f"output or amaxes not bitwise ({diff.sum().item()} "
                        f"elements differ; amax_s {got[1].item()} vs "
                        f"{want[1].item()}, amax_p {got[2].item()} vs "
                        f"{want[2].item()})")
                n += 1
    if failed:
        raise AssertionError("; ".join(failed))
    log(f"attention: {n} exact-input cases (constant keys, stepped scores, "
        "unsaturated overflow) bitwise equal to the plain version (output "
        "and amaxes, NaN where NaN)")


def check_attention_schedule(dev, probe_lib):
    """The schedule the attention forward ran (its probe build's records:
    each block's q tile, visited kv blocks and live warps) against the rule
    ops.fwd_tile_order / fwd_live_blocks / fwd_dead_warps state, for every
    mask of ATTN_MODES and the training shape (causal B=4, S=512)."""
    import torch
    from repro_torch.kernels.fp8_attention import probe
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = [(m, attn_inputs(dev, gen, m, "e4m3")) for m in ATTN_MODES]
    cases.append(("training", (*attn_train_inputs(dev, gen, "e4m3"),
                               dict(mask_mode="causal"))))
    failed, n = [], 0
    for mode, (q, k, v, kw) in cases:
        faults = probe.fwd_schedule_faults(probe_lib, q, k, v, kw)
        n += q.shape[0] * q.shape[1] * -(-q.shape[2] // 128)
        failed += [f"{mode}: {f}" for f in faults[:3]]
    if failed:
        raise AssertionError("attention forward schedule differs from "
                             "ops.fwd_*: " + "; ".join(failed))
    log(f"attention forward schedule: {n} blocks over {len(cases)} layouts "
        "ran the q tile, kv blocks and live warps that ops.fwd_tile_order / "
        "fwd_live_blocks / fwd_dead_warps state")


def attended_pairs(q, k, kw):
    """(row, col) pairs the mask admits, summed over batch and heads."""
    import torch
    b, h, t, _ = q.shape
    if kw["mask_mode"] == "chunk":
        sp = kw["kv_mask"].long()
        cp = kw["chunk_pos"].long()
        rows = torch.arange(t, device=q.device)[None]
        qpos = torch.where(rows < cp[:, 1:2], cp[:, :1] + rows,
                           torch.full_like(rows, -1))
        valid = (sp[:, None, :] >= 0) & (sp[:, None, :] <= qpos[:, :, None])
        return int(valid.sum().item()) * h
    if kw["mask_mode"] == "causal":
        return b * h * t * (t + 1) // 2
    return b * h * t * k.shape[2]


def check_attention(dev):
    """General inputs at the serving shapes, kernel against the plain
    version on the card. The products are exact, but the f32 row sums of
    exp (and P.V sums over a wide range) round in another order, so an
    output may move by bf16 ulps: at most ATTN_MAX_ULPS, in at most
    ATTN_MAX_DIFF_FRAC of the elements; the amaxes must be equal."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fp8_attention import ref as at_ref
    gen = torch.Generator(device=dev).manual_seed(3)
    scal = [0.088388, 1.0, 1.0, 1.0]
    rows = {}
    failed = []
    for mode in ATTN_MODES:
        for fmt in ("e4m3", "e5m2"):
            for rounding in ("rne", "sr"):
                q, k, v, kw = attn_inputs(dev, gen, mode, fmt)
                kk = dict(fmt_s=fmt, fmt_p=fmt, rounding_s=rounding,
                          rounding_p=rounding, **kw)
                ok_, as_k, ap_k = at.fp8_attention_fwd(q, k, v, 7, scal, **kk)
                op_, as_p, ap_p = at_ref.fp8_attention_fwd_ref(
                    q, k, v, 7, scal, **kk)
                torch.cuda.synchronize()
                err = (ok_.float() - op_.float()).abs().max().item()
                ref_mag = op_.float().abs().max().item()
                ulps = bf16_ulps(ok_, op_)
                max_ulps = ulps.max().item()
                frac = (ulps > 0).float().mean().item()
                tag = f"attention {mode} {fmt} {rounding}"
                same_amax = (torch.equal(as_k, as_p)
                             and torch.equal(ap_k, ap_p))
                log(f"{tag}: max_abs_err {err:.3e} (|o|max {ref_mag:.3f}), "
                    f"max {max_ulps} bf16 ulps, {frac:.2e} of elements "
                    f"differ, amaxes {'equal' if same_amax else 'DIFFER'}")
                if not (max_ulps <= ATTN_MAX_ULPS
                        and frac <= ATTN_MAX_DIFF_FRAC and same_amax):
                    failed.append(
                        f"{tag}: {max_ulps} ulps, fraction {frac:.2e}, amax_s "
                        f"{as_k.item()} vs {as_p.item()}, amax_p "
                        f"{ap_k.item()} vs {ap_p.item()}")
                if fmt == "e4m3" and rounding == "rne" and mode in (
                        "chunk", "causal"):
                    b, h, t, d = q.shape
                    hkv, s = k.shape[1], k.shape[2]
                    ms = cuda_ms(lambda: at.fp8_attention_fwd(
                        q, k, v, 7, scal, **kk))
                    plain = cuda_ms(lambda: at_ref.fp8_attention_fwd_ref(
                        q, k, v, 7, scal, **kk), iters=5)
                    qd, kd, vd = (x.to(torch.bfloat16) for x in (q, k, v))
                    if mode == "chunk":
                        sp = kw["kv_mask"].long()
                        cp = kw["chunk_pos"].long()
                        r = torch.arange(t, device=dev)[None]
                        qpos = torch.where(r < cp[:, 1:2], cp[:, :1] + r,
                                           torch.full_like(r, -1))
                        mask = ((sp[:, None, :] >= 0)
                                & (sp[:, None, :] <= qpos[:, :, None])
                                )[:, None]
                        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                            qd, kd, vd, attn_mask=mask, enable_gqa=True))
                    else:
                        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                            qd, kd, vd, is_causal=True, enable_gqa=True))
                    nbytes = (q.numel() + k.numel() + v.numel()
                              + 2 * q.numel())
                    if mode == "chunk":
                        nbytes += kw["kv_mask"].numel() * 4 + 8 * b
                    pairs = attended_pairs(q, k, kw)
                    b_ms, b_by = bound(nbytes, 4.0 * d * pairs, FP8_OPS_PER_S)
                    log(f"attention time {mode} B={b} H={h} Hkv={hkv} Q={t} "
                        f"S={s}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                        f"sdpa(bf16) {lib:.4f} ms, bound {b_ms:.4f} ms "
                        f"({b_by}) [{CARD}]")
                    rows[mode] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                      bound_ms=b_ms, bound_by=b_by,
                                      max_abs_err=err)
    if failed:
        raise AssertionError(
            f"attention beyond {ATTN_MAX_ULPS} bf16 ulps / "
            f"{ATTN_MAX_DIFF_FRAC:.0e} of elements: " + "; ".join(failed))
    return rows


# ---------------------------------------------------------------------------
# phases 3-5: calibrate, serve, step parity
# ---------------------------------------------------------------------------

def model_cfg(n_layers=None):
    import dataclasses
    from repro_torch.core.precision_policy import QuantConfig
    from repro_torch.models.registry import build_config
    cfg = build_config("qwen2-1.5b")
    quant = QuantConfig(recipe="hybrid", scaling="delayed", backend="pallas")
    cfg = cfg.replace(policy=dataclasses.replace(cfg.policy, quant=quant))
    return cfg if n_layers is None else cfg.replace(n_layers=n_layers)


def calibrate_full(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.models.transformer import init_lm
    from repro_torch.scaling.calibrate import calibrate, freeze
    cfg = model_cfg()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"qwen2-1.5b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params (seeded) in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 256))}
               for _ in range(2)]
    causal0 = at.fp8_attention_fwd.launches
    t0 = time.perf_counter()
    ds, state = calibrate(params, cfg, batches)
    frozen = freeze(ds, state)
    torch.cuda.synchronize()
    vals = np.array(list(frozen.values()), np.float64)
    if not (len(frozen) == cfg.n_layers * 26 and np.all(np.isfinite(vals))
            and np.all(vals > 0)):
        raise AssertionError(f"bad frozen scales: {len(frozen)} sites")
    log(f"calibrated {len(ds.registry)} sites ({len(frozen)} frozen W/A) on "
        f"2 batches of 2x256 in {time.perf_counter() - t0:.1f} s; causal "
        f"attention launches {at.fp8_attention_fwd.launches - causal0}")
    return cfg, params, frozen


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def serve_full(dev, cfg, params, frozen):
    import numpy as np
    import torch
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    from repro_torch.serve.engine import PagedServeConfig, PagedServeEngine
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(20, 101)))
               for _ in range(4)]
    eng = PagedServeEngine(cfg, params, PagedServeConfig(
        max_batch=4, max_len=512, n_pages=4 * 32 + 1, page_size=16,
        chunk_size=32), frozen_scales=frozen, device=dev)
    fq.fused_quant_matmul.launches = 0
    at.fp8_attention_fwd.launches = 0
    t0 = time.perf_counter()
    uids = [eng.add_request(p, max_new_tokens=16) for p in prompts]
    out = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_quant_matmul": fq.fused_quant_matmul.launches,
                "fp8_attention_fwd": at.fp8_attention_fwd.launches}
    streams = [out[u] for u in uids]
    if any(len(s) != 16 or not all(0 <= t < cfg.vocab_size for t in s)
           for s in streams):
        raise AssertionError(f"bad streams {streams}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    st = eng.stats()
    n_tok = sum(len(s) for s in streams)
    log(f"served {len(prompts)} requests (prompts "
        f"{[len(p) for p in prompts]}, 16 new tokens each) in {wall:.2f} s: "
        f"{n_tok / wall:.1f} generated tokens/s, step p50 "
        f"{st['step_s']['p50'] * 1e3:.1f} ms, p99 "
        f"{st['step_s']['p99'] * 1e3:.1f} ms, launches {launches} [{CARD}]")
    log(f"first stream: {streams[0]}")
    profile_serving(eng, cfg)
    return launches, st, n_tok / wall


# The GEMM wrappers' profiler ranges. A trace also holds them as device
# events (user annotations spanning the ranges' kernels), which the
# profiles keep out of their kernel lists and device totals.
WRAPPER_RANGES = ("fp8_matmul", "fused_quant_matmul.nn",
                  "fused_quant_matmul.nt", "fused_quant_matmul.tn")


def profile_serving(eng, cfg):
    """Device time against wall time over the serving steps of 4 more
    requests (64-token prompts, 4 new tokens), traced by torch.profiler
    (CUPTI). The profiler's own host work lengthens the wall time, so the
    idle share it gives is an upper bound. A measurement, not a check: if
    the trace holds no device time it says so and the script goes on."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(3)
    for _ in range(4):
        eng.add_request(rng.integers(0, cfg.vocab_size, 64), max_new_tokens=4)
    n = 0
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while n == 0 or any(s is not None for s in eng.slots):
                eng.step()
                n += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.key not in WRAPPER_RANGES]
    except Exception as e:  # noqa: BLE001 — a measurement, reported
        log(f"profile: not measured ({type(e).__name__}: {e})")
        return
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us <= 0:
        log("profile: not measured (the trace holds no device time)")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    log(f"profile ({n} serving steps under torch.profiler): device time "
        f"{dev_us / 1e3 / n:.1f} ms per step, wall {wall * 1e3 / n:.1f} ms "
        f"per step, device idle share <= {1 - dev_us / 1e6 / wall:.2f} "
        f"[{CARD}]")
    ours = []
    for name, sym in (("fp8_attention_fwd", "attn_fwd_kernel"),
                      ("fused_quant_matmul", "fqmm")):
        mine = [e for e in events if sym in e.key]
        ms = sum(e.self_device_time_total for e in mine) / 1e3 / n
        ours.append(f"{name} {ms:.2f} ms "
                    f"({sum(e.count for e in mine) // n} calls)")
    log("  per step: " + ", ".join(ours))
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / n:8.2f} ms/step "
            f"{e.count // n:6d} calls/step  {e.key[:90]}")


def plain_gemm(a, b, scale=1.0, *, dims="nn", out_format="e5m2",
               rounding="sr", saturate=True, rand8=None, generator=None,
               with_amax=False, with_counts=False):
    """The GEMM wrapper's contract computed by its plain version on the
    operands' own device (the card here), for the serving path's calls."""
    import torch
    from repro_torch.kernels.fused_quant_matmul import ref as fq_ref
    if with_counts:
        raise NotImplementedError("the serving path reads no counts")
    if rounding == "sr" and rand8 is None:
        m, n, _ = fq_ref.gemm_shape(a.shape, b.shape, dims)
        rand8 = torch.randint(0, 256, (m, n), dtype=torch.uint8,
                              device=a.device, generator=generator)
    out, amax, _ = fq_ref.fused_quant_matmul_ref(
        a, b, rand8 if rounding == "sr" else None, scale, dims=dims,
        out_format=out_format, rounding=rounding, saturate=saturate)
    return (out, amax) if with_amax else out


def unquantized_sblock(qf, kf_blk, rows, cols, bh, qpos, kvm, *, f_s, s_s,
                       mask_mode, window, q_len, s_len, **_):
    """A planted fault for the attention forward: the plain version's score
    block with S left unquantized."""
    import torch
    from repro_torch.kernels.fp8_attention import ref as at_ref
    sv = (qf @ kf_blk.transpose(-1, -2)) * f_s
    valid = at_ref.mask_block(mask_mode, rows, cols, s_len, window, kvm, qpos)
    x = torch.where(valid, sv * s_s, torch.full_like(sv, -1e30))
    return sv, valid, x, (rows < q_len) & valid


def step_parity(dev, frozen):
    """One chunk step, 2 layers at full width, the same weights, scales and
    batch run five ways: the kernels on the card; the plain versions on the
    card (the wrappers' module attributes pointed at them for the run); two
    planted kernel faults, also on the card (the GEMM rounding SR where RNE
    is asked; attention with S left unquantized); the plain versions on the
    CPU. Each of kernels vs plain on the card (the kernels' own error, no
    device difference mixed in) and kernels on the card vs the CPU must
    read a rel L2 of the logits below STEP_TOL, and each planted fault must
    read above it against both references.

    Why STEP_TOL is not tighter: the fp8 chain amplifies a one-notch flip
    anywhere (a kernel's summation order, or the last bit of a plain op)
    into ~2e-2 of the logits after 2 layers. Plain on the card vs the CPU,
    which runs no kernel, is printed as the witness of that floor."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fp8_attention import ref as at_ref
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    from repro_torch.models.transformer import (init_lm,
                                                init_paged_stack_state)
    from repro_torch.serve.paging import flat_slots, gather_plan
    from repro_torch.train.step import make_serve_chunk
    cfg = model_cfg(n_layers=2)
    # Seed 0 again: the first two layers of the calibrated model.
    params = init_lm(cfg, seed=0, device=dev)
    cpu_params = _to_cpu(params)
    sub = {k: v for k, v in frozen.items()
           if k.startswith(("decoder/layer_0/", "decoder/layer_1/"))}
    rng = np.random.default_rng(2)
    b, t, psize, cap = 4, 32, 16, 512
    lengths = [32, 20, 7, 32]
    tables = [[1 + 2 * i, 2 + 2 * i] for i in range(b)]
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32),
             "positions": np.tile(np.arange(t, dtype=np.int32), (b, 1)),
             "write_slots": np.zeros((b, t), np.int32),
             "chunk_pos": np.array([[0, n] for n in lengths], np.int32),
             "last_row": np.array([n - 1 for n in lengths], np.int32)}
    for i, n in enumerate(lengths):
        batch["write_slots"][i, :n] = flat_slots(tables[i], psize, 0, n)
    batch["read_slots"], batch["slot_pos"] = gather_plan(tables, lengths,
                                                         psize, cap)
    step = make_serve_chunk(cfg, sub)

    def run(d, p, *patches):
        launches = fq.fused_quant_matmul.launches, at.fp8_attention_fwd.launches
        with contextlib.ExitStack() as stack:
            for obj, name, value in patches:
                stack.enter_context(mock.patch.object(obj, name, value))
            st = init_paged_stack_state(cfg, 16 * psize, device=d)
            tb = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
            logits, _ = step(p, tb, st)
            out = logits.float().cpu()
        launched = (fq.fused_quant_matmul.launches - launches[0],
                    at.fp8_attention_fwd.launches - launches[1])
        return out, launched

    plain = [(fq, "fused_quant_matmul", plain_gemm),
             (at, "fp8_attention_fwd", at_ref.fp8_attention_fwd_ref)]
    fault_gen = torch.Generator(device=dev).manual_seed(11)
    sr_gemm = lambda *a, **kw: plain_gemm(  # noqa: E731
        *a, **{**kw, "rounding": "sr", "generator": fault_gen})
    faults = {
        "gemm SR for RNE": [(fq, "fused_quant_matmul", sr_gemm), plain[1]],
        "attention S unquantized": [*plain, (at_ref, "sblock",
                                             unquantized_sblock)],
    }
    g, launched = run(dev, params)
    if min(launched) <= 0:
        raise AssertionError(f"kernel step launched {launched}")
    gp, launched = run(dev, params, *plain)
    if max(launched) != 0:
        raise AssertionError(f"plain step launched kernels {launched}")
    gf = {name: run(dev, params, *pt)[0] for name, pt in faults.items()}
    c, _ = run("cpu", cpu_params)
    if not (torch.isfinite(g).all() and g.shape == (b, 1,
                                                    cfg.padded_vocab_size)):
        raise AssertionError("bad logits")

    def rel(x, y):
        return ((x - y).norm() / y.norm()).item()

    def agree(x, y):
        return (x.argmax(-1) == y.argmax(-1)).float().mean().item()

    r_card, r_cpu, r_witness = rel(g, gp), rel(g, c), rel(gp, c)
    log(f"step parity (2 layers, full width), rel L2 of the logits "
        f"(tolerance {STEP_TOL:.0e}): kernels vs plain on the card "
        f"{r_card:.3e} (max|dlogit| {(g - gp).abs().max().item():.4e}, "
        f"argmax agreement {agree(g, gp):.2f}); kernels on the card vs the "
        f"CPU {r_cpu:.3e} (argmax agreement {agree(g, c):.2f}); plain on the "
        f"card vs the CPU {r_witness:.3e} (no kernel: the floor)")
    weak = []
    for name, gx in gf.items():
        rf_card, rf_cpu = rel(gx, gp), rel(gx, c)
        log(f"  planted fault '{name}': vs plain on the card {rf_card:.3e}, "
            f"vs the CPU {rf_cpu:.3e}")
        if min(rf_card, rf_cpu) <= STEP_TOL:
            weak.append(f"'{name}' reads {rf_card:.3e} / {rf_cpu:.3e}")
    if r_card >= STEP_TOL:
        raise AssertionError(f"kernels vs plain on the card: rel L2 {r_card}")
    if r_cpu >= STEP_TOL:
        raise AssertionError(f"card vs CPU logits rel L2 {r_cpu}")
    if weak:
        raise AssertionError("a planted fault goes unseen: " + "; ".join(weak))


# ---------------------------------------------------------------------------
# phase 2, training shapes: the GEMM's dgrad / wgrad layouts and the
# attention backward kernels
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 6
# (C, N) of the four projection kinds of qwen2-1.5b (wq / wo, wk / wv,
# up / gate, down): forward 'nn' A(M, C) . B(C, N) with M = B x S rows.
PROJ = ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536))
# Attention backward, general inputs, kernels vs plain on the card: rel L2
# of dq / dk / dv (set from readings, PERF.md; a planted unquantized dS
# must exceed it).
ATTN_BWD_REL_L2 = 1e-3
DKV_BLOCKS_PER_SM = 2              # the dK/dV kernel's residency target


def train_gemm_cases():
    """(dims, a_shape, b_shape, a_fmt, b_fmt) of the training step's GEMMs:
    forward Y = A.W ('nn', e4m3 x e4m3), dgrad dA = dY.W^T ('nt', e5m2 x
    e4m3), wgrad dW = A^T.dY ('tn', e4m3 x e5m2)."""
    m = TRAIN_B * TRAIN_S
    out = []
    for c, n in PROJ:
        out.append(("nn", (m, c), (c, n), "e4m3", "e4m3"))
        out.append(("nt", (m, n), (c, n), "e5m2", "e4m3"))
        out.append(("tn", (m, c), (m, n), "e4m3", "e5m2"))
    return out


def check_gemm_case(fq, fq_ref, a, b, dims, out_fmt, saturate, exact, gen,
                    dev, roundings=("rne", "sr")):
    """One GEMM case against the plain version on the card, RNE and SR, at a
    power-of-two scale that puts the largest outputs just past the output
    format's ceiling (saturating) or just below it (not saturating): payload
    bitwise and amax and counts equal on exact inputs; on general inputs at
    most 1e-3 of the payloads flipped, each to a grid neighbour, and the
    amax equal. Returns (cases, worst flip rate, tile widths launched)."""
    import torch
    from repro_torch.core.fp8_formats import get_format
    m, n, k = fq_ref.gemm_shape(a.shape, b.shape, dims)
    rand8 = torch.randint(0, 256, (m, n), dtype=torch.uint8, generator=gen,
                          device=dev)
    acc = fq_ref.dot_f32(a, b, dims).abs().max().item()
    top = get_format(out_fmt).max_normal * (1.3 if saturate else 0.7)
    scale = 2.0 ** round(math.log2(max(acc, 1e-30) / top))
    worst, tiles = 0.0, set()
    for rounding in roundings:
        kw = dict(dims=dims, out_format=out_fmt, rounding=rounding,
                  saturate=saturate, rand8=rand8, with_amax=True,
                  with_counts=True)
        before = dict(fq.fused_quant_matmul.launches_by_tile)
        qk, ak, hk = fq.fused_quant_matmul(a, b, scale, **kw)
        qp, ap, cp = fq_ref.fused_quant_matmul_ref(
            a, b, rand8 if rounding == "sr" else None, scale, dims=dims,
            out_format=out_fmt, rounding=rounding, saturate=saturate)
        torch.cuda.synchronize()
        tiles |= {bn for bn, v in fq.fused_quant_matmul.launches_by_tile.items()
                  if v != before[bn]}
        tag = (f"gemm {dims} m={m} n={n} k={k} {out_fmt} {rounding} "
               f"sat={saturate} exact={exact}")
        same_amax = torch.equal(ak, ap) or (
            ak.isnan().item() and ap.isnan().item())
        if exact:
            counts = cp / torch.tensor(float(m * n), device=dev)
            if not (torch.equal(canon(qk), canon(qp)) and same_amax
                    and torch.equal(hk, counts)):
                raise AssertionError(f"{tag}: not bitwise")
        else:
            rate, near = neighbour_flips(qk, qp, out_fmt)
            worst = max(worst, rate)
            if rate > 1e-3 or not near or not same_amax:
                raise AssertionError(f"{tag}: flip rate {rate:.2e} "
                                     f"neighbours={near} amax {ak.item()} "
                                     f"vs {ap.item()}")
    return len(roundings), worst, tiles


def check_gemm_train(dev):
    """Every GEMM of the training step at its training shape with the
    recipe's formats (forward 'nn': e4m3 output, saturating; dgrad 'nt'
    and wgrad 'tn': e5m2, not saturating), RNE and SR: bitwise on exact
    inputs, the flip-rate bound on general ones."""
    import torch
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    from repro_torch.kernels.fused_quant_matmul import ref as fq_ref
    gen = torch.Generator(device=dev).manual_seed(4)
    n_cases = worst = 0
    tiles = {d: set() for d in fq_ref.DIMS}
    for dims, sa, sb, fa, fb in train_gemm_cases():
        for exact in (True, False):
            a = fp8_tensor(sa, fa, gen, dev, exact)
            b = fp8_tensor(sb, fb, gen, dev, exact)
            nn = dims == "nn"
            c, w, t = check_gemm_case(fq, fq_ref, a, b, dims,
                                      "e4m3" if nn else "e5m2", nn, exact,
                                      gen, dev)
            n_cases, worst = n_cases + c, max(worst, w)
            tiles[dims] |= t
    log(f"gemm (training shapes, nn/nt/tn): {n_cases} cases match the plain "
        f"version (bitwise on exact inputs; worst flip rate {worst:.2e}); "
        f"tile widths launched by layout {tiles}")


# Ragged shapes (M, N, K; none a multiple of 128), one for each tile width
# the host picks: gemm_tile(1000, 1400, 1000) = 128, gemm_tile(2000, 1500,
# 4100) = 256.
GEMM_RAGGED = ((1000, 1400, 1000), (2000, 1500, 4100))


def check_gemm_ragged(dev):
    """Each layout at each ragged shape of GEMM_RAGGED, both formats: exact
    inputs with RNE and SR, saturating and not, bitwise; general inputs
    within the flip-rate bound. Every layout must have launched both tile
    widths."""
    import torch
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    from repro_torch.kernels.fused_quant_matmul import ref as fq_ref
    gen = torch.Generator(device=dev).manual_seed(14)
    n_cases = worst = 0
    tiles = {d: set() for d in fq_ref.DIMS}
    for m, n, k in GEMM_RAGGED:
        for fmt in ("e4m3", "e5m2"):
            for exact in (True, False):
                x = fp8_tensor((m, k), fmt, gen, dev, exact)
                w = fp8_tensor((k, n), fmt, gen, dev, exact)
                operands = {"nn": (x, w), "nt": (x, w.t().contiguous()),
                            "tn": (x.t().contiguous(), w)}
                for dims, (a, b) in operands.items():
                    for sat in ((True, False) if exact else (fmt == "e4m3",)):
                        c, wr, t = check_gemm_case(fq, fq_ref, a, b, dims, fmt,
                                                   sat, exact, gen, dev)
                        n_cases, worst = n_cases + c, max(worst, wr)
                        tiles[dims] |= t
    if any(t != set(fq.TILE_WIDTHS) for t in tiles.values()):
        raise AssertionError(f"tile widths launched by layout {tiles}")
    log(f"gemm (ragged shapes {GEMM_RAGGED}): {n_cases} cases match the "
        f"plain version (bitwise on exact inputs; worst flip rate "
        f"{worst:.2e}); tile widths launched by layout {tiles}")


def time_gemm_train(dev):
    """Kernel / plain / torch._scaled_mm times of every training GEMM
    shape (e5m2 SR output for nt / tn, e4m3 SR for nn), with the bound."""
    import torch
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    from repro_torch.kernels.fused_quant_matmul import ref as fq_ref
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for dims, sa, sb, fa, fb in train_gemm_cases():
        a = fp8_tensor(sa, fa, gen, dev, False)
        b = fp8_tensor(sb, fb, gen, dev, False)
        m, n, c = fq_ref.gemm_shape(a.shape, b.shape, dims)
        fmt = "e4m3" if dims == "nn" else "e5m2"
        rand8 = torch.randint(0, 256, (m, n), dtype=torch.uint8,
                              generator=gen, device=dev)
        kw = dict(dims=dims, out_format=fmt, rounding="sr",
                  saturate=dims == "nn", rand8=rand8)
        ms = cuda_ms(lambda: fq.fused_quant_matmul(a, b, 64.0, **kw))
        plain = cuda_ms(lambda: fq_ref.fused_quant_matmul_ref(
            a, b, rand8, 64.0, dims=dims, out_format=fmt, rounding="sr",
            saturate=dims == "nn"), iters=5)
        # _scaled_mm wants A row-major and B column-major, with at most one
        # e5m2 operand: lay the operands out so, outside the timed call.
        al = a if dims != "tn" else a.t().contiguous()
        bl = (b.t() if dims == "nt" else b.t().contiguous().t())
        one = torch.ones((), device=dev)
        lib = cuda_ms(lambda: torch._scaled_mm(al, bl, one, one,
                                               out_dtype=torch.bfloat16))
        qk, ak = fq.fused_quant_matmul(a, b, 64.0, with_amax=True, **kw)
        qp, ap, _ = fq_ref.fused_quant_matmul_ref(
            a, b, rand8, 64.0, dims=dims, out_format=fmt, rounding="sr",
            saturate=dims == "nn")
        err = (qk.float() - qp.float()).abs().max().item()
        b_ms, b_by = bound(m * c + c * n + 2 * m * n, 2.0 * m * n * c,
                           FP8_OPS_PER_S)
        tile = fq.gemm_tile(m, n, c)
        log(f"gemm time {dims} M={m} C={c} N={n} (128x{tile} tiles): kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, _scaled_mm {lib:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), max_abs_err {err} [{CARD}]")
        rows.append(dict(dims=dims, m=m, c=c, n=n, tile=tile, ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=err))
    return rows


def bwd_fixture(kind, fmt_a, fmt_e, gen, dev, b=TRAIN_B, h=12, hkv=2,
                s=TRAIN_S, d=128):
    """The exact backward fixtures of tests/test_torch_attn_bwd.py at the
    training shape: one-hot q and dO rows, k and v rows constant across the
    head dim (k: 4, or 32 x the kv block index for 'stepped', on a random
    half of the columns and -224 elsewhere; v: +-1, +-2), so every exp is
    1 or 0, l is a count and every f32 sum is exact in any order."""
    import torch
    from repro_torch.core.fp8_formats import get_format
    ta, te = get_format(fmt_a).dtype, get_format(fmt_e).dtype
    eye = torch.eye(d, device=dev)
    q = eye[torch.randint(0, d, (b, h, s), generator=gen, device=dev)]
    # 'stepped': 32 x the kv block index modulo 8, so that the keys of long
    # sequences stay inside e4m3's range (at most 224).
    top = (32.0 * (torch.arange(s, device=dev) // 128 % 8).float()
           if kind == "stepped" else torch.full((s,), 4.0, device=dev))
    hi = torch.rand((b, hkv, s), generator=gen, device=dev) < 0.5
    k = torch.where(hi, top, torch.full_like(top, -224.0))[..., None] \
        * torch.ones(d, device=dev)
    vals = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=dev)
    v = vals[torch.randint(0, 4, (b, hkv, s, 1), generator=gen,
                           device=dev)] * torch.ones(d, device=dev)
    dval = fp8_tensor((b, h, s, 1), fmt_e, gen, dev, True).float() * 4
    do = eye[torch.randint(0, d, (b, h, s), generator=gen, device=dev)] \
        * dval
    scal = [1.0, 1.0, 1.0, 1.0, 2.0 ** -6, 64.0, 256.0, 1.0, 1.0, 1.0]
    return q.to(ta), k.to(ta), v.to(ta), do.to(te), scal


BWD_RECIPES = {"hybrid": ("e4m3", "e5m2"), "paper": ("e5m2", "e5m2")}


# Shapes of the exact backward checks: (mask, B, S, the dQ kernel's
# variant). The training shape, the long-span variant past the stash's cap
# (causal S=2048, full S=1024), and ragged lengths (S not a multiple of 64)
# on each variant.
BWD_EXACT_SHAPES = (("causal", TRAIN_B, TRAIN_S, "stash"),
                    ("causal", 1, 2048, "long"), ("full", 1, 1024, "long"),
                    ("causal", 1, 456, "stash"), ("full", 1, 968, "long"))


def same_bits(a, b):
    """Equal element for element, NaN where the other is NaN."""
    import torch
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_attention_bwd(dev):
    """Kernels 3 (both variants) and 4 against the plain backward on the
    card at H=12, Hkv=2, D=128 over BWD_EXACT_SHAPES: dq / dk / dv, the
    amaxes and kernel 3's row statistics bitwise on the exact fixtures
    (both recipes, RNE and SR), each launch on the variant the shape
    selects; at the training shape (causal, B=4, S=512) the two variants
    of kernel 3 bitwise equal on general inputs, and dq / dk / dv within
    ATTN_BWD_REL_L2 of the plain version there, which a planted fault (the
    plain version with dS left unquantized) must exceed."""
    import torch
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fp8_attention import ref as at_ref
    gen = torch.Generator(device=dev).manual_seed(8)
    n = 0
    names = ("dq", "dk", "dv", "amax_dp", "amax_ds")
    for mask, b, s, variant in BWD_EXACT_SHAPES:
        for recipe, (fa, fe) in BWD_RECIPES.items():
            for kind in ("uniform", "stepped"):
                q, k, v, do, scal = bwd_fixture(kind, fa, fe, gen, dev, b=b,
                                                s=s)
                kp, vp = (at._pad_bytes(x, 2, 128) for x in (k, v))
                for rnd in ("rne", "sr"):
                    kw = dict(mask_mode=mask, fmt_s=fa, fmt_p=fa, fmt_e=fe,
                              rounding_s=rnd, rounding_p=rnd, rounding_e=rnd,
                              saturate_e=False)
                    before = dict(at.fp8_attention_bwd_dq.launches_by_variant)
                    got = at.fp8_attention_bwd(q, k, v, do, 7, scal, **kw)
                    after = dict(at.fp8_attention_bwd_dq.launches_by_variant)
                    want = at_ref.fp8_attention_bwd_ref(
                        q, k, v, do, 7, scal, with_stats=True, **kw)
                    stats = at.fp8_attention_bwd_dq(
                        q, kp, vp, do, 7, scal, q_len=s, s_len=s, **kw)[1:4]
                    twice = [at.fp8_attention_bwd_dkv(
                        q, kp, vp, do, 7, scal, *stats, q_len=s, s_len=s,
                        **kw) for _ in range(2)]
                    torch.cuda.synchronize()
                    tag = (f"attention bwd {mask} B={b} S={s} {recipe} {kind}"
                           f" {rnd}")
                    if after[variant] != before[variant] + 1:
                        raise AssertionError(f"{tag}: the dQ kernel's "
                                             f"{variant} variant not launched")
                    bad = [nm for nm, g, w in zip(names + ("m", "l", "rd"),
                                                  tuple(got) + tuple(stats),
                                                  want)
                           if not torch.equal(g, w)]
                    if bad:
                        raise AssertionError(
                            f"{tag}: {bad} not bitwise (dq max diff "
                            f"{(got[0] - want[0]).abs().max().item()})")
                    if not all(same_bits(x, y) for x, y in zip(*twice)):
                        raise AssertionError(f"{tag}: two launches of the "
                                             "dK/dV kernel differ")
                    n += 1
    log(f"attention bwd: {n} exact-input cases (uniform, stepped; shapes "
        f"{list(BWD_EXACT_SHAPES)}) "
        "bitwise equal to the plain version (dq, dk, dv, amaxes, m, l, rd); "
        "two dK/dV launches bitwise equal in each")
    worst, fault = 0.0, float("inf")
    orig = at_ref._ds_block
    for recipe, (fa, fe) in BWD_RECIPES.items():
        for rnd in ("rne", "sr"):
            q, k, v = attn_train_inputs(dev, gen, fa)
            do = (torch.randn(q.shape, generator=gen, device=dev)).to(
                fp8_dtype(fe))
            scal = [0.088388, 1.0, 1.0, 1.0, 1.0, 1.0, 0.088388, 1.0, 1.0,
                    1.0]
            kw = dict(mask_mode="causal", fmt_s=fa, fmt_p=fa, fmt_e=fe,
                      rounding_s=rnd, rounding_p=rnd, rounding_e=rnd,
                      saturate_e=False)
            got = at.fp8_attention_bwd(q, k, v, do, 7, scal, **kw)
            want = at_ref.fp8_attention_bwd_ref(q, k, v, do, 7, scal, **kw)
            lens = dict(q_len=q.shape[2], s_len=k.shape[2])
            stash, long_ = (at.fp8_attention_bwd_dq(
                q, k, v, do, 7, scal, variant=var, **lens, **kw)
                for var in ("stash", "long"))
            if not all(same_bits(x, y) for x, y in zip(stash, long_)):
                raise AssertionError(
                    f"attention bwd general {recipe} {rnd}: the dQ kernel's "
                    "stash and long variants differ")
            twice = [at.fp8_attention_bwd_dkv(q, k, v, do, 7, scal,
                                              *stash[1:4], **lens, **kw)
                     for _ in range(2)]
            if not all(same_bits(x, y) for x, y in zip(*twice)):
                raise AssertionError(f"attention bwd general {recipe} {rnd}:"
                                     " two launches of the dK/dV kernel "
                                     "differ")
            at_ref._ds_block = lambda p_d, dp_d, rd, bits, *, f_ds, **_: \
                (p_d * (dp_d - rd)) * f_ds
            try:
                faulty = at_ref.fp8_attention_bwd_ref(q, k, v, do, 7, scal,
                                                      **kw)
            finally:
                at_ref._ds_block = orig
            rels = [((g - w).norm() / w.norm()).item()
                    for g, w in zip(got[:3], want[:3])]
            rel = max(rels)
            rel_f = min(max(((g - w).norm() / w.norm()).item()
                            for g, w in zip(got[:3], faulty[:3])), 1e9)
            worst, fault = max(worst, rel), min(fault, rel_f)
            same = torch.equal(got[3], want[3]) and torch.equal(got[4],
                                                               want[4])
            log(f"attention bwd general {recipe} {rnd}: rel L2 dq "
                f"{rels[0]:.3e}, dk {rels[1]:.3e}, dv {rels[2]:.3e} "
                f"(planted unquantized dS {rel_f:.3e}), amaxes "
                f"{'equal' if same else 'DIFFER'}; dQ stash and long "
                "variants bitwise equal; two dK/dV launches bitwise equal")
            if rel > ATTN_BWD_REL_L2 or not same:
                raise AssertionError(f"attention bwd general {recipe} {rnd}:"
                                     f" rel L2 {rel}, amaxes equal {same}")
    if fault <= ATTN_BWD_REL_L2:
        raise AssertionError(f"planted unquantized dS reads {fault:.3e}, "
                             f"within the bound {ATTN_BWD_REL_L2}")
    return worst


def bwd_overflow_fixture(fmt_a, fmt_e, gen, dev, b=TRAIN_B, h=12, hkv=2,
                         s=TRAIN_S, d=128):
    """The uniform exact fixture with dP overflowing e5m2 at masked
    positions inside a visited pair, and nowhere else: rows r < 32 take dO
    = 2^14 at dim d-1, columns 64 <= c < 128 take V = 256 there; the
    other rows' dO lies in dims below d-1, V is 0 at dim d-1 elsewhere. So
    dP = 2^22 (2^16 after f_dp: inf, unsaturated) exactly where c > r in
    the (q tile 0, kv block 0) pair, and 0 at those rows' attended columns.
    P = 0 there makes P * dP NaN, so rd and every dS of rows 0-31 turn NaN,
    and with them dq's rows 0-31 and dk's rows 0-127 (the only kv block q
    tile 0 visits), as in the plain version; the rest stays exact."""
    import torch
    q, k, v, do, scal = bwd_fixture("uniform", fmt_a, fmt_e, gen, dev, b=b,
                                    h=h, hkv=hkv, s=s, d=d)
    rows = torch.arange(s, device=dev)
    eye = torch.eye(d, device=dev)
    dof = do.float()
    dval = dof.abs().amax(-1, keepdim=True) * torch.sign(dof.sum(-1, True))
    normal = eye[torch.randint(0, d - 1, (b, h, s), generator=gen,
                               device=dev)] * dval
    do = torch.where((rows < 32)[:, None], eye[d - 1] * 2.0 ** 14, normal)
    vf = v.float()
    vf[..., d - 1] = torch.where((rows >= 64) & (rows < 128), 256.0, 0.0)
    return q, k, vf.to(v.dtype), do.to(fp8_dtype(fmt_e)), scal


def check_attention_bwd_overflow(dev):
    """Kernels 3 and 4 on bwd_overflow_fixture (both recipes, RNE and SR,
    the unsaturated e5m2 dP of the backward's default) against the plain
    version on the card: dq / dk / dv and the amaxes bitwise, NaN where
    NaN; dk must hold NaN; two dK/dV launches bitwise equal."""
    import torch
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fp8_attention import ref as at_ref
    gen = torch.Generator(device=dev).manual_seed(12)
    n = 0
    for mask, b, s, _ in BWD_EXACT_SHAPES[:1] + BWD_EXACT_SHAPES[3:4]:
        for recipe, (fa, fe) in BWD_RECIPES.items():
            q, k, v, do, scal = bwd_overflow_fixture(fa, fe, gen, dev, b=b,
                                                     s=s)
            kp, vp = (at._pad_bytes(x, 2, 128) for x in (k, v))
            for rnd in ("rne", "sr"):
                kw = dict(mask_mode=mask, fmt_s=fa, fmt_p=fa, fmt_e=fe,
                          rounding_s=rnd, rounding_p=rnd, rounding_e=rnd,
                          saturate_e=False)
                got = at.fp8_attention_bwd(q, k, v, do, 7, scal, **kw)
                want = at_ref.fp8_attention_bwd_ref(q, k, v, do, 7, scal,
                                                    **kw)
                stats = at.fp8_attention_bwd_dq(
                    q, kp, vp, do, 7, scal, q_len=s, s_len=s, **kw)[1:4]
                twice = [at.fp8_attention_bwd_dkv(
                    q, kp, vp, do, 7, scal, *stats, q_len=s, s_len=s, **kw)
                    for _ in range(2)]
                torch.cuda.synchronize()
                tag = f"attention bwd overflow {mask} B={b} S={s} {recipe} {rnd}"
                if not bool(torch.isnan(want[1]).any()):
                    raise AssertionError(f"{tag}: the fixture did not overflow")
                bad = [nm for nm, g, w in zip(("dq", "dk", "dv", "amax_dp",
                                               "amax_ds"), got, want)
                       if not same_bits(g, w)]
                if bad:
                    raise AssertionError(f"{tag}: {bad} not bitwise")
                if not all(same_bits(x, y) for x, y in zip(*twice)):
                    raise AssertionError(f"{tag}: two dK/dV launches differ")
                n += 1
                nan_rows = torch.isnan(want[1]).any(-1).float().mean().item()
    log(f"attention bwd unsaturated-overflow fixture: {n} cases bitwise "
        f"equal to the plain version, NaN included ({nan_rows:.3f} of dk's "
        "rows NaN in the last, the rest finite); two dK/dV launches bitwise "
        "equal in each")


def check_dkv_schedule(dev, probe_lib):
    """The schedule the dK/dV kernel ran (its probe build's records: each
    block's head, batch row and kv block, and the q tiles it visited) is
    the one ops.dkv_block_order / dkv_live_tiles state, at the training
    shape, a windowed causal S=2048 and a ragged full S=968."""
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fp8_attention import probe
    cases = probe.dkv_case_list(dev)
    n = 0
    for case in cases:
        faults = probe.dkv_schedule_faults(probe_lib, case)
        if faults:
            raise AssertionError(f"dK/dV schedule, {case[0]}: "
                                 f"{len(faults)} blocks differ: {faults[:3]}")
        q, k = case[1], case[2]
        n += q.shape[0] * q.shape[1] * len(at.dkv_block_order(k.shape[2]))
    log(f"dK/dV schedule: {n} blocks over {len(cases)} layouts ran "
        "ops.dkv_block_order / dkv_live_tiles")


def fp8_dtype(fmt):
    from repro_torch.core.fp8_formats import get_format
    return get_format(fmt).dtype


def attn_train_inputs(dev, gen, fmt):
    import torch
    dt = fp8_dtype(fmt)
    b, h, hkv, s, d = TRAIN_B, 12, 2, TRAIN_S, 128
    q = torch.randn((b, h, s, d), generator=gen, device=dev).to(dt)
    k = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dt)
    v = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dt)
    return q, k, v


def causal_pairs(b, h, q, s):
    return b * h * sum(min(r + 1, s) for r in range(q))


def bwd_bounds(q, k, do):
    """(kernel 3's, kernel 4's) bound of a causal backward: fp8 q, dO, k, v
    read once; f32 dq, m, l, rd (kernel 3) or dk, dv (kernel 4) written;
    fp8 products over the attended pairs, three for kernel 3 (S, dP, dQ)
    and two for kernel 4 (dK, dV)."""
    b, h, s, d = q.shape
    pairs = causal_pairs(b, h, s, s)
    fp8 = q.numel() + do.numel() + 2 * k.numel()
    return (bound(fp8 + 4 * q.numel() + 3 * 4 * b * h * s,
                  3 * 2.0 * d * pairs, FP8_OPS_PER_S),
            bound(fp8 + 3 * 4 * b * h * s + 2 * 4 * k.numel(),
                  2 * 2.0 * d * pairs, FP8_OPS_PER_S))


def time_attention_bwd(dev):
    """Kernel 3 (its stash variant, and the long-span variant at the same
    shape), kernel 4, the plain backward and the library yardstick
    (autograd backward of scaled_dot_product_attention on dequantized bf16)
    at the training shape, hybrid recipe, SR; kernel 3's long-span variant
    where it runs (causal, B=1, S=2048) with the same yardsticks; with each
    kernel's bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fp8_attention import ref as at_ref
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v = attn_train_inputs(dev, gen, "e4m3")
    do = torch.randn(q.shape, generator=gen, device=dev).to(
        torch.float8_e5m2)
    scal = [0.088388, 1.0, 1.0, 1.0, 1.0, 1.0, 0.088388, 1.0, 1.0, 1.0]
    kw = dict(mask_mode="causal", fmt_s="e4m3", fmt_p="e4m3", fmt_e="e5m2",
              rounding_s="sr", rounding_p="sr", rounding_e="sr",
              saturate_e=False)
    lens = dict(q_len=q.shape[2], s_len=k.shape[2])
    dq, m, l, rd, _, _ = at.fp8_attention_bwd_dq(q, k, v, do, 7, scal,
                                                 **lens, **kw)
    # The two variants in turns (stash, long, long, stash) on one card.
    t_dq = {"stash": [], "long": []}
    for var in ("stash", "long", "long", "stash"):
        t_dq[var].append(cuda_ms(lambda: at.fp8_attention_bwd_dq(
            q, k, v, do, 7, scal, variant=var, **lens, **kw)))
    ms_dq = min(t_dq["stash"])
    ms_dq_long = min(t_dq["long"])
    ms_dkv = cuda_ms(lambda: at.fp8_attention_bwd_dkv(
        q, k, v, do, 7, scal, m, l, rd, **lens, **kw))
    parts = dkv_part_ms(lambda: at.fp8_attention_bwd_dkv(
        q, k, v, do, 7, scal, m, l, rd, **lens, **kw))
    ms_bwd = cuda_ms(lambda: at.fp8_attention_bwd(q, k, v, do, 7, scal, **kw))
    plain = cuda_ms(lambda: at_ref.fp8_attention_bwd_ref(
        q, k, v, do, 7, scal, **kw), iters=3)
    got = at.fp8_attention_bwd(q, k, v, do, 7, scal, **kw)
    want = at_ref.fp8_attention_bwd_ref(q, k, v, do, 7, scal, **kw)
    err_dq = (got[0] - want[0]).abs().max().item()
    err_dkv = max((got[i] - want[i]).abs().max().item() for i in (1, 2))
    qd, kd, vd = (x.to(torch.bfloat16).requires_grad_(True)
                  for x in (q, k, v))
    o = F.scaled_dot_product_attention(qd, kd, vd, is_causal=True,
                                       enable_gqa=True)
    dod = do.to(torch.bfloat16)
    lib = cuda_ms(lambda: torch.autograd.grad(o, (qd, kd, vd), dod,
                                              retain_graph=True))
    b, h, s, d = q.shape
    hkv = k.shape[1]
    pairs = causal_pairs(b, h, s, s)
    b_dq, b_dkv = bwd_bounds(q, k, do)
    log(f"attention bwd time causal B={b} H={h} Hkv={hkv} S={s}: dQ kernel "
        f"{ms_dq:.4f} ms (stash variant; runs {t_dq['stash']}; the long-"
        f"span variant at this shape {ms_dq_long:.4f} ms, runs "
        f"{t_dq['long']}; bound {b_dq[0]:.4f} ms, {b_dq[1]}), dK/dV kernel "
        f"{ms_dkv:.4f} ms (bound {b_dkv[0]:.4f} ms, {b_dkv[1]}), plain "
        f"{plain:.4f} ms, sdpa backward (bf16) {lib:.4f} ms [{CARD}]")
    # The parts carry no bound of their own: the group sum's scratch exists
    # only by the design, so the function's bound (b_dkv) is the one bound.
    log("dK/dV kernel by part (device time, profiler): " + (", ".join(
        f"{p['name']} ({p['symbol']}) {p['ms']:.4f} ms" for p in parts)
        if parts else "not measured") + f"; the function's bound "
        f"{b_dkv[0]:.4f} ms; whole backward (dQ + dK/dV kernels, one "
        f"wrapper call) {ms_bwd:.4f} ms against sdpa's bf16 backward "
        f"{lib:.4f} ms: {ms_bwd / lib:.2f}x [{CARD}]")
    long_row = time_attention_bwd_long(dev, gen)
    # The forward kernel at the same shape (the training path's).
    fscal = [0.088388, 1.0, 1.0, 1.0]
    fkw = dict(mask_mode="causal", fmt_s="e4m3", fmt_p="e4m3",
               rounding_s="sr", rounding_p="sr")
    ms_f = cuda_ms(lambda: at.fp8_attention_fwd(q, k, v, 7, fscal, **fkw))
    plain_f = cuda_ms(lambda: at_ref.fp8_attention_fwd_ref(
        q, k, v, 7, fscal, **fkw), iters=3)
    with torch.no_grad():
        lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, is_causal=True, enable_gqa=True))
    # Held like check_attention: bf16 ulps, the share of elements that
    # differ, equal amaxes.
    o_k, as_k, ap_k = at.fp8_attention_fwd(q, k, v, 7, fscal, **fkw)
    o_p, as_p, ap_p = at_ref.fp8_attention_fwd_ref(q, k, v, 7, fscal, **fkw)
    err_f = (o_k.float() - o_p.float()).abs().max().item()
    ulps = bf16_ulps(o_k, o_p)
    max_ulps, frac = ulps.max().item(), (ulps > 0).float().mean().item()
    same_amax = torch.equal(as_k, as_p) and torch.equal(ap_k, ap_p)
    b_f = bound(q.numel() + 2 * k.numel() + 2 * q.numel(),
                2 * 2.0 * d * pairs, FP8_OPS_PER_S)
    log(f"attention fwd time causal B={b} H={h} Hkv={hkv} S={s}: kernel "
        f"{ms_f:.4f} ms, plain {plain_f:.4f} ms, sdpa(bf16) {lib_f:.4f} ms, "
        f"bound {b_f[0]:.4f} ms ({b_f[1]}); max {max_ulps} bf16 ulps, "
        f"{frac:.2e} of elements differ, amaxes "
        f"{'equal' if same_amax else 'DIFFER'} [{CARD}]")
    if not (max_ulps <= ATTN_MAX_ULPS and frac <= ATTN_MAX_DIFF_FRAC
            and same_amax):
        raise AssertionError(
            f"attention fwd at the training shape: {max_ulps} ulps, "
            f"fraction {frac:.2e}, amax_s {as_k.item()} vs {as_p.item()}, "
            f"amax_p {ap_k.item()} vs {ap_p.item()}")
    common = dict(plain_ms=plain, library_ms=lib)
    return {"fwd": dict(ms=ms_f, plain_ms=plain_f, library_ms=lib_f,
                        bound_ms=b_f[0], bound_by=b_f[1], max_abs_err=err_f),
            "dq": dict(ms=ms_dq, bound_ms=b_dq[0], bound_by=b_dq[1],
                       max_abs_err=err_dq, **common),
            "dq_long": long_row,
            "dkv": dict(ms=ms_dkv, bound_ms=b_dkv[0], bound_by=b_dkv[1],
                        max_abs_err=err_dkv, parts=parts, whole_bwd_ms=ms_bwd,
                        **common)}


def dkv_part_ms(fn, iters: int = 20):
    """Device ms per call of each of the dK/dV wrapper's two kernels
    (attn_bwd_dkv_kernel_head, attn_bwd_dkv_kernel_group_sum) over `iters`
    calls of fn under torch.profiler; [] where the trace holds no device
    time (a measurement, not a check)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except Exception as e:  # noqa: BLE001 — a measurement, reported
        log(f"dK/dV parts: not measured ({type(e).__name__}: {e})")
        return []
    out = []
    for name, sym in (("main", "attn_bwd_dkv_kernel_head"),
                      ("group_sum", "attn_bwd_dkv_kernel_group_sum")):
        us = sum(e.self_device_time_total for e in events if sym in e.key)
        if us <= 0:
            return []
        out.append(dict(name=name, symbol=sym, ms=us / 1e3 / iters))
    return out


def time_attention_bwd_long(dev, gen):
    """Kernel 3's long-span variant where the host selects it (causal, B=1,
    H=12, Hkv=2, S=2048, hybrid recipe, SR): its time, bound, max abs error
    against the plain version, the plain backward's and SDPA's backward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fp8_attention import ref as at_ref
    b, h, hkv, s, d = 1, 12, 2, 2048, 128
    q = torch.randn((b, h, s, d), generator=gen, device=dev).to(
        torch.float8_e4m3fn)
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev).to(
        torch.float8_e4m3fn) for _ in range(2))
    do = torch.randn(q.shape, generator=gen, device=dev).to(
        torch.float8_e5m2)
    scal = [0.088388, 1.0, 1.0, 1.0, 1.0, 1.0, 0.088388, 1.0, 1.0, 1.0]
    kw = dict(mask_mode="causal", fmt_s="e4m3", fmt_p="e4m3", fmt_e="e5m2",
              rounding_s="sr", rounding_p="sr", rounding_e="sr",
              saturate_e=False)
    variant = at.dq_variant(s, s, "causal")
    if variant != "long":
        raise AssertionError(f"S={s} causal selects {variant}, not long")
    ms = cuda_ms(lambda: at.fp8_attention_bwd_dq(
        q, k, v, do, 7, scal, q_len=s, s_len=s, **kw), iters=5)
    plain = cuda_ms(lambda: at_ref.fp8_attention_bwd_ref(
        q, k, v, do, 7, scal, **kw), iters=2)
    got = at.fp8_attention_bwd(q, k, v, do, 7, scal, **kw)
    want = at_ref.fp8_attention_bwd_ref(q, k, v, do, 7, scal, **kw)
    err = (got[0] - want[0]).abs().max().item()
    qd, kd, vd = (x.to(torch.bfloat16).requires_grad_(True)
                  for x in (q, k, v))
    o = F.scaled_dot_product_attention(qd, kd, vd, is_causal=True,
                                       enable_gqa=True)
    dod = do.to(torch.bfloat16)
    lib = cuda_ms(lambda: torch.autograd.grad(o, (qd, kd, vd), dod,
                                              retain_graph=True))
    bnd = bwd_bounds(q, k, do)[0]
    log(f"attention bwd time causal B={b} H={h} Hkv={hkv} S={s}: dQ kernel "
        f"{ms:.4f} ms (long-span variant; bound {bnd[0]:.4f} ms, {bnd[1]}),"
        f" plain {plain:.4f} ms, sdpa backward (bf16) {lib:.4f} ms, dq "
        f"max_abs_err {err} [{CARD}]")
    return dict(ms=ms, bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=err,
                plain_ms=plain, library_ms=lib, shape=f"causal B={b} H={h} "
                f"Hkv={hkv} S={s} D={d}")


# ---------------------------------------------------------------------------
# phase 2, the paper recipe's kernels: the unfused fp8 GEMM (kernel 5) and
# the two stochastic-rounding kernels (6, 7)
# ---------------------------------------------------------------------------

F32_OPS_PER_S = 67e12              # dense f32 outside the tensor cores
SR_SHAPE = (TRAIN_B * TRAIN_S, 8960)
# Values an SR check must meet: inf, NaN, zeros, f32 subnormals, the fp8
# subnormal ranges, and values past either format's maximum.
SR_SPECIAL = (float("inf"), float("-inf"), float("nan"), 0.0, -0.0, 1e-40,
              2.0 ** -17, -3e-6, 2.0 ** -8, -5e-3, 1e6, -7e4, 57344.0,
              61440.0, 65519.0, 70000.0, 448.0, 464.0, 470.0, 480.0, -500.0)


def check_fp8_matmul(dev):
    """Kernel 5 against its plain version on the card at the forward
    training shapes (M = B x S rows, the four projection kinds) and the
    ragged shapes of GEMM_RAGGED (both tile widths), paper (e5m2 x e5m2)
    and mixed (e4m3 x e5m2) operands: bitwise on exact inputs for f32 and
    bf16 output, within rtol 1e-5 / atol 1e-4 (the reference's own
    tolerance) on general inputs with f32 output."""
    import torch
    from repro_torch.kernels.fp8_matmul import ops as mm
    from repro_torch.kernels.fp8_matmul import ref as mm_ref
    gen = torch.Generator(device=dev).manual_seed(12)
    n_cases, worst = 0, 0.0
    shapes = ([(TRAIN_B * TRAIN_S, k, n) for k, n in PROJ]
              + [(m, k, n) for m, n, k in GEMM_RAGGED])
    before = dict(mm.fp8_matmul.launches_by_tile)
    for m, k, n in shapes:
        for fa, fb in (("e5m2", "e5m2"), ("e4m3", "e5m2")):
            for exact in (True, False):
                a = fp8_tensor((m, k), fa, gen, dev, exact)
                b = fp8_tensor((k, n), fb, gen, dev, exact)
                for out in ((torch.float32, torch.bfloat16) if exact
                            else (torch.float32,)):
                    got = mm.fp8_matmul(a, b, out)
                    want = mm_ref.fp8_matmul_ref(a, b, out)
                    torch.cuda.synchronize()
                    tag = f"fp8_matmul m={m} k={k} n={n} {fa}x{fb} {out}"
                    if exact and not torch.equal(got, want):
                        raise AssertionError(f"{tag}: not bitwise on exact "
                                             "inputs")
                    if not exact:
                        err = ((got - want).abs() - 1e-5 * want.abs()).max()
                        worst = max(worst, (got - want).abs().max().item())
                        if err.item() > 1e-4:
                            raise AssertionError(f"{tag}: beyond rtol 1e-5 "
                                                 "atol 1e-4")
                    n_cases += 1
    tiles = {bn: v - before[bn]
             for bn, v in mm.fp8_matmul.launches_by_tile.items()}
    if not all(tiles.values()):
        raise AssertionError(f"fp8_matmul launches by tile width {tiles}")
    log(f"fp8_matmul: {n_cases} cases match the plain version (bitwise on "
        f"exact inputs; max abs diff {worst:.3e} on general inputs); "
        f"launches by tile width {tiles}")


def time_fp8_matmul(dev):
    """Kernel 5 / plain / torch.matmul on the bf16-upcast operands at the
    four forward training shapes, paper recipe (e5m2 x e5m2, f32 out),
    with the bound; torch._scaled_mm takes no e5m2 x e5m2 pair, so it is
    timed on e4m3 x e5m2 operands of the same shape as a yardstick of the
    card's fp8 rate only."""
    import torch
    from repro_torch.kernels.fp8_matmul import ops as mm
    from repro_torch.kernels.fp8_matmul import ref as mm_ref
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    gen = torch.Generator(device=dev).manual_seed(13)
    m, rows = TRAIN_B * TRAIN_S, []
    for k, n in PROJ:
        a = fp8_tensor((m, k), "e5m2", gen, dev, False)
        b = fp8_tensor((k, n), "e5m2", gen, dev, False)
        ms = cuda_ms(lambda: mm.fp8_matmul(a, b))
        plain = cuda_ms(lambda: mm_ref.fp8_matmul_ref(a, b), iters=5)
        ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
        lib = cuda_ms(lambda: torch.matmul(ab, bb))
        a43 = fp8_tensor((m, k), "e4m3", gen, dev, False)
        one = torch.ones((), device=dev)
        bcol = b.t().contiguous().t()
        smm = cuda_ms(lambda: torch._scaled_mm(a43, bcol, one, one,
                                               out_dtype=torch.bfloat16))
        err = (mm.fp8_matmul(a, b) - mm_ref.fp8_matmul_ref(a, b)
               ).abs().max().item()
        b_ms, b_by = bound(m * k + k * n + 4 * m * n, 2.0 * m * n * k,
                           FP8_OPS_PER_S)
        tile = fq.gemm_tile(m, n, k)
        log(f"fp8_matmul time M={m} K={k} N={n} (128x{tile} tiles) e5m2xe5m2 "
            f"f32 out: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"torch.matmul(bf16) "
            f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max_abs_err {err}; "
            f"_scaled_mm (no e5m2 x e5m2: e4m3 x e5m2 yardstick) {smm:.4f} "
            f"ms [{CARD}]")
        rows.append(dict(k=k, n=n, tile=tile, ms=ms, plain_ms=plain,
                         library_ms=lib, scaled_mm_ms=smm, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=err))
    return rows


def sr_input(shape, dtype, gen, dev):
    import torch
    x = torch.randn(shape, generator=gen, device=dev) * torch.exp2(
        torch.randint(-20, 17, shape, generator=gen, device=dev).float())
    x.view(-1)[:len(SR_SPECIAL)] = torch.tensor(SR_SPECIAL, device=dev)
    return x.to(dtype)


def check_sr(dev):
    """Kernels 6 and 7 against their plain versions on the card at
    SR_SHAPE, f32 and bf16 input, both formats, both saturation modes,
    special values planted: bitwise on every input (NaNs as NaN)."""
    import torch
    from repro_torch.kernels.stochastic_round import ops as sr
    from repro_torch.kernels.stochastic_round import ref as sr_ref
    gen = torch.Generator(device=dev).manual_seed(14)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        x = sr_input(SR_SHAPE, dtype, gen, dev)
        rand8 = torch.randint(0, 256, SR_SHAPE, dtype=torch.uint8,
                              generator=gen, device=dev)
        for fmt in ("e5m2", "e4m3"):
            for sat in (True, False):
                kw = dict(fmt=fmt, saturate=sat)
                pairs = {
                    "sr_quantize": (
                        sr.sr_quantize(x, rand8, 0.37, **kw),
                        sr_ref.stochastic_round_fp8_ref(x, rand8, 0.37,
                                                        **kw)),
                    "sr_quantize_onchip": (
                        sr.sr_quantize_onchip(x, 4321, 0.37, **kw),
                        sr_ref.stochastic_round_fp8_onchip_ref(
                            x, 4321, 0.37, **kw))}
                torch.cuda.synchronize()
                for name, (got, want) in pairs.items():
                    if not torch.equal(canon(got), canon(want)):
                        raise AssertionError(
                            f"{name} {dtype} {fmt} saturate={sat}: "
                            f"{(canon(got) != canon(want)).sum().item()} "
                            "payloads differ")
                    n += 1
    log(f"stochastic rounding: {n} cases at {SR_SHAPE} bitwise equal to the "
        "plain versions (f32 / bf16 in, e5m2 / e4m3, both saturations)")


def time_sr(dev):
    """Kernels 6 and 7 / their plain versions at SR_SHAPE, f32 in, e5m2 out,
    with the bound (bytes: the input, kernel 6's bits, the output; one f32
    multiply per element at the f32 rate). No PyTorch call rounds
    stochastically; the RNE cast x.to(float8_e5m2), which moves the same
    bytes as kernel 7, is printed as a yardstick only."""
    import torch
    from repro_torch.kernels.stochastic_round import ops as sr
    from repro_torch.kernels.stochastic_round import ref as sr_ref
    gen = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn(SR_SHAPE, generator=gen, device=dev)
    rand8 = torch.randint(0, 256, SR_SHAPE, dtype=torch.uint8, generator=gen,
                          device=dev)
    n = x.numel()
    rows = {}
    for name, kern, plain, extra in (
            ("sr_quantize", lambda: sr.sr_quantize(x, rand8),
             lambda: sr_ref.stochastic_round_fp8_ref(x, rand8), n),
            ("sr_quantize_onchip", lambda: sr.sr_quantize_onchip(x, 9),
             lambda: sr_ref.stochastic_round_fp8_onchip_ref(x, 9), 0)):
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain, iters=5)
        err = (kern().float() - plain().float()).abs().nan_to_num().max().item()
        b_ms, b_by = bound(4 * n + n + extra, n, F32_OPS_PER_S)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        log(f"{name} time {SR_SHAPE} f32 -> e5m2: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max_abs_err "
            f"{err} [{CARD}]")
    cast = cuda_ms(lambda: x.to(torch.float8_e5m2))
    log(f"same-bytes yardstick, not SR: x.to(float8_e5m2) (RNE cast) "
        f"{cast:.4f} ms [{CARD}]")
    return rows


# ---------------------------------------------------------------------------
# training: the full model, its step against the plain versions, a profile
# ---------------------------------------------------------------------------

# Launches of each kernel per training step of qwen2-1.5b (28 layers x 7
# projections per layout; one attention call per layer).
STEP_LAUNCHES = {"fused_quant_matmul.nn": 196, "fused_quant_matmul.nt": 196,
                 "fused_quant_matmul.tn": 196, "fp8_attention_fwd": 28,
                 "fp8_attention_bwd_dq": 28, "fp8_attention_bwd_dkv": 28,
                 "fp8_matmul": 0, "sr_quantize": 0, "sr_quantize_onchip": 0}
# The paper recipe's step (phase 8): every forward projection GEMM through
# kernel 5; the adjoint GEMMs, attention and the 16-bit head are plain.
PAPER_STEP_LAUNCHES = {k: 0 for k in STEP_LAUNCHES}
PAPER_STEP_LAUNCHES["fp8_matmul"] = 196
# The GEMM's launches per step by tile width (gemm_tile): per layer the
# forward 'down' GEMM (M=2048, N=1536, K=8960) and the 'up' / 'gate' dgrad
# (N=1536, K=8960) take 128x256 tiles, the other 18 GEMMs 128x128; the
# paper step's kernel 5 runs the forward ones only.
STEP_TILE_LAUNCHES = {128: 18 * 28, 256: 3 * 28}
PAPER_STEP_TILE_LAUNCHES = {128: 6 * 28, 256: 1 * 28}
# Training-step parity (2 layers at full width, B=2, S=256): rel L2 of the
# gradients of all leaves together, kernels vs plain versions on the card
# (same generator seeds, SR recipe) and card vs CPU (all-RNE variant). Read
# on the H100 (PERF.md): 0.150 and 0.141 — summation-order notch flips
# grown through the fp8 chain — against 0.83 and NaN for the two planted
# faults that must exceed it; subtler faults sit at the floor (printed).
TRAIN_STEP_TOL = 0.3
LOSS_TOL = 1e-2


def train_cfg(n_layers=None, rne=False):
    import dataclasses
    cfg = model_cfg(n_layers).replace(remat=False)
    if rne:
        quant = dataclasses.replace(cfg.policy.quant, act_rounding="rne",
                                    error_rounding="rne",
                                    grad_rounding="rne")
        cfg = cfg.replace(policy=dataclasses.replace(cfg.policy,
                                                     quant=quant))
    return cfg


def launch_counts():
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fp8_matmul import ops as mm
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    from repro_torch.kernels.stochastic_round import ops as sr
    out = {f"fused_quant_matmul.{d}": n
           for d, n in fq.fused_quant_matmul.launches_by_dims.items()}
    out.update(fp8_attention_fwd=at.fp8_attention_fwd.launches,
               fp8_attention_bwd_dq=at.fp8_attention_bwd_dq.launches,
               fp8_attention_bwd_dkv=at.fp8_attention_bwd_dkv.launches,
               fp8_matmul=mm.fp8_matmul.launches,
               sr_quantize=sr.sr_quantize.launches,
               sr_quantize_onchip=sr.sr_quantize_onchip.launches)
    return out


def reset_launches():
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fp8_matmul import ops as mm
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    from repro_torch.kernels.stochastic_round import ops as sr
    for mod in (fq, at, mm, sr):
        mod.reset_launches()


def train_full(dev):
    """The training main path: qwen2-1.5b at full width and depth, hybrid
    recipe with delayed scaling, enhanced loss scaling from 2^13, Adam
    through the fp16-master optimizer, TRAIN_STEPS steps of B x S seeded
    synthetic tokens. Launch counts are set to 0 just before the steps and
    read just after."""
    import numpy as np
    import torch
    from repro_torch.core.loss_scale import LossScaler
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    from repro_torch.models.transformer import init_lm
    from repro_torch.scaling.calibrate import discover_lm_sites
    from repro_torch.scaling.state import DelayedScaling
    from repro_torch.train.step import make_optimizer_for, make_train_step
    cfg = train_cfg()
    params = init_lm(cfg, seed=0, device=dev)
    data = synthetic_lm_batches(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=TRAIN_S,
                                           batch_size=TRAIN_B, seed=0))
    batches = [next(data) for _ in range(TRAIN_STEPS + 2)]
    t0 = time.perf_counter()
    reg = discover_lm_sites(cfg, params, {k: v[:1, :128]
                                          for k, v in batches[0].items()})
    log(f"train: {len(reg)} scale sites discovered in "
        f"{time.perf_counter() - t0:.1f} s")
    ds = DelayedScaling(reg, qcfg=cfg.policy.quant)
    opt = make_optimizer_for(cfg, learning_rate=1e-4, scaler=LossScaler(
        mode="enhanced", init_scale=2.0 ** 13))
    state = opt.init(params)
    del params
    torch.cuda.empty_cache()
    step = make_train_step(cfg, opt, scaling=ds)
    ss = ds.init()
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times, applied = [], [], 0
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        (state, ss), m = step(state, ss, batches[i], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        applied += m["grads_finite"]
        log(f"train step {i}: loss {m['loss']:.4f}, loss scale "
            f"{m['loss_scale']:.0f}, grads_finite {m['grads_finite']}, "
            f"grad_norm {m['grad_norm']:.4f}, {times[-1] * 1e3:.1f} ms")
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    p50 = float(np.median(times)) * 1e3
    tok_s = TRAIN_B * TRAIN_S / (p50 / 1e3)
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    log(f"train: step p50 {p50:.1f} ms (first {times[0] * 1e3:.1f} ms), "
        f"{tok_s:.0f} tokens/s, max_memory_allocated {peak:.2f} GiB, "
        f"{int(applied)} of {TRAIN_STEPS} updates applied [{CARD}]")
    log(f"train: launches per step {per_step}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if applied < 1:
        raise AssertionError("no update was applied")
    want = {k: v * TRAIN_STEPS for k, v in STEP_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    tiles = dict(fq.fused_quant_matmul.launches_by_tile)
    log(f"train: GEMM launches by tile width {tiles}")
    if tiles != {k: v * TRAIN_STEPS for k, v in STEP_TILE_LAUNCHES.items()}:
        raise AssertionError(f"GEMM launches by tile width {tiles}")
    # S=512 causal: every dQ launch takes the stash variant.
    variants = dict(at.fp8_attention_bwd_dq.launches_by_variant)
    log(f"train: dQ kernel launches by variant {variants}")
    if variants["stash"] != launches["fp8_attention_bwd_dq"]:
        raise AssertionError(f"dQ launches by variant {variants}")
    state_box = [state, ss]

    def one(b):
        (state_box[0], state_box[1]), _ = step(state_box[0], state_box[1], b,
                                               gen)
    prof = profile_train(one, batches[TRAIN_STEPS:])
    return dict(launches=launches, p50_ms=p50, tokens_s=tok_s,
                peak_gib=peak, losses=losses, profile=prof,
                dq_variants=variants, gemm_tiles=tiles)


def profile_train(one_step, batches):
    """Device time per kernel over `one_step(batch)` for each of `batches`
    (training steps), traced by torch.profiler; the fused GEMM by layout
    and the unfused GEMM (which shares its symbol) through their launch
    ranges. A measurement, not a check."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches:
                one_step(b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
    except Exception as e:  # noqa: BLE001 — a measurement, reported
        log(f"train profile: not measured ({type(e).__name__}: {e})")
        return None
    n = len(batches)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in WRAPPER_RANGES]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us <= 0:
        log("train profile: not measured (the trace holds no device time)")
        return None

    def dev_ms(pred):
        return sum(e.self_device_time_total for e in kernels
                   if pred(e.key)) / 1e3 / n

    def range_ms(name):
        rng = [e for e in events if e.key == name]
        return (sum(e.device_time_total for e in rng) / 1e3 / n) if rng \
            else 0.0
    out = {name: dev_ms(lambda k, s=sym: s in k) for name, sym in (
        ("fp8_attention_fwd", "attn_fwd_kernel"),
        ("fp8_attention_bwd_dq", "attn_bwd_dq_kernel"),
        ("fp8_attention_bwd_dkv", "attn_bwd_dkv_kernel"),  # _head, _group_sum
        ("fused_quant_matmul", "fqmm"))}
    out["fp8_matmul"] = range_ms("fp8_matmul")
    out["fused_quant_matmul"] -= out["fp8_matmul"]
    for d in ("nn", "nt", "tn"):
        out[f"fused_quant_matmul.{d}"] = range_ms(f"fused_quant_matmul.{d}")
    ours = sum(out[k] for k in ("fp8_attention_fwd", "fp8_attention_bwd_dq",
                                "fp8_attention_bwd_dkv", "fused_quant_matmul",
                                "fp8_matmul"))
    out["plain_pytorch"] = dev_us / 1e3 / n - ours
    out["device_ms"] = dev_us / 1e3 / n
    out["wall_ms"] = wall * 1e3 / n
    out["idle_share"] = 1 - dev_us / 1e6 / wall
    log(f"train profile ({n} steps under torch.profiler): device "
        f"{out['device_ms']:.1f} ms per step, wall {out['wall_ms']:.1f} ms, "
        f"idle share <= {out['idle_share']:.2f} [{CARD}]")
    log("  per step: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in out.items()
        if k not in ("device_ms", "wall_ms", "idle_share")))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / n:8.2f} ms/step "
            f"{e.count // n:6d} calls/step  {e.key[:90]}")
    return out


def plain_patches():
    """Point the three kernel wrappers at their plain versions (on the
    card), for the step-parity runs."""
    from repro_torch.kernels.fp8_attention import ops as at
    from repro_torch.kernels.fp8_attention import ref as at_ref
    from repro_torch.kernels.fused_quant_matmul import ops as fq
    return [(fq, "fused_quant_matmul", plain_gemm),
            (at, "fp8_attention_fwd", at_ref.fp8_attention_fwd_ref),
            (at, "fp8_attention_bwd", at_ref.fp8_attention_bwd_ref)]


def train_step_parity(dev):
    """One training step's loss and gradients at full width, 2 layers,
    B=2, S=256, from a ScaleState that one kernel step produced, run:
      kernels on the card, twice (bitwise identical);
      plain versions on the card with the same generator seeds (SR);
      planted faults on the plain versions: two that must read above
        TRAIN_STEP_TOL (the softmax VJP's rd dropped from dS; the dgrad
        quantized at 16x its site's scale) and two printed as readings
        (the dgrad at #y.A's scale; dS left unquantized), which the
        step's floor hides — the kernel checks of phase 2 and the CPU
        tests hold those;
      and, under the all-RNE variant, kernels on the card against the
        plain versions on the CPU.
    Kernels vs plain and card vs CPU must read a gradient rel L2 below
    TRAIN_STEP_TOL."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.core import qlinear as qlin
    from repro_torch.kernels.fp8_attention import ref as at_ref
    from repro_torch.models.transformer import init_lm, lm_loss
    from repro_torch.optim.optimizers import tmap
    from repro_torch.scaling import context as sctx
    from repro_torch.scaling.calibrate import discover_lm_sites
    from repro_torch.scaling.state import DelayedScaling
    from repro_torch.train.step import make_optimizer_for, make_train_step
    cfg = train_cfg(2)
    params = init_lm(cfg, seed=0, device=dev)
    cpu_params = _to_cpu(params)
    batch = next(synthetic_lm_batches(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=256, batch_size=2, seed=1)))
    reg = discover_lm_sites(cfg, params, batch)
    ds = DelayedScaling(reg, qcfg=cfg.policy.quant)
    opt = make_optimizer_for(cfg)
    (_, ss1), _ = make_train_step(cfg, opt, scaling=ds)(
        opt.init(params), ds.init(), batch,
        torch.Generator(device=dev).manual_seed(5))

    def run(c, p, d, *patches):
        before = launch_counts()
        with contextlib.ExitStack() as stack:
            for obj, name, value in patches:
                stack.enter_context(mock.patch.object(obj, name, value))
            o = make_optimizer_for(c)
            st = o.init(p)
            prm = tmap(lambda x: x.requires_grad_(True),
                       o.compute_params(st))
            with DelayedScaling(reg, qcfg=c.policy.quant).collect(ss1):
                loss, _ = lm_loss(prm, batch, cfg=c, qgen=torch.Generator(
                    device=d).manual_seed(0), loss_scale=st.loss_scale.scale)
                loss.backward()
            grads = tmap(lambda x: x.grad.float().cpu(), prm)
        launched = sum(launch_counts()[k] - before[k] for k in before)
        return loss.item(), grads, launched

    def flat(t):
        return [x for x in _leaves(t)]

    def rel(a, b):
        fa, fb = flat(a), flat(b)
        num = sum(float((x - y).double().pow(2).sum())
                  for x, y in zip(fa, fb))
        den = sum(float(y.double().pow(2).sum()) for y in fb)
        leaf = max(float((x - y).norm() / max(y.norm(), 1e-30))
                   for x, y in zip(fa, fb))
        return (num / den) ** 0.5, leaf

    lk, gk, n_k = run(cfg, params, dev)
    lk2, gk2, _ = run(cfg, params, dev)
    lp, gp, n_p = run(cfg, params, dev, *plain_patches())
    if n_k <= 0 or n_p != 0:
        raise AssertionError(f"launches: kernels {n_k}, plain {n_p}")
    if lk != lk2 or not all(torch.equal(x, y)
                            for x, y in zip(flat(gk), flat(gk2))):
        raise AssertionError("two kernel runs of the step differ")
    faults = {
        "dgrad at #y.A's scale": [(sctx, "fused_output_keys",
                                   lambda k, c: {"y": f"{k}#y.A",
                                                 "err": f"{k}#y.A"})],
        "attention dS unquantized": [(at_ref, "_ds_block",
                                      lambda p_d, dp_d, rd, bits, *, f_ds,
                                      **_: (p_d * (dp_d - rd)) * f_ds)]}
    ds_block, fused_gemm = at_ref._ds_block, qlin._fused_gemm

    def ds_without_rd(p_d, dp_d, rd, bits, **kw):
        return ds_block(p_d, dp_d, torch.zeros_like(rd), bits, **kw)

    def dgrad_x16(x8, w8, sx, sw, s_out, c, out_cls, dims, generator=None):
        if dims == "nt":
            s_out = s_out * np.float32(16)
        return fused_gemm(x8, w8, sx, sw, s_out, c, out_cls, dims, generator)

    faults["attention rd dropped"] = [(at_ref, "_ds_block", ds_without_rd)]
    faults["dgrad at 16x its scale"] = [(qlin, "_fused_gemm", dgrad_x16)]
    r_kp, leaf_kp = rel(gk, gp)
    rcfg = train_cfg(2, rne=True)
    lr_, gr, _ = run(rcfg, params, dev)
    lc, gc, _ = run(rcfg, cpu_params, "cpu")
    r_cpu, leaf_cpu = rel(gr, gc)
    log(f"train step parity (2 layers, full width, B=2, S=256), gradient "
        f"rel L2 (tolerance {TRAIN_STEP_TOL}): kernels vs plain on the card "
        f"{r_kp:.3e} (worst leaf {leaf_kp:.3e}; loss {lk:.6f} vs {lp:.6f}); "
        f"two kernel runs bitwise equal; all-RNE card vs CPU {r_cpu:.3e} "
        f"(worst leaf {leaf_cpu:.3e}; loss {lr_:.6f} vs {lc:.6f})")
    weak = []
    must = ("attention rd dropped", "dgrad at 16x its scale")
    for name, pt in faults.items():
        lf, gf, _ = run(cfg, params, dev, *plain_patches(), *pt)
        r_f, leaf_f = rel(gf, gp)
        log(f"  planted fault '{name}': vs plain {r_f:.3e} (worst leaf "
            f"{leaf_f:.3e}, loss {lf:.6f})"
            + ("" if name in must else " — a reading, not checked"))
        if name in must and r_f <= TRAIN_STEP_TOL:   # NaN reads as seen
            weak.append(f"'{name}' reads {r_f:.3e}")
    if not (r_kp < TRAIN_STEP_TOL and abs(lk - lp) <= LOSS_TOL * abs(lp)):
        raise AssertionError(f"kernels vs plain: rel L2 {r_kp}, loss {lk} "
                             f"vs {lp}")
    if not (r_cpu < TRAIN_STEP_TOL and abs(lr_ - lc) <= LOSS_TOL * abs(lc)):
        raise AssertionError(f"card vs CPU: rel L2 {r_cpu}, loss {lr_} vs "
                             f"{lc}")
    if weak:
        raise AssertionError("a planted fault goes unseen: " + "; ".join(weak))
    return dict(kernels_vs_plain=r_kp, card_vs_cpu=r_cpu)


# ---------------------------------------------------------------------------
# phases 8-9: the paper's own recipe (unit scales, no delayed scaling) on the
# unfused kernel path
# ---------------------------------------------------------------------------

def paper_cfg(n_layers=None, rne=False):
    """qwen2-1.5b under `QuantConfig()` (the paper's recipe: e5m2 W/A/E/G,
    RNE on W, SR on A/E/G, W/A saturating, unit scales) on the kernel
    backend, no remat; rne=True rounds every class RNE."""
    import dataclasses
    from repro_torch.core.precision_policy import QuantConfig
    from repro_torch.models.registry import build_config
    quant = QuantConfig(backend="pallas")
    if rne:
        quant = dataclasses.replace(quant, act_rounding="rne",
                                    error_rounding="rne", grad_rounding="rne")
    cfg = build_config("qwen2-1.5b").replace(remat=False)
    cfg = cfg.replace(policy=dataclasses.replace(cfg.policy, quant=quant))
    return cfg if n_layers is None else cfg.replace(n_layers=n_layers)


def paper_optimizer(cfg):
    from repro_torch.core.loss_scale import LossScaler
    from repro_torch.train.step import make_optimizer_for
    return make_optimizer_for(cfg, learning_rate=1e-4, scaler=LossScaler(
        mode="enhanced", init_scale=1024.0, min_scale_schedule=()))


def train_paper(dev):
    """Phase 8: qwen2-1.5b at full width and depth under the paper's recipe
    (the reference quickstart's loss scaler: enhanced, from 1024, no
    minimum schedule), Adam through the fp16-master optimizer, TRAIN_STEPS
    steps of B x S seeded synthetic tokens with `make_train_step(cfg, opt)`
    (no scaling). Launch counts are set to 0 just before the steps and read
    just after: kernel 5 runs every forward projection GEMM."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.kernels.fp8_matmul import ops as mm
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.step import make_train_step
    cfg = paper_cfg()
    data = synthetic_lm_batches(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=TRAIN_S,
                                           batch_size=TRAIN_B, seed=0))
    batches = [next(data) for _ in range(TRAIN_STEPS + 2)]
    opt = paper_optimizer(cfg)
    state = opt.init(init_lm(cfg, seed=0, device=dev))
    torch.cuda.empty_cache()
    step = make_train_step(cfg, opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times, applied = [], [], 0
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batches[i], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        applied += m["grads_finite"]
        log(f"paper step {i}: loss {m['loss']:.4f}, loss scale "
            f"{m['loss_scale']:.0f}, grads_finite {m['grads_finite']}, "
            f"grad_norm {m['grad_norm']:.4f}, {times[-1] * 1e3:.1f} ms")
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    p50 = float(np.median(times)) * 1e3
    tok_s = TRAIN_B * TRAIN_S / (p50 / 1e3)
    log(f"paper train: step p50 {p50:.1f} ms (first {times[0] * 1e3:.1f} ms)"
        f", {tok_s:.0f} tokens/s, max_memory_allocated {peak:.2f} GiB, "
        f"{int(applied)} of {TRAIN_STEPS} updates applied [{CARD}]")
    log(f"paper train: launches per step "
        f"{ {k: v / TRAIN_STEPS for k, v in launches.items()} }")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if applied < 1:
        raise AssertionError("no update was applied")
    want = {k: v * TRAIN_STEPS for k, v in PAPER_STEP_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    tiles = dict(mm.fp8_matmul.launches_by_tile)
    log(f"paper train: kernel-5 launches by tile width {tiles}")
    if tiles != {k: v * TRAIN_STEPS
                 for k, v in PAPER_STEP_TILE_LAUNCHES.items()}:
        raise AssertionError(f"kernel-5 launches by tile width {tiles}")
    box = [state]

    def one(b):
        box[0], _ = step(box[0], b, gen)
    prof = profile_train(one, batches[TRAIN_STEPS:])
    sr_path = sr_weights(dev, box[0], opt)
    return dict(launches=launches, p50_ms=p50, tokens_s=tok_s,
                peak_gib=peak, losses=losses, profile=prof, sr_path=sr_path,
                gemm_tiles=tiles)


def sr_weights(dev, state, opt):
    """The stochastic-rounding op's own path (no training step reaches it,
    in the reference or here): SR-quantize every projection weight of the
    trained model (its bf16 compute copy) to e5m2 through
    `stochastic_round_fp8`, once with bits from a generator (kernel 6) and
    once with the in-kernel hash (kernel 7); counts set to 0 just before
    and read just after. Each payload must lie on a neighbour of its value:
    |q - w| below one e5m2 spacing of w (2^-2 relative, or the subnormal
    step)."""
    import torch
    from repro_torch.kernels.stochastic_round import ops as sr
    params = opt.compute_params(state)
    weights = [leaf for name, layer in params["decoder"].items()
               for part in ("attn", "mlp")
               for key, leaf in layer[part].items() if leaf.dim() == 2]
    gen = torch.Generator(device=dev).manual_seed(3)
    reset_launches()
    worst = 0.0
    for i, w in enumerate(weights):
        for q in (sr.stochastic_round_fp8(w, gen),
                  sr.stochastic_round_fp8(w, i, use_onchip_prng=True)):
            wf = w.float()
            step = torch.maximum(wf.abs() * 0.25,
                                 torch.full_like(wf, 2.0 ** -16))
            worst = max(worst, ((q.float() - wf).abs() / step).max().item())
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"sr op path: {len(weights)} weights SR-quantized twice, launches "
        f"sr_quantize {launches['sr_quantize']}, sr_quantize_onchip "
        f"{launches['sr_quantize_onchip']}, worst |q - w| / spacing "
        f"{worst:.3f}")
    if worst > 1.0 or min(launches["sr_quantize"],
                          launches["sr_quantize_onchip"]) != len(weights):
        raise AssertionError(f"sr op path: launches {launches}, worst "
                             f"{worst}")
    return launches


def train_paper_parity(dev):
    """Phase 9: one paper-recipe training step's loss and gradients at full
    width, 2 layers, B=2, S=256, run: kernels on the card, twice (bitwise
    identical); the plain versions on the card with the same generator
    seed (kernel 5 pointed at its plain version); a planted kernel-5 fault
    (its last 64-wide K block dropped), which must read above
    TRAIN_STEP_TOL; and, all-RNE, kernels on the card against the plain
    versions on the CPU. Kernels vs plain and card vs CPU must read a
    gradient rel L2 below TRAIN_STEP_TOL."""
    import contextlib
    from unittest import mock

    import torch
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.kernels.fp8_matmul import ops as mm
    from repro_torch.kernels.fp8_matmul import ref as mm_ref
    from repro_torch.models.transformer import init_lm, lm_loss
    from repro_torch.optim.optimizers import tmap
    cfg = paper_cfg(2)
    params = init_lm(cfg, seed=0, device=dev)
    cpu_params = _to_cpu(params)
    batch = next(synthetic_lm_batches(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=256, batch_size=2, seed=1)))
    launch = mm._launch

    def run(c, p, d, *patches):
        before = launch_counts()
        with contextlib.ExitStack() as stack:
            for obj, name, value in patches:
                stack.enter_context(mock.patch.object(obj, name, value))
            o = paper_optimizer(c)
            st = o.init(p)
            prm = tmap(lambda x: x.requires_grad_(True),
                       o.compute_params(st))
            loss, _ = lm_loss(prm, batch, cfg=c, qgen=torch.Generator(
                device=d).manual_seed(0), loss_scale=st.loss_scale.scale)
            loss.backward()
            grads = tmap(lambda x: x.grad.float().cpu(), prm)
        after = launch_counts()
        return loss.item(), grads, after["fp8_matmul"] - before["fp8_matmul"]

    def rel(a, b):
        fa, fb = list(_leaves(a)), list(_leaves(b))
        num = sum(float((x - y).double().pow(2).sum()) for x, y in zip(fa, fb))
        den = sum(float(y.double().pow(2).sum()) for y in fb)
        return (num / den) ** 0.5

    def drop_last_k(a, b, out_dtype):
        """The kernel launched without its last 64-wide K block."""
        k = a.shape[1] - 64
        return launch(a[:, :k].contiguous(), b[:k].contiguous(), out_dtype)

    plain = [(mm, "fp8_matmul", mm_ref.fp8_matmul_ref)]
    lk, gk, n_k = run(cfg, params, dev)
    lk2, gk2, _ = run(cfg, params, dev)
    lp, gp, n_p = run(cfg, params, dev, *plain)
    lf, gf, n_f = run(cfg, params, dev, (mm, "_launch", drop_last_k))
    if n_k != 2 * 7 or n_p != 0 or n_f != 2 * 7:
        raise AssertionError(f"kernel-5 launches: kernels {n_k}, plain "
                             f"{n_p}, fault {n_f}")
    if lk != lk2 or not all(torch.equal(x, y) for x, y in
                            zip(_leaves(gk), _leaves(gk2))):
        raise AssertionError("two kernel runs of the step differ")
    rcfg = paper_cfg(2, rne=True)
    lr_, gr, _ = run(rcfg, params, dev)
    lc, gc, _ = run(rcfg, cpu_params, "cpu")
    r_kp, r_cpu, r_f = rel(gk, gp), rel(gr, gc), rel(gf, gp)
    log(f"paper step parity (2 layers, full width, B=2, S=256), gradient "
        f"rel L2 (tolerance {TRAIN_STEP_TOL}): kernels vs plain on the card "
        f"{r_kp:.3e} (loss {lk:.6f} vs {lp:.6f}); two kernel runs bitwise "
        f"equal; all-RNE card vs CPU {r_cpu:.3e} (loss {lr_:.6f} vs "
        f"{lc:.6f}); planted fault 'kernel 5 drops its last K block' "
        f"{r_f:.3e} (loss {lf:.6f})")
    if not (r_kp < TRAIN_STEP_TOL and abs(lk - lp) <= LOSS_TOL * abs(lp)):
        raise AssertionError(f"kernels vs plain: rel L2 {r_kp}, loss {lk} "
                             f"vs {lp}")
    if not (r_cpu < TRAIN_STEP_TOL and abs(lr_ - lc) <= LOSS_TOL * abs(lc)):
        raise AssertionError(f"card vs CPU: rel L2 {r_cpu}, loss {lr_} vs "
                             f"{lc}")
    if r_f <= TRAIN_STEP_TOL:   # NaN reads as seen
        raise AssertionError(f"the planted kernel-5 fault reads {r_f:.3e}")
    return dict(kernels_vs_plain=r_kp, card_vs_cpu=r_cpu, fault=r_f)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on the "
              "card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build as kbuild
        from repro_torch.kernels.fp8_attention import ops as at
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    global CARD
    CARD = card = card_line()
    log(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}")
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    # The probe builds of the attention forward and of the dK/dV kernel
    # (they record the schedule they ran) beside the four libraries, all
    # nvcc processes at once.
    from repro_torch.kernels.fp8_attention import probe as at_probe
    probe_dirs = [kbuild.build_dir() / n for n in ("fwd_probe", "dkv_probe")]
    for d in probe_dirs:
        d.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        probe_build = pool.submit(at_probe.build_fwd_probe, probe_dirs[0])
        dkv_build = pool.submit(at_probe.build_dkv_probe, probe_dirs[1])
        kbuild.build(kbuild.KERNELS)
        fwd_probe = probe_build.result()[0]
        dkv_probe = dkv_build.result()[0]
    for name in kbuild.KERNELS:
        rep = [ln.strip() for ln in kbuild.BUILD_LOGS.get(name, "").splitlines()
               if "registers" in ln or "spill" in ln or "smem" in ln]
        log(f"built {name} from src/repro_torch/csrc/{name}.cu: "
            + " | ".join(rep))
    bwd = kbuild.load("fp8_attention_bwd")
    log(f"dynamic shared memory per block: fp8_attention_bwd dQ (long-span "
        f"variant) {bwd.attn_bwd_dq_smem_bytes()} bytes")
    log(f"build: {time.perf_counter() - t0:.1f} s")

    # Every phase runs even if an earlier one failed (one call to the card
    # then reports every fault); any failure fails the script at the end.
    failures = []
    info = (ctypes.c_int * 4)()
    cap = at.STASH_BLOCKS
    err = bwd.attn_bwd_dq_stash_info(cap, info)
    log(f"fp8_attention_bwd dQ stash variant at its cap of {cap} kv blocks: "
        f"{info[0]} bytes of dynamic shared memory, {info[1]} registers and "
        f"{info[2]} local (spill) bytes a thread, {info[3]} blocks per SM "
        f"(cudaError {err})")
    if err or info[3] < 2:
        failures.append(f"dQ stash variant: cudaError {err}, {info[3]} "
                        "blocks per SM (2 expected)")
    dkv_info = (ctypes.c_int * 6)()
    err = bwd.attn_bwd_dkv_info(dkv_info)
    log(f"fp8_attention_bwd dK/dV kernel (attn_bwd_dkv_kernel_head): "
        f"{dkv_info[0]} bytes of dynamic shared memory, {dkv_info[1]} "
        f"registers and {dkv_info[2]} local (spill) bytes a thread, "
        f"{dkv_info[3]} blocks per SM; its group sum "
        f"(attn_bwd_dkv_kernel_group_sum): {dkv_info[4]} registers and "
        f"{dkv_info[5]} local (spill) bytes a thread (cudaError {err})")
    if err or dkv_info[2] or dkv_info[5] \
            or dkv_info[3] < DKV_BLOCKS_PER_SM:
        failures.append(f"dK/dV kernel: cudaError {err}, {dkv_info[2]} and "
                        f"{dkv_info[5]} spill bytes (0 expected), "
                        f"{dkv_info[3]} blocks per SM "
                        f"({DKV_BLOCKS_PER_SM} expected)")
    nk = TRAIN_S // at.LANE
    err = kbuild.load("fp8_attention_fwd").attn_fwd_info(nk, info)
    log(f"fp8_attention_fwd at S={TRAIN_S}: {info[0]} bytes of dynamic shared "
        f"memory, {info[1]} registers and {info[2]} local (spill) bytes a "
        f"thread, {info[3]} blocks per SM (cudaError {err})")
    if err or info[2] or info[3] < 1:
        failures.append(f"attention forward: cudaError {err}, {info[2]} spill "
                        f"bytes (0 expected), {info[3]} blocks per SM")
    gemm_info = gemm_variant_info(kbuild.load("fused_quant_matmul"))
    for v in gemm_info:
        log(f"fused_quant_matmul variant {v['name']}: {v['smem']} bytes of "
            f"dynamic shared memory, {v['registers']} registers and "
            f"{v['spill_bytes']} local (spill) bytes a thread, "
            f"{v['blocks_per_sm']} blocks per SM (cudaError {v['error']})")
        if v["error"] or v["blocks_per_sm"] < v["blocks_wanted"]:
            failures.append(f"GEMM variant {v['name']}: cudaError "
                            f"{v['error']}, {v['blocks_per_sm']} blocks per "
                            f"SM ({v['blocks_wanted']} expected)")

    def phase(fn, *args):
        t_p = time.perf_counter()
        try:
            return fn(*args)
        except Exception as e:   # noqa: BLE001 — reported, then re-failed
            failures.append(f"{fn.__name__}: {type(e).__name__}: {e}")
            log(f"FAILED {failures[-1]}")
            return None
        finally:
            log(f"[{fn.__name__}: {time.perf_counter() - t_p:.1f} s]")

    phase(check_gemm, dev)
    phase(time_gemm, dev)
    phase(check_gemm_train, dev)
    phase(check_gemm_ragged, dev)
    gemm_rows = phase(time_gemm_train, dev)
    phase(check_fp8_matmul, dev)
    mm_rows = phase(time_fp8_matmul, dev)
    phase(check_sr, dev)
    sr_rows = phase(time_sr, dev)
    phase(check_attention_exact, dev)
    phase(check_attention_schedule, dev, fwd_probe)
    phase(check_attention, dev)
    phase(check_attention_bwd, dev)
    phase(check_attention_bwd_overflow, dev)
    phase(check_dkv_schedule, dev, dkv_probe)
    attn_rows = phase(time_attention_bwd, dev)
    calib = phase(calibrate_full, dev)
    if calib is not None:
        cfg, params, frozen = calib
        served = phase(serve_full, dev, cfg, params, frozen)
        if served is not None:
            log(f"serving launches: {served[0]}")
        del params, calib
        torch.cuda.empty_cache()
        phase(step_parity, dev, frozen)
    trained = phase(train_full, dev)
    torch.cuda.empty_cache()
    phase(train_step_parity, dev)
    gc.collect()
    torch.cuda.empty_cache()
    paper = phase(train_paper, dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase(train_paper_parity, dev)
    if failures:
        log(f"{len(failures)} phase(s) failed:\n  " + "\n  ".join(failures))
        return 1

    launches = trained["launches"]
    big = next(r for r in gemm_rows
               if r["dims"] == "nn" and (r["c"], r["n"]) == (1536, 8960))
    src = "src/repro_torch/csrc/"
    pal = "src/repro/kernels/"
    entries = [
        ("fused_quant_matmul", src + "fused_quant_matmul.cu",
         pal + "fused_quant_matmul/kernel.py:206",
         sum(v for k, v in launches.items()
             if k.startswith("fused_quant_matmul")), big),
        ("fp8_attention_fwd", src + "fp8_attention_fwd.cu",
         pal + "fp8_attention/kernel.py:154", launches["fp8_attention_fwd"],
         attn_rows["fwd"]),
        ("fp8_attention_bwd_dq", src + "fp8_attention_bwd.cu",
         pal + "fp8_attention/kernel.py:537",
         launches["fp8_attention_bwd_dq"], attn_rows["dq"]),
        ("fp8_attention_bwd_dkv", src + "fp8_attention_bwd.cu",
         pal + "fp8_attention/kernel.py:571",
         launches["fp8_attention_bwd_dkv"], attn_rows["dkv"]),
        # The paper recipe's training run (phase 8) and the SR op's path.
        ("fp8_matmul", src + "fused_quant_matmul.cu",
         pal + "fp8_matmul/kernel.py:47", paper["launches"]["fp8_matmul"],
         next(r for r in mm_rows if (r["k"], r["n"]) == (1536, 8960))),
        ("sr_quantize", src + "stochastic_round.cu",
         pal + "stochastic_round/kernel.py:58",
         paper["sr_path"]["sr_quantize"], sr_rows["sr_quantize"]),
        ("sr_quantize_onchip", src + "stochastic_round.cu",
         pal + "stochastic_round/kernel.py:81",
         paper["sr_path"]["sr_quantize_onchip"],
         sr_rows["sr_quantize_onchip"]),
    ]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [dict(name=name, route="cuda", source=source, replaces=rep,
                    launches=n, **{k: row[k] for k in keys})
               for name, source, rep, n, row in entries]
    # Kernel 3's two variants: the stash one at the training shape (phase
    # 6's launches), the long-span one where the host selects it.
    # The GEMM's tile widths: launches from phase 6 (kernel 1) and phase 8
    # (kernel 5); times at the largest forward ('nn') training shape that
    # takes each width; each layout's build of it.
    for i, trn, rows, out in ((0, trained, gemm_rows, "fp8"),
                              (4, paper, mm_rows, "f32")):
        kernels[i]["variants"] = []
        for bn in (128, 256):
            row = max((r for r in rows
                       if r["tile"] == bn and r.get("dims", "nn") == "nn"),
                      key=lambda r: r["n"] * r.get("c", r.get("k")))
            kernels[i]["variants"].append(dict(
                name=f"128x{bn}", symbol=f"fqmm_kernel<*, *, *, {bn}>",
                launches=trn["gemm_tiles"][bn],
                shape=f"nn M={TRAIN_B * TRAIN_S} "
                      f"K={row['c'] if 'c' in row else row['k']} N={row['n']}",
                builds=[dict(layout=v["dims"], smem=v["smem"],
                             registers=v["registers"],
                             spill_bytes=v["spill_bytes"],
                             blocks_per_sm=v["blocks_per_sm"])
                        for v in gemm_info if v["out"] == out
                        and v["bn"] == bn],
                **{k: row[k] for k in keys}))
    kernels[2]["variants"] = [
        dict(name="stash", symbol="attn_bwd_dq_kernel_stash",
             launches=trained["dq_variants"]["stash"],
             shape="causal B=4 H=12 Hkv=2 S=512 D=128",
             **{k: attn_rows["dq"][k] for k in keys}),
        dict(name="long", symbol="attn_bwd_dq_kernel",
             launches=trained["dq_variants"]["long"],
             shape=attn_rows["dq_long"]["shape"],
             **{k: attn_rows["dq_long"][k] for k in keys})]
    # Kernel 4's two kernels, each by its device time (profiler).
    kernels[3]["parts"] = attn_rows["dkv"]["parts"]
    log(f"total {time.perf_counter() - t_all:.1f} s; training "
        f"{trained['tokens_s']:.0f} tokens/s (hybrid, delayed scaling), "
        f"{paper['tokens_s']:.0f} tokens/s (paper recipe) on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
