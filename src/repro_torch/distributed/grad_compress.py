"""The e5m2 error-feedback gradient all-reduce (counterpart of
`repro.distributed.grad_compress`).

The paper makes FP8 a storage format for W/A/E/G; here it is also the wire
format of the data-parallel gradient reduction. Per gradient leaf, on each
rank of the wire group:

  1. e      <- the rank's error-feedback residual (f32, the leaf's shape)
  2. y      =  g + e
  3. scale  =  max over ranks of amax(|y|) / max_normal, floored at 1e-30
  4. q      =  RNE_fp8(y / scale), saturating (1 byte an element)
  5. reduce-scatter: the flat payload, zero-padded to a multiple of N,
     goes out in N chunks by an all-to-all of uint8; each rank upcasts
     what it receives to f32 and sums it in rank order, times scale
  6. q2     =  RNE_fp8(partial / scale2), scale2 shared as in 3; the
     all-gather leg moves q2's bytes
  7. mean   =  dequant(gathered) / N ;  e' = y - dequant(q)

Every rank decodes the same gathered bytes with the same scale2, so the
mean is the same on every rank, bit for bit. Wire bytes a rank sends:
2 (N - 1) / N x the padded element count, one byte each — half of a bf16
ring all-reduce.

The reference holds one JAX controller's N devices on a leading "stacked"
axis; in the port each rank holds its own gradient and its own residual.
`models.convert.stack_wire_error` / `unstack_wire_error` convert between
the two layouts (tests, checkpoints).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fp8_formats import E5M2, FloatFormat
from repro_torch.core.quantize import quantize_rne
from repro_torch.distributed import comm
from repro_torch.optim.optimizers import tmap

_SCALE_FLOOR = 1e-30


def _shared_scale(x: torch.Tensor, group, fmt: FloatFormat) -> torch.Tensor:
    """max over ranks of amax(|x|) / max_normal, floored at 1e-30 (0-d
    f32)."""
    amax = comm.all_reduce(x.abs().max().reshape(1), "max", group)[0]
    return torch.clamp_min(amax / fmt.max_normal, _SCALE_FLOOR)


def fp8_allreduce_mean(y: torch.Tensor, *, group, fmt: FloatFormat = E5M2
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed all-reduce-mean of the f32 tensor `y` over `group`.
    Returns (mean, the rank's dequantized contribution); the caller's
    residual is y - contribution."""
    n = comm.group_size(group)
    scale = _shared_scale(y, group, fmt)
    q = quantize_rne(y / scale, fmt, saturate=True)
    flat = q.reshape(-1).view(torch.uint8)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    recv = comm.all_to_all_bytes(flat.reshape(n, -1), group).view(fmt.dtype)
    acc = recv[0].float()
    for i in range(1, n):
        acc = acc + recv[i].float()
    partial = acc * scale
    scale2 = _shared_scale(partial, group, fmt)
    q2 = quantize_rne(partial / scale2, fmt, saturate=True)
    gathered = comm.all_gather_bytes(q2.view(torch.uint8), group)
    total = gathered.view(fmt.dtype).float().reshape(-1) * scale2
    if pad:
        total = total[:-pad]
    mean = (total / n).reshape(y.shape)
    local = (q.float() * scale).reshape(y.shape)
    return mean, local


def compressed_psum_mean(grads: Any, error: Optional[Any], *, group,
                         fmt: FloatFormat = E5M2) -> Tuple[Any, Any]:
    """Tree-wise compressed mean with error feedback: (reduced grads in
    each leaf's dtype, new residuals). `error` None starts from zeros."""
    if error is None:
        error = tmap(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                           device=g.device), grads)

    def one(g, e):
        y = g.float() + e
        mean, local = fp8_allreduce_mean(y, group=group, fmt=fmt)
        return mean.to(g.dtype), y - local

    return _unzip(tmap(one, grads, error))


def _unzip(pairs):
    """A tree of (a, b) leaves -> (tree of a, tree of b)."""
    if isinstance(pairs, dict):
        both = {k: _unzip(v) for k, v in pairs.items()}
        return ({k: v[0] for k, v in both.items()},
                {k: v[1] for k, v in both.items()})
    return pairs


def make_compressed_dp_allreduce(group, *, fmt: FloatFormat = E5M2
                                 ) -> Callable:
    """allreduce(grads, error) -> (the compressed mean over `group`, the
    new residuals), on the port's per-rank layout."""
    def allreduce(grads, error):
        return compressed_psum_mean(grads, error, group=group, fmt=fmt)
    return allreduce


def make_full_dp_allreduce(group) -> Callable:
    """The uncompressed twin: an f32 SUM all-reduce divided by N, the
    residuals returned unchanged."""
    def allreduce(grads, error):
        n = comm.group_size(group)
        return tmap(lambda g: comm.all_reduce(g.float(), "sum", group) / n,
                    grads), error
    return allreduce


def wire_bytes_model(tree: Any, n: int) -> dict:
    """Cost model of one step's gradient reduction, ring-style: 2 (N - 1) /
    N x numel payload bytes a rank, at 1 byte an element for fp8_ef and 2
    for the bf16 baseline. Leaves: tensors, arrays or shape tuples."""
    numel = int(sum(int(np.prod(tuple(getattr(x, "shape", x)),
                                dtype=np.int64))
                    for x in _leaves(tree)))
    hops = 2.0 * (n - 1) / n if n > 1 else 0.0
    full = hops * numel * 2.0
    fp8 = hops * numel * 1.0
    return {"numel": numel, "dp_size": int(n),
            "bytes_full_bf16": full, "bytes_fp8_ef": fp8,
            "ratio_fp8_vs_bf16": (fp8 / full) if full else 0.0}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
