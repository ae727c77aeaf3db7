"""Tensor parallelism over the 'model' dim of a training step: the active
group, the Megatron conjugates, and whole-tensor SR bits.

The reference's tensor parallelism is GSPMD: its numerics are those of the
one-device program, every per-tensor amax the whole tensor's and every Q
node quantizing a whole sum. The port runs one program a rank on the
rank's shards (`ParallelPlan`'s TP layout) and keeps that oracle:

 * a partial product over a sharded contraction (a row-parallel site's
   forward, a column-parallel site's input gradient) is summed in f32
   over the group, in rank order, BEFORE its Q node (`core.qlinear`);
 * every SR bit is drawn for the whole tensor, in the one process's
   order, and each rank keeps its slice (`bits`), so the generators of
   the ranks stay in step with one another and with one process;
 * the step max-reduces its amax observations over the group and averages
   the health pairs of sharded payloads (`train.step`).

The training step enters the group (`active`) around its loss and
backward passes, with the plan's layout of the step's parameters
(`with_layout`); the layers read it (`current()`), ask it which of their
weights are split and along which dim (`dim_of`), and call the
conjugates below. Every combine runs in rank order, so a replicated
tensor holds the same bytes on every rank. Collectives go through
`distributed.comm` and count their bytes as "tp".
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import (Any, Callable, Iterable, Mapping, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.distributed import comm
from repro_torch.distributed.global_batch import param_leaf

KIND = "tp"
_ACTIVE: Optional["TPGroup"] = None


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The 'model' process group of this rank: its torch group, this
    rank's index in it and its size; `dims`, the layout of the step's
    parameters: id of a parameter leaf -> the dim it is split along over
    the group (`ParallelPlan.tp_dims`; a leaf absent is replicated)."""
    group: object
    rank: int
    size: int
    dims: Mapping[int, int] = dataclasses.field(default_factory=dict)

    def with_layout(self, pairs: Iterable[Tuple[torch.Tensor, Any]]
                    ) -> "TPGroup":
        """This group with the layout of the step's parameters: `pairs`,
        (leaf, its TP dim or None: replicated)."""
        return dataclasses.replace(self, dims={
            id(p): d for p, d in pairs if d is not None})

    def dim_of(self, w: torch.Tensor) -> Optional[int]:
        """The dim along which the parameter `w` (a leaf of the layout, or
        a function of one leaf alone, such as its transpose) is split over
        the group, in the leaf's own dims; None: replicated."""
        if id(w) in self.dims:
            return self.dims[id(w)]
        leaf = param_leaf(w)
        return None if leaf is None else self.dims.get(id(leaf))


def current() -> Optional[TPGroup]:
    return _ACTIVE


@contextlib.contextmanager
def active(tp: Optional[TPGroup]):
    """Make `tp` the current group (None: none) for the block."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, tp
    try:
        yield tp
    finally:
        _ACTIVE = saved


# ---------------------------------------------------------------------------
# collectives without autograd
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """(n, *x.shape): every rank's `x`, row i from rank i. A 16-bit tensor
    travels as its bytes (gloo reduces no bf16)."""
    if x.dtype in (torch.float32, torch.float64, torch.int32, torch.int64):
        return comm.all_gather(x, tp.group, kind=KIND)
    raw = comm.all_gather(x.contiguous().view(torch.uint8), tp.group,
                          kind=KIND)
    return raw.view(x.dtype)


def rank_sum(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The sum of every rank's `x`, added in rank order (identical bytes on
    every rank), in x's dtype."""
    rows = _rows(x, tp)
    acc = rows[0]
    for i in range(1, rows.shape[0]):
        acc = acc + rows[i]
    return acc


def rank_max(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return comm.all_reduce(x, "max", tp.group, kind=KIND)


def gather_cat(x: torch.Tensor, dim: int, tp: TPGroup) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order."""
    return torch.cat(list(_rows(x, tp).unbind(0)), dim=dim)


# ---------------------------------------------------------------------------
# the conjugates (autograd Functions)
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed over the ranks (before a
    site whose ranks each take part of a replicated input's use)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return rank_sum(g.contiguous(), ctx.tp), None


class _ReduceFrom(torch.autograd.Function):
    """The ranks' partials summed in the forward; identity backward (the
    sum is replicated, and so is its gradient)."""

    @staticmethod
    def forward(ctx, x, tp):
        return rank_sum(x.contiguous(), tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The ranks' shards joined along `dim`; the gradient of the whole
    (replicated) tensor sliced back to this rank's shard."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp, ctx.n = dim, tp, x.shape[dim]
        return gather_cat(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n), None, None


class _Slice(torch.autograd.Function):
    """This rank's shard of a replicated tensor along `dim`; the gradient
    gathered whole from the ranks' shards."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        n = x.shape[dim] // tp.size
        return x.narrow(dim, tp.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_cat(g.contiguous(), ctx.dim, ctx.tp), None, None


def copy_to(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return _CopyTo.apply(x, tp)


def reduce_from(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    return _ReduceFrom.apply(x, tp)


def gather(x: torch.Tensor, dim: int, tp: TPGroup) -> torch.Tensor:
    return _Gather.apply(x, dim % x.dim(), tp)


def scatter(x: torch.Tensor, dim: int, tp: TPGroup) -> torch.Tensor:
    return _Slice.apply(x, dim % x.dim(), tp)


# ---------------------------------------------------------------------------
# SR bits of the whole tensor
# ---------------------------------------------------------------------------

def bits(draw: Callable[[Sequence[int]], torch.Tensor], shape,
         dim: Optional[int], tp: Optional[TPGroup]) -> torch.Tensor:
    """draw(whole shape) -> bits; this rank's slice along `dim` of a
    tensor whose local shape is `shape` (dim None, or no group: drawn at
    `shape` as it is)."""
    shape = tuple(shape)
    if tp is None or dim is None:
        return draw(shape)
    dim = dim % len(shape)
    whole = list(shape)
    whole[dim] *= tp.size
    return draw(tuple(whole)).narrow(dim, tp.rank * shape[dim], shape[dim])


def step_bytes_model(n_layers: int, d_model: int, tokens: int,
                     m: int) -> int:
    """The bytes a rank sends over 'model' in one training step of a dense
    decoder whose heads divide m, `tokens` rows a rank (B x S), the
    observation vectors and the grad norm's few floats left out: the rank-
    order sums are all-gathers of (m - 1) copies of this rank's part. Per
    layer 7 f32 (tokens, d) sums (wo and down in the forward; wq, wk, wv,
    up and gate's input gradients in the backward); the embedding's bf16
    lookup sum; the head's f32 input gradient; the cross-entropy's row
    max (an all-reduce) and its (2, tokens) f32 sum."""
    act = tokens * d_model
    per = (m - 1) * (4 * act * (7 * n_layers + 1) + 2 * act + 8 * tokens)
    return int(per + 2 * (m - 1) / m * 4 * tokens)
