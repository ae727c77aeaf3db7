"""Shared layers (counterpart of `repro.models.layers`): plain functions on
tensors and parameter dicts. GEMM-bearing layers go through qeinsum; norms,
rope and the embedding run at >= 16 bits as in the reference, and train
through ordinary autograd."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision_policy import QuantConfig, dtype_of
from repro_torch.core.qlinear import qeinsum
from repro_torch.distributed import tensor_parallel


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               device, scale: float = 1.0) -> torch.Tensor:
    """Truncated normal (+-2 sigma) / sqrt(d_in), f32 — the reference's
    initializer (its numbers come from jax.random, these from `generator`)."""
    std = scale / float(d_in) ** 0.5
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def embed_init(vocab: int, d: int, *, generator: torch.Generator,
               device) -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(w, 0.0, 0.02, -0.04, 0.04,
                                       generator=generator)


def rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Statistics in f32, elementwise application in x's dtype."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(name: str):
    """The reference's activations; its gelu is jax.nn.gelu's default, the
    tanh approximation."""
    fns = {"silu": torch.nn.functional.silu,
           "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
           "relu": torch.relu}
    if name not in fns:
        raise ValueError(f"unknown activation {name!r}")
    return fns[name]


def _split(w: torch.Tensor) -> bool:
    """Whether the active 'model' group's layout splits the weight `w`."""
    tp = tensor_parallel.current()
    return tp is not None and tp.dim_of(w) is not None


def mlp(params, x: torch.Tensor, *, act: str, qcfg: QuantConfig,
        qgen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Gated MLP (activation `act` on the gate, in f32) with all three
    GEMMs in FP8 (SR bits from qgen). Under a 'model' group
    (`distributed.tensor_parallel`) whose layout splits `up` (and with it
    gate and down, which the rules split alike): up and gate run
    column-parallel, down row-parallel, the hidden activation on the
    rank's columns."""
    col, row = ("col", "row") if _split(params["up"]) else (None, None)
    up = qeinsum("bsd,df->bsf", x, params["up"], cfg=qcfg, site="up",
                 generator=qgen, tp=col)
    gate = qeinsum("bsd,df->bsf", x, params["gate"], cfg=qcfg, site="gate",
                   generator=qgen, tp=col)
    h = activation(act)(gate.float()).to(up.dtype) * up
    return qeinsum("bsf,fd->bsd", h, params["down"], cfg=qcfg, site="down",
                   generator=qgen, tp=row)


def vocab_shard(params):
    """(the 'model' group, this rank's first vocabulary row) when the
    active group's layout splits the vocabulary of `params`' logits head
    (its "head" (d, V), else the tied "table" (V, d)), else None. A table
    split along d raises (ROADMAP.md, slice 10d)."""
    tied = "head" not in params
    w = params["table"] if tied else params["head"]
    tp = tensor_parallel.current()
    d = tp.dim_of(w) if tp is not None else None
    if d is None:
        return None
    vdim = 0 if tied else 1
    if d != vdim:
        raise NotImplementedError(
            "a table split along d under tensor parallelism (ROADMAP.md, "
            "slice 10d)")
    return tp, tp.rank * w.shape[vdim]


def embed(params, tokens: torch.Tensor, *, dtype=torch.bfloat16
          ) -> torch.Tensor:
    """The table's rows of `tokens`. Under a 'model' group whose layout
    splits the table's vocabulary each rank looks up the tokens in its
    rows (zeros elsewhere) and the ranks' lookups are summed, exactly, one
    rank holding each token."""
    # Gather first, then cast: the same values as casting the whole table.
    table = params["table"]
    shard = vocab_shard({"table": table})
    if shard is None:
        return table[tokens].to(dtype)
    tp, v0 = shard
    local = tokens - v0
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)].to(dtype)
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return tensor_parallel.reduce_from(rows, tp)


def logits_head(params, x: torch.Tensor, *,
                qcfg: QuantConfig) -> torch.Tensor:
    """Final projection; qcfg is the 16-bit baseline under the paper's
    first/last-layer rule. Tied embeddings use table^T. Under a 'model'
    group whose layout splits the head's vocabulary (`vocab_shard`): the
    logits of the rank's columns, x's gradient summed over the ranks in
    f32 (before the cast to x's dtype, where the one process's sum over
    the vocabulary is)."""
    w = params["head"] if "head" in params else params["table"].t()
    shard = vocab_shard(params)
    if shard is None:
        return qeinsum("bsd,dv->bsv", x, w, cfg=qcfg, site="head")
    if qcfg.enabled:
        raise NotImplementedError("a quantized logits head under tensor "
                                  "parallelism (ROADMAP.md, slice 10d)")
    cd = dtype_of(qcfg.compute_dtype)
    xf = tensor_parallel.copy_to(x.to(cd).float(), shard[0])
    y = torch.einsum("bsd,dv->bsv", xf, w.to(cd).float())
    return y.to(dtype_of(qcfg.output_dtype))

