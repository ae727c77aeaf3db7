"""Shared layers (counterpart of `repro.models.layers`): plain functions on
tensors and parameter dicts. GEMM-bearing layers go through qeinsum; norms,
rope and the embedding run at >= 16 bits as in the reference, and train
through ordinary autograd."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision_policy import QuantConfig
from repro_torch.core.qlinear import qeinsum


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


def mlp(params, x: torch.Tensor, *, act: str, qcfg: QuantConfig,
        qgen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Gated MLP (activation `act` on the gate, in f32) with all three
    GEMMs in FP8 (SR bits from qgen)."""
    up = qeinsum("bsd,df->bsf", x, params["up"], cfg=qcfg, site="up",
                 generator=qgen)
    gate = qeinsum("bsd,df->bsf", x, params["gate"], cfg=qcfg, site="gate",
                   generator=qgen)
    h = activation(act)(gate.float()).to(up.dtype) * up
    return qeinsum("bsf,fd->bsd", h, params["down"], cfg=qcfg, site="down",
                   generator=qgen)


def embed(params, tokens: torch.Tensor, *, dtype=torch.bfloat16
          ) -> torch.Tensor:
    # Gather first, then cast: the same values as casting the whole table.
    return params["table"][tokens].to(dtype)


def logits_head(params, x: torch.Tensor, *,
                qcfg: QuantConfig) -> torch.Tensor:
    """Final projection; qcfg is the 16-bit baseline under the paper's
    first/last-layer rule. Tied embeddings use table^T."""
    w = params["head"] if "head" in params else params["table"].t()
    return qeinsum("bsd,dv->bsv", x, w, cfg=qcfg, site="head")

