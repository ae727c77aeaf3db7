"""Mixture-of-experts FFN with FP8 expert GEMMs (counterpart of
`repro.models.moe`; the dbrx and moonshot archs).

Capacity-based top-k routing with gather dispatch, as in the reference:
each (token, slot) pair's position in its expert comes from a cumsum in
(token, slot) order; pairs past the expert's capacity go to an overflow
slot and are dropped; token ids are scattered into an (E, C) slot table,
the tokens gathered into per-expert buffers, and the expert outputs
gathered back per pair, weighted by the renormalised gate and summed per
token. The router runs in f32 (softmax, top-k and the gate are
precision-critical; its logits are the correctly rounded f32 values,
whatever the call's batch).

Top-k takes ties as `jax.lax.top_k` does, the lower expert index first: a
stable descending sort of the probabilities, then the first k.

The expert GEMMs are batched einsums through `qeinsum` with the
reference's specs, sites ("w_gate", "w_up", "w_down") and classes
(activation, weight). They are not '...k,kn->...n'-shaped, so they take
qeinsum's unfused path under every recipe (delayed scaling included): an
f32 product of the fp8 payloads, as the reference computes them outside
any Pallas kernel. The router, softmax, top-k, cumsum, gather and
scatter-add are plain PyTorch.

Capacity depends on the number of tokens of the call (per sample by
default), so a prefill, a paged chunk and a decode step drop different
pairs, exactly as the reference's calls do. The reference's sharding
constraints (expert parallelism) have no single-device counterpart.

Each function returns (y, aux) with aux {"lb_loss", "router_z_loss",
"dropped_frac"}, 0-d f32 tensors; the first two carry gradients to the
router, the third has none.

Inside a data-parallel "full" step (`distributed.global_batch.current()`
active) the reference computes the aux losses over the global batch, of
which this rank holds 1 / n_ranks of the rows. Per-sample dispatch is a
function of each row alone, so each rank dispatches its rows as the
reference does, and the aux losses become the rank's contributions, which
the step sums over the ranks: lb_loss = E coef sum(me_r ce_g), me_r the
rank's router probabilities summed over its tokens over the global token
count, ce_g the expert counts summed over the ranks over the global pair
count (no gradient); router_z_loss the rank's sum of lse^2 over the global
token count, times 1e-3; dropped_frac the rank's dropped pairs over the
global pair count. (Global dispatch is refused there by the step.)
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.precision_policy import QuantConfig
from repro_torch.core.qlinear import qeinsum
from repro_torch.distributed import comm, global_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init


def init_moe(cfg: ModelConfig, *, generator: torch.Generator, device):
    """{"router": (D, E) f32, "w_gate" / "w_up": (E, D, F), "w_down":
    (E, F, D)}, each expert drawn as `dense_init` draws a dense layer."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, device=device)

    def expert_stack(d_in, d_out, scale=1.0):
        return torch.stack([dense_init(d_in, d_out, scale=scale, **kw)
                            for _ in range(e)])

    return {"router": dense_init(d, e, **kw),
            "w_gate": expert_stack(d, f),
            "w_up": expert_stack(d, f),
            "w_down": expert_stack(f, d, scale=0.5)}


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call of `n_tokens` tokens: the reference's
    ceil(n * k * capacity_factor / E), at least 8, rounded up to 8."""
    c = math.ceil(n_tokens * cfg.experts_per_token
                  * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, largest
    first, ties to the lower index (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
           dims: str):
    """f32 router logits, softmax, top-k with the renormalised gate, and
    the two aux losses (load balance over the mean probability and the
    token fraction per expert; router z-loss). The logits are summed in
    f64 and rounded once to f32: each token's then do not depend on the
    other rows of the call (an f32 matmul's summation order changes with
    its row count), so a prompt routes alike whether prefilled whole or in
    chunks beside other requests."""
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = torch.einsum(f"{dims}d,de->{dims}e", x.double(),
                          router.double()).float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = top_k(probs, k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    flat = expert_idx.reshape(-1)
    gb = global_batch.current()
    if gb is not None:
        # The rank's contributions to the global batch's aux losses: their
        # sum over the ranks is the global value (module docstring).
        tokens = float(flat.numel() // k * gb.n_ranks)
        me = probs.reshape(-1, e).sum(dim=0) / tokens
        counts = torch.zeros((e,), dtype=torch.float32,
                             device=x.device).index_add_(
            0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                device=x.device))
        ce = comm.all_reduce(counts, "sum", gb.group) / (tokens * k)
        lb_loss = e * torch.sum(me * ce) * cfg.router_aux_coef
        z_loss = torch.sum(torch.logsumexp(logits, dim=-1) ** 2) \
            / tokens * 1e-3
        return gate, expert_idx, lb_loss, z_loss
    n_pairs = expert_idx.numel()
    me = probs.reshape(-1, e).mean(dim=0)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / n_pairs, dtype=torch.float32,
                            device=x.device))
    lb_loss = e * torch.sum(me * ce) * cfg.router_aux_coef
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * 1e-3
    return gate, expert_idx, lb_loss, z_loss


def _positions(flat_e: torch.Tensor, e: int, c: int):
    """Each pair's position in its expert (pairs before it in (token,
    slot) order, along the last axis), whether it fits, and its slot
    (e * c, the overflow slot, if dropped)."""
    onehot = torch.nn.functional.one_hot(flat_e, e)
    pos = torch.cumsum(onehot, dim=-2) - onehot
    pos_in_e = torch.gather(pos, -1, flat_e[..., None])[..., 0]
    keep = pos_in_e < c
    dest = torch.where(keep, flat_e * c + pos_in_e,
                       torch.full_like(flat_e, e * c))
    return keep, dest


def _experts(params, xe: torch.Tensor, spec_in: str, spec_out: str, *,
             qcfg: QuantConfig, qgen: Optional[torch.Generator]
             ) -> torch.Tensor:
    """The gated expert FFN on the per-expert buffers, three FP8 GEMMs."""
    g = qeinsum(spec_in, xe, params["w_gate"], cfg=qcfg, site="w_gate",
                generator=qgen)
    u = qeinsum(spec_in, xe, params["w_up"], cfg=qcfg, site="w_up",
                generator=qgen)
    h = torch.nn.functional.silu(g.float()).to(u.dtype) * u
    return qeinsum(spec_out, h, params["w_down"], cfg=qcfg, site="w_down",
                   generator=qgen)


def _combine(pair_out: torch.Tensor, k: int) -> torch.Tensor:
    """Sum each token's k weighted pair outputs (..., T * k, D) -> (..., T,
    D) in f32, from zero in slot order: the reference's scatter-add."""
    p = pair_out.reshape(pair_out.shape[:-2] + (-1, k, pair_out.shape[-1]))
    y = torch.zeros_like(p[..., 0, :])
    for j in range(k):
        y = y + p[..., j, :]
    return y


def _aux(lb_loss, z_loss, keep) -> Dict[str, torch.Tensor]:
    gb = global_batch.current()
    if gb is not None:
        dropped = (~keep).sum().to(torch.float32) \
            / float(keep.numel() * gb.n_ranks)
    else:
        dropped = 1.0 - keep.float().mean()
    return {"lb_loss": lb_loss, "router_z_loss": z_loss,
            "dropped_frac": dropped}


def moe_ffn(params, x: torch.Tensor, *, cfg: ModelConfig, qcfg: QuantConfig,
            qgen: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y, aux). Global dispatch over the B * S tokens of
    the call (`moe_per_sample_dispatch=False`); the default config takes
    `moe_ffn_per_sample`."""
    if cfg.moe_per_sample_dispatch:
        return moe_ffn_per_sample(params, x, cfg=cfg, qcfg=qcfg, qgen=qgen)
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    c = capacity(n, cfg)
    xf = x.reshape(n, d)
    gate, expert_idx, lb_loss, z_loss = _route(xf, params["router"], cfg,
                                               "n")
    keep, dest = _positions(expert_idx.reshape(-1), e, c)
    token_of_pair = torch.arange(n * k, device=x.device) // k
    slot_token = torch.zeros((e * c + 1,), dtype=torch.long,
                             device=x.device).scatter_(
        0, dest, token_of_pair + 1)[:e * c]
    xe = xf[torch.clamp_min(slot_token - 1, 0)].reshape(e, c, d)
    xe = torch.where((slot_token > 0).reshape(e, c, 1), xe,
                     torch.zeros_like(xe)).to(torch.bfloat16)
    ye = _experts(params, xe, "ecd,edf->ecf", "ecf,efd->ecd", qcfg=qcfg,
                  qgen=qgen)
    pair_out = ye.reshape(e * c, d)[torch.clamp_max(dest, e * c - 1)]
    w = (gate.reshape(-1) * keep.float())[:, None]
    y = _combine(pair_out.float() * w, k)
    return y.reshape(b, s, d).to(x.dtype), _aux(lb_loss, z_loss, keep)


def moe_ffn_per_sample(params, x: torch.Tensor, *, cfg: ModelConfig,
                       qcfg: QuantConfig,
                       qgen: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y, aux). Per-sample dispatch: capacity(S) slots per
    expert and sample; every gather and scatter indexes along the sequence
    of one batch row. Expert buffers are (E, B, C, D)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    c = capacity(s, cfg)
    gate, expert_idx, lb_loss, z_loss = _route(x, params["router"], cfg,
                                               "bs")
    flat_e = expert_idx.reshape(b, s * k)
    keep, dest = _positions(flat_e, e, c)
    token_of_pair = (torch.arange(s * k, device=x.device) // k)[None] \
        .expand(b, s * k)
    slot_token = torch.zeros((b, e * c + 1), dtype=torch.long,
                             device=x.device).scatter_(
        1, dest, token_of_pair + 1)[:, :e * c]
    xe = torch.gather(x, 1, torch.clamp_min(slot_token - 1, 0)[..., None]
                      .expand(b, e * c, d))
    xe = torch.where((slot_token > 0)[..., None], xe, torch.zeros_like(xe))
    xe = xe.reshape(b, e, c, d).transpose(0, 1).to(torch.bfloat16)
    ye = _experts(params, xe, "ebcd,edf->ebcf", "ebcf,efd->ebcd", qcfg=qcfg,
                  qgen=qgen)
    ye_flat = ye.transpose(0, 1).reshape(b, e * c, d)
    pair_out = torch.gather(ye_flat, 1, torch.clamp_max(dest, e * c - 1)
                            [..., None].expand(b, s * k, d))
    w = (gate.reshape(b, s * k) * keep.float())[..., None]
    y = _combine(pair_out.float() * w, k)
    return y.to(x.dtype), _aux(lb_loss, z_loss, keep)
