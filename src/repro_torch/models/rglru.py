"""RG-LRU recurrent block of Griffin / RecurrentGemma with FP8 projections
(counterpart of `repro.models.rglru`).

Block layout: two branches from the input,
  left:  W_x -> causal depthwise conv (width 4) -> RG-LRU
  right: W_g -> GeLU
merged by an elementwise product, then W_o back to d_model. The five
projections go through qeinsum (sites wx, wg, wa, wi, wo at the caller's
scope); the recurrence runs in f32:

  r_t = sigmoid(W_a xi_t);  i_t = sigmoid(W_i xi_t)
  a_t = exp(-c * softplus(Lambda) * r_t),   c = 8
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * xi_t)

Training and prefill evaluate h over the sequence with a log-depth scan
that pairs elements as `jax.lax.associative_scan` does (`_rglru_scan`):
about 2 log2(S) tensor operations, not S sequential steps. Decode is the
single-step recurrence with the carried (h, conv window) state. The
reference has no Pallas kernel here (plain jnp, XLA's fusions), and the
port keeps it plain PyTorch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.precision_policy import QuantConfig
from repro_torch.core.qlinear import qeinsum
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import activation, dense_init

_C = 8.0
_CONV_W = 4


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def init_rglru(cfg: ModelConfig, *, generator: torch.Generator, device):
    """wx, wg (D, W); wa, wi (W, W); lam (W,) with a = exp(-c softplus(lam))
    uniform in [0.9, 0.999] (Griffin's appendix); conv (4, W); wo (W, D)."""
    d, w = cfg.d_model, cfg.lru_dim or cfg.d_model
    kw = dict(generator=generator, device=device)
    p = {"wx": dense_init(d, w, **kw), "wg": dense_init(d, w, **kw),
         "wa": dense_init(w, w, scale=0.5, **kw),
         "wi": dense_init(w, w, scale=0.5, **kw)}
    u = torch.empty((w,), dtype=torch.float32, device=device).uniform_(
        0.9, 0.999, generator=generator)
    p["lam"] = torch.log(torch.expm1(-torch.log(u) / _C))
    p["conv"] = torch.randn((_CONV_W, w), dtype=torch.float32, device=device,
                            generator=generator) * (1.0 / _CONV_W)
    p["wo"] = dense_init(w, d, scale=0.5, **kw)
    return p


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width 4. x: (B, S, W); state: (B, 3, W) the
    last three inputs before x (zeros when None). Sums in f32, in the
    reference's order; returns (out in x's dtype, the new (B, 3, W) state in
    x's dtype)."""
    b, s, w = x.shape
    hist = torch.zeros((b, _CONV_W - 1, w), dtype=x.dtype, device=x.device) \
        if state is None else state.to(x.dtype)
    xp = torch.cat([hist, x], dim=1)                      # (B, S+3, W)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(_CONV_W):
        out = out + xp[:, i:i + s].float() * kernel[i]
    return out.to(x.dtype), xp[:, -(_CONV_W - 1):]


def _combine(a1, b1, a2, b2):
    """(a1, b1) then (a2, b2) of h -> a h + b: (a1 a2, b1 a2 + b2)."""
    return a1 * a2, b1 * a2 + b2


def _rglru_scan(gated: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + gated_t (h_{-1} = 0) along dim 1, evaluated as
    `jax.lax.associative_scan(combine, (a, gated), axis=1)` pairs it: the
    neighbours (0, 1), (2, 3), ... combined, the odd outputs by recursion
    on those pairs, the even ones from the odd outputs and the even
    inputs, then interleaved. Same operations in the same pairing: the f32
    results match the reference's up to XLA's own fusions."""
    def scan(av, bv):
        n = av.shape[1]
        if n < 2:
            return av, bv
        ra, rb = _combine(av[:, 0:-1:2], bv[:, 0:-1:2], av[:, 1::2],
                          bv[:, 1::2])
        oa, ob = scan(ra, rb)
        if n % 2 == 0:
            ea, eb = _combine(oa[:, :-1], ob[:, :-1], av[:, 2::2],
                              bv[:, 2::2])
        else:
            ea, eb = _combine(oa, ob, av[:, 2::2], bv[:, 2::2])
        ea = torch.cat([av[:, :1], ea], dim=1)
        eb = torch.cat([bv[:, :1], eb], dim=1)
        return _interleave(ea, oa), _interleave(eb, ob)

    return scan(a, gated)[1]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along dim 1 (even one longer or equal)."""
    b, ne = even.shape[:2]
    out = even.new_empty((b, ne + odd.shape[1]) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def rglru_block(params, x: torch.Tensor, *, cfg: ModelConfig,
                qcfg: QuantConfig, mode: str = "train",
                state: Optional[dict] = None,
                qgen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, D) -> (y, new_state); state = {'h': (B, W) f32, 'conv':
    (B, 3, W)}. Modes: 'train' (no state; h from zero), 'prefill' (the
    conv starts from state['conv'] when a state is given, h from zero;
    returns the state after the last token), 'decode' (one step from
    state). qgen: the generator SR bits come from (training)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"rglru mode {mode!r} is not one of train, "
                         "prefill, decode")
    xi = qeinsum("bsd,dw->bsw", x, params["wx"], cfg=qcfg, site="wx",
                 generator=qgen)
    gate = qeinsum("bsd,dw->bsw", x, params["wg"], cfg=qcfg, site="wg",
                   generator=qgen)
    xi, new_conv = _causal_conv(xi, params["conv"],
                                None if state is None else state.get("conv"))
    r = torch.sigmoid(qeinsum("bsw,wv->bsv", xi, params["wa"], cfg=qcfg,
                              site="wa", generator=qgen).float())
    i = torch.sigmoid(qeinsum("bsw,wv->bsv", xi, params["wi"], cfg=qcfg,
                              site="wi", generator=qgen).float())
    a = torch.exp(-_C * _softplus(params["lam"]) * r)          # (B, S, W)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * i \
        * xi.float()
    new_state = None
    if mode == "decode":
        if state is None:
            raise ValueError("rglru decode needs the carried state")
        h = a[:, 0] * state["h"] + gated[:, 0]
        hs = h[:, None]
        new_state = {"h": h, "conv": new_conv}
    else:
        hs = _rglru_scan(gated, a)
        if mode == "prefill":
            new_state = {"h": hs[:, -1], "conv": new_conv}
    merged = hs.to(x.dtype) * activation("gelu")(gate.float()).to(x.dtype)
    y = qeinsum("bsw,wd->bsd", merged, params["wo"], cfg=qcfg, site="wo",
                generator=qgen)
    return y, new_state


def init_rglru_state(cfg: ModelConfig, batch: int, *, device):
    """A zero state: h (B, W) f32, conv (B, 3, W) bf16."""
    w = cfg.lru_dim or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, _CONV_W - 1, w), dtype=torch.bfloat16,
                                device=device)}
