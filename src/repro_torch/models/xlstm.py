"""xLSTM blocks (mLSTM and sLSTM) with FP8 projections, the xlstm-125m
arch (counterpart of `repro.models.xlstm`, in its names and its order of
operations).

mLSTM (matrix memory): trained and prefilled in the stabilised
chunkwise-parallel form (xLSTM paper, Eq. 21-27), per head and chunk:

  F_i = sum_{t<=i} log sigmoid(f_t),  D_ij = F_i - F_j + i_j   (j <= i)
  m_i = max(max_j D_ij, F_i + m_prev, 0)
  h_i = (sum_j exp(D_ij - m_i) (q_i . k_j / sqrt(d)) v_j + inter-chunk term)
        / max(|normaliser|, exp(-m_i))

with (C, n, m) carried from chunk to chunk; decode is the recurrent form
on that state. The block is an up-projection sandwich (factor
`ssm_proj_factor`) with a SiLU gate branch. Its seven projections go
through qeinsum (sites w_up, w_gate, wq, wk, wv, w_if, w_down); the QK and
PV products, the C / n updates and the normaliser are f32 PyTorch
products, as the reference computes them with f32 `jnp.einsum` outside
any Pallas kernel.

sLSTM (scalar memory): a loop over time (the reference's `lax.scan`) with
block-diagonal recurrent mixing over the heads (`r_zifo`, f32) and
exponential gating with the m stabiliser; then a gated GeLU FFN (sites
ff_up, ff_gate, ff_down; w_zifo before the loop).

Kept as the reference has them (not faults of the port):
* `_slstm_scan` reshapes the per-head recurrent product (B, H, 4 dh) to
  (B, 4 D) before splitting it into z / i / f / o, so the recurrent
  quarters are not aligned head by head with the input projection's;
* an mLSTM prefill starts from a zero (C, n, m), whatever state the slot
  carries; an sLSTM prefill starts its loop from the carried (h, c, n, m);
* `f_raw + 1.0` (the forget-gate bias), `w_if`'s init scale 0.5 and the
  sLSTM's `max(n, 1)`.

Ties: the reference differentiates through the stabiliser m; its maxima
(`jnp.max`, `jnp.maximum`) split the gradient evenly among tied entries,
and so do `torch.amax` and `torch.maximum`, which this module uses (never
`torch.max(dim=)` or a clamp, which send it to one side).
`jax.nn.log_sigmoid(x)` = -logaddexp(-x, 0) is `F.logsigmoid`: min(x, 0) -
log1p(exp(-|x|)), with the gradient 1/2 at x = 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.precision_policy import QuantConfig
from repro_torch.core.qlinear import qeinsum
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import activation, dense_init, rmsnorm
from repro_torch.models.remat import checkpointed

_MODES = ("train", "prefill", "decode")
# Profiler ranges around the f32 recurrences (the mLSTM's chunkwise
# products, the sLSTM's loop over time): a trace attributes the kernels
# launched inside them, and those of their backward nodes, to each.
MLSTM_RANGE = "xlstm.mlstm_parallel"
SLSTM_RANGE = "xlstm.slstm_scan"


def _check_mode(mode: str, state, kind: str):
    if mode not in _MODES:
        raise ValueError(f"{kind} mode {mode!r} is not one of "
                         f"{', '.join(_MODES)}")
    if mode == "decode" and state is None:
        raise ValueError(f"{kind} decode needs the carried state")


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(cfg: ModelConfig, *, generator: torch.Generator, device):
    """w_up, w_gate (D, I); wq, wk, wv (I, I); w_if (I, 2H) at scale 0.5;
    the inner RMSNorm (I,); w_down (I, D) at scale 0.5 (I = D x
    ssm_proj_factor)."""
    d = cfg.d_model
    inner = int(d * cfg.ssm_proj_factor)
    kw = dict(generator=generator, device=device)
    return {
        "w_up": dense_init(d, inner, **kw),
        "w_gate": dense_init(d, inner, **kw),
        "wq": dense_init(inner, inner, **kw),
        "wk": dense_init(inner, inner, **kw),
        "wv": dense_init(inner, inner, **kw),
        "w_if": dense_init(inner, 2 * cfg.n_heads, scale=0.5, **kw),
        "norm": {"scale": torch.ones((inner,), dtype=torch.float32,
                                     device=device)},
        "w_down": dense_init(inner, d, scale=0.5, **kw),
    }


def _mlstm_chunk(q, k, v, i_gate, log_f, c_prev, n_prev, m_prev):
    """One chunk of the chunkwise-parallel mLSTM. q, k, v: (B, H, c, dh)
    f32; i_gate, log_f: (B, H, c) f32; the carried state C (B, H, dh, dh),
    n (B, H, dh), m (B, H). Returns (h (B, H, c, dh), (C, n, m) at the
    chunk's end), all f32 and m-stabilised."""
    dh = q.shape[-1]
    c = q.shape[2]
    cum_f = torch.cumsum(log_f, dim=-1)                   # (B,H,c) F_i
    # intra-chunk decay D_ij = F_i - F_j + i_j for j <= i
    d_mat = cum_f[..., :, None] - cum_f[..., None, :] + i_gate[..., None, :]
    causal = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    d_mat = torch.where(causal, d_mat, float("-inf"))
    # inter-chunk contribution scale: b_i = F_i + m_prev
    b_vec = cum_f + m_prev[..., None]                     # (B,H,c)
    m_i = torch.maximum(torch.amax(d_mat, dim=-1), b_vec)
    m_i = torch.maximum(m_i, m_i.new_zeros(()))
    decay = torch.exp(d_mat - m_i[..., None])             # (B,H,c,c)
    qs = q / (dh ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", qs, k) * decay
    inter_w = torch.exp(b_vec - m_i)                      # (B,H,c)
    num = torch.einsum("bhqk,bhkd->bhqd", scores, v) \
        + inter_w[..., None] * torch.einsum("bhvk,bhqk->bhqv", c_prev, qs)
    den = scores.sum(-1) + inter_w * torch.einsum("bhk,bhqk->bhq", n_prev,
                                                  qs)
    # The exp(-m) floor makes h independent of the stabiliser m, so the
    # parallel and recurrent forms agree.
    h = num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None]
    # end-of-chunk state
    f_tail = cum_f[..., -1:] - cum_f                      # sum_{t>j} log f
    m_new = torch.maximum(cum_f[..., -1] + m_prev,
                          torch.amax(f_tail + i_gate, dim=-1))
    w_j = torch.exp(f_tail + i_gate - m_new[..., None])   # (B,H,c)
    carry = torch.exp(cum_f[..., -1] + m_prev - m_new)    # (B,H)
    c_new = carry[..., None, None] * c_prev \
        + torch.einsum("bhs,bhsv,bhsk->bhvk", w_j, v, k)
    n_new = carry[..., None] * n_prev + torch.einsum("bhs,bhsk->bhk", w_j, k)
    return h, (c_new, n_new, m_new)


def _mlstm_parallel(q, k, v, i_gate, f_gate, *, chunk: int = 1024,
                    state: Optional[dict] = None, remat: bool = True):
    """Chunkwise-parallel mLSTM: a static loop over chunks of `chunk`
    positions carrying (C, n, m), each chunk recomputed in the backward
    when `remat` (the reference's jax.checkpoint of `_mlstm_chunk`).
    Returns (h (B, H, S, dh) f32, the final state {"C", "n", "m"})."""
    b, h, s, dh = q.shape
    log_f = F.logsigmoid(f_gate)
    if state is None:
        st = (torch.zeros((b, h, dh, dh), dtype=torch.float32,
                          device=q.device),
              torch.zeros((b, h, dh), dtype=torch.float32, device=q.device),
              torch.zeros((b, h), dtype=torch.float32, device=q.device))
    else:
        st = (state["C"], state["n"], state["m"])
    outs = []
    qf, kf, vf = (t.float() for t in (q, k, v))
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        args = (qf[:, :, c0:c1], kf[:, :, c0:c1], vf[:, :, c0:c1],
                i_gate[..., c0:c1], log_f[..., c0:c1], *st)
        if remat:
            hc, st = checkpointed(lambda _, *a: _mlstm_chunk(*a), None,
                                  *args)
        else:
            hc, st = _mlstm_chunk(*args)
        outs.append(hc)
    hs = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
    return hs, {"C": st[0], "n": st[1], "m": st[2]}


def _mlstm_step(q, k, v, i_raw, f_raw, state):
    """One decode step. q, k, v: (B, H, dh) in the projections' dtype
    (bf16: the outer product v k^T and q / sqrt(dh) round to it, as the
    reference's do); gates (B, H) f32; state {"C", "n", "m"} f32."""
    c_prev, n_prev, m_prev = state["C"], state["n"], state["m"]
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + m_prev, i_raw)
    i_p = torch.exp(i_raw - m_new)[..., None]
    f_p = torch.exp(log_f + m_prev - m_new)[..., None]
    n_new = f_p * n_prev + i_p * k
    c_new = f_p[..., None] * c_prev + i_p[..., None] * \
        (v[..., :, None] * k[..., None, :])               # (B,H,dh,dh)
    dh = q.shape[-1]
    # jnp divides a bf16 array by the weakly typed sqrt(dh) rounded to
    # bf16.
    qn = (q / torch.tensor(dh ** 0.5, dtype=q.dtype)).float()
    num = torch.einsum("bhvk,bhk->bhv", c_new, qn)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, qn).abs(),
                        torch.exp(-m_new))
    h = num / den[..., None]
    return h, {"C": c_new, "n": n_new, "m": m_new}


def mlstm_block(params, x: torch.Tensor, *, cfg: ModelConfig,
                qcfg: QuantConfig, mode: str = "train",
                state: Optional[dict] = None,
                qgen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, D) -> (y, new_state); state {"C", "n", "m"}
    (init_mlstm_state). Modes: 'train' (no state), 'prefill' (from a zero
    state, whatever `state` holds, as the reference's; returns the state
    after the last token), 'decode' (one step from `state`). qgen: the
    generator SR bits come from."""
    _check_mode(mode, state, "mlstm")
    b, s, d = x.shape
    h_heads = cfg.n_heads
    inner = int(d * cfg.ssm_proj_factor)
    dh = inner // h_heads

    def proj(inp, w, site, spec="bsi,ij->bsj"):
        return qeinsum(spec, inp, params[w], cfg=qcfg, site=site,
                       generator=qgen)

    def heads(t):
        return t.reshape(b, s, h_heads, dh).transpose(1, 2)

    up = proj(x, "w_up", "w_up", "bsd,di->bsi")
    gate = proj(x, "w_gate", "w_gate", "bsd,di->bsi")
    q = heads(proj(up, "wq", "wq"))
    k = heads(proj(up, "wk", "wk"))
    v = heads(proj(up, "wv", "wv"))
    gates = proj(up, "w_if", "w_if", "bsi,ig->bsg").float()   # (B,S,2H)
    i_raw = gates[..., :h_heads].transpose(1, 2)              # (B,H,S)
    f_raw = gates[..., h_heads:].transpose(1, 2) + 1.0        # forget bias

    new_state = None
    if mode == "decode":
        h, new_state = _mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                   i_raw[..., 0], f_raw[..., 0], state)
        h = h[:, :, None]                                     # (B,H,1,dh)
    else:
        with torch.profiler.record_function(MLSTM_RANGE):
            h, end_state = _mlstm_parallel(q, k, v, i_raw, f_raw,
                                           chunk=cfg.attn_chunk_size,
                                           remat=cfg.remat)
        if mode == "prefill":
            new_state = end_state

    h = h.transpose(1, 2).reshape(b, s, inner).to(x.dtype)
    h = rmsnorm(params["norm"], h, eps=cfg.norm_eps)
    h = h * F.silu(gate.float()).to(h.dtype)
    return proj(h, "w_down", "w_down", "bsi,id->bsd"), new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, *, device):
    """A zero state: C (B, H, dh, dh), n (B, H, dh), m (B, H), f32."""
    inner = int(cfg.d_model * cfg.ssm_proj_factor)
    dh = inner // cfg.n_heads
    h = cfg.n_heads
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, dh, dh), **kw),
            "n": torch.zeros((batch, h, dh), **kw),
            "m": torch.zeros((batch, h), **kw)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(cfg: ModelConfig, *, generator: torch.Generator, device):
    """w_zifo (D, 4D); r_zifo (H, dh, 4 dh) f32, standard normal /
    sqrt(dh) (the block-diagonal recurrent mixing); the RMSNorm (D,); the
    FFN's w_up, w_gate (D, F) and w_down (F, D) at scale 0.5, F =
    max(8, int(4 D / 3))."""
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    ff = max(8, int(d * 4 / 3))
    kw = dict(generator=generator, device=device)
    return {
        "w_zifo": dense_init(d, 4 * d, **kw),
        "r_zifo": torch.randn((h, dh, 4 * dh), dtype=torch.float32,
                              **kw) / (dh ** 0.5),
        "norm": {"scale": torch.ones((d,), dtype=torch.float32,
                                     device=device)},
        "w_up": dense_init(d, ff, **kw),
        "w_gate": dense_init(d, ff, **kw),
        "w_down": dense_init(ff, d, scale=0.5, **kw),
    }


def _slstm_scan(params, z_in: torch.Tensor, h0, c0, n0, m0):
    """z_in: (B, S, 4D) pre-activations from the input projection; the
    carry (h, c, n, m) (B, D) f32. A loop over S (the reference's
    lax.scan). Returns (hs (B, S, D) f32, the final (h, c, n, m))."""
    b, s, d4 = z_in.shape
    d = d4 // 4
    # jnp.einsum promotes a bf16 compute copy of r_zifo to f32.
    r = params["r_zifo"].float()
    h_heads = r.shape[0]
    dh = d // h_heads
    # z_in as (S, H, B, 4 dh): a step's input is the addend of its
    # per-head recurrent product, zt + einsum("bhd,hde->bhe", h, r), one
    # batched GEMM (the loop is launch-bound).
    zf = z_in.float().reshape(b, s, h_heads, 4 * dh).permute(
        1, 2, 0, 3).contiguous()
    one = zf.new_ones(())
    h, c, n, m = h0, c0, n0, m0
    hs = []
    for t in range(s):
        hh = h.reshape(b, h_heads, dh).transpose(0, 1)
        zifo = torch.baddbmm(zf[t], hh, r).transpose(0, 1).reshape(b, 4 * d)
        z_r, i_r, f_r, o_r = torch.chunk(zifo, 4, dim=-1)
        z = torch.tanh(z_r)
        o = torch.sigmoid(o_r)
        log_f = F.logsigmoid(f_r)
        lfm = log_f + m
        m_new = torch.maximum(lfm, i_r)
        i_p = torch.exp(i_r - m_new)
        f_p = torch.exp(lfm - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        h = o * c / torch.maximum(n, one)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c, n, m)


def slstm_block(params, x: torch.Tensor, *, cfg: ModelConfig,
                qcfg: QuantConfig, mode: str = "train",
                state: Optional[dict] = None,
                qgen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, D) -> (y, new_state); state {"h", "c", "n", "m"}
    (init_slstm_state). The loop starts from `state` when one is given
    (prefill and decode), from zeros otherwise; prefill and decode return
    the state after the last token."""
    _check_mode(mode, state, "slstm")
    b, s, d = x.shape
    z_in = qeinsum("bsd,dz->bsz", x, params["w_zifo"], cfg=qcfg,
                   site="w_zifo", generator=qgen)
    if state is None:
        carry0 = tuple(torch.zeros((b, d), dtype=torch.float32,
                                   device=x.device) for _ in range(4))
    else:
        carry0 = (state["h"], state["c"], state["n"], state["m"])
    with torch.profiler.record_function(SLSTM_RANGE):
        hs, (h, c, n, m) = _slstm_scan(params, z_in, *carry0)
    new_state = {"h": h, "c": c, "n": n, "m": m} \
        if mode in ("prefill", "decode") else None

    y = rmsnorm(params["norm"], hs.to(x.dtype), eps=cfg.norm_eps)
    up = qeinsum("bsd,df->bsf", y, params["w_up"], cfg=qcfg, site="ff_up",
                 generator=qgen)
    gate = qeinsum("bsd,df->bsf", y, params["w_gate"], cfg=qcfg,
                   site="ff_gate", generator=qgen)
    hff = activation("gelu")(gate.float()).to(up.dtype) * up
    return qeinsum("bsf,fd->bsd", hff, params["w_down"], cfg=qcfg,
                   site="ff_down", generator=qgen), new_state


def init_slstm_state(cfg: ModelConfig, batch: int, *, device):
    """A zero state: h, c, n, m (B, D) f32 (four tensors: the engines write
    them in place)."""
    return {name: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                              device=device) for name in ("h", "c", "n", "m")}
