"""Dense decoder LM assembly (counterpart of `repro.models.transformer`).

Parameters are nested dicts of tensors laid out like the reference's
unscanned tree: {"embed": {"table"}, "final_norm": {"scale"},
"decoder": {"layer_{i}": {...}}}. Layers run in a plain
Python loop (the reference's lax.scan), each under the site scope of its
key, so scale-site keys are the reference's `scan_layers=False` keys.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.precision_policy import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (attention, init_attention,
                                          init_paged_pool)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, embed, embed_init,
                                       logits_head, mlp, rmsnorm)
from repro_torch.scaling import context as scale_ctx


def _layer_names(cfg: ModelConfig):
    """Decoder keys in execution order (one-kind pattern: no remainder)."""
    return [f"layer_{i}" for i in range(cfg.n_layers)]


def init_layer(cfg: ModelConfig, *, generator, device):
    kw = dict(generator=generator, device=device)
    ones = torch.ones((cfg.d_model,), dtype=torch.float32, device=device)
    return {"norm1": {"scale": ones.clone()},
            "attn": init_attention(cfg, **kw),
            "norm2": {"scale": ones.clone()},
            "mlp": {"up": dense_init(cfg.d_model, cfg.d_ff, **kw),
                    "down": dense_init(cfg.d_ff, cfg.d_model, scale=0.5, **kw),
                    "gate": dense_init(cfg.d_model, cfg.d_ff, **kw)}}


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random weights drawn from `seed` (a torch.Generator on the target
    device), with the reference's shapes and initializer distributions."""
    cfg.check_ported()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": {"table": embed_init(cfg.padded_vocab_size, cfg.d_model,
                                      generator=gen, device=dev)},
        "final_norm": {"scale": torch.ones((cfg.d_model,),
                                           dtype=torch.float32, device=dev)},
        "decoder": {name: init_layer(cfg, generator=gen, device=dev)
                    for name in _layer_names(cfg)},
    }
    if not cfg.tie_embeddings:
        params["embed"]["head"] = dense_init(
            cfg.d_model, cfg.padded_vocab_size, scale=0.5, generator=gen,
            device=dev)
    return params


def init_paged_stack_state(cfg: ModelConfig, n_slots: int, *, device=None):
    """Per-layer paged KV pools, keyed like the decoder params."""
    cfg.check_ported()
    dev = resolve_device(device)
    return {name: {"kv": init_paged_pool(cfg, n_slots, device=dev)}
            for name in _layer_names(cfg)}


def apply_layer(p, h: torch.Tensor, *, cfg: ModelConfig, qcfg: QuantConfig,
                positions: torch.Tensor, mode: str, state=None, page=None):
    """One 'attn' decoder layer. Returns (h, new_state)."""
    with scale_ctx.scope("attn"):
        a, cache = attention(
            p["attn"], rmsnorm(p["norm1"], h, eps=cfg.norm_eps), cfg=cfg,
            qcfg=qcfg, positions=positions, mode=mode,
            cache_layer=None if state is None else state["kv"], page=page)
    h = h + a
    with scale_ctx.scope("mlp"):
        f = mlp(p["mlp"], rmsnorm(p["norm2"], h, eps=cfg.norm_eps),
                act=cfg.act, qcfg=qcfg)
    h = h + f
    return h, (None if cache is None else {"kv": cache})


def forward(params, tokens: torch.Tensor, *, cfg: ModelConfig,
            mode: str = "train", states=None,
            positions: Optional[torch.Tensor] = None, page=None,
            gather_rows: Optional[torch.Tensor] = None,
            last_only: bool = False):
    """Backbone forward. Returns (logits, new_states).

    mode 'train' (causal, no cache) or 'chunk' (paged serving: `states`
    are the pools of init_paged_stack_state, `page` the step's block-table
    indirection). gather_rows: (B,) row per request at which to compute
    logits (the chunk's last valid token)."""
    cfg.check_ported()
    qcfg = cfg.policy.quant
    head_cfg = cfg.policy.quant_for_layer(is_head=True)
    h = embed(params["embed"], tokens)
    b, s, _ = h.shape
    if positions is None:
        positions = torch.arange(s, device=h.device)[None].expand(b, s)
    new_states = {} if states is not None else None
    with scale_ctx.scope("decoder"):
        for name in _layer_names(cfg):
            with scale_ctx.scope(name):
                h, ns = apply_layer(
                    params["decoder"][name], h, cfg=cfg, qcfg=qcfg,
                    positions=positions, mode=mode,
                    state=None if states is None else states[name], page=page)
            if states is not None:
                new_states[name] = ns
    if last_only:
        h = h[:, -1:]
    elif gather_rows is not None:
        h = h[torch.arange(b, device=h.device), gather_rows.long()][:, None]
    h = rmsnorm(params["final_norm"], h, eps=cfg.norm_eps)
    logits = logits_head(params["embed"], h, qcfg=head_cfg)
    return logits, new_states
