"""Calibration + freeze: from amax history to deterministic FP8 serving
(counterpart of `repro.scaling.calibrate`).

`calibrate` runs the forward (mode 'train', RNE, saturating, delayed
scaling) over N batches: scales start at 1.0 and follow the amax history
exactly as the reference's DelayedScaling does. The first batch also
registers every site it touches (the reference discovers them by an
abstract trace, which eager PyTorch has no counterpart of; its first batch
runs at unit scales either way). `freeze` emits {site_key: float}.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.scaling import context as scale_ctx
from repro_torch.scaling.state import (DelayedScaling, ScaleState,
                                       ScalingConfig, SiteRegistry)


def _delayed_eval_cfg(cfg: ModelConfig) -> ModelConfig:
    """Deterministic (RNE, saturating) config with delayed scaling on."""
    quant = dataclasses.replace(cfg.policy.quant.eval_mode(),
                                scaling="delayed")
    return cfg.replace(policy=dataclasses.replace(cfg.policy, quant=quant))


def _observe(params, ecfg: ModelConfig, tokens: torch.Tensor,
             scales) -> Tuple[Dict[str, float], set]:
    """One calibration forward: {key: amax} (host floats) and the keys."""
    from repro_torch.models.transformer import forward
    ctx = scale_ctx.calibrate_context(scales)
    with torch.no_grad(), scale_ctx.activate(ctx):
        forward(params, tokens, cfg=ecfg, mode="train")
    keys = list(ctx.collected)
    vals = torch.stack([ctx.collected[k].float() for k in keys]).cpu().numpy() \
        if keys else np.zeros((0,), np.float32)
    return dict(zip(keys, vals.astype(np.float32))), set(ctx.discovered)


def discover_lm_sites(cfg: ModelConfig, params, batch) -> SiteRegistry:
    """Site registry of the training loss (W/A/E/G sites and the token
    sites with backward observations), in the reference's key order.

    The reference traces `lm_loss` abstractly; eager torch has no abstract
    trace, so this runs the loss forward once, without gradients, on
    `batch` ({"tokens", "labels"}; a small one will do — the sites do not
    depend on its size) under a discovery context (unit scales, nothing
    recorded), with SR bits from a throwaway generator."""
    from repro_torch.models.transformer import lm_loss
    dcfg = cfg.replace(policy=dataclasses.replace(
        cfg.policy, quant=dataclasses.replace(cfg.policy.quant,
                                              scaling="delayed")))
    device = params["embed"]["table"].device
    gen = torch.Generator(device=device).manual_seed(0)
    ctx = scale_ctx.discover_context()
    with torch.no_grad(), scale_ctx.activate(ctx):
        lm_loss(params, batch, cfg=dcfg, qgen=gen)
    return SiteRegistry(ctx.discovered, ctx.discovered_token_sites)


def calibrate(params, cfg: ModelConfig, batches: Iterable, *,
              scaling_cfg: ScalingConfig = ScalingConfig(),
              registry: Optional[SiteRegistry] = None
              ) -> Tuple[DelayedScaling, ScaleState]:
    """Populate amax history from forward batches of {"tokens": (B, S)}
    (int tensors on the params' device, or numpy). Returns the
    DelayedScaling bundle and the converged ScaleState."""
    ecfg = _delayed_eval_cfg(cfg)
    device = params["embed"]["table"].device
    batches = [torch.as_tensor(np.asarray(b["tokens"]) if not
                               isinstance(b["tokens"], torch.Tensor)
                               else b["tokens"], device=device).long()
               for b in batches]
    ds = state = None
    for i, tokens in enumerate(batches):
        if ds is None:
            # Unit scales for the first batch (a fresh ScaleState's).
            observed, found = _observe(params, ecfg, tokens, {})
            ds = DelayedScaling(registry or SiteRegistry(found),
                                config=scaling_cfg, qcfg=ecfg.policy.quant)
            state = ds.init()
        else:
            observed, _ = _observe(params, ecfg, tokens,
                                   ds.scales_dict(state))
        state = ds.update(state, observed)
    return ds, state


def freeze(ds: DelayedScaling, state: ScaleState) -> Dict[str, float]:
    """Frozen per-site scales for serving (forward classes only)."""
    return ds.freeze(state)


def freeze_with_formats(ds: DelayedScaling, state: ScaleState
                        ) -> Tuple[Dict[str, float], Dict[str, str]]:
    return ds.freeze(state), ds.frozen_formats()
