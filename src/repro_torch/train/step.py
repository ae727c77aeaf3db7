"""Serving step (counterpart of the serving half of `repro.train.step`).
The training step belongs to a later slice of the port."""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward
from repro_torch.scaling import context as scale_ctx


def _eval_cfg(cfg: ModelConfig, frozen_scales=None) -> ModelConfig:
    """RNE everywhere, saturating; delayed scaling when scales are frozen."""
    quant = cfg.policy.quant.eval_mode()
    if frozen_scales is not None:
        quant = dataclasses.replace(quant, scaling="delayed")
    return cfg.replace(policy=dataclasses.replace(cfg.policy, quant=quant))


def _maybe_frozen(frozen_scales):
    if frozen_scales is None:
        return contextlib.nullcontext()
    return scale_ctx.activate(scale_ctx.frozen_context(frozen_scales))


def make_serve_chunk(cfg: ModelConfig, frozen_scales=None):
    """Paged chunked serving step: each batch row carries a prompt chunk or
    one decode token (mode='chunk' attention over the block-table pool).

    batch keys: tokens/positions/write_slots (B, T), read_slots/slot_pos
    (B, C), chunk_pos (B, 2), last_row (B,) — int tensors on the device.
    Returns (logits (B, 1, V), states); the pools update in place."""
    ecfg = _eval_cfg(cfg, frozen_scales)

    def chunk_step(params, batch, states):
        with torch.no_grad(), _maybe_frozen(frozen_scales):
            page = {k: batch[k] for k in
                    ("write_slots", "read_slots", "slot_pos", "chunk_pos")}
            return forward(params, batch["tokens"], cfg=ecfg, mode="chunk",
                           states=states, positions=batch["positions"],
                           page=page, gather_rows=batch["last_row"])

    return chunk_step
