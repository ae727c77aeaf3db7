"""Training and serving steps (counterpart of `repro.train.step`).

`make_train_step` is the reference's `train_step_scaled`: the paper's full
Fig. 1b pipeline per step —

    fp16 master -> bf16 compute params -> FP8 forward / backward of the
    loss times the loss scale (every projection GEMM and the attention
    through the hand-written kernels, SR bits from the step's generator)
    -> overflow probe -> unscale in f32 -> Adam in f32 -> fp16 master
    store -> loss-scale update -> delayed-scaling update

on one device with one microbatch. Forward amaxes and the backward's
error / gradient amaxes are recorded by the call sites into the step's
scaling context; they reach the host together with the step's loss, grad
norm and overflow flag in ONE device->host read, after which the host
updates ScaleState (numpy f32, the reference's arithmetic) for the next
step.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.loss_scale import LossScaler
from repro_torch.core.master_weights import (MixedPrecisionOptimizer,
                                             MixedPrecisionState)
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward, lm_loss
from repro_torch.optim.optimizers import (make_leafwise, make_optimizer,
                                          tmap)
from repro_torch.scaling import context as scale_ctx
from repro_torch.scaling.state import DelayedScaling, ScaleState


def make_optimizer_for(cfg: ModelConfig, *, name: str = "adam",
                       scaler: Optional[LossScaler] = None,
                       learning_rate: float = 1e-4
                       ) -> MixedPrecisionOptimizer:
    """The mixed-precision optimizer of the policy (fp16 master, f32
    update math, bf16 compute params) on the fused leaf-wise path, which
    updates the master and the optimizer state in place."""
    init, update = make_optimizer(name, learning_rate=learning_rate)
    names, leaf = make_leafwise(name, learning_rate=learning_rate)
    return MixedPrecisionOptimizer(
        inner_init=init, inner_update=update,
        scaler=scaler or LossScaler(mode="enhanced"),
        master_dtype=cfg.policy.master_weight_dtype,
        update_dtype=cfg.policy.update_dtype,
        compute_dtype=cfg.policy.activation_dtype,
        accum_names=names, leaf_update=leaf)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to the training step yet (ROADMAP.md, "
        "queue 1)")


def make_train_step(cfg: ModelConfig, optimizer: MixedPrecisionOptimizer,
                    *, scaling: DelayedScaling, n_microbatches: int = 1,
                    amax_sync=None, plan=None, device=None):
    """Returns train_step(state, scale_state, batch, generator)
    -> ((state, scale_state), metrics).

    state: MixedPrecisionState on `device` (CUDA unless device="cpu" is
    passed; the CPU runs the kernels' plain versions). batch: {"tokens",
    "labels"[, "loss_mask"]} (B, S), numpy or tensors. generator: a
    torch.Generator on the device, the source of every SR bit of the step
    (the reference's step_key). metrics: python floats — loss, nll (both
    unscaled), grad_norm (of the unscaled gradients), loss_scale (after
    the update), grads_finite, overflow_count.

    The master weights and optimizer state are updated in place (see
    core.master_weights). Not ported (each raises): n_microbatches > 1, a
    ParallelPlan / fp8 wire, amax_sync, track_health, remat, a step
    without delayed scaling (the port has no unfused path)."""
    dev = resolve_device(device)
    if n_microbatches != 1:
        raise _not_ported("gradient accumulation (n_microbatches > 1)")
    if plan is not None:
        raise _not_ported("a ParallelPlan / fp8-on-the-wire collective")
    if amax_sync is not None:
        raise _not_ported("cross-replica amax sync")
    if scaling is None:
        raise _not_ported("a step without delayed scaling (unfused path)")
    if cfg.policy.quant.track_health or scaling.qcfg.track_health:
        raise _not_ported("precision-health tracking (track_health)")
    if cfg.remat:
        raise _not_ported("activation recomputation (remat=True); pass "
                          "remat=False")
    cfg.check_ported()

    def train_step(state: MixedPrecisionState, scale_state: ScaleState,
                   batch: Dict, generator: torch.Generator):
        if state.loss_scale.scale.device.type != dev.type:
            raise ValueError(f"train state on {state.loss_scale.scale.device}"
                             f", step built for {dev}")
        params = tmap(lambda p: p.requires_grad_(True),
                      optimizer.compute_params(state))
        scale = state.loss_scale.scale
        with scaling.collect(scale_state) as ctx:
            loss, aux = lm_loss(params, batch, cfg=cfg, qgen=generator,
                                loss_scale=scale)
            loss.backward()
        grads = tmap(lambda p: p.grad, params)
        del params
        new_state, opt_m = optimizer.apply_gradients(state, grads)
        inv = optimizer.scaler.inverse(state.loss_scale)
        sq = sum(torch.sum(torch.square(g.float())) for g in _leaves(grads))
        step_vals = [loss.detach() * inv, aux["nll"], torch.sqrt(sq) * inv,
                     opt_m["loss_scale"], opt_m["grads_finite"],
                     opt_m["overflow_count"]]
        n = len(step_vals)
        # The step's one device->host read: its scalars and every
        # observation of the scaling context.
        host = torch.stack([v.float().reshape(()) for v in
                            step_vals + ctx.pending()]).cpu().numpy()
        new_scale_state = scaling.update(scale_state,
                                         ctx.observations(host[n:]))
        metrics = {k: float(v) for k, v in zip(
            ("loss", "nll", "grad_norm", "loss_scale", "grads_finite",
             "overflow_count"), host[:n])}
        metrics["grads_finite"] = bool(metrics["grads_finite"])
        return (new_state, new_scale_state), metrics

    return train_step


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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
