"""Training and serving steps (counterpart of `repro.train.step`).

`make_train_step` builds the reference's `train_step` (no scaling: the
paper's recipe at unit scales) or, given a DelayedScaling, its
`train_step_scaled`: the paper's full Fig. 1b pipeline per step —

    fp16 master -> bf16 compute params -> FP8 forward / backward of the
    loss times the loss scale (the GEMMs and the attention through the
    hand-written kernels where the recipe takes them, SR bits from the
    step's generator) -> overflow probe -> unscale in f32 -> Adam in f32
    -> fp16 master store -> loss-scale update [-> delayed-scaling update]

on one device, or on each rank of a data-parallel `ParallelPlan` (the
gradients reduced over the ranks in f32 or through the e5m2
error-feedback wire; `make_train_step`'s docstring). Under delayed
scaling, forward amaxes and the backward's error / gradient amaxes are
recorded by the call sites into the step's scaling context, and with
`track_health` the precision-health pairs beside them. Either way the
step's loss, grad norm and overflow flag (and those observations) reach
the host in ONE device->host read; with scaling the host then updates
ScaleState (numpy f32, the reference's arithmetic) for the next step.

Gradient accumulation (`n_microbatches` > 1, the reference's scan): the
batch splits on its leading axis; each microbatch runs its forward and
backward in turn, drawing its SR bits from the step's generator in order,
into its own scaling context; gradients accumulate in f32 as g / n;
forward observations, backward observation sums and health pairs combine
by maximum over microbatches (`scaling.context.combine_microbatches`);
the loss and nll are the microbatches' mean.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.loss_scale import LossScaler
from repro_torch.core.master_weights import (MixedPrecisionOptimizer,
                                             MixedPrecisionState)
from repro_torch.device import resolve_device
from repro_torch.distributed import comm, global_batch, tensor_parallel
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import encode, forward, lm_loss
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


def _refuse_tp(plan, cfg: ModelConfig):
    """Tensor parallelism runs the attention-plus-dense-FFN decoders (the
    registry's qwen2, codeqwen, internlm2, mistral-large and llava, with
    llava's patch prefix) under two recipes: delayed scaling on the fused
    path (kernels 1-4, with the count variants under track_health) and
    the paper's recipe (no scaling) on the unfused path; with
    n_microbatches, remat and ZeRO-1 on a 'data' dim. The rest raises,
    naming ROADMAP.md and slice 10d: the mixture-of-experts FFN (expert
    parallelism), the RG-LRU, local-attention and xLSTM layers, the
    encoder-decoder (and seamless), a table whose vocabulary does not
    divide the 'model' dim (which the rules shard along d), a quantized
    logits head, just-in-time amax scaling and delayed scaling off the
    fused path."""
    q = cfg.policy.quant
    m = plan.tp_size
    kinds = set(cfg.layer_kinds())
    why = None
    if cfg.n_experts:
        why = "the mixture-of-experts FFN (expert parallelism)"
    elif cfg.is_encoder_decoder:
        why = "the encoder-decoder"
    elif kinds != {"attn"}:
        why = f"the {', '.join(sorted(kinds - {'attn'}))} layers"
    elif cfg.padded_vocab_size % m:
        why = (f"a vocabulary of {cfg.padded_vocab_size} rows over "
               f"{m} 'model' ranks (the table shards along d)")
    elif cfg.policy.quantize_logits_head:
        why = "a quantized logits head"
    elif q.enabled and q.scaling == "jit_amax":
        why = "just-in-time amax scaling"
    elif q.enabled and q.delayed and not (
            q.fuse_epilogue and q.fuse_attention
            and q.backend.startswith("pallas")):
        why = "delayed scaling off the fused path"
    if why is not None:
        raise NotImplementedError(
            f"{why} under tensor parallelism is not ported (ROADMAP.md, "
            "queue 1, slice 10d); build the plan with DistConfig(tp=False) "
            "or a mesh without a 'model' dim")


def _refuse_unported(plan, cfg: ModelConfig, spmd: bool):
    """What the step does not run yet raises, naming ROADMAP.md: outside
    tensor parallelism's scope (`_refuse_tp`, slice 10d); under "full",
    a mixture-of-experts model's global-dispatch ablation, whose dispatch
    the reference computes over the global batch, and a tied embedding
    table under a quantized head, whose gradient would be summed in the
    backward through the head and not through the embedding
    (`distributed.global_batch`)."""
    if plan.tp is not None:
        _refuse_tp(plan, cfg)
    if spmd and cfg.n_experts and not cfg.moe_per_sample_dispatch:
        raise NotImplementedError(
            "the mixture-of-experts global-dispatch ablation "
            "(moe_per_sample_dispatch=False) under wire='full': the "
            "reference dispatches over the tokens of the global batch, "
            "which no rank holds (ROADMAP.md, queue 1); use per-sample "
            "dispatch or wire='fp8_ef'")
    if spmd and cfg.tie_embeddings and cfg.policy.quantize_logits_head:
        raise NotImplementedError(
            "a tied embedding table under a quantized logits head with "
            "wire='full' (ROADMAP.md, queue 1)")


def _combine(gathered: torch.Tensor, op: str) -> torch.Tensor:
    """(n, L) rows of the ranks -> (L,): "max", or "sum" / "mean" added in
    rank order."""
    if op == "max":
        return gathered.amax(dim=0)
    acc = gathered[0]
    for i in range(1, gathered.shape[0]):
        acc = acc + gathered[i]
    return acc / gathered.shape[0] if op == "mean" else acc


def make_train_step(cfg: ModelConfig, optimizer: MixedPrecisionOptimizer,
                    *, scaling: Optional[DelayedScaling] = None,
                    n_microbatches: int = 1, amax_sync=None, plan=None,
                    device=None):
    """Returns train_step(state, batch, generator) -> (state, metrics)
    without `scaling`, and train_step(state, scale_state, batch, generator)
    -> ((state, scale_state), metrics) with it.

    state: MixedPrecisionState on `device` (CUDA unless device="cpu" is
    passed; the CPU runs the kernels' plain versions). batch: {"tokens",
    "labels"[, "loss_mask"]} (B, S), numpy or tensors. generator: a
    torch.Generator on the device, the source of every SR bit of the step
    (the reference's step_key). metrics: python floats — loss, nll (both
    unscaled), grad_norm (of the unscaled gradients), loss_scale (after
    the update), grads_finite, overflow_count, and the model's aux losses
    summed over its layers (a mixture-of-experts model's lb_loss,
    router_z_loss and dropped_frac; the loss includes them).

    With scaling, the model's `track_health` adds the reference's
    `health/<site key>` metrics, (2,) [sat_frac, flush_frac] arrays, and
    `scaling.qcfg.track_health` `health/scale_churn` (the share of sites
    whose scale moved) and `health/amax_sites` (the newest amax of every
    site, in registry order). `amax_sync` (`distributed.amax_sync.
    make_amax_sync(group)`) reduces the step's dense observation vector
    across replicas before the ScaleState update.

    With `cfg.remat` (and scanned layers) each layer is recomputed in the
    backward, as in the reference (`models.remat`): the step's results are
    those without recomputation, bit for bit.

    plan: a data-parallel `distributed.strategy.ParallelPlan`, the step
    running on every rank of its mesh, each with its own rows of the
    global batch and the same generator seed. Two paths, as in the
    reference:
      * wire "full" (and a plan that does not compress): the reference's
        one program over the global batch. The rank's rows: with one
        microbatch its contiguous shard (`data.pipeline.host_shard(batch,
        plan.dp_rank, plan.dp_size)`); with n > 1 microbatches, in each
        microbatch i, its share of the reference's microbatch i, the
        global rows [i B / n, (i + 1) B / n) (`data.pipeline.
        microbatch_shard(batch, plan.dp_rank, plan.dp_size, n)`, which
        the loop applies). The nll divides by the microbatch's global
        mask count (an all-reduce before the loss); every weight-operand
        gradient of `qeinsum` is summed in f32 over the dp ranks inside
        the backward, before its class-G Q node, so the Q node quantizes
        and observes the global sum (`distributed.global_batch`); the
        other gradients are summed in f32 after the backward; the loss,
        nll and aux losses are summed (a mixture-of-experts layer returns
        the rank's contributions to the global batch's aux losses).
      * plan.compresses (wire "fp8_ef" over a wire dim of more than one
        rank): each rank's loss is its shard's own mean; the gradients
        are averaged in f32 over the inner dp dims, then through the e5m2
        error-feedback all-reduce over the wire dim, and the loss and nll
        averaged. The step then takes and returns this rank's residual:
        train_step(state, [scale_state,] err, batch, generator) ->
        ((state, [scale_state,] err), metrics), err from
        plan.init_wire_state(state.master). amax_sync is ignored there:
        the observations are combined across the ranks already.
    Under either, the forward and backward amaxes are MAX-combined over
    the dp ranks and the health pairs averaged (the wire path keeps the
    reference's MAX for the forward pairs), all in ONE all-gather of the
    step's dense vector before its one device->host read. Every rank
    applies the same reduced gradients, so master weights, optimizer and
    loss-scale state and ScaleState stay equal across ranks, bit for bit,
    and a non-finite gradient skips the step on every rank.

    ZeRO-1 (plan.zero1): `state` holds this rank's shards of the master
    weights and the Adam moments (`plan.shard_state(whole state)`; the
    count, the loss scale and the residual stay whole). The step gathers
    the compute params over 'data' (bf16 shards; under a compressing plan
    with wire_zero_gather="fp8" the e4m3 gather, `plan.gather_params`),
    reduces each gradient to this rank's shard (under "full" a
    reduce-scatter over 'data', after a sum over the other dp dims; a
    gradient summed in the backward is sliced; under the wire the
    reduced gradient is sliced), combines the overflow flag and the
    squared grad norm over 'data' before the update, so that every rank
    skips an overflowing step together, and updates its shards in place.
    At two ranks its states are those without ZeRO-1, sliced, bit for
    bit.

    Tensor parallelism (plan.tp, a 'model' dim of m ranks, wire "full"):
    `state` holds this rank's 'model' shards (and of those its 'data'
    shards under ZeRO-1; `plan.shard_state`); every rank of a 'model'
    group takes the same rows. The step enters the group
    (`distributed.tensor_parallel.active`) around its loss and backward
    passes, with the plan's layout of the step's parameters
    (`TPGroup.with_layout`), and the layers run their TP sites on the
    shards the layout names: a
    row-parallel output and a column-parallel input gradient quantized
    after their f32 sum over 'model', attention on the rank's heads, the
    vocab-parallel embedding, head and cross-entropy; SR bits drawn whole
    and sliced. After each microbatch's backward its observations are
    combined over 'model' (`ScaleContext.tp_combine`: amaxes by MAX, a
    shard's health pairs averaged, a replicated one's taken once); the
    squared grad norm and the overflow flag sum a leaf's part over the
    dims its shards split it along; the loss is the same on every rank.
    So the group computes what one process computes on the same batch,
    up to f32 summation order, and the leaves TP leaves whole stay equal
    on every rank, bit for bit.

    Refused (NotImplementedError, naming ROADMAP.md): under a TP plan
    what slice 10d ports (`_refuse_tp`) and, under "full", a
    mixture-of-experts model's global-dispatch ablation and a tied
    embedding under a quantized head (`_refuse_unported`).

    The master weights and optimizer state are updated in place (see
    core.master_weights)."""
    dev = resolve_device(device)
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {n_microbatches}")
    cfg.check_ported()
    wire = plan is not None and plan.compresses
    spmd = plan is not None and not wire and plan.dp is not None \
        and plan.dp_size > 1
    if plan is not None:
        _refuse_unported(plan, cfg, spmd)
    zero = plan is not None and plan.zero1 is not None
    tpar = plan is not None and plan.tp is not None
    gather_fp8 = zero and wire and plan.dist.wire_zero_gather == "fp8"
    if wire:
        amax_sync = None
    # The process groups, looked up at the first call (every rank of the
    # mesh makes a multi-dim group in the same order).
    groups: Dict[str, object] = {}

    def group_table():
        if groups or not (wire or spmd or zero or tpar):
            return groups
        groups["tp"] = tensor_parallel.TPGroup(
            plan.tp_group(), plan.tp_rank, plan.tp_size) if tpar else None
        groups["dp"] = plan.dp_group() if (wire or spmd) else None
        groups["wire"] = plan.dp_allreduce() if wire else None
        groups["inner"] = [(plan.group(a), comm.group_size(plan.group(a)))
                           for a in plan.inner_dp_axes] if wire else []
        if zero:
            groups["zero"] = plan.zero_group()
            outer = tuple(a for a in plan.dp_axes if a != plan.zero1.axis)
            groups["outer"] = plan.group(outer) if outer else None
        return groups

    def global_denom(mb):
        """The global batch's max(mask count, 1) for this rank's shard."""
        mask = mb.get("loss_mask")
        local = torch.as_tensor(mask, dtype=torch.float32).to(dev).sum() \
            if mask is not None else torch.full(
                (), float(np.prod(np.shape(mb["labels"]))), device=dev)
        return torch.clamp_min(
            comm.all_reduce(local.reshape(1), "sum", groups["dp"])[0], 1.0)

    def grads_of(params, batch, generator, scale, collect):
        """The loss pass of one step: (scaled loss, its metrics (nll and
        the aux losses), gradients, the scaling context or None). Over
        microbatches: f32 gradients accumulated as g / n, the losses' and
        metrics' means, the contexts combined. `collect` makes a fresh
        scaling context's manager (None without scaling)."""
        tpg = groups.get("tp")
        if tpg is not None:
            tpg = tpg.with_layout(_leaves(tmap(lambda p, d: (p, d), params,
                                               plan.tp_dims())))

        def pass_(mb):
            denom = global_denom(mb) if spmd else None
            with (collect() if collect else contextlib.nullcontext()) as ctx, \
                    tensor_parallel.active(tpg):
                loss, mets = lm_loss(params, mb, cfg=cfg, qgen=generator,
                                     loss_scale=scale, loss_denom=denom)
                loss.backward()
            if ctx is not None and tpg is not None:
                # The microbatch's observations over 'model' (amaxes by
                # MAX, a shard's health pairs averaged), before the
                # microbatches combine.
                ctx.tp_combine(lambda v: comm.all_gather(v, tpg.group,
                                                         kind="tp"))
            return loss.detach(), mets, ctx

        if n_microbatches == 1:
            loss, mets, ctx = pass_(batch)
            return loss, mets, tmap(lambda p: p.grad, params), ctx
        div = torch.full((), float(n_microbatches), device=dev)
        acc = tmap(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=dev), params)
        losses, metses, ctxs = [], [], []
        for mb in split_batch(batch, n_microbatches):
            loss, mets, ctx = pass_(mb)
            with torch.no_grad():
                tmap(lambda a, p: a.add_(p.grad.float() / div), acc, params)
            for p in _leaves(params):
                p.grad = None
            losses.append(loss)
            metses.append(mets)
            ctxs.append(ctx)
        ctx = scale_ctx.combine_microbatches(ctxs) if collect else None
        mets = {k: torch.stack([m[k] for m in metses]).mean()
                for k in metses[0]}
        return torch.stack(losses).mean(), mets, acc, ctx

    def reduce_grads(grads, err, summed):
        """The dp reduction of the step's gradients: (reduced, new err).
        `summed`: a tree of bools, the leaves summed in the backward.
        Under ZeRO-1 each leaf comes out as this rank's shard."""
        dims = plan.zero_dims() if zero else tmap(lambda _: None, grads)
        n_zero = plan.zero_size if zero else 1

        def mine(g, d):
            return g if d is None else \
                torch.chunk(g, n_zero, dim=d)[plan.zero_rank]

        with torch.no_grad():
            if spmd:
                def one(g, was_summed, d):
                    g = g.float()
                    if was_summed:
                        return mine(g, d)
                    if d is None:
                        return comm.all_reduce(g, "sum", groups["dp"])
                    if groups["outer"] is not None:
                        g = comm.all_reduce(g, "sum", groups["outer"])
                    return comm.reduce_scatter(g, d, groups["zero"])
                return tmap(one, grads, summed, dims), err
            if not wire:
                return tmap(lambda g, d: mine(g.float(), d), grads,
                            dims), err
            g32 = tmap(lambda g: g.float(), grads)
            for grp, n in groups["inner"]:
                g32 = tmap(lambda g: comm.all_reduce(g, "sum", grp) / n, g32)
            red, err = groups["wire"](g32, err)
            return tmap(mine, red, dims), err

    def norm_and_finite(grads):
        """(the whole gradient's sum of squares, its overflow flag or None
        for `apply_gradients` to compute). A leaf's part is summed over
        the dims its shards split it along: 'data' under ZeRO-1 (one
        all-reduce), then 'model' under TP (a rank-order sum); a leaf
        replicated over a dim counts once."""
        if not (zero or tpar):
            return sum(torch.sum(torch.square(g.float()))
                       for g in _leaves(grads)), None
        zdims, tdims = plan.layout_dims(grads)
        zero_ = torch.zeros((), dtype=torch.float32, device=dev)
        # [sq, non-finite count] of the leaves split over (data, model).
        part = {(z, t): [zero_, zero_] for z in (0, 1) for t in (0, 1)}
        for g, zd, td in zip(_leaves(grads), _leaves(zdims),
                             _leaves(tdims)):
            acc = part[(int(zd is not None), int(td is not None))]
            acc[0] = acc[0] + torch.sum(torch.square(g.float()))
            acc[1] = acc[1] + (~torch.isfinite(g)).sum().float()
        if zero:
            red = comm.all_reduce(torch.stack(part[(1, 0)] + part[(1, 1)]),
                                  "sum", groups["zero"])
            part[(1, 0)], part[(1, 1)] = list(red[:2]), list(red[2:])
        if tpar:
            red = tensor_parallel.rank_sum(
                torch.stack(part[(0, 1)] + part[(1, 1)]), groups["tp"])
            part[(0, 1)], part[(1, 1)] = list(red[:2]), list(red[2:])
        sq = sum(v[0] for v in part.values())
        finite = sum(v[1] for v in part.values()) == 0
        return sq, finite

    def combine_ranks(local, pending, ctx):
        """The ranks' step scalars (loss, nll, aux: summed under "full",
        averaged under the wire) and the context's pending observations
        (amaxes by MAX; health pairs averaged, the wire's forward pairs by
        MAX), in one all-gather. Returns (scalars, observations)."""
        vec = torch.cat([v.float().reshape(-1) for v in local] + pending)
        rows = comm.all_gather(vec, groups["dp"])
        n_amax = len(ctx.collected) + len(ctx.collected_bwd) if ctx else 0
        n_fwd_health = 2 * len(ctx.health) if ctx else 0
        cuts = np.cumsum([len(local), n_amax, n_fwd_health])
        parts = [_combine(rows[:, :cuts[0]], "sum" if spmd else "mean"),
                 _combine(rows[:, cuts[0]:cuts[1]], "max"),
                 _combine(rows[:, cuts[1]:cuts[2]], "max" if wire else "mean"),
                 _combine(rows[:, cuts[2]:], "mean")]
        return parts[0], torch.cat(parts[1:])

    def run(state: MixedPrecisionState, batch: Dict,
            generator: torch.Generator, collect, err=None):
        """One step; `collect` makes a fresh scaling context's manager
        (None without scaling). Returns (new state, metrics, the context's
        observations, its health pairs, the new residual)."""
        if state.loss_scale.scale.device.type != dev.type:
            raise ValueError(f"train state on {state.loss_scale.scale.device}"
                             f", step built for {dev}")
        group_table()
        params = optimizer.compute_params(state)
        if zero:
            with torch.no_grad():
                params = plan.gather_params(params, fp8=gather_fp8)
        params = tmap(lambda p: p.requires_grad_(True), params)
        gb = global_batch.GlobalBatch(groups["dp"], plan.dp_size,
                                      _leaves(params)) if spmd else None
        with global_batch.active(gb):
            loss, mets, grads, ctx = grads_of(params, batch, generator,
                                              state.loss_scale.scale,
                                              collect)
        summed = tmap(lambda p: gb is not None and id(p) in gb.summed,
                      params)
        del params
        if wire or spmd or zero:
            grads, err = reduce_grads(grads, err, summed)
        sq, finite = norm_and_finite(grads)
        new_state, opt_m = optimizer.apply_gradients(state, grads, finite)
        inv = optimizer.scaler.inverse(state.loss_scale)
        aux_names = [k for k in mets if k != "nll"]
        local = [loss, mets["nll"]] + [mets[k] for k in aux_names]
        pending = ctx.pending() if ctx is not None else []
        if wire or spmd:
            scalars, obs_vec = combine_ranks(local, pending, ctx)
            local = list(scalars)
            pending = [obs_vec]
        step_vals = [local[0] * inv, local[1], torch.sqrt(sq) * inv,
                     opt_m["loss_scale"], opt_m["grads_finite"],
                     opt_m["overflow_count"]] + local[2:]
        n = len(step_vals)
        # The step's one device->host read: its scalars and every
        # observation of the scaling context (amaxes and health pairs).
        host = torch.cat([v.float().reshape(-1) for v in step_vals]
                         + pending).cpu().numpy()
        metrics = {k: float(v) for k, v in zip(
            ["loss", "nll", "grad_norm", "loss_scale", "grads_finite",
             "overflow_count"] + aux_names, host[:n])}
        metrics["grads_finite"] = bool(metrics["grads_finite"])
        if ctx is None:
            return new_state, metrics, {}, {}, err
        return (new_state, metrics, ctx.observations(host[n:]),
                ctx.health_observations(host[n:]), err)

    def scaled(state, scale_state, batch, generator, err=None):
        new_state, metrics, obs, health, err = run(
            state, batch, generator, lambda: scaling.collect(scale_state),
            err)
        new_scale_state = scaling.update(scale_state, obs, sync=amax_sync)
        metrics.update(health)
        if scaling.qcfg.track_health:
            moved = np.count_nonzero(scale_state.scale
                                     != new_scale_state.scale)
            metrics["health/scale_churn"] = float(
                np.float32(moved) / np.float32(scale_state.scale.size))
            metrics["health/amax_sites"] = \
                new_scale_state.amax_history[:, 0].copy()
        return new_state, new_scale_state, metrics, err

    if scaling is None and not wire:
        def train_step(state: MixedPrecisionState, batch: Dict,
                       generator: torch.Generator):
            new_state, metrics, _, _, _ = run(state, batch, generator, None)
            return new_state, metrics

        return train_step

    if scaling is None:
        def train_step_wire(state: MixedPrecisionState, err, batch: Dict,
                            generator: torch.Generator):
            new_state, metrics, _, _, err = run(state, batch, generator,
                                                None, err)
            return (new_state, err), metrics

        return train_step_wire

    if not wire:
        def train_step_scaled(state: MixedPrecisionState,
                              scale_state: ScaleState, batch: Dict,
                              generator: torch.Generator):
            new_state, new_ss, metrics, _ = scaled(state, scale_state, batch,
                                                   generator)
            return (new_state, new_ss), metrics

        return train_step_scaled

    def train_step_wire_scaled(state: MixedPrecisionState,
                               scale_state: ScaleState, err, batch: Dict,
                               generator: torch.Generator):
        new_state, new_ss, metrics, err = scaled(state, scale_state, batch,
                                                 generator, err)
        return (new_state, new_ss, err), metrics

    return train_step_wire_scaled


def split_batch(batch: Dict, n: int):
    """The n microbatches of a batch, each a dict of its leading-axis
    slice (numpy arrays or tensors)."""
    lead = len(next(iter(batch.values())))
    if lead % n:
        raise ValueError(f"batch of {lead} rows does not split into {n} "
                         "microbatches")
    m = lead // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


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
    Returns (logits (B, 1, V), states); the pools update in place. An
    encoder-decoder is refused: the reference's chunk step passes no
    enc_out; so is a stack with other layers than attention, which paged
    serving does not hold (ValueError, as the reference's)."""
    cfg.check_ported(serving=True, paged=True)
    ecfg = _eval_cfg(cfg, frozen_scales)

    def chunk_step(params, batch, states):
        with torch.no_grad(), _maybe_frozen(frozen_scales):
            page = {k: batch[k] for k in
                    ("write_slots", "read_slots", "slot_pos", "chunk_pos")}
            return forward(params, batch["tokens"], cfg=ecfg, mode="chunk",
                           states=states, positions=batch["positions"],
                           page=page, gather_rows=batch["last_row"])

    return chunk_step


def make_serve_prefill(cfg: ModelConfig, frozen_scales=None):
    """Fixed-slot prefill: batch {"tokens": (B, S)} through the causal
    forward, the prompt written into each layer's cache in place (with
    batch["slot"], only that row's cache). An encoder-decoder's batch also
    holds "enc_inputs" (B, T, D): `encode` runs first, under the same
    scales, and the decoder's cross-attention attends its output. A
    patch-stub batch may hold "extra_embeds" (B, P, D), prepended to the
    token embeddings (the cache then holds P + S positions). Returns
    (logits (B, 1, V) of the last position, states)."""
    ecfg = _eval_cfg(cfg, frozen_scales)

    def prefill(params, batch, states):
        page = {"slot": batch["slot"]} if "slot" in batch else None
        with torch.no_grad(), _maybe_frozen(frozen_scales):
            enc_out = encode(params, batch["enc_inputs"], cfg=ecfg) \
                if ecfg.is_encoder_decoder else None
            return forward(params, batch["tokens"], cfg=ecfg, mode="prefill",
                           states=states, page=page, last_only=True,
                           enc_out=enc_out,
                           extra_embeds=batch.get("extra_embeds"))

    return prefill


def make_serve_decode(cfg: ModelConfig, frozen_scales=None):
    """Fixed-slot decode: batch {"tokens", "positions"} (B, 1), one token
    per row appended to the caches, and for an encoder-decoder "enc_out",
    the encoder's output, which the caller computes as the reference's
    does (`encode` with `_eval_cfg(cfg, frozen_scales)` under
    `_maybe_frozen(frozen_scales)`, without gradients); the cross-attention
    projects it again at every step. Returns (logits (B, 1, V),
    states)."""
    ecfg = _eval_cfg(cfg, frozen_scales)

    def decode(params, batch, states):
        with torch.no_grad(), _maybe_frozen(frozen_scales):
            return forward(params, batch["tokens"], cfg=ecfg, mode="decode",
                           states=states, positions=batch["positions"],
                           enc_out=batch.get("enc_out"))

    return decode
