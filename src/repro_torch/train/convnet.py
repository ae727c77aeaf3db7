"""The paper's convnet training run (counterpart of the reference's
`benchmarks/common.py::train_convnet`): the reduced ResNet on synthetic
images, momentum SGD through the fp16-master optimizer, the loss scaled
by the scaler, and evaluation with RNE.

`make_convnet_step` is the training step: fp16 master -> bf16 compute
params -> FP8 forward / backward of the scaled loss (each FP8 conv's
forward GEMM through the fp8 GEMM kernel under a kernel backend, SR bits
from the step's generator) -> [the gradients' underflow fraction] ->
overflow probe, unscale in f32, momentum in f32, fp16 store, loss-scale
update. Its scalars reach the host in one device->host read.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.fp8_formats import get_format
from repro_torch.core.loss_scale import LossScaler, underflow_fraction
from repro_torch.core.master_weights import (MixedPrecisionOptimizer,
                                             MixedPrecisionState)
from repro_torch.core.precision_policy import QuantConfig
from repro_torch.data.pipeline import synthetic_image_batches
from repro_torch.device import resolve_device
from repro_torch.models.resnet import ResNetConfig, init_resnet, resnet_loss
from repro_torch.optim.optimizers import (MomentumConfig, momentum_leafwise,
                                          momentum_sgd, tmap)

def momentum_optimizer(lr: float, scaler: LossScaler,
                       master_dtype: str = "float16"
                       ) -> MixedPrecisionOptimizer:
    """Momentum 0.9 SGD in the mixed-precision optimizer (fp16 master, f32
    update math, bf16 compute params) on its leaf-wise, in-place path."""
    cfg = MomentumConfig(learning_rate=lr, momentum=0.9)
    init, update = momentum_sgd(cfg)
    names, leaf = momentum_leafwise(cfg)
    return MixedPrecisionOptimizer(inner_init=init, inner_update=update,
                                   scaler=scaler, master_dtype=master_dtype,
                                   accum_names=names, leaf_update=leaf)


def make_convnet_step(cfg: ResNetConfig, opt: MixedPrecisionOptimizer, *,
                      include_l2: bool = True,
                      track_underflow: bool = False):
    """train_step(state, batch, generator) -> (state, metrics): python
    floats nll, l2_loss, accuracy, loss_scale (after the update),
    grads_finite, overflow_count, underflow_frac (0 unless
    track_underflow: the fraction of the scaled gradients' nonzero
    entries that e5m2 would flush). The master weights and the momentum
    are updated in place."""

    def train_step(state: MixedPrecisionState, batch: Dict,
                   generator: torch.Generator):
        params = tmap(lambda p: p.requires_grad_(True),
                      opt.compute_params(state))
        loss, aux = resnet_loss(params, batch, cfg=cfg, qgen=generator,
                                loss_scale=state.loss_scale.scale,
                                include_l2=include_l2)
        loss.backward()
        grads = tmap(lambda p: p.grad, params)
        del params
        # e5m2's smallest subnormal, 2^-16: the paper's Fig. 2a measurement.
        uf = underflow_fraction(
            grads, threshold=get_format("e5m2").min_subnormal) \
            if track_underflow else torch.zeros((), device=loss.device)
        state, opt_m = opt.apply_gradients(state, grads)
        names = ("nll", "l2_loss", "accuracy", "loss_scale", "grads_finite",
                 "overflow_count", "underflow_frac")
        vals = [aux["nll"], aux["l2_loss"], aux["accuracy"],
                opt_m["loss_scale"], opt_m["grads_finite"],
                opt_m["overflow_count"], uf]
        host = torch.stack([v.float().reshape(()) for v in vals]).cpu()
        metrics = dict(zip(names, host.tolist()))
        metrics["grads_finite"] = bool(metrics["grads_finite"])
        return state, metrics

    return train_step


def make_convnet_eval(cfg: ResNetConfig, opt: MixedPrecisionOptimizer):
    """eval_step(state, batch) -> {nll, accuracy}: the compute params, no
    generator (so RNE, saturating), no L2."""

    def eval_step(state: MixedPrecisionState, batch: Dict):
        with torch.no_grad():
            _, m = resnet_loss(opt.compute_params(state), batch, cfg=cfg,
                               include_l2=False)
        host = torch.stack([m["nll"], m["accuracy"]]).cpu().tolist()
        return {"nll": host[0], "accuracy": host[1]}

    return eval_step


def train_convnet(*, quant: QuantConfig, scaler: LossScaler,
                  steps: int = 150, seed: int = 0, lr: float = 0.05,
                  include_l2: bool = True, weight_decay: float = 5e-4,
                  batch_size: int = 64, eval_every: int = 25,
                  track_underflow: bool = False, params=None,
                  device=None) -> Dict:
    """The reference's convnet run: ResNetConfig((1, 1), (16, 32)) on
    16x16 images (noise 1.6), momentum SGD from weights drawn from `seed`,
    SR bits from a generator seeded 7, validation on one 256-image batch.
    params: initial weights (the reference's, carried across); drawn from
    `seed` when None.
    Returns the reference's history dict (step, train_nll, val_acc,
    val_nll, l2_loss, loss_scale, underflow_frac, overflows) at every
    `eval_every`-th step and the last. On the CUDA device unless `device`
    says otherwise."""
    dev = resolve_device(device)
    cfg = ResNetConfig(depth_per_stage=(1, 1), widths=(16, 32), quant=quant,
                       weight_decay=weight_decay)
    opt = momentum_optimizer(lr, scaler)
    if params is None:
        params = init_resnet(cfg, seed=seed, device=dev)
    state = opt.init(params)
    # noise=1.6 keeps the task hard enough that the precision and rounding
    # ablations separate.
    train_it = synthetic_image_batches(batch_size=batch_size, image_size=16,
                                       seed=seed, noise=1.6)
    val_batch = next(synthetic_image_batches(batch_size=256, image_size=16,
                                             seed=seed + 1000, noise=1.6))
    step = make_convnet_step(cfg, opt, include_l2=include_l2,
                             track_underflow=track_underflow)
    evaluate = make_convnet_eval(cfg, opt)
    gen = torch.Generator(device=dev).manual_seed(7)
    hist = {k: [] for k in ("step", "train_nll", "val_acc", "val_nll",
                            "l2_loss", "loss_scale", "underflow_frac",
                            "overflows")}
    for i in range(steps):
        state, m = step(state, next(train_it), gen)
        if i % eval_every == 0 or i == steps - 1:
            ev = evaluate(state, val_batch)
            hist["step"].append(i)
            hist["train_nll"].append(m["nll"])
            hist["val_acc"].append(ev["accuracy"])
            hist["val_nll"].append(ev["nll"])
            hist["l2_loss"].append(m["l2_loss"])
            hist["loss_scale"].append(m["loss_scale"])
            hist["underflow_frac"].append(m["underflow_frac"])
            hist["overflows"].append(m["overflow_count"])
    return hist

