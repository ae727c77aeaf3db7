"""Reduced ResNet with FP8 convolutions (counterpart of
`repro.models.resnet`): the paper's convnet workload at CIFAR scale.

The stem conv and the classifier head stay at 16 bits (the paper's
first/last-layer rule); every other conv runs the FP8 recipe through
`core.qconv.qconv2d`, so under a kernel backend each forward conv GEMM is
the fp8 GEMM kernel. Normalization is the reference's GroupNorm-style
per-channel scale and shift with statistics in f32.

Parameters are nested dicts of tensors keyed as the reference's:
{"stem", "stem_gn", "s{stage}_b{block}": {"conv1", "gn1", "conv2", "gn2"
[, "proj"]}, "head"}. Convolutions carry no `site`, so the model runs
without delayed scaling (`scaling="none"`: PAPER_FP8, PAPER_FP8_RNE,
BASELINE), as the reference's benchmarks run it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.precision_policy import (BASELINE, PAPER_FP8,
                                               QuantConfig)
from repro_torch.core.qconv import conv_init, qconv2d
from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init
from repro_torch.optim.optimizers import l2_regularization_loss


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth_per_stage: Tuple[int, ...] = (2, 2, 2)
    widths: Tuple[int, ...] = (32, 64, 128)
    n_classes: int = 10
    quant: QuantConfig = PAPER_FP8
    weight_decay: float = 5e-4


def _groupnorm(params, x: torch.Tensor, *, groups: int = 8,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (H, W, channels of a group) with min(groups, C)
    groups: mean and population variance in f32, then scale and shift,
    cast back to x's dtype."""
    b, h, w, c = x.shape
    g = min(groups, c)
    xf = x.float().reshape(b, h, w, g, c // g)
    mu = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = xf.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    xn = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xn * params["scale"] + params["bias"]).to(x.dtype)


def _init_gn(c: int, device):
    return {"scale": torch.ones((c,), dtype=torch.float32, device=device),
            "bias": torch.zeros((c,), dtype=torch.float32, device=device)}


def init_resnet(cfg: ResNetConfig, *, seed: int = 0, device=None):
    """Random weights drawn from `seed` (a torch.Generator on the target
    device), with the reference's shapes and initializers."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=gen, device=dev)
    params = {"stem": conv_init(3, 3, 3, cfg.widths[0], **kw),
              "stem_gn": _init_gn(cfg.widths[0], dev)}
    c_prev = cfg.widths[0]
    for s, (depth, c) in enumerate(zip(cfg.depth_per_stage, cfg.widths)):
        for i in range(depth):
            blk = {"conv1": conv_init(3, 3, c_prev if i == 0 else c, c, **kw),
                   "gn1": _init_gn(c, dev),
                   "conv2": conv_init(3, 3, c, c, **kw),
                   "gn2": _init_gn(c, dev)}
            if i == 0 and c_prev != c:
                blk["proj"] = conv_init(1, 1, c_prev, c, **kw)
            params[f"s{s}_b{i}"] = blk
        c_prev = c
    params["head"] = dense_init(c_prev, cfg.n_classes, **kw)
    return params


def resnet_forward(params, x: torch.Tensor, *, cfg: ResNetConfig,
                   qgen: Optional[torch.Generator] = None) -> torch.Tensor:
    """x: (B, H, W, 3) -> f32 logits (B, n_classes). Without `qgen` a
    config that rounds stochastically runs its eval variant (RNE,
    saturating), as the reference does without a key."""
    q = cfg.quant
    if qgen is None and q.needs_key:
        q = q.eval_mode()
    h = qconv2d(x.to(torch.bfloat16), params["stem"], cfg=BASELINE)
    h = torch.relu(_groupnorm(params["stem_gn"], h))
    for s, (depth, c) in enumerate(zip(cfg.depth_per_stage, cfg.widths)):
        for i in range(depth):
            blk = params[f"s{s}_b{i}"]
            stride = (2, 2) if (i == 0 and s > 0) else (1, 1)
            r = qconv2d(h, blk["conv1"], stride=stride, cfg=q,
                        generator=qgen)
            r = torch.relu(_groupnorm(blk["gn1"], r))
            r = qconv2d(r, blk["conv2"], cfg=q, generator=qgen)
            r = _groupnorm(blk["gn2"], r)
            sc = h
            if "proj" in blk:
                sc = qconv2d(h, blk["proj"], stride=stride, cfg=q,
                             generator=qgen)
            elif stride != (1, 1):
                sc = h[:, ::2, ::2]
            h = torch.relu(sc.float() + r.float()).to(torch.bfloat16)
    pooled = h.float().mean(dim=(1, 2))
    # The 16-bit head: bf16 operands, f32 products and sums, a bf16 result.
    logits = (pooled.to(torch.bfloat16).float()
              @ params["head"].to(torch.bfloat16).float()).to(torch.bfloat16)
    return logits.float()


def resnet_loss(params, batch, *, cfg: ResNetConfig,
                qgen: Optional[torch.Generator] = None,
                loss_scale: Optional[torch.Tensor] = None,
                include_l2: bool = True):
    """Cross-entropy plus the paper's L2 loss. batch: {"image" (B, H, W,
    3), "label" (B,)}, tensors on the params' device or numpy. Returns
    (loss, metrics {nll, l2_loss, accuracy}); with `loss_scale` the loss
    is multiplied by it."""
    dev = params["head"].device
    image = torch.as_tensor(batch["image"]).to(device=dev,
                                               dtype=torch.float32)
    labels = torch.as_tensor(batch["label"]).to(device=dev,
                                                dtype=torch.long)
    logits = resnet_forward(params, image, cfg=cfg, qgen=qgen)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None]).mean()
    l2 = l2_regularization_loss(params, cfg.weight_decay) if include_l2 \
        else torch.zeros((), dtype=torch.float32, device=dev)
    loss = nll + l2
    acc = (logits.argmax(-1) == labels).float().mean()
    if loss_scale is not None:
        loss = loss * loss_scale.to(loss.dtype)
    return loss, {"nll": nll.detach(), "l2_loss": l2.detach(),
                  "accuracy": acc}
