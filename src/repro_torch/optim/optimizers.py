"""Optimizers as (init, update) pairs over dicts of tensors (counterpart of
`repro.optim.optimizers`).

`momentum_sgd` / `adam` work on whole parameter trees and return updates
(deltas to add); `momentum_leafwise` / `adam_leafwise` give the update of
one leaf, so `core.master_weights.MixedPrecisionOptimizer` can run
unscale -> update -> overflow-select -> downcast leaf by leaf and keep its
f32 temporaries per leaf. All update math is f32, in the reference's
order of operations; scalars (learning rate, bias corrections) are 0-d f32
tensors on the parameters' device, as the reference's are f32 arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


def tmap(fn, *trees):
    """Map `fn` over matching leaves of nested dicts."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tmap(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def _lr(cfg, lr_schedule, count: torch.Tensor) -> torch.Tensor:
    if lr_schedule is not None:
        return lr_schedule(count)
    # A fill on the device: no blocking host-to-device copy per leaf.
    return torch.full((), cfg.learning_rate, dtype=torch.float32,
                      device=count.device)


def _bias_correction(beta: float, count: torch.Tensor) -> torch.Tensor:
    """1 - beta ** count in f32."""
    c = count.to(torch.float32)
    return 1.0 - torch.pow(torch.full((), beta, dtype=torch.float32,
                                      device=c.device), c)


def l2_regularization_loss(params, weight_decay: float) -> torch.Tensor:
    """The paper's L2_loss = weight_decay * sum_i w_i^2 over every floating
    leaf, squares summed in f32, leaves in the reference's order (sorted
    keys, as jax.tree_util.tree_leaves walks a dict)."""
    total = None
    for p in _sorted_leaves(params):
        if p.is_floating_point():
            sq = torch.sum(torch.square(p.float()))
            total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32)
    return weight_decay * total


def warmup_rsqrt_schedule(base_lr: float, warmup_steps: int = 4000):
    """The Transformer learning-rate schedule: linear warm-up, then
    1/sqrt(step); count (an integer tensor) -> 0-d f32 tensor."""
    def sched(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp_min(count.to(torch.float32), 1.0)
        return base_lr * torch.minimum(c * warmup_steps ** -1.5,
                                       torch.pow(c, -0.5))
    return sched


# ---------------------------------------------------------------------------
# Momentum SGD
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MomentumConfig:
    learning_rate: float = 0.1
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 0.0


def momentum_sgd(cfg: MomentumConfig,
                 lr_schedule: Optional[Callable] = None):
    def init(params):
        dev = next(iter(_leaves(params))).device
        return {"mu": tmap(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        count = state["count"] + 1
        lr = _lr(cfg, lr_schedule, count)
        if cfg.weight_decay:
            grads = tmap(lambda g, p: g + cfg.weight_decay * p, grads, params)
        mu = tmap(lambda m, g: cfg.momentum * m + g, state["mu"], grads)
        if cfg.nesterov:
            upd = tmap(lambda m, g: -(lr * (cfg.momentum * m + g)), mu, grads)
        else:
            upd = tmap(lambda m: -(lr * m), mu)
        return upd, {"mu": mu, "count": count}

    return init, update


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamConfig:
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


def adam(cfg: AdamConfig, lr_schedule: Optional[Callable] = None):
    def init(params):
        dev = next(iter(_leaves(params))).device
        return {"mu": tmap(torch.zeros_like, params),
                "nu": tmap(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        count = state["count"] + 1
        lr = _lr(cfg, lr_schedule, count)
        if cfg.weight_decay:
            grads = tmap(lambda g, p: g + cfg.weight_decay * p, grads, params)
        mu = tmap(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g,
                  state["mu"], grads)
        nu = tmap(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * torch.square(g),
                  state["nu"], grads)
        mu_hat_scale = 1.0 / _bias_correction(cfg.b1, count)
        nu_hat_scale = 1.0 / _bias_correction(cfg.b2, count)
        upd = tmap(lambda m, v: -(lr * (m * mu_hat_scale)
                                  / (torch.sqrt(v * nu_hat_scale) + cfg.eps)),
                   mu, nu)
        return upd, {"mu": mu, "nu": nu, "count": count}

    return init, update


def make_optimizer(name: str, **kwargs):
    """'momentum' | 'adam' -> (init, update)."""
    lr_schedule = kwargs.pop("lr_schedule", None)
    if name == "momentum":
        return momentum_sgd(MomentumConfig(**kwargs), lr_schedule)
    if name == "adam":
        return adam(AdamConfig(**kwargs), lr_schedule)
    raise ValueError(f"unknown optimizer {name!r}")


# ---------------------------------------------------------------------------
# leaf-wise variants: (names of the accumulators, leaf(g32, accums, count,
# p32) -> (update, new accums))
# ---------------------------------------------------------------------------

def momentum_leafwise(cfg: MomentumConfig,
                      lr_schedule: Optional[Callable] = None):
    names = ("mu",)

    def leaf(g32, accums, count, p32):
        lr = _lr(cfg, lr_schedule, count)
        if cfg.weight_decay:
            g32 = g32 + cfg.weight_decay * p32
        mu = cfg.momentum * accums["mu"] + g32
        upd = -(lr * (cfg.momentum * mu + g32)) if cfg.nesterov \
            else -(lr * mu)
        return upd, {"mu": mu}

    return names, leaf


def adam_leafwise(cfg: AdamConfig, lr_schedule: Optional[Callable] = None):
    names = ("mu", "nu")

    def leaf(g32, accums, count, p32):
        lr = _lr(cfg, lr_schedule, count)
        if cfg.weight_decay:
            g32 = g32 + cfg.weight_decay * p32
        mu = cfg.b1 * accums["mu"] + (1 - cfg.b1) * g32
        nu = cfg.b2 * accums["nu"] + (1 - cfg.b2) * torch.square(g32)
        mu_hat = mu / _bias_correction(cfg.b1, count)
        nu_hat = nu / _bias_correction(cfg.b2, count)
        upd = -(lr * mu_hat / (torch.sqrt(nu_hat) + cfg.eps))
        return upd, {"mu": mu, "nu": nu}

    return names, leaf


def make_leafwise(name: str, **kwargs):
    lr_schedule = kwargs.pop("lr_schedule", None)
    if name == "momentum":
        return momentum_leafwise(MomentumConfig(**kwargs), lr_schedule)
    if name == "adam":
        return adam_leafwise(AdamConfig(**kwargs), lr_schedule)
    raise ValueError(f"unknown optimizer {name!r}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k])
    else:
        yield tree
