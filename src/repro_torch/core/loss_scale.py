"""Loss scaling: constant, dynamic back-off, and the paper's ENHANCED scheme
(counterpart of `repro.core.loss_scale`).

e5m2 keeps fp16's exponent range but has a 256x smaller subnormal range,
so error gradients underflow earlier than in fp16 training. The enhanced
scaler is dynamic back-off scaling whose minimum threshold rises on a
schedule of (step, min_scale) knots.

The state lives on the device as 0-d tensors and every update is
branch-free `torch.where` arithmetic, so a training step never has to read
the overflow flag back to the host to advance the scaler.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class LossScaleState:
    scale: torch.Tensor           # f32 0-d, current loss scale
    growth_count: torch.Tensor    # i32, consecutive finite steps
    step: torch.Tensor            # i32, global step (drives the schedule)
    overflow_count: torch.Tensor  # i32, total overflow events

    @classmethod
    def create(cls, init_scale: float, device=None) -> "LossScaleState":
        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=device)
        return cls(scale=torch.tensor(init_scale, dtype=torch.float32,
                                      device=device),
                   growth_count=i32(0), step=i32(0), overflow_count=i32(0))


def all_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every floating leaf of `tree` (a dict of tensors)
    is finite — the overflow probe, kept on the device."""
    leaves = [torch.isfinite(x.float()).all() for x in _leaves(tree)
              if x.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    return torch.stack(leaves).all()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@dataclasses.dataclass(frozen=True)
class LossScaler:
    """mode: 'constant' (fixed scale), 'dynamic' (back-off), 'enhanced'
    (dynamic + a minimum threshold rising on `min_scale_schedule`)."""
    mode: str = "enhanced"
    init_scale: float = 2.0 ** 13
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    max_scale: float = 2.0 ** 24
    min_scale: float = 1.0
    min_scale_schedule: Tuple[Tuple[int, float], ...] = \
        ((40_000, 8192.0), (150_000, 32768.0))

    def __post_init__(self):
        if self.mode not in ("constant", "dynamic", "enhanced"):
            raise ValueError(f"unknown loss-scaler mode {self.mode!r}")

    def init(self, device=None) -> LossScaleState:
        return LossScaleState.create(self.init_scale, device=device)

    def min_scale_at(self, step: torch.Tensor) -> torch.Tensor:
        floor = torch.full_like(step, self.min_scale, dtype=torch.float32)
        if self.mode != "enhanced":
            return floor
        for knot_step, knot_min in self.min_scale_schedule:
            floor = torch.where(step >= knot_step,
                                torch.full_like(floor, knot_min), floor)
        return floor

    def scale_loss(self, state: LossScaleState, loss: torch.Tensor
                   ) -> torch.Tensor:
        return loss * state.scale.to(loss.dtype)

    def inverse(self, state: LossScaleState) -> torch.Tensor:
        """1 / scale in f32 (an IEEE division on a device tensor)."""
        return torch.ones_like(state.scale) / state.scale

    def unscale(self, state: LossScaleState, grads):
        """Divide gradients by the scale in full precision (f32)."""
        inv = self.inverse(state)
        return {k: (self.unscale(state, v) if isinstance(v, dict)
                    else v.float() * inv) for k, v in grads.items()}

    def update(self, state: LossScaleState, grads_finite: torch.Tensor
               ) -> LossScaleState:
        fin = torch.as_tensor(grads_finite, device=state.scale.device)
        bad = (~fin).to(torch.int32)
        if self.mode == "constant":
            return LossScaleState(scale=state.scale,
                                  growth_count=state.growth_count,
                                  step=state.step + 1,
                                  overflow_count=state.overflow_count + bad)
        grew = state.growth_count + 1 >= self.growth_interval
        ok_scale = torch.where(
            grew, torch.clamp_max(state.scale * self.growth_factor,
                                  self.max_scale), state.scale)
        ok_count = torch.where(grew, torch.zeros_like(state.growth_count),
                               state.growth_count + 1)
        scale = torch.where(fin, ok_scale, state.scale * self.backoff_factor)
        # The floor is evaluated at the post-increment step, as in the
        # reference: a knot at step S bounds the update that lands on S.
        scale = torch.maximum(scale, self.min_scale_at(state.step + 1))
        return LossScaleState(
            scale=scale,
            growth_count=torch.where(fin, ok_count,
                                     torch.zeros_like(ok_count)),
            step=state.step + 1,
            overflow_count=state.overflow_count + bad)


# The paper's scalers ---------------------------------------------------------

def convnet_scaler(scale: float = 10_000.0) -> LossScaler:
    """Constant scaling: ResNets train under e5m2 at 10000, not 1000."""
    return LossScaler(mode="constant", init_scale=scale)


def gnmt_scaler() -> LossScaler:
    """Dynamic scaling with a minimum rising to 8K at 40K steps and 32K at
    150K."""
    return LossScaler(mode="enhanced")


def transformer_scaler() -> LossScaler:
    return LossScaler(mode="enhanced", init_scale=2.0 ** 13)


def underflow_fraction(tree, *, threshold: float) -> torch.Tensor:
    """0-d f32 tensor: the fraction of the nonzero floating entries of
    `tree` whose magnitude RNE would flush to zero in a format whose
    smallest subnormal is `threshold` (below half of it)."""
    num = tot = None
    for g in _leaves(tree):
        if not g.is_floating_point():
            continue
        gf = g.float().abs()
        nz = gf > 0
        under = (nz & (gf < threshold / 2)).sum()
        num = under if num is None else num + under
        tot = nz.sum() if tot is None else tot + nz.sum()
    if num is None:
        return torch.zeros((), dtype=torch.float32)
    return num.to(torch.float32) / torch.clamp_min(tot, 1).to(torch.float32)
