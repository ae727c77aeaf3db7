"""Delayed-scaling state: per-site amax ring buffers and derived scales.

Counterpart of `repro.scaling.state` (the history policies "max",
"most_recent" and "ema", `DelayedScaling.collect` / `update` for training
and calibration, and `freeze`). The state is small (50 sites a layer)
and lives on the host as numpy float32, so every derived scale is the
same IEEE f32 arithmetic as the reference's, and the kernels take their
scales by value.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.fp8_formats import get_format
from repro_torch.core.precision_policy import QuantConfig
from repro_torch.scaling import context as scale_ctx

_SAT_TOL = 1.0 - 2.0 ** -8

_CLASS_OF_LETTER = {"W": "weight", "A": "act", "E": "error", "G": "grad"}


def format_for_site(key: str, qcfg: QuantConfig,
                    kv_format: Optional[str] = None) -> Optional[str]:
    """Storage format a site key quantizes with (FP8 KV-cache sites follow
    `kv_format`; every other site follows the recipe via its class)."""
    base = key.split("#", 1)[0]
    if base.endswith(("kv/k", "kv/v")):
        return kv_format
    letter = key.rsplit("#", 1)[1][-1]
    cls = _CLASS_OF_LETTER.get(letter)
    if cls is None:
        raise ValueError(f"unrecognized tensor class {letter!r} in site "
                         f"key {key!r}")
    return qcfg.format_for(cls)


@dataclasses.dataclass
class ScaleState:
    amax_history: np.ndarray   # (n_sites, history_len) f32, col 0 = newest
    scale: np.ndarray          # (n_sites,) f32
    step: int

    @classmethod
    def create(cls, n_sites: int, history_len: int) -> "ScaleState":
        return cls(amax_history=np.zeros((n_sites, history_len), np.float32),
                   scale=np.ones((n_sites,), np.float32), step=0)


@dataclasses.dataclass(frozen=True)
class ScalingConfig:
    history_len: int = 16
    policy: str = "max"          # max | most_recent | ema
    margin: float = 2.0
    growth: float = 2.0
    ema_decay: float = 0.75      # for policy="ema"


def _sum_cols(x: np.ndarray) -> np.ndarray:
    """(S, H) f32 -> (S,) f32 row sums, added from the first column to the
    last, as the reference's update sums (numpy's pairwise sum would add
    in another order)."""
    acc = np.zeros((x.shape[0],), np.float32)
    for j in range(x.shape[1]):
        acc = (acc + x[:, j]).astype(np.float32)
    return acc


def amax_from_history(history: np.ndarray, cfg: ScalingConfig
                      ) -> np.ndarray:
    """(S, H) f32 history -> (S,) representative amax, per policy. The ema
    weights are built in f64 as the reference builds them, then cast to
    f32, and normalized over each row's populated prefix only; its sums
    are the reference's update's, bit for bit, up to a history of 32
    (the reference's reduction orders longer rows otherwise)."""
    if cfg.policy == "max":
        return history.max(axis=1)
    if cfg.policy == "most_recent":
        return history[:, 0].copy()
    if cfg.policy == "ema":
        h = history.shape[1]
        w = (1.0 - cfg.ema_decay) * cfg.ema_decay ** np.arange(h)
        w = (w / w.sum()).astype(np.float32)
        populated = (history > 0).astype(np.float32)
        denom = np.maximum(_sum_cols(populated * w[None, :]),
                           np.float32(1e-30))
        return (_sum_cols(history * w[None, :]) / denom).astype(np.float32)
    raise ValueError(f"unknown history policy {cfg.policy!r}")


class SiteRegistry:
    """Stable key -> row mapping (sorted keys, one row per key: the port's
    stack is unrolled, so every layer has its own keys). `token_sites`
    are the site keys with backward observations, sorted as in the
    reference."""

    def __init__(self, keys: Iterable[str], token_sites: Iterable[str] = ()):
        self.keys: Tuple[str, ...] = tuple(sorted(set(keys)))
        self.index: Dict[str, int] = {k: i for i, k in enumerate(self.keys)}
        self.token_sites: Tuple[str, ...] = tuple(sorted(set(token_sites)))

    def __len__(self) -> int:
        return len(self.keys)

    def class_letter(self, key: str) -> str:
        return key.rsplit("#", 1)[1][-1]

    def format_for(self, key: str, qcfg: QuantConfig) -> str:
        return qcfg.fwd_format if self.class_letter(key) in ("W", "A") \
            else qcfg.bwd_format

    def fmt_max_vector(self, qcfg: QuantConfig) -> np.ndarray:
        return np.asarray([get_format(self.format_for(k, qcfg)).max_normal
                           for k in self.keys], np.float32)

    def unpack(self, vec) -> Dict[str, np.float32]:
        return {k: np.float32(vec[i]) for k, i in self.index.items()}


@dataclasses.dataclass(frozen=True)
class DelayedScaling:
    registry: SiteRegistry
    config: ScalingConfig = ScalingConfig()
    qcfg: QuantConfig = QuantConfig(scaling="delayed")

    def init(self) -> ScaleState:
        return ScaleState.create(len(self.registry), self.config.history_len)

    def scales_dict(self, state: ScaleState) -> Dict[str, np.float32]:
        return self.registry.unpack(state.scale)

    def collect(self, state: ScaleState):
        """Activate a training (collect-mode) context over `state`'s
        scales; the forward and backward record into it, and
        `ctx.observations()` feeds `update`."""
        return scale_ctx.activate(
            scale_ctx.collect_context(self.scales_dict(state)))

    def update(self, state: ScaleState, observed: Mapping[str, float], *,
               sync: Optional[Callable] = None) -> ScaleState:
        """Fold one step of observations into history and re-derive scales
        (sites not observed carry their newest history value forward).
        sync: an optional cross-replica reduction of the dense observation
        vector (`distributed.amax_sync.make_amax_sync(group)`): one MAX
        over the replicas for every site, not one collective per site."""
        obs = state.amax_history[:, 0].copy()
        seen = np.zeros((len(self.registry),), bool)
        for k, v in observed.items():
            i = self.registry.index.get(k)
            if i is not None:
                obs[i] = np.float32(v)
                seen[i] = True
        if sync is not None:
            obs = np.asarray(sync(obs), np.float32)
        fmax = self.registry.fmt_max_vector(self.qcfg)
        cap = state.scale * fmax
        growth = np.float32(self.config.growth)
        obs = np.where(np.isfinite(obs), obs, cap * growth)
        # Pinned at the representable ceiling => probe the range upward.
        saturated = seen & (obs >= cap * np.float32(_SAT_TOL)) \
            & (obs <= cap / np.float32(_SAT_TOL))
        obs = np.where(saturated, obs * growth, obs).astype(np.float32)
        hist = np.concatenate([obs[:, None], state.amax_history[:, :-1]],
                              axis=1)
        amax = amax_from_history(hist, self.config)
        scale = np.where(amax > 0,
                         amax * np.float32(self.config.margin) / fmax,
                         np.float32(1.0))
        return ScaleState(amax_history=hist, scale=scale.astype(np.float32),
                          step=state.step + 1)

    def freeze(self, state: ScaleState) -> Dict[str, float]:
        """Frozen per-site scales for serving (forward classes W/A only)."""
        return {k: float(state.scale[i]) for k, i in self.registry.index.items()
                if self.registry.class_letter(k) in ("W", "A")}

    def frozen_formats(self, *, kv_format: Optional[str] = None
                       ) -> Dict[str, str]:
        """Storage format each frozen (forward) site was calibrated under.
        The FP8 KV-cache sites ('.../kv/{k,v}#A') record `kv_format` (the
        policy's kv_cache_format), or their class's format without one;
        their scales target the class's format all the same
        (`fmt_max_vector`), as the reference's do."""
        return {k: format_for_site(k, self.qcfg, kv_format)
                or self.registry.format_for(k, self.qcfg)
                for k in self.registry.keys
                if self.registry.class_letter(k) in ("W", "A")}
