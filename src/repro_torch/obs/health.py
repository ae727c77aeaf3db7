"""Anomaly detectors over the metrics stream (counterpart of
`repro.obs.health`; the same detectors, thresholds, cooldown and event
layout).

`HealthMonitor.observe(step, record)` runs after each step on the
host-side (already serialized) metrics record and returns a list of
structured `health_events` dicts — TrainLoop attaches them to the same
jsonl record, so the anomaly stream is joinable with the metric that
triggered it.

Detectors (each a paper-operational failure mode):
 * overflow        — `overflow_count` incremented: a loss-scale back-off
                     event (normal under dynamic scaling; the trajectory
                     is the Fig. 2b signal).
 * scale_floor     — an overflow landed the scale ON the enhanced
                     schedule's minimum threshold: the paper's Fig. 2b
                     mechanism engaging (needs the scaler's schedule).
 * loss_scale_flapping — >= `flap_min_changes` direction changes of the
                     loss scale inside `flap_window` steps: growth
                     interval and overflow rate are fighting.
 * saturation      — a site's saturation fraction above `sat_threshold`:
                     its per-tensor scale is too large for the format.
 * underflow       — a site's flush fraction above `flush_threshold`.
 * range_overflow  — saturation AND flush high simultaneously: the site's
                     dynamic range exceeds what ONE per-tensor scale can
                     place inside the format (per-channel scaling or a
                     wider format needed).
 * stuck_amax      — a site's amax bit-identical for `stuck_window`
                     consecutive steps (dead site / frozen-scale leak).
 * nan_amax        — a site observed a non-finite amax.
 * straggler_streak — `stragglers` incremented on `straggler_streak`
                     consecutive steps: persistent slow host, not noise.

Per-(kind, site) cooldown (`cooldown` steps) keeps a persistent condition
from emitting one event per step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

HEALTH_METRIC_PREFIX = "health/"


@dataclasses.dataclass
class HealthConfig:
    flap_window: int = 20
    flap_min_changes: int = 6
    sat_threshold: float = 0.05
    flush_threshold: float = 0.9
    stuck_window: int = 25
    straggler_streak: int = 3
    cooldown: int = 20


class HealthMonitor:
    def __init__(self, cfg: Optional[HealthConfig] = None, *,
                 site_names: Optional[Sequence[str]] = None,
                 scaler=None):
        """site_names: registry row order of the dense `health/amax_sites`
        vector (DelayedScaling.registry row order — logger meta carries the
        same list). scaler: optional LossScaler (core.loss_scale) for the
        schedule-floor detector."""
        self.cfg = cfg or HealthConfig()
        self.site_names = list(site_names) if site_names else None
        self.scaler = scaler
        self._scales: List[float] = []
        self._last_overflow: Optional[float] = None
        self._amax_prev: Optional[np.ndarray] = None
        self._amax_stuck: Optional[np.ndarray] = None
        self._last_stragglers: Optional[float] = None
        self._straggler_run = 0
        self._last_emit: Dict[Any, int] = {}

    # -- helpers --------------------------------------------------------------
    def _emit(self, events, step, kind, site=None, value=None, msg=""):
        key = (kind, site)
        last = self._last_emit.get(key)
        if last is not None and step - last < self.cfg.cooldown:
            return
        self._last_emit[key] = step
        ev: Dict[str, Any] = {"step": int(step), "kind": kind}
        if site is not None:
            ev["site"] = site
        if value is not None:
            ev["value"] = float(value)
        if msg:
            ev["msg"] = msg
        events.append(ev)

    def _site(self, i: int) -> str:
        if self.site_names and i < len(self.site_names):
            return self.site_names[i]
        return f"row{i}"

    # -- main -----------------------------------------------------------------
    def observe(self, step: int, record: Dict[str, Any]) -> List[Dict]:
        events: List[Dict] = []
        cfg = self.cfg

        # overflow + schedule floor
        oc = record.get("overflow_count")
        scale = record.get("loss_scale")
        if oc is not None:
            oc = float(oc)
            if self._last_overflow is not None and oc > self._last_overflow:
                self._emit(events, step, "overflow", value=oc,
                           msg="loss-scale overflow event")
                if self.scaler is not None and scale is not None \
                        and getattr(self.scaler, "mode", "") == "enhanced":
                    floor = float(self.scaler.min_scale_at(
                        torch.tensor(step, dtype=torch.int32)))
                    if floor > float(self.scaler.min_scale) \
                            and float(scale) <= floor:
                        self._emit(events, step, "scale_floor", value=floor,
                                   msg="overflow clamped to the enhanced "
                                       "min-scale schedule floor")
            self._last_overflow = oc

        # loss-scale flapping
        if scale is not None:
            self._scales.append(float(scale))
            self._scales = self._scales[-(cfg.flap_window + 1):]
            d = np.sign(np.diff(np.asarray(self._scales)))
            d = d[d != 0]
            changes = int((d[1:] != d[:-1]).sum()) if d.size > 1 else 0
            if changes >= cfg.flap_min_changes:
                self._emit(events, step, "loss_scale_flapping", value=changes,
                           msg=f"{changes} scale direction changes in "
                               f"{cfg.flap_window} steps")

        # per-site saturation / flush fractions
        for k, v in record.items():
            if not k.startswith(HEALTH_METRIC_PREFIX) or k == "health/amax_sites":
                continue
            arr = np.asarray(v, np.float64)
            if arr.ndim == 0 or arr.shape[-1] != 2:
                continue
            site = k[len(HEALTH_METRIC_PREFIX):]
            sat = float(arr[..., 0].max())
            flush = float(arr[..., 1].max())
            if sat > cfg.sat_threshold and flush > cfg.flush_threshold:
                self._emit(events, step, "range_overflow", site=site,
                           value=sat,
                           msg="saturation and flush high simultaneously: "
                               "per-tensor scaling insufficient for this site")
            elif sat > cfg.sat_threshold:
                self._emit(events, step, "saturation", site=site, value=sat)
            elif flush > cfg.flush_threshold:
                self._emit(events, step, "underflow", site=site, value=flush)

        # stuck / NaN amax (dense per-registry-row vector)
        amax = record.get("health/amax_sites")
        if amax is not None:
            amax = np.asarray(amax, np.float64).reshape(-1)
            bad = ~np.isfinite(amax)
            for i in np.nonzero(bad)[0]:
                self._emit(events, step, "nan_amax", site=self._site(i))
            if self._amax_prev is not None \
                    and amax.shape == self._amax_prev.shape:
                same = (amax == self._amax_prev) & (amax > 0) & ~bad
                self._amax_stuck = np.where(
                    same, self._amax_stuck + 1, 0)
            if self._amax_stuck is None \
                    or self._amax_stuck.shape != amax.shape:
                self._amax_stuck = np.zeros(amax.shape, np.int64)
            for i in np.nonzero(self._amax_stuck >= cfg.stuck_window)[0]:
                self._emit(events, step, "stuck_amax", site=self._site(i),
                           value=amax[i])
            self._amax_prev = amax

        # straggler streaks
        st = record.get("stragglers")
        if st is not None:
            st = float(st)
            if self._last_stragglers is not None:
                self._straggler_run = self._straggler_run + 1 \
                    if st > self._last_stragglers else 0
            if self._straggler_run >= cfg.straggler_streak:
                self._emit(events, step, "straggler_streak",
                           value=self._straggler_run)
            self._last_stragglers = st

        return events
