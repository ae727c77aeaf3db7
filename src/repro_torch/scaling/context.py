"""Per-site scale plumbing for delayed per-tensor scaling (forward only).

Counterpart of `repro.scaling.context`, reduced to what frozen serving and
calibration need. A `ScaleContext` carries per-site scales into the
quantization call sites (core.qlinear, core.qattention) and collects the
observed amaxes out of them. PyTorch runs eagerly, so the context is plain
state for the duration of one forward.

Site keys are the reference's keys for an unscanned stack
(`scan_layers=False`), e.g.

    decoder/layer_3/attn/wq#a.A    operand a of a qeinsum (activation)
    decoder/layer_3/attn/wq#b.W    operand b (weight)
    decoder/layer_3/attn/wq#y.A    the fused-epilogue GEMM output
    decoder/layer_3/attn/wq#E, #G, #da.E    backward sites (registered only)
    decoder/layer_3/attn/sdpa#{q,k,v,qk,p}.A    fused attention forward sites
    decoder/layer_3/attn/sdpa#{E,dp.E,ds.E}     its backward sites

Modes:
    calibrate — scales are host f32 values from ScaleState; every key the
                forward touches is registered and every forward amax is
                recorded (a 0-d device tensor, max-combined per key). The
                first calibration batch doubles as site discovery (JAX
                discovers by an abstract trace; eager torch has none).
    frozen    — serving: scales are python floats; nothing is recorded.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Set

import numpy as np
import torch

_CLASS_LETTER = {"weight": "W", "act": "A", "error": "E", "grad": "G"}


@dataclasses.dataclass
class ScaleContext:
    mode: str                              # calibrate | frozen
    scales: Mapping[str, Any]              # key -> scale (float / np.float32)
    discovered: Set[str] = dataclasses.field(default_factory=set)
    collected: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    _scope: List[str] = dataclasses.field(default_factory=list)

    def site_key(self, site: str) -> str:
        return "/".join(self._scope + [site])

    def register(self, key: str):
        self.discovered.add(key)

    def scale_for(self, key: str, default: float = 1.0) -> np.float32:
        """The site's scale as an f32 scalar (the reference's
        `jnp.asarray(s, jnp.float32)`)."""
        s = self.scales.get(key)
        return np.float32(default if s is None else s)

    def has_scale(self, key: str) -> bool:
        return key in self.scales

    def record(self, key: str, amax: torch.Tensor):
        self.register(key)
        if self.mode == "calibrate":
            prev = self.collected.get(key)
            self.collected[key] = amax if prev is None \
                else torch.maximum(prev, amax)


_ACTIVE: Optional[ScaleContext] = None


def current() -> Optional[ScaleContext]:
    return _ACTIVE


@contextlib.contextmanager
def activate(ctx: ScaleContext):
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a ScaleContext is already active")
    _ACTIVE = ctx
    try:
        yield ctx
    finally:
        _ACTIVE = None


@contextlib.contextmanager
def scope(name: str):
    """Push a site-scope segment (no-op when no context is active)."""
    ctx = _ACTIVE
    if ctx is None:
        yield
        return
    ctx._scope.append(name)
    try:
        yield
    finally:
        ctx._scope.pop()


def calibrate_context(scales: Mapping[str, Any]) -> ScaleContext:
    return ScaleContext(mode="calibrate", scales=scales)


def frozen_context(scales: Mapping[str, float]) -> ScaleContext:
    """Frozen-serving context over {key: float} from `freeze`."""
    return ScaleContext(mode="frozen", scales=dict(scales))


def operand_keys(site_key: str, classes) -> Dict[str, str]:
    ca, cb = _CLASS_LETTER[classes[0]], _CLASS_LETTER[classes[1]]
    return {"a": f"{site_key}#a.{ca}", "b": f"{site_key}#b.{cb}",
            "E": f"{site_key}#E", "G": f"{site_key}#G"}


def attention_keys(site_key: str) -> Dict[str, str]:
    return {"q": f"{site_key}#q.A", "k": f"{site_key}#k.A",
            "v": f"{site_key}#v.A", "s": f"{site_key}#qk.A",
            "p": f"{site_key}#p.A", "do": f"{site_key}#E",
            "dp": f"{site_key}#dp.E", "ds": f"{site_key}#ds.E"}


def fused_output_keys(site_key: str, classes) -> Dict[str, str]:
    out = {"y": f"{site_key}#y.A"}
    if classes[0] != "weight":
        out["err"] = f"{site_key}#da.E"
    elif classes[1] != "weight":
        out["err"] = f"{site_key}#db.E"
    return out
