"""Per-site scale plumbing for delayed per-tensor scaling.

Counterpart of `repro.scaling.context`. A `ScaleContext` carries per-site
scales into the quantization call sites (core.qlinear, core.qattention)
and collects the observed amaxes out of them. PyTorch runs eagerly, so the
context is plain state for the duration of one forward (and, in training,
the backward that follows it).

Site keys are the reference's keys for an unscanned stack
(`scan_layers=False`), e.g.

    decoder/layer_3/attn/wq#a.A    operand a of a qeinsum (activation)
    decoder/layer_3/attn/wq#b.W    operand b (weight)
    decoder/layer_3/attn/wq#y.A    the fused-epilogue GEMM output
    decoder/layer_3/attn/wq#E, #G, #da.E    backward sites (registered only)
    decoder/layer_3/attn/sdpa#{q,k,v,qk,p}.A    fused attention forward sites
    decoder/layer_3/attn/sdpa#{E,dp.E,ds.E}     its backward sites

Modes:
    discover  — site discovery: every key a call site touches is
                registered, with its token site (the site key itself);
                scales read as 1.0 and nothing is recorded. Eager torch has
                no abstract trace, so discovery runs a real (small)
                forward (`scaling.calibrate.discover_lm_sites`).
    collect   — training: scales are host f32 values from ScaleState; the
                forward records its amaxes (max-combined per key), and the
                backward of each autograd Function records the error-class
                observations (E, G, #da.E, #dp.E, #ds.E) with
                `record_bwd`. That replaces the reference's token-cotangent
                channel: backward recordings are SUMMED per key and counted,
                and `observations()` divides each sum by its count, as
                `repro.scaling.state.split_observations` divides a token's
                summed cotangent by the site's use count.
    calibrate — like collect, forward only (the first calibration batch
                also registers the sites).
    frozen    — serving: scales are python floats; nothing is recorded.

Precision-health observations (`QuantConfig.track_health`; the
reference's health channels): (2,) [sat_frac, flush_frac] pairs per site.
Forward pairs are max-combined over uses (`record_health`); backward pairs
ride beside the backward amaxes (`record_bwd_health`), summed over uses and
times 1/uses, as the reference divides the health tail of a token's summed
cotangent by the site's use count. They are telemetry: they reach the
step's metrics as `health/<site key>` and never enter ScaleState.

Recorded values stay device tensors until `observations()` /
`health_observations()`, which read them from one host copy.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Set

import numpy as np
import torch

_CLASS_LETTER = {"weight": "W", "act": "A", "error": "E", "grad": "G"}

HEALTH_PREFIX = "health/"


@dataclasses.dataclass
class ScaleContext:
    mode: str                      # discover | collect | calibrate | frozen
    scales: Mapping[str, Any]              # key -> scale (float / np.float32)
    discovered: Set[str] = dataclasses.field(default_factory=set)
    discovered_token_sites: Set[str] = dataclasses.field(default_factory=set)
    collected: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    # Backward observations: key -> summed amax, and key -> number of uses.
    collected_bwd: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    bwd_uses: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Health pairs: forward key -> max over uses; backward key -> sum over
    # uses (divided by the key's bwd_uses when read).
    health: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    health_bwd: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    # Health keys read from this rank's shard of a tensor-parallel payload
    # (`mark_sharded`): `tp_combine` averages their pairs over 'model' and
    # takes the others from one rank.
    tp_sharded: Set[str] = dataclasses.field(default_factory=set)
    _scope: List[str] = dataclasses.field(default_factory=list)

    def site_key(self, site: str) -> str:
        return "/".join(self._scope + [site])

    def register(self, key: str):
        self.discovered.add(key)

    def register_token_site(self, site_key: str):
        """A site with backward observations (the reference's token)."""
        self.discovered_token_sites.add(site_key)

    def scale_for(self, key: str, default: float = 1.0) -> np.float32:
        """The site's scale as an f32 scalar (the reference's
        `jnp.asarray(s, jnp.float32)`)."""
        s = self.scales.get(key)
        return np.float32(default if s is None else s)

    def frozen_scale(self, key: str, default: float = 1.0) -> float:
        """The site's frozen scale as a python float in frozen mode (the
        reference burns it into the program as a constant); `default` in
        every other mode."""
        if self.mode != "frozen":
            return default
        return float(self.scales.get(key, default))

    def has_scale(self, key: str) -> bool:
        return key in self.scales

    def record(self, key: str, amax: torch.Tensor):
        """A forward observation (max-combined over uses)."""
        self.register(key)
        if self.mode in ("collect", "calibrate"):
            prev = self.collected.get(key)
            self.collected[key] = amax if prev is None \
                else torch.maximum(prev, amax)

    def record_bwd(self, key: str, amax: torch.Tensor):
        """A backward observation (summed over uses, counted)."""
        if self.mode == "collect":
            prev = self.collected_bwd.get(key)
            self.collected_bwd[key] = amax if prev is None else prev + amax
            self.bwd_uses[key] = self.bwd_uses.get(key, 0) + 1

    def record_health(self, key: str, frac2: torch.Tensor):
        """A forward (2,) [sat_frac, flush_frac] observation of `key`
        (max-combined over uses: a high fraction in any use is the
        signal)."""
        if self.mode in ("collect", "calibrate"):
            prev = self.health.get(key)
            self.health[key] = frac2 if prev is None \
                else torch.maximum(prev, frac2)

    def record_bwd_health(self, key: str, frac2: torch.Tensor):
        """A backward (2,) health pair of `key`, recorded beside its
        `record_bwd` amax (summed over uses; read times 1/uses)."""
        if self.mode == "collect":
            prev = self.health_bwd.get(key)
            self.health_bwd[key] = frac2 if prev is None else prev + frac2

    def mark_sharded(self, key: str):
        """`key`'s health pairs are read from this rank's shard of a
        tensor-parallel payload (`tp_combine` averages them)."""
        self.tp_sharded.add(key)

    def pending(self) -> List[torch.Tensor]:
        """Every recorded value as flat f32 tensors, in read order:
        forward amaxes, backward amax sums, forward health pairs, backward
        health sums, each in key order. Concatenated, they are the vector
        `observations` and `health_observations` read."""
        return [t[k].float().reshape(-1) for t in self._tables()
                for k in sorted(t)]

    def _tables(self):
        return (self.collected, self.collected_bwd, self.health,
                self.health_bwd)

    def tp_combine(self, rows_of) -> None:
        """Combine this rank's observations with the other ranks' of its
        'model' group, in place: `rows_of(vec)` -> (m, len) every rank's
        `pending()` vector. Amaxes take the MAX over the ranks (a sharded
        tensor's whole amax; a replicated one's own, as MAX is
        idempotent); a health pair read from a shard the mean of the
        ranks' pairs (the whole payload's fractions, the shards being of
        equal size), added in rank order; any other pair is replicated
        and rank 0's is kept."""
        vals = self.pending()
        if not vals:
            return
        rows = rows_of(torch.cat(vals))
        n_amax = len(self.collected) + len(self.collected_bwd)
        amax = rows[:, :n_amax].amax(dim=0)
        acc = rows[0, n_amax:]
        for i in range(1, rows.shape[0]):
            acc = acc + rows[i, n_amax:]
        mean = acc / torch.full((), float(rows.shape[0]), device=acc.device)
        hkeys = sorted(self.health) + sorted(self.health_bwd)
        pick = torch.tensor([k in self.tp_sharded for k in hkeys
                             for _ in range(2)], device=acc.device)
        health = torch.where(pick, mean, rows[0, n_amax:])
        flat = torch.cat([amax, health])
        i = 0
        for table in self._tables():
            for k in sorted(table):
                n = table[k].numel()
                table[k] = flat[i:i + n].reshape(table[k].shape)
                i += n

    def _host(self, host_values):
        if host_values is None:
            vals = self.pending()
            host_values = torch.cat(vals).cpu().numpy() if vals else []
        return np.asarray(host_values, np.float32)

    def _inv_uses(self, key: str) -> np.float32:
        return np.float32(1.0 / max(1, self.bwd_uses.get(key, 1)))

    def observations(self, host_values=None) -> Dict[str, np.float32]:
        """{key: host f32 amax}: forward maxima as recorded, backward sums
        times 1/uses (the reference's `tok * (1 / uses)`). `host_values`
        is `pending()` already on the host as one vector (a caller
        that reads it together with other step results); otherwise it is
        read here, in one device->host transfer."""
        fk, bk = sorted(self.collected), sorted(self.collected_bwd)
        host_values = self._host(host_values)
        out = {k: np.float32(v) for k, v in zip(fk, host_values[:len(fk)])}
        for k, v in zip(bk, host_values[len(fk):len(fk) + len(bk)]):
            out[k] = np.float32(np.float32(v) * self._inv_uses(k))
        return out

    def health_observations(self, host_values=None
                            ) -> Dict[str, np.ndarray]:
        """{HEALTH_PREFIX + key: (2,) host f32 [sat_frac, flush_frac]}:
        forward maxima as recorded, backward sums times 1/uses. Reads the
        same vector as `observations`."""
        host_values = self._host(host_values)
        i = len(self.collected) + len(self.collected_bwd)
        out = {}
        for k in sorted(self.health):
            out[HEALTH_PREFIX + k] = host_values[i:i + 2].copy()
            i += 2
        for k in sorted(self.health_bwd):
            out[HEALTH_PREFIX + k] = (host_values[i:i + 2]
                                      * self._inv_uses(k)).astype(np.float32)
            i += 2
        return out


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


def scope_path() -> List[str]:
    """The active context's scope segments, outermost first ([] without
    a context)."""
    return [] if _ACTIVE is None else list(_ACTIVE._scope)


@contextlib.contextmanager
def at_scope(path: List[str]):
    """Run under the scope `path` (from `scope_path`) in place of the
    current one: a recomputation inside backward(), where the scope stack
    the forward ran under has unwound, reads and records at the forward's
    site keys."""
    ctx = _ACTIVE
    if ctx is None:
        yield
        return
    saved = ctx._scope
    ctx._scope = list(path)
    try:
        yield
    finally:
        ctx._scope = saved


def combine_microbatches(ctxs: List[ScaleContext]) -> ScaleContext:
    """One collect context holding the observations of a step's
    microbatch contexts, as the reference's accumulation scan combines
    them: forward amaxes and health pairs by maximum (as recorded), and the
    backward sums by elementwise maximum over microbatches (the reference
    max-combines the token cotangents, each a sum over the microbatch's
    uses), divided by the uses of one microbatch when read."""
    out = ScaleContext(mode=ctxs[0].mode, scales=ctxs[0].scales,
                       bwd_uses=dict(ctxs[0].bwd_uses),
                       tp_sharded=set().union(*(c.tp_sharded for c in ctxs)))
    for name in ("collected", "collected_bwd", "health", "health_bwd"):
        merged = getattr(out, name)
        for ctx in ctxs:
            for k, v in getattr(ctx, name).items():
                merged[k] = v if k not in merged else torch.maximum(
                    merged[k], v)
    for ctx in ctxs:
        out.discovered |= ctx.discovered
        out.discovered_token_sites |= ctx.discovered_token_sites
        if ctx.bwd_uses != out.bwd_uses:
            raise ValueError("microbatches recorded backward observations "
                             "a different number of times")
    return out


def discover_context() -> ScaleContext:
    return ScaleContext(mode="discover", scales={})


def collect_context(scales: Mapping[str, Any]) -> ScaleContext:
    return ScaleContext(mode="collect", scales=scales)


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
