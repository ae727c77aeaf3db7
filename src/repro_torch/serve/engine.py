"""Serving engines (counterpart of `repro.serve.engine`).

`PagedServeEngine`: one fixed-shape `step()` serves every phase: each
request row carries a prompt chunk (up to `chunk_size` tokens) or one
decode token through the same forward — 'chunk' attention over a
block-table KV pool, per-row [start, n_valid] ragged bounds — and sampling
on the device. The host reads back only the (B,) sampled token ids. The
exact prefix cache is on by default, as in the reference.

`ServeEngine`: the reference's fixed-slot engine (the paged engine's
oracle). `max_batch` slots of `max_len` cache rows each; add_request()
prefills a free slot (the whole batch runs, as in the reference, and only
the slot's cache rows are written); step() decodes one token for every
slot; the host samples from the logits with numpy.

Both serve the deterministic FP8 path (RNE, saturating), with frozen
calibrated scales when given, over a bf16 or FP8 (`kv_cache_format`) KV
cache; under frozen scales and a bf16 cache their greedy streams agree
with each other and with the reference's.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import Tracer


def _check_formats(cfg: ModelConfig, frozen_formats: Dict[str, str]):
    """Refuse scales calibrated under another storage format (a scale for
    the e4m3 grid is 128x off on e5m2's)."""
    from repro_torch.scaling.state import format_for_site
    quant = cfg.policy.quant
    kv_fmt = cfg.policy.kv_cache_format
    for key, calibrated in frozen_formats.items():
        serving = format_for_site(key, quant, kv_fmt)
        if serving != calibrated:
            raise ValueError(
                f"frozen scale for site {key!r} was calibrated under "
                f"format {calibrated!r} but this engine would quantize "
                f"it as {serving!r} (recipe={quant.recipe!r}, "
                f"kv_cache_format={kv_fmt!r}); recalibrate or fix the "
                "serving config")


def _pct(win, q):
    return float(np.percentile(np.asarray(win), q)) if win else None


class _Counters:
    """The serving counters both engines keep: latency windows (prefill,
    step, request), slot occupancy per step, requests and tokens."""

    def __init__(self, win: int = 512):
        self.prefill_lat = collections.deque(maxlen=win)
        self.step_lat = collections.deque(maxlen=win)
        self.req_lat = collections.deque(maxlen=win)
        self.occupancy = collections.deque(maxlen=win)
        self.requests = self.finished = 0
        self.prefill_tokens = self.decode_tokens = 0
        self.decode_time_s = 0.0

    def finish(self, req):
        req.t_finished = time.perf_counter()
        self.finished += 1
        self.req_lat.append(req.t_finished - req.t_added)

    def stats(self, slots, occupancy_key: str, step_key: str
              ) -> Dict[str, Any]:
        return {
            "requests": self.requests,
            "finished": self.finished,
            "active": sum(s is not None for s in slots),
            "max_batch": len(slots),
            occupancy_key: (float(np.mean(self.occupancy))
                            if self.occupancy else 0.0),
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "decode_tokens_per_s": (self.decode_tokens / self.decode_time_s
                                    if self.decode_time_s > 0 else 0.0),
            "prefill_latency_s": {"p50": _pct(self.prefill_lat, 50),
                                  "p99": _pct(self.prefill_lat, 99)},
            step_key: {"p50": _pct(self.step_lat, 50),
                       "p99": _pct(self.step_lat, 99)},
            "request_latency_s": {"p50": _pct(self.req_lat, 50),
                                  "p99": _pct(self.req_lat, 99)},
        }


# ===========================================================================
# Fixed-slot engine
# ===========================================================================

@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    eos_id: int = -1          # -1 => never stops early
    temperature: float = 0.0  # 0 => greedy
    seed: int = 0


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_added: float = 0.0      # perf_counter at add_request
    prefill_s: float = 0.0    # prefill latency (sampling included)
    decode_s: float = 0.0     # summed decode-step time while active
    t_finished: float = 0.0


class ServeEngine:
    """Fixed-slot serving on `device` (CUDA by default; pass device='cpu'
    for the plain versions). frozen_scales: calibrated per-site scales
    (`scaling.calibrate.freeze` / `load_frozen`), the FP8 KV cache's
    included; frozen_formats: the formats they were calibrated under —
    serving refuses a site this engine would quantize in another."""

    def __init__(self, cfg: ModelConfig, params, serve: ServeConfig,
                 frozen_scales: Optional[Dict[str, float]] = None,
                 frozen_formats: Optional[Dict[str, str]] = None,
                 device=None):
        from repro_torch.models.transformer import init_stack_state
        from repro_torch.train.step import (make_serve_decode,
                                            make_serve_prefill)
        self.device = resolve_device(device)
        cfg.check_ported(serving=True)
        self.cfg = cfg
        self.params = params
        self.serve = serve
        self.frozen_scales = frozen_scales
        self.frozen_formats = frozen_formats
        if frozen_formats:
            _check_formats(cfg, frozen_formats)
        self._prefill = make_serve_prefill(cfg, frozen_scales)
        self._decode = make_serve_decode(cfg, frozen_scales)
        b = serve.max_batch
        self.states = init_stack_state(cfg, b, serve.max_len,
                                       device=self.device)
        self.slots: List[Optional[Request]] = [None] * b
        self.positions = np.zeros((b,), np.int64)
        self.last_token = np.zeros((b,), np.int32)
        self._uid = 0
        self.tracer = Tracer()
        self._c = _Counters()

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def add_request(self, prompt: np.ndarray,
                    max_new_tokens: int = 32) -> int:
        """Prefill `prompt` into a free slot; returns the request uid."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slots; call step() until one frees")
        slot = free[0]
        self._uid += 1
        req = Request(self._uid, np.asarray(prompt, np.int32),
                      max_new_tokens, t_added=time.perf_counter())
        self.slots[slot] = req
        s = req.prompt.shape[0]
        tokens = np.zeros((len(self.slots), s), np.int32)
        tokens[slot] = req.prompt
        with self.tracer.span("prefill", uid=req.uid, tokens=s):
            logits, self.states = self._prefill(
                self.params, {"tokens": torch.from_numpy(tokens).to(
                    self.device), "slot": slot}, self.states)
            self.positions[slot] = s
            nxt = self._sample(logits[slot, -1].float().cpu().numpy())
        req.prefill_s = time.perf_counter() - req.t_added
        self._c.prefill_lat.append(req.prefill_s)
        self._c.requests += 1
        self._c.prefill_tokens += s
        self.last_token[slot] = nxt
        req.generated.append(int(nxt))
        return req.uid

    def step(self) -> Dict[int, List[int]]:
        """One decode step for all slots. Returns the finished requests."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return {}
        t0 = time.perf_counter()
        self._c.occupancy.append(len(active) / len(self.slots))
        dev = self.device
        batch = {"tokens": torch.from_numpy(self.last_token[:, None]).to(dev),
                 "positions": torch.from_numpy(
                     self.positions[:, None].astype(np.int32)).to(dev)}
        with self.tracer.span("decode", active=len(active)):
            logits, self.states = self._decode(self.params, batch,
                                               self.states)
            logits = logits[:, 0].float().cpu().numpy()
        dt = time.perf_counter() - t0
        self._c.step_lat.append(dt)
        self._c.decode_time_s += dt
        self._c.decode_tokens += len(active)
        finished: Dict[int, List[int]] = {}
        for i in active:
            req = self.slots[i]
            req.decode_s += dt
            nxt = self._sample(logits[i])
            req.generated.append(int(nxt))
            self.positions[i] += 1
            self.last_token[i] = nxt
            hit_eos = (self.serve.eos_id >= 0 and nxt == self.serve.eos_id)
            if hit_eos or len(req.generated) >= req.max_new_tokens \
                    or self.positions[i] >= self.serve.max_len - 1:
                req.done = True
                self._c.finish(req)
                finished[req.uid] = req.generated
                self.slots[i] = None
        return finished

    def run_to_completion(self, max_steps: int = 10_000
                          ) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            out.update(self.step())
            if not any(self.slots):
                break
        return out

    def stats(self) -> Dict[str, Any]:
        """The reference's serving counters (jsonable)."""
        return self._c.stats(self.slots, "kv_slot_occupancy",
                             "decode_step_s")

    def _sample(self, logits: np.ndarray) -> int:
        """Greedy over the real vocabulary, or a draw from numpy's
        generator seeded with seed + the latest uid (the reference's
        rule; it draws in the logits' f32 here, bf16 there)."""
        logits = logits[:self.cfg.vocab_size]
        if self.serve.temperature <= 0:
            return int(logits.argmax())
        p = np.exp((logits - logits.max()) / self.serve.temperature)
        p /= p.sum()
        rng = np.random.default_rng(self.serve.seed + self._uid)
        return int(rng.choice(len(p), p=p))


# ===========================================================================
# Paged engine
# ===========================================================================

@dataclasses.dataclass
class PagedServeConfig:
    """Knobs (the reference's): max_batch rows per step, max_len positions
    per request, n_pages pool pages per layer (page 0 is the trash page),
    page_size tokens per page, chunk_size prompt tokens per row per step,
    sampling controls (temperature <= 0 => greedy), per-request seeds
    (seed + uid), and the exact full-page prefix cache."""
    max_batch: int = 8
    max_len: int = 512
    n_pages: int = 64
    page_size: int = 16
    chunk_size: int = 32
    eos_id: int = -1
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    prefix_cache: bool = True
    max_cache_entries: int = 128


@dataclasses.dataclass
class _PagedRequest:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    table: list
    prefill_pos: int = 0
    pos: int = 0
    generated: list = dataclasses.field(default_factory=list)
    cached_tokens: int = 0
    t_added: float = 0.0
    prefill_s: float = 0.0
    t_finished: float = 0.0


class PagedServeEngine:
    """Serving loop over a paged KV pool on `device` (CUDA by default; pass
    device='cpu' for the plain versions)."""

    def __init__(self, cfg: ModelConfig, params, serve: PagedServeConfig,
                 frozen_scales: Optional[Dict[str, float]] = None,
                 frozen_formats: Optional[Dict[str, str]] = None,
                 device=None):
        from repro_torch.models.transformer import init_paged_stack_state
        from repro_torch.serve.paging import PageAllocator
        from repro_torch.serve.prefix_cache import PrefixCache, scale_fingerprint
        from repro_torch.train.step import make_serve_chunk

        self.device = resolve_device(device)
        cfg.check_ported(serving=True, paged=True)
        self.cfg = cfg
        self.params = params
        self.serve = serve
        self.frozen_scales = frozen_scales
        self.frozen_formats = frozen_formats
        if frozen_formats:
            _check_formats(cfg, frozen_formats)
        self.pager = PageAllocator(serve.n_pages, serve.page_size)
        self.capacity = -(-serve.max_len // serve.page_size) * serve.page_size
        self.states = init_paged_stack_state(cfg, self.pager.n_slots,
                                             device=self.device)
        self.prefix_cache = None
        if serve.prefix_cache:
            fp = scale_fingerprint(frozen_scales, frozen_formats,
                                   recipe=cfg.policy.quant.recipe,
                                   kv_format=cfg.policy.kv_cache_format)
            self.prefix_cache = PrefixCache(
                self.pager, fp, max_entries=serve.max_cache_entries)
        self._chunk_step = make_serve_chunk(cfg, frozen_scales)

        self.slots: List[Optional[_PagedRequest]] = [None] * serve.max_batch
        self._uid = 0
        self.tracer = Tracer()
        self._c = _Counters()

    # -- admission ----------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def add_request(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        """Admit a request (prefill happens in later step()s). Raises
        PagesExhausted when the pool cannot hold the prompt."""
        from repro_torch.serve.paging import PagesExhausted
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slots; call step() until one frees")
        prompt = np.asarray(prompt, np.int32)
        n = int(prompt.shape[0])
        if n < 1 or n >= self.serve.max_len:
            raise ValueError(
                f"prompt length {n} out of range [1, {self.serve.max_len})")
        slot = free[0]
        self._uid += 1
        req = _PagedRequest(self._uid, prompt, max_new_tokens, table=[],
                            t_added=time.perf_counter())
        if self.prefix_cache is not None:
            pages, n_cached = self.prefix_cache.lookup(prompt)
            req.table = pages
            req.prefill_pos = req.pos = n_cached
            req.cached_tokens = n_cached
        need = self.pager.pages_for(n) - len(req.table)
        try:
            if need > self.pager.n_free and self.prefix_cache is not None:
                self.prefix_cache.evict_for(need)
            req.table += self.pager.alloc(max(need, 0),
                                          what=f"prompt of {n} tokens")
        except PagesExhausted:
            if req.cached_tokens:
                self.pager.release(req.table)
            raise
        self.slots[slot] = req
        self._c.requests += 1
        return req.uid

    # -- the unified step ---------------------------------------------------

    def _grow(self, req: _PagedRequest, pos: int):
        from repro_torch.serve.paging import PagesExhausted
        if pos // self.serve.page_size < len(req.table):
            return
        try:
            req.table += self.pager.alloc(1, what=f"decode of req {req.uid}")
        except PagesExhausted:
            if self.prefix_cache is None or \
                    not self.prefix_cache.evict_for(1):
                raise
            req.table += self.pager.alloc(1, what=f"decode of req {req.uid}")

    def _device_step(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Forward + padded-vocab mask + sampling; returns (B,) token ids
        (the one device->host transfer of the step)."""
        from repro_torch.serve import sampling as _sampling
        dev = self.device
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
              if k not in ("seeds", "steps")}
        logits, self.states = self._chunk_step(self.params, tb, self.states)
        lg = logits[:, 0].float()
        col = torch.arange(lg.shape[-1], device=dev)
        lg = torch.where(col[None, :] < self.cfg.vocab_size, lg,
                         torch.full_like(lg, _sampling.NEG_INF))
        s = self.serve
        gens = None
        if s.temperature > 0:
            gens = _sampling.row_generators(batch["seeds"], batch["steps"],
                                            dev)
        tok = _sampling.sample(lg, gens, temperature=s.temperature,
                               top_k=s.top_k, top_p=s.top_p)
        return tok.cpu().numpy()

    def step(self) -> Dict[int, List[int]]:
        """One fixed-shape step: a prompt chunk OR one decode token per
        active row. Returns the requests that finished."""
        from repro_torch.serve import paging as _paging
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return {}
        t0 = time.perf_counter()
        self._c.occupancy.append(len(active) / len(self.slots))
        b, tchunk = self.serve.max_batch, self.serve.chunk_size
        psize = self.serve.page_size
        tokens = np.zeros((b, tchunk), np.int32)
        positions = np.zeros((b, tchunk), np.int32)
        write_slots = np.zeros((b, tchunk), np.int32)
        chunk_pos = np.zeros((b, 2), np.int32)
        last_row = np.zeros((b,), np.int32)
        seeds = np.zeros((b,), np.int64)
        steps = np.zeros((b,), np.int64)
        tables, lengths = [], []
        plan = {}
        n_prefill_rows = n_decode_rows = 0
        for i in range(b):
            req = self.slots[i]
            if req is None:
                tables.append([])
                lengths.append(0)
                continue
            seeds[i] = self.serve.seed + req.uid
            steps[i] = len(req.generated)
            if req.prefill_pos < len(req.prompt):
                pp = req.prefill_pos
                t_eff = min(tchunk, len(req.prompt) - pp)
                tokens[i, :t_eff] = req.prompt[pp:pp + t_eff]
                positions[i] = pp + np.arange(tchunk)
                write_slots[i, :t_eff] = _paging.flat_slots(
                    req.table, psize, pp, t_eff)
                chunk_pos[i] = (pp, t_eff)
                last_row[i] = t_eff - 1
                lengths.append(pp + t_eff)
                plan[i] = ("prefill", t_eff)
                n_prefill_rows += 1
            else:
                pos = req.pos
                self._grow(req, pos)
                tokens[i, 0] = (req.generated[-1] if req.generated
                                else req.prompt[-1])
                positions[i] = pos + np.arange(tchunk)
                write_slots[i, 0] = _paging.flat_slots(
                    req.table, psize, pos, 1)[0]
                chunk_pos[i] = (pos, 1)
                last_row[i] = 0
                lengths.append(pos + 1)
                plan[i] = ("decode",)
                n_decode_rows += 1
            tables.append(req.table)
        read_slots, slot_pos = _paging.gather_plan(tables, lengths, psize,
                                                   self.capacity)
        batch = {"tokens": tokens, "positions": positions,
                 "write_slots": write_slots, "read_slots": read_slots,
                 "slot_pos": slot_pos, "chunk_pos": chunk_pos,
                 "last_row": last_row, "seeds": seeds, "steps": steps}
        with self.tracer.span("step", prefill_rows=n_prefill_rows,
                              decode_rows=n_decode_rows):
            tok = self._device_step(batch)
        dt = time.perf_counter() - t0
        self._c.step_lat.append(dt)
        finished: Dict[int, List[int]] = {}
        for i, what in plan.items():
            req = self.slots[i]
            if what[0] == "prefill":
                req.prefill_pos += what[1]
                req.pos = req.prefill_pos
                self._c.prefill_tokens += what[1]
                if req.prefill_pos < len(req.prompt):
                    continue            # prompt not done; sample discarded
                req.prefill_s = time.perf_counter() - req.t_added
                self._c.prefill_lat.append(req.prefill_s)
                if self.prefix_cache is not None:
                    self.prefix_cache.insert(req.prompt, req.table)
            else:
                req.pos += 1
                self._c.decode_tokens += 1
                self._c.decode_time_s += dt / max(len(plan), 1)
            nxt = int(tok[i])
            req.generated.append(nxt)
            hit_eos = (self.serve.eos_id >= 0 and nxt == self.serve.eos_id)
            if hit_eos or len(req.generated) >= req.max_new_tokens \
                    or req.pos >= self.serve.max_len - 1:
                self._c.finish(req)
                finished[req.uid] = req.generated
                self.pager.release(req.table)
                self.slots[i] = None
        return finished

    def run_to_completion(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            out.update(self.step())
            if not any(s is not None for s in self.slots):
                break
        return out

    # -- telemetry ----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        out = self._c.stats(self.slots, "slot_occupancy", "step_s")
        out.update(self.pager.stats())
        if self.prefix_cache is not None:
            out.update(self.prefix_cache.stats())
        return out
