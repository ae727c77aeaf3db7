"""Paged serving engine (counterpart of `repro.serve.engine.PagedServeEngine`).

One fixed-shape `step()` serves every phase: each request row carries a
prompt chunk (up to `chunk_size` tokens) or one decode token through the
same forward — 'chunk' attention over a block-table KV pool, per-row
[start, n_valid] ragged bounds — and sampling on the device. The host
reads back only the (B,) sampled token ids.

Serving runs the deterministic FP8 path (RNE, saturating) with frozen
calibrated scales and a bf16 KV cache; under those, greedy streams match
the reference engine's. The exact prefix cache is on by default, as in the
reference. The legacy fixed-slot engine and the FP8 KV cache are queued in
ROADMAP.md.
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
        cfg.check_ported()
        self.cfg = cfg
        self.params = params
        self.serve = serve
        self.frozen_scales = frozen_scales
        self.frozen_formats = frozen_formats
        if frozen_formats:
            self._check_formats(frozen_formats)
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
        win = 512
        self._prefill_lat = collections.deque(maxlen=win)
        self._step_lat = collections.deque(maxlen=win)
        self._req_lat = collections.deque(maxlen=win)
        self._occupancy = collections.deque(maxlen=win)
        self._n_requests = 0
        self._n_finished = 0
        self._prefill_tokens = 0
        self._decode_tokens = 0
        self._decode_time_s = 0.0

    def _check_formats(self, frozen_formats: Dict[str, str]):
        """Refuse scales calibrated under another storage format."""
        from repro_torch.scaling.state import format_for_site
        quant = self.cfg.policy.quant
        kv_fmt = self.cfg.policy.kv_cache_format
        for key, calibrated in frozen_formats.items():
            serving = format_for_site(key, quant, kv_fmt)
            if serving != calibrated:
                raise ValueError(
                    f"frozen scale for site {key!r} was calibrated under "
                    f"format {calibrated!r} but this engine would quantize "
                    f"it as {serving!r} (recipe={quant.recipe!r}); "
                    "recalibrate or fix the serving config")

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
        self._n_requests += 1
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
        self._occupancy.append(len(active) / len(self.slots))
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
        self._step_lat.append(dt)
        finished: Dict[int, List[int]] = {}
        for i, what in plan.items():
            req = self.slots[i]
            if what[0] == "prefill":
                req.prefill_pos += what[1]
                req.pos = req.prefill_pos
                self._prefill_tokens += what[1]
                if req.prefill_pos < len(req.prompt):
                    continue            # prompt not done; sample discarded
                req.prefill_s = time.perf_counter() - req.t_added
                self._prefill_lat.append(req.prefill_s)
                if self.prefix_cache is not None:
                    self.prefix_cache.insert(req.prompt, req.table)
            else:
                req.pos += 1
                self._decode_tokens += 1
                self._decode_time_s += dt / max(len(plan), 1)
            nxt = int(tok[i])
            req.generated.append(nxt)
            hit_eos = (self.serve.eos_id >= 0 and nxt == self.serve.eos_id)
            if hit_eos or len(req.generated) >= req.max_new_tokens \
                    or req.pos >= self.serve.max_len - 1:
                req.t_finished = time.perf_counter()
                self._n_finished += 1
                self._req_lat.append(req.t_finished - req.t_added)
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
        def pct(win, q):
            return float(np.percentile(np.asarray(win), q)) if win else None
        out = {
            "requests": self._n_requests,
            "finished": self._n_finished,
            "active": sum(s is not None for s in self.slots),
            "max_batch": len(self.slots),
            "slot_occupancy": (float(np.mean(self._occupancy))
                               if self._occupancy else 0.0),
            "prefill_tokens": self._prefill_tokens,
            "decode_tokens": self._decode_tokens,
            "decode_tokens_per_s": (self._decode_tokens / self._decode_time_s
                                    if self._decode_time_s > 0 else 0.0),
            "prefill_latency_s": {"p50": pct(self._prefill_lat, 50),
                                  "p99": pct(self._prefill_lat, 99)},
            "step_s": {"p50": pct(self._step_lat, 50),
                       "p99": pct(self._step_lat, 99)},
            "request_latency_s": {"p50": pct(self._req_lat, 50),
                                  "p99": pct(self._req_lat, 99)},
        }
        out.update(self.pager.stats())
        if self.prefix_cache is not None:
            out.update(self.prefix_cache.stats())
        return out
