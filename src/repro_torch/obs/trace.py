"""Phase spans with a perfetto-compatible trace export.

TrainLoop (and ServeEngine) wrap their phases in `Tracer.span(name)`:

  data_wait      — blocking on `next(data)` (input pipeline health)
  step_dispatch  — the jitted step call (async dispatch + host work)
  device_sync    — blocking on device results (true device time tail)
  checkpoint     — snapshot + (async) serialization handoff

Span durations feed the per-step metrics record as `span/<name>_s`; the
full event list exports as Chrome/Perfetto "trace event" JSON
(`{"traceEvents": [...]}`, "X" complete events, µs timestamps) loadable in
ui.perfetto.dev — the standard way to see data-wait vs device-time phase
structure across steps.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional


class Tracer:
    def __init__(self, path: Optional[str] = None, *, max_events: int = 200_000):
        self.path = path
        self.max_events = max_events
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._pending: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            self._pending[name] = self._pending.get(name, 0.0) + dur
            if len(self.events) < self.max_events:
                ev = {"name": name, "ph": "X", "pid": os.getpid(), "tid": 0,
                      "ts": round((t0 - self._t0) * 1e6, 1),
                      "dur": round(dur * 1e6, 1)}
                if args:
                    ev["args"] = args
                self.events.append(ev)

    def durations(self) -> Dict[str, float]:
        """Pop the span durations accumulated since the last call — one
        step's phase breakdown, keyed `span/<name>_s`."""
        out = {f"span/{k}_s": round(v, 6) for k, v in self._pending.items()}
        self._pending = {}
        return out

    def export(self, path: Optional[str] = None) -> Optional[str]:
        path = path or self.path
        if not path:
            return None
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(
            {"traceEvents": self.events,
             "displayTimeUnit": "ms"}))
        return path
