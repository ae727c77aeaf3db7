"""Metrics pipeline: versioned-schema jsonl sink and rolling windows
(counterpart of `repro.obs.metrics`; the record and sidecar layout of
docs/metrics_schema.md, schema version 1).

 * `jsonable` — python / numpy / torch scalars become floats or ints,
   vectors (health pairs, the per-site amax vector) become lists,
   non-finite floats their `repr` ("nan", "inf").
 * `MetricsLogger` — one record per step with `"v": SCHEMA_VERSION`,
   flushed on every write (a preempted process may die at any step); a
   sidecar `<path>.meta.json` holds the schema version and the run's
   metadata (site registry order, recipe, ...); bounded per-key windows
   of the scalar fields for mean / percentile queries.
"""
from __future__ import annotations

import collections
import json
import math
from pathlib import Path
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

SCHEMA_VERSION = 1


def jsonable(v: Any) -> Any:
    """Scalar/vector-aware: scalars -> float/int, arrays -> (nested) lists."""
    if isinstance(v, (bool, int, str)) or v is None:
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: jsonable(x) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    arr = np.asarray(v)
    if arr.ndim == 0:
        if np.issubdtype(arr.dtype, np.integer):
            return int(arr)
        if np.issubdtype(arr.dtype, np.bool_):
            return bool(arr)
        return jsonable(float(arr))
    return [jsonable(x) for x in arr.astype(np.float64).tolist()]


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, *,
                 meta: Optional[Dict[str, Any]] = None,
                 window: int = 64):
        self.path = path
        self.window = window
        self._f = None
        self._windows: Dict[str, collections.deque] = {}
        self.n_records = 0
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            self._f = open(path, "a")
            meta_rec = {"schema_version": SCHEMA_VERSION,
                        **jsonable(meta or {})}
            Path(str(path) + ".meta.json").write_text(json.dumps(meta_rec))

    def log(self, record: Dict[str, Any]) -> Dict[str, Any]:
        """Serialize and write one jsonl record; returns the serialized
        dict."""
        rec = {"v": SCHEMA_VERSION}
        rec.update({k: jsonable(v) for k, v in record.items()})
        for k, v in rec.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._windows.setdefault(
                    k, collections.deque(maxlen=self.window)).append(float(v))
        self.n_records += 1
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return rec

    def values(self, key: str) -> Iterable[float]:
        return tuple(self._windows.get(key, ()))

    def mean(self, key: str) -> Optional[float]:
        w = self._windows.get(key)
        return float(np.mean(w)) if w else None

    def percentile(self, key: str, q: float) -> Optional[float]:
        w = self._windows.get(key)
        return float(np.percentile(np.asarray(w), q)) if w else None

    def flush(self):
        if self._f:
            self._f.flush()

    def close(self):
        if self._f:
            self._f.flush()
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
