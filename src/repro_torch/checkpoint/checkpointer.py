"""Fault-tolerant checkpointing: atomic commit, async save, restore of the
newest committed step (counterpart of `repro.checkpoint.checkpointer`, in
its on-disk format).

 * A checkpoint is `step_<10 digits>/` holding `leaves.npz` (one array a
   leaf, named by its tree path under the v2 key escape), `manifest.json`
   (step, time, keys, dtypes, `"key_escape": "v2"`, `extra`) and a
   `COMMITTED` marker. It is written under a tmp name and renamed into
   place, so a crash mid-save never damages the newest good checkpoint;
   restore reads the newest directory that carries the marker.
 * Async save: the leaves are copied to the host on the caller's thread
   (the training step updates the master weights in place afterwards),
   then written on a non-daemon thread; `wait()` joins it, before the next
   save and at exit. The commit and the garbage collection of all but the
   newest `keep_last_k` steps hold a lock that directory scans and
   restores take too.
 * Leaves are the tensors, numpy arrays and python numbers of nested
   dicts, lists and dataclasses (`MixedPrecisionState`, `LossScaleState`,
   `ScaleState`); a dataclass field's path part is `.<field>`, as the
   reference's tree paths name a registered dataclass's fields. bf16 and
   fp8 leaves are stored as their bit patterns (unsigned integers of their
   width) with the real dtype in the manifest, as the reference stores
   them, so either package reads the other's checkpoints of such trees.
 * `restore(target)` fills the structure of `target`: a tensor leaf is
   copied into the target's tensor in place (its device, its dtype), a
   numpy leaf replaced by the stored array (cast to the target's dtype), a
   number by the stored number. A leaf missing from the checkpoint raises
   KeyError, a shape mismatch ValueError.
 * `last_save_s` (from a save's call to the end of its write),
   `last_save_bytes` (its leaves.npz) and `last_restore_s` time the
   checkpointer for a caller that reports them.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

_MANIFEST = "manifest.json"
_COMMITTED = "COMMITTED"

_UINT_OF_WIDTH = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}

# The dtypes numpy stores as they are; torch's others by their bit pattern.
_TORCH_NAMES = {torch.bfloat16: "bfloat16",
                torch.float8_e5m2: "float8_e5m2",
                torch.float8_e4m3fn: "float8_e4m3fn"}
_TORCH_OF_NAME = {v: k for k, v in _TORCH_NAMES.items()}

# np.savez forbids "/" in archive names, so path keys are escaped. v2
# escapes "_" -> "_u" first, so every "__" in the escaped form comes from
# "/" and the decode ("__" -> "/", then "_u" -> "_") is exact (the v1
# scheme, "/" -> "__" alone, mangled "w__gate" and "w/gate" alike).
_KEY_ESCAPE = "v2"


def _escape_key(key: str) -> str:
    return key.replace("_", "_u").replace("/", "__")


def _unescape_key(name: str, scheme) -> str:
    if scheme == _KEY_ESCAPE:
        return name.replace("__", "/").replace("_u", "_")
    # Legacy (pre-v2) manifests carry no "key_escape": lossy inverse.
    return name.replace("__", "/")


def _children(tree):
    """(path part, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for part, child in kids:
        out.update(_flatten(child, f"{prefix}/{part}" if prefix else part))
    return out


def _to_host(x):
    """(a host numpy array the writer may keep, its dtype name)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        name = _TORCH_NAMES.get(t.dtype)
        if name is not None:
            width = t.element_size()
            ints = {1: torch.uint8, 2: torch.int16}[width]
            return t.view(ints).numpy().view(_UINT_OF_WIDTH[width]), name
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(x, copy=True)
    return arr, str(arr.dtype)


def _restore_leaf(key: str, target, arr: np.ndarray, dtype_name: str):
    shape = tuple(target.shape) if hasattr(target, "shape") else ()
    if arr.shape != shape:
        raise ValueError(f"leaf {key}: checkpoint shape {arr.shape} != "
                         f"target {shape}")
    if isinstance(target, torch.Tensor):
        special = _TORCH_OF_NAME.get(dtype_name)
        src = (torch.from_numpy(arr.view(np.uint8 if special.itemsize == 1
                                         else np.int16)).view(special)
               if special is not None else torch.from_numpy(arr))
        with torch.no_grad():
            target.copy_(src.to(target.dtype))
        return target
    if isinstance(target, np.ndarray):
        return arr.astype(target.dtype)
    return type(target)(arr.item())


def _rebuild(target, leaves: Dict[str, tuple], prefix: str = ""):
    kids = _children(target)
    if kids is None:
        if prefix not in leaves:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        return _restore_leaf(prefix, target, *leaves[prefix])
    new = {part: _rebuild(child, leaves,
                          f"{prefix}/{part}" if prefix else part)
           for part, child in kids}
    if isinstance(target, dict):
        return {k: new[str(k)] for k in target}
    if dataclasses.is_dataclass(target):
        return dataclasses.replace(
            target, **{f.name: new[f".{f.name}"]
                       for f in dataclasses.fields(target)})
    return type(target)(new[str(i)] for i in range(len(target)))


class Checkpointer:
    def __init__(self, directory, *, keep_last_k: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last_k = keep_last_k
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.last_save_s = self.last_restore_s = None
        self.last_save_bytes = None
        # Serializes the writer thread's commit / GC against directory
        # scans and restores on the caller's thread.
        self._lock = threading.Lock()
        # With the non-daemon writer: a process that exits right after its
        # last save() still joins the write in flight.
        atexit.register(self.wait)

    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None):
        """Snapshot `tree` at `step`: copied to the host here, written
        (optionally) on a background thread."""
        self.wait()
        t0 = time.perf_counter()
        leaves, dtypes = {}, {}
        for k, v in _flatten(tree).items():
            leaves[k], dtypes[k] = _to_host(v)
        manifest = {"step": int(step), "time": time.time(),
                    "keys": sorted(leaves), "dtypes": dtypes,
                    "key_escape": _KEY_ESCAPE, "extra": extra or {}}

        def _write():
            tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "leaves.npz",
                     **{_escape_key(k): v for k, v in leaves.items()})
            (tmp / _MANIFEST).write_text(json.dumps(manifest))
            (tmp / _COMMITTED).write_text("ok")
            size = (tmp / "leaves.npz").stat().st_size
            with self._lock:
                final = self.dir / f"step_{step:010d}"
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
                self._gc_locked()
            self.last_save_s = time.perf_counter() - t0
            self.last_save_bytes = size

        if self.async_save:
            # Non-daemon: interpreter shutdown joins it, so the last
            # checkpoint is never left as a tmp directory.
            self._thread = threading.Thread(target=_write, daemon=False)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc_locked(self):
        steps = self._all_steps_locked()
        for s in steps[:-self.keep_last_k] if self.keep_last_k else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    def _all_steps_locked(self):
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if (p / _COMMITTED).exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def all_steps(self):
        with self._lock:
            return self._all_steps_locked()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, *, step: Optional[int] = None):
        """Restore step `step` (default: the newest committed one) into the
        structure of `target` (module docstring). Returns (tree, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        t0 = time.perf_counter()
        # The lock is held through the reads: the writer's GC must not
        # delete a step directory mid-load.
        with self._lock:
            d = self.dir / f"step_{step:010d}"
            man = json.loads((d / _MANIFEST).read_text())
            dtypes, scheme = man["dtypes"], man.get("key_escape")
            with np.load(d / "leaves.npz") as data:
                leaves = {}
                for name in data.files:
                    key = _unescape_key(name, scheme)
                    leaves[key] = (data[name], dtypes[key])
        out = _rebuild(target, leaves)
        self.last_restore_s = time.perf_counter() - t0
        return out, step

    def manifest(self, step: Optional[int] = None) -> dict:
        if step is None:
            step = self.latest_step()
        d = self.dir / f"step_{step:010d}"
        return json.loads((d / _MANIFEST).read_text())
