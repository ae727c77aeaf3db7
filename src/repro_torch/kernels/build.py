"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` exports plain C launch functions and is compiled on
first use into the build directory (`src/repro_torch/_build/`, or
$REPRO_TORCH_BUILD_DIR), named by a hash of its source and flags, so a stale
library is never loaded. Nothing is compiled at import time: this module is
imported on machines without nvcc, where only the plain versions run. The
attention kernels build once per head dim: `fp8_attention_{fwd,bwd}` at
D = 128 and `fp8_attention_{fwd,bwd}_d256` from the same sources with
`-DFP8_ATTN_D=256` (`attention_lib`), four nvcc processes side by side.

Every kernel is compiled with `--fmad=false`: the reference computes
`s8 * s_s - m` and `acc * c + pv` as separate roundings, which nvcc would
otherwise contract into FMAs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
KERNELS = ("fused_quant_matmul", "fp8_attention_fwd", "fp8_attention_bwd",
           "fp8_attention_fwd_d256", "fp8_attention_bwd_d256",
           "stochastic_round")
# Libraries built from another library's source: name -> (source, flags).
VARIANTS = {f"fp8_attention_{k}_d256": (f"fp8_attention_{k}",
                                        ("-DFP8_ATTN_D=256",))
            for k in ("fwd", "bwd")}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR")
                or Path(__file__).resolve().parents[1] / "_build")


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels build only on a machine with the CUDA toolkit")


def attention_lib(name: str, head_dim: int) -> str:
    """The library of attention kernel `name` ('fp8_attention_fwd' /
    'fp8_attention_bwd') built for `head_dim` (128 or 256)."""
    return name if head_dim == 128 else f"{name}_d{head_dim}"


def _source(name: str):
    """(source stem, extra nvcc flags) of library `name`."""
    return VARIANTS.get(name, (name, ()))


def lib_path(name: str) -> Path:
    src, extra = _source(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS + extra).encode())
    for f in [CSRC / f"{src}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    digest = h.hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every missing library in `names`, one nvcc each, all started
    together. Returns {name: library path}; raises with nvcc's output if
    any build fails. ptxas' register/shared-memory report lands in
    BUILD_LOGS[name], and beside the library (`.log`), from where a cached
    library's report is read back."""
    out = {n: lib_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    for n, p in out.items():
        if n not in todo and p.with_suffix(".log").exists():
            BUILD_LOGS[n] = p.with_suffix(".log").read_text()
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n, p in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
        os.close(fd)
        src, extra = _source(n)
        cmd = [exe, *NVCC_FLAGS, *extra, "-o", tmp, str(CSRC / f"{src}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            os.unlink(tmp)
        else:
            todo[n].with_suffix(".log").write_text(log)
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
