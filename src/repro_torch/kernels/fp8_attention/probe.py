"""Where the time of the dQ kernel's stash variant goes, read on the card.

    python -m repro_torch.kernels.fp8_attention.probe [--b 4] [--s 512]

Builds csrc/fp8_attention_bwd.cu with -DDQ_PROBE into a temporary
directory (the stash kernel then records the SM clock at its pass
boundaries in the grid's first block, a longest span, and its last, a
shortest; and every block's start, end, SM and clock count), launches the
stash variant at a causal shape (H=12, Hkv=2, D=128, hybrid recipe, SR,
random fp8 inputs from a seed) and prints: ptxas' registers and spills;
the probe build's time per launch beside the plain build's; the cycles of
each pass in the two blocks; the launch's makespan, the share of the
block slots (blocks resident per SM x SMs) that held a block, the SM
clock, and the resident blocks at 20 points of the launch. A measurement,
not a check; it needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.fp8_attention import ops

PASSES = ("stage q", "A: S8", "A: dP8", "B: l", "B: P8, rd", "C: dS8, dq")


def build_probe(out_dir: Path) -> tuple[ctypes.CDLL, str]:
    out = out_dir / "libfp8_attention_bwd_probe.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-DDQ_PROBE", "-o", str(out),
           str(_build.CSRC / "fp8_attention_bwd.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(out)), res.stdout + res.stderr


def launch(lib, q, k, v, do, scal, kw):
    """One stash-variant launch through `lib` (the wrapper's arguments)."""
    iv, fv = ops._bwd_args(q, k, v, do, scal=scal, **kw)
    b, h, s, d = q.shape
    dq = torch.empty((b, h, s, d), dtype=torch.float32, device=q.device)
    m, l, rd = (torch.empty((b, h, s), device=q.device) for _ in range(3))
    am = [torch.empty((b, h, -(-s // 64)), device=q.device)
          for _ in range(2)]
    seed = ops.seed_tensor(7, q.device)
    fn = lib.attn_bwd_dq_stash_launch
    fn.argtypes = ops._BWD_DQ_ARGTYPES
    fn.restype = ctypes.c_int
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    seed.data_ptr(), dq.data_ptr(), m.data_ptr(),
                    l.data_ptr(), rd.data_ptr(), am[0].data_ptr(),
                    am[1].data_ptr(), iv, fv,
                    torch.cuda.current_stream().cuda_stream), "probe")


def event_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=4)
    ap.add_argument("--s", type=int, default=512)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(9)
    b, h, hkv, s, d = a.b, 12, 2, a.s, 128
    q = torch.randn((b, h, s, d), generator=gen, device=dev).to(
        torch.float8_e4m3fn)
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev).to(
        torch.float8_e4m3fn) for _ in range(2))
    do = torch.randn(q.shape, generator=gen, device=dev).to(
        torch.float8_e5m2)
    scal = [0.088388, 1.0, 1.0, 1.0, 1.0, 1.0, 0.088388, 1.0, 1.0, 1.0]
    kw = dict(mask_mode="causal", fmt_s="e4m3", fmt_p="e4m3", fmt_e="e5m2",
              rounding_s="sr", rounding_p="sr", rounding_e="sr",
              saturate_e=False, q_len=s, s_len=s)
    if ops.dq_variant(s, s, "causal") != "stash":
        raise SystemExit(f"probe: S={s} causal takes the long-span variant")
    with tempfile.TemporaryDirectory() as tmp:
        lib, log = build_probe(Path(tmp))
        print(f"card: {card}; causal B={b} H={h} Hkv={hkv} S={s} D={d}")
        rep = log.splitlines()
        for i, ln in enumerate(rep):
            if "Function properties" in ln and "stash" in ln:
                print("ptxas (probe build):", " | ".join(
                    x.strip() for x in rep[i + 1:i + 3]))
        info = (ctypes.c_int * 4)()
        _build.check(lib.attn_bwd_dq_stash_info(
            ops.dq_span_blocks(s, s, "causal"), info), "probe")
        resident = info[3]
        print(f"{info[0]} bytes of shared memory, {resident} blocks per SM")
        plain = _build.load("fp8_attention_bwd")
        ms_probe = event_ms(lambda: launch(lib, q, k, v, do, scal, kw))
        ms_plain = event_ms(lambda: launch(plain, q, k, v, do, scal, kw))
        print(f"ms per launch: probe build {ms_probe:.4f}, plain build "
              f"{ms_plain:.4f}")
        launch(lib, q, k, v, do, scal, kw)
        torch.cuda.synchronize()
        n = b * h * -(-s // 64)
        marks = (ctypes.c_ulonglong * 16)()
        blocks = (ctypes.c_ulonglong * (4 * n))()
        _build.check(lib.attn_bwd_dq_probe_read(marks, blocks, n), "probe")
    mk = np.array(marks, dtype=np.int64).reshape(2, 8)
    for row, name in zip(mk, ("first block (a longest span)",
                              "last block (a shortest span)")):
        cyc = np.diff(row[:7])
        print(f"{name}: {int(cyc.sum())} cycles; " + ", ".join(
            f"{p} {int(c)}" for p, c in zip(PASSES, cyc)))
    bl = np.array(blocks, dtype=np.int64).reshape(n, 4)
    t0 = bl[:, 0].min()
    st, en = (bl[:, 0] - t0) / 1e3, (bl[:, 1] - t0) / 1e3
    slots = torch.cuda.get_device_properties(dev).multi_processor_count \
        * resident
    span = en.max()
    print(f"makespan {span:.1f} us; busy share of the {slots} block slots "
          f"{(en - st).sum() / (slots * span):.3f}; SM clock "
          f"{np.median(bl[:, 3] / (bl[:, 1] - bl[:, 0])) * 1e3:.0f} MHz; "
          f"{len(set(bl[:, 2].tolist()))} SMs")
    ts = np.linspace(0, span, 21)
    print("resident blocks:", [int(((st <= x) & (en > x)).sum())
                               for x in ts])


if __name__ == "__main__":
    main()
