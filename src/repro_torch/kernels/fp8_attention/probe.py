"""Where the time of the attention kernels goes, read on the card.

    python -m repro_torch.kernels.fp8_attention.probe [--b 4] [--s 512]
    python -m repro_torch.kernels.fp8_attention.probe --fwd
    python -m repro_torch.kernels.fp8_attention.probe --dkv

The default mode probes the dQ kernel's stash variant; --fwd the forward
kernel and --dkv the dK/dV kernel (below).

Builds csrc/fp8_attention_bwd.cu with -DDQ_PROBE into a temporary
directory (the stash kernel then records the SM clock at its pass
boundaries in the grid's first block, a longest span, and its last, a
shortest; and every block's start, end, SM and clock count), launches the
stash variant at a causal shape (H=12, Hkv=2, D=128, hybrid recipe, SR,
random fp8 inputs from a seed) and prints: ptxas' registers and spills;
the probe build's time per launch beside the plain build's; the cycles of
each pass in the two blocks; the launch's makespan, the share of the
block slots (blocks resident per SM x SMs) that held a block, the SM
clock, and the resident blocks at 20 points of the launch.

--fwd builds csrc/fp8_attention_fwd.cu with -DFWD_PROBE (thread 0 of every
block attributes its SM clock to the passes: stage / widen, S product, S
epilogue, P epilogue, P.V, rescale, store; every block records its start,
end, SM and the kv blocks it visited, and each warp whether it ran its
epilogue). At the training shape (causal B=4, H=12, Hkv=2, S=512, e4m3,
SR) and the serving 'chunk' shape (B=4, Q=32, S=512, the ragged requests
of chip_smoke.py) it prints ptxas' registers and spills, the shared memory
and blocks per SM, the probe build's and the package build's device time
per launch (20 launches replayed from a CUDA graph) and time per
back-to-back call, the cycles of each pass in a longest-span tile, the
makespan, the share of block slots busy, and whether the schedule the
kernel ran is the one `ops.fwd_live_blocks` / `fwd_dead_warps` /
`fwd_tile_order` state (`fwd_schedule_faults`, which chip_smoke.py and the
`gpu` tests also run).

--dkv builds csrc/fp8_attention_bwd.cu with -DDKV_PROBE (thread 0 of every
dK/dV block attributes its SM clock to the parts: staging, the S^T
product, the S/P epilogue, the dV product, the dP^T product, the dS
epilogue, the dK product, the store; every block records its start, end,
SM, (head, batch row, kv block) and the q tiles it visited). At the
training shape (causal B=4, H=12, Hkv=2, S=512, hybrid, SR), a windowed
causal S=2048 with a GQA group of one and a ragged full S=968 it prints
ptxas' registers and spills, the shared memory and blocks per SM, the
probe and package builds' device time (graph replays, main kernel and
group sum), the cycles of each part in the longest block, the makespan,
the busy share of the block slots, and whether the schedule the kernel
ran is the one `ops.dkv_block_order` / `dkv_live_tiles` state
(`dkv_schedule_faults`, which chip_smoke.py and the `gpu` tests also
run). Every mode needs a CUDA device and nvcc.
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
    return build_all(out_dir, "fp8_attention_bwd", {"probe": ["-DDQ_PROBE"]})[
        "probe"]


def build_all(out_dir: Path, name: str, variants: dict) -> dict:
    """{variant: (library, ptxas log)}: csrc/<name>.cu built once per
    variant with its extra nvcc flags, all builds started together."""
    procs = {}
    for var, flags in variants.items():
        out = out_dir / f"lib{name}_{var}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
               str(_build.CSRC / f"{name}.cu")]
        procs[var] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for var, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({var}):\n{log}")
        libs[var] = (ctypes.CDLL(str(out)), log)
    return libs


def ptxas_line(log: str, symbol: str) -> str:
    """ptxas' stack / spill and register lines for `symbol`, and whether it
    serialized the kernel's wgmma instructions (warning C7510-C7520)."""
    rep = log.splitlines()
    ser = "; wgmma serialized" if any(
        "serialized" in ln and symbol in ln for ln in rep) else ""
    for i, ln in enumerate(rep):
        if "Function properties" in ln and symbol in ln:
            return " | ".join(x.strip() for x in rep[i + 1:i + 3]) + ser
    return "not found"


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


def graph_ms(fn, iters=20):
    """Device time per call of fn, replayed from a CUDA graph of `iters`
    calls (no host time between the launches)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


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


FWD_PASSES = ("stage / widen", "S product", "S epilogue", "P epilogue",
              "P.V", "rescale", "store")
FWD_WARPS = ops.FWD_BQ // ops.FWD_WARP_ROWS
FWD_WORDS = 7 + FWD_WARPS + len(FWD_PASSES)


def build_fwd_probe(out_dir: Path) -> tuple[ctypes.CDLL, str]:
    """csrc/fp8_attention_fwd.cu built with -DFWD_PROBE into out_dir."""
    return build_all(out_dir, "fp8_attention_fwd",
                     {"probe": ["-DFWD_PROBE"]})["probe"]


def fwd_records(lib, q, k, v, kw) -> np.ndarray:
    """One launch of the probe build `lib` on the wrapper's arguments
    (kw: mask_mode, window, kv_mask, chunk_pos; e4m3 scores and probs,
    RNE); its per-block records, by block id ((z * B + b) * H + h)."""
    ops._fwd_cuda(q, k, v, 7, [0.088388, 1.0, 1.0, 1.0], lib=lib,
                  fmt_s="e4m3", fmt_p="e4m3", rounding_s="rne",
                  rounding_p="rne", saturate_s=True, saturate_p=True, **kw)
    return read_fwd_records(lib, q)


def read_fwd_records(lib, q) -> np.ndarray:
    """The probe build's records of its last launch on queries q."""
    torch.cuda.synchronize()
    b, h, t = q.shape[:3]
    n = b * h * len(ops.fwd_tile_order(t))
    rec = (ctypes.c_ulonglong * (FWD_WORDS * n))()
    _build.check(lib.attn_fwd_probe_read(rec, n), "probe")
    return np.array(rec, dtype=np.int64).reshape(n, FWD_WORDS)


def fwd_schedule_faults(lib, q, k, v, kw) -> list:
    """Where the schedule kernel 2 ran (probe build `lib`, one launch)
    differs from the rule `ops` states: for every block, the q tile its
    blockIdx.z stands for (fwd_tile_order), the kv blocks it visited
    (fwd_live_blocks) and the warps that skipped their epilogue
    (fwd_dead_warps). Returns a description per differing block."""
    kw = {"window": 0, "kv_mask": None, "chunk_pos": None, **kw}
    b, h, t = q.shape[:3]
    s_len = k.shape[2]
    if -(-s_len // ops.LANE) > 64:
        raise ValueError("the probe records at most 64 kv blocks a tile")
    rule = dict(q_rows=t, mask_mode=kw["mask_mode"])
    kvm, cpos = kw["kv_mask"], kw["chunk_pos"]
    kvm = None if kvm is None else torch.as_tensor(kvm).cpu().numpy()
    cpos = None if cpos is None else torch.as_tensor(cpos).cpu().numpy()
    order = ops.fwd_tile_order(t)
    faults = []
    for bid, r in enumerate(fwd_records(lib, q, k, v, kw)):
        z, bb, hh = bid // (b * h), bid // h % b, bid % h
        iq = int(r[5])
        live = [j for j in range(64) if int(r[6]) >> j & 1]
        dead = [not r[7 + w] for w in range(FWD_WARPS)]
        want_live = ops.fwd_live_blocks(
            iq, bb, s_len=s_len, window=kw["window"], kv_mask=kvm,
            chunk_pos=cpos, **rule)
        want_dead = ops.fwd_dead_warps(iq, bb, chunk_pos=cpos, **rule)
        if iq != order[z] or live != want_live or dead != want_dead \
                or r[4] != len(live):
            faults.append(f"block (b {bb}, h {hh}, z {z}): q tile {iq} "
                          f"(rule {order[z]}), kv blocks {live} (rule "
                          f"{want_live}), dead warps {dead} (rule "
                          f"{want_dead})")
    return faults


def fwd_cases(dev):
    """(name, q, k, v, scal, kwargs) of the two shapes the probe reads."""
    gen = torch.Generator(device=dev).manual_seed(9)
    e4 = torch.float8_e4m3fn

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(e4)
    b, h, hkv, s, d = 4, 12, 2, 512, 128
    rec = dict(fmt_s="e4m3", fmt_p="e4m3", rounding_s="sr", rounding_p="sr",
               saturate_s=True, saturate_p=True)
    train = ("training: causal B=4 H=12 Hkv=2 S=512 D=128, e4m3, SR",
             rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d),
             [0.088388, 1.0, 1.0, 1.0],
             dict(mask_mode="causal", window=0, s_len=s,
                  kvm=None, chunk_pos=None, **rec))
    t = 32
    cols = torch.arange(s, device=dev)[None]
    lengths = torch.tensor([100, 37, 480, 5], device=dev)[:, None]
    slot_pos = torch.where(cols < lengths, cols, torch.full_like(cols, -1))
    chunk_pos = torch.tensor([[68, 32], [36, 1], [479, 1], [0, 5]],
                             device=dev)
    serve = ("serving: chunk B=4 H=12 Hkv=2 Q=32 S=512 D=128, e4m3, SR",
             rnd(b, h, t, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d),
             [0.088388, 1.0, 1.0, 1.0],
             dict(mask_mode="chunk", window=0, s_len=s,
                  kvm=slot_pos.int().contiguous(),
                  chunk_pos=chunk_pos.int().contiguous(), **rec))
    return train, serve


def fwd_launch(lib, case):
    _, q, k, v, scal, kw = case
    kw = dict(kw)
    kvm, cpos = kw.pop("kvm"), kw.pop("chunk_pos")
    return ops._launch(q, k, v, kvm, cpos, 7, scal, lib=lib, **kw)


def fwd_main(card):
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"probe": build_fwd_probe(Path(tmp)),
                "package": (_build.load("fp8_attention_fwd"),
                            _build.BUILD_LOGS.get("fp8_attention_fwd", ""))}
        print(f"card: {card}")
        for var, (lib, log) in libs.items():
            info = (ctypes.c_int * 4)()
            _build.check(lib.attn_fwd_info(4, info), "probe")
            print(f"{var} build: ptxas {ptxas_line(log, 'attn_fwd_kernel')}; "
                  f"{info[0]} bytes of shared memory at S=512, {info[1]} "
                  f"registers, {info[2]} local bytes, {info[3]} blocks per "
                  f"SM")
        resident = info[3]
        slots = torch.cuda.get_device_properties(dev).multi_processor_count \
            * resident
        for case in fwd_cases(dev):
            name, q = case[0], case[1]
            print(f"-- {name}")
            # Each build in turn, then back (a, b, b, a): the device time of
            # 20 launches replayed from a CUDA graph (the host's time per
            # call does not enter), and back-to-back calls.
            order = ("package", "probe")
            ms = {v: [] for v in order}
            calls = {v: [] for v in order}
            for var in order + order[::-1]:
                fn = lambda: fwd_launch(libs[var][0], case)  # noqa: E731
                ms[var].append(graph_ms(fn))
                calls[var].append(event_ms(fn))
            print("device ms per launch (graph): " + ", ".join(
                f"{v} {min(x):.4f} (runs {', '.join(f'{y:.4f}' for y in x)})"
                for v, x in ms.items()))
            print("ms per call (back-to-back): " + ", ".join(
                f"{v} {min(x):.4f}" for v, x in calls.items()))
            lib = libs["probe"][0]
            fwd_launch(lib, case)
            bl = read_fwd_records(lib, q)
            top = bl[np.argmax(bl[:, 4])]
            cyc = top[7 + FWD_WARPS:]
            print(f"longest-span tile (q tile {top[5]}, {top[4]} kv "
                  f"blocks): {int(top[3])} cycles; " + ", ".join(
                      f"{p} {int(c)}" for p, c in zip(FWD_PASSES, cyc)))
            print(f"live kv blocks per tile: {np.bincount(bl[:, 4]).tolist()}"
                  " (count of tiles with 0, 1, ... blocks)")
            t0 = bl[:, 0].min()
            st, en = (bl[:, 0] - t0) / 1e3, (bl[:, 1] - t0) / 1e3
            span = en.max()
            print(f"makespan {span:.1f} us; busy share of the {slots} block "
                  f"slots {(en - st).sum() / (slots * span):.3f}; SM clock "
                  f"{np.median(bl[:, 3] / (bl[:, 1] - bl[:, 0])) * 1e3:.0f} "
                  f"MHz; {len(set(bl[:, 2].tolist()))} SMs")
            kw = {x: case[5][x] for x in ("mask_mode", "window")}
            kw.update(kv_mask=case[5]["kvm"], chunk_pos=case[5]["chunk_pos"])
            faults = fwd_schedule_faults(lib, q, case[2], case[3], kw)
            print(f"schedule against ops.fwd_*: {len(faults)} of "
                  f"{len(bl)} blocks "
                  "differ" + "".join(f"\n  {f}" for f in faults[:5]))


DKV_PARTS = ("staging", "S^T product", "S/P epilogue", "dV product",
             "dP^T product", "dS epilogue", "dK product", "store")
DKV_WORDS = 9 + len(DKV_PARTS)


def build_dkv_probe(out_dir: Path) -> tuple[ctypes.CDLL, str]:
    """csrc/fp8_attention_bwd.cu built with -DDKV_PROBE into out_dir."""
    return build_all(out_dir, "fp8_attention_bwd",
                     {"dkv_probe": ["-DDKV_PROBE"]})["dkv_probe"]


def dkv_case(dev, *, b=4, s=512, mask="causal", window=0, group=6):
    """(name, q, k, v, do, scal, kw) of a backward at H = 2 * group, Hkv=2,
    D=128 (hybrid recipe, SR; random fp8 inputs from a seed), kw holding
    the dK/dV wrapper's keyword arguments."""
    gen = torch.Generator(device=dev).manual_seed(9)
    h, hkv, d = 2 * group, 2, 128

    def rnd(*shape, dt=torch.float8_e4m3fn):
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    q, do = rnd(b, h, s, d), rnd(b, h, s, d, dt=torch.float8_e5m2)
    s_pad = -(-s // ops.LANE) * ops.LANE
    k, v = rnd(b, hkv, s_pad, d), rnd(b, hkv, s_pad, d)
    scal = [0.088388, 1.0, 1.0, 1.0, 1.0, 1.0, 0.088388, 1.0, 1.0, 1.0]
    kw = dict(mask_mode=mask, window=window, fmt_s="e4m3", fmt_p="e4m3",
              fmt_e="e5m2", rounding_s="sr", rounding_p="sr",
              rounding_e="sr", saturate_e=False, q_len=s, s_len=s)
    name = (f"{mask} B={b} H={h} Hkv={hkv} S={s} D={d}"
            + (f" window={window}" if window else "") + ", hybrid, SR")
    return name, q, k, v, do, scal, kw


def dkv_stats(case):
    """Kernel 1's row statistics (m, l, rd) for a dK/dV case."""
    _, q, k, v, do, scal, kw = case
    return ops.fp8_attention_bwd_dq(q, k, v, do, 7, scal, **kw)[1:4]


def dkv_records(lib, case, stats) -> np.ndarray:
    """One launch of the probe build `lib`; its per-block records, by
    block id ((z * B + b) * H + h)."""
    _, q, k, v, do, scal, kw = case
    ops.fp8_attention_bwd_dkv(q, k, v, do, 7, scal, *stats, lib=lib, **kw)
    torch.cuda.synchronize()
    b, h = q.shape[:2]
    n = b * h * len(ops.dkv_block_order(k.shape[2]))
    rec = (ctypes.c_ulonglong * (DKV_WORDS * n))()
    _build.check(lib.attn_bwd_dkv_probe_read(rec, n), "probe")
    return np.array(rec, dtype=np.int64).reshape(n, DKV_WORDS)


def dkv_schedule_faults(lib, case, stats=None) -> list:
    """Where the schedule the dK/dV kernel ran (probe build `lib`, one
    launch) differs from the rule `ops` states: for every block, the
    (head, batch row) of its blockIdx, the kv block its blockIdx.z stands
    for (dkv_block_order) and the query tiles it visited, in two steps
    each (dkv_live_tiles). Returns a description per differing block."""
    _, q, k, v, do, scal, kw = case
    b, h, q_rows = q.shape[:3]
    s_pad = k.shape[2]
    if -(-q_rows // 128) > 64:
        raise ValueError("the probe records at most 64 q tiles a block")
    order = ops.dkv_block_order(s_pad)
    faults = []
    recs = dkv_records(lib, case, stats if stats is not None
                       else dkv_stats(case))
    for bid, r in enumerate(recs):
        z, bb, hh = bid // (b * h), bid // h % b, bid % h
        tiles = [t for t in range(64) if int(r[7]) >> t & 1]
        want = ops.dkv_live_tiles(order[z], q_rows=q_rows, s_pad=s_pad,
                                  mask_mode=kw["mask_mode"],
                                  window=kw["window"])
        if (r[4], r[5], r[6]) != (hh, bb, order[z]) or tiles != want \
                or r[8] != 2 * len(want):
            faults.append(f"block (h {hh}, b {bb}, z {z}): ran (h {r[4]}, "
                          f"b {r[5]}, kv block {r[6]}), q tiles {tiles} in "
                          f"{r[8]} steps (rule: kv block {order[z]}, q "
                          f"tiles {want})")
    return faults


def dkv_case_list(dev):
    """The training shape, and shapes that reach a window, a full mask, a
    GQA group of one and ragged lengths."""
    return (dkv_case(dev),
            dkv_case(dev, b=1, s=2048, window=256, group=1),
            dkv_case(dev, b=1, s=968, mask="full", group=2))


def dkv_main(card):
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"probe": build_dkv_probe(Path(tmp)),
                "package": (_build.load("fp8_attention_bwd"),
                            _build.BUILD_LOGS.get("fp8_attention_bwd", ""))}
        print(f"card: {card}")
        for var, (lib, log) in libs.items():
            info = (ctypes.c_int * 6)()
            _build.check(lib.attn_bwd_dkv_info(info), "probe")
            print(f"{var} build: ptxas "
                  f"{ptxas_line(log, 'attn_bwd_dkv_kernel_head')}; group "
                  f"sum {ptxas_line(log, 'attn_bwd_dkv_kernel_group_sum')}; "
                  f"{info[0]} bytes of shared memory, {info[1]} registers, "
                  f"{info[2]} local bytes, {info[3]} blocks per SM; group "
                  f"sum {info[4]} registers, {info[5]} local bytes")
        slots = torch.cuda.get_device_properties(dev).multi_processor_count \
            * info[3]
        for case in dkv_case_list(dev):
            name, q, k, v, do, scal, kw = case
            print(f"-- {name}")
            stats = dkv_stats(case)
            order = ("package", "probe")
            ms = {x: [] for x in order}
            for var in order + order[::-1]:
                fn = lambda: ops.fp8_attention_bwd_dkv(  # noqa: E731
                    q, k, v, do, 7, scal, *stats, lib=libs[var][0], **kw)
                ms[var].append(graph_ms(fn))
            print("device ms per launch (graph, both kernels): " + ", ".join(
                f"{x} {min(y):.4f} (runs {', '.join(f'{z:.4f}' for z in y)})"
                for x, y in ms.items()))
            bl = dkv_records(libs["probe"][0], case, stats)
            top = bl[np.argmax(bl[:, 3])]
            print(f"longest block (kv block {top[6]}, {top[8]} steps): "
                  f"{int(top[3])} cycles; " + ", ".join(
                      f"{p} {int(c)}" for p, c in zip(DKV_PARTS, top[9:])))
            t0 = bl[:, 0].min()
            st, en = (bl[:, 0] - t0) / 1e3, (bl[:, 1] - t0) / 1e3
            span = en.max()
            print(f"makespan {span:.1f} us; busy share of the {slots} block "
                  f"slots {(en - st).sum() / (slots * span):.3f}; SM clock "
                  f"{np.median(bl[:, 3] / (bl[:, 1] - bl[:, 0])) * 1e3:.0f} "
                  f"MHz; {len(set(bl[:, 2].tolist()))} SMs")
            faults = dkv_schedule_faults(libs["probe"][0], case, stats)
            print(f"schedule against ops.dkv_*: {len(faults)} of {len(bl)} "
                  "blocks differ" + "".join(f"\n  {x}" for x in faults[:5]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=4)
    ap.add_argument("--s", type=int, default=512)
    ap.add_argument("--fwd", action="store_true",
                    help="probe the forward kernel instead of the dQ kernel")
    ap.add_argument("--dkv", action="store_true",
                    help="probe the dK/dV kernel instead of the dQ kernel")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if a.fwd:
        return fwd_main(card)
    if a.dkv:
        return dkv_main(card)
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
        print("ptxas (probe build):", ptxas_line(log, "stash"))
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
