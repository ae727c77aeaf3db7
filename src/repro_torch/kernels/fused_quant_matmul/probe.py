"""Where the time of the FP8 GEMM's mainloop goes, read on the card.

    python -m repro_torch.kernels.fused_quant_matmul.probe [--m 2048]
        [--k 1536] [--n 8960]

Builds csrc/fused_quant_matmul.cu six times into a temporary directory,
one nvcc each, all started together: as it is, and with -DFQMM_SKIP
leaving out the widening (1), the widening and the ring refills (3), the
products (4), the widening and the products (5), or all three (7). Prints each variant's shared memory, registers, spills
and blocks per SM; then, at the `nn` shape (M, K, N) with random e4m3
operands from a seed, for each tile width: kernel 1 (RNE and SR, e4m3
out) and kernel 5 (f32 out) launched straight through the C entry points
(no wrapper, no padding), and kernel 5 in each skip build; beside them the
shared-memory bytes a k-step moves and the k-step's products in
tensor-core cycles of one SM at the f16 rate. A measurement, not a check
(the skip builds compute wrong results); it needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.fp8_matmul import ops as mm
from repro_torch.kernels.fused_quant_matmul import ops

SKIPS = {"full": 0, "no widening": 1, "no widening, no refills": 3,
         "no products": 4, "refills only": 5, "prologue and epilogue": 7}
F16_FLOP_PER_SM_CYCLE = 4096     # 989 TFLOP/s / (132 SMs x 1.83 GHz)


def build_skips(out_dir: Path) -> dict:
    """{skip name: (library, nvcc output)} for every entry of SKIPS."""
    procs = {}
    for name, bits in SKIPS.items():
        out = out_dir / f"libfqmm_skip{bits}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, f"-DFQMM_SKIP={bits}",
               "-o", str(out), str(_build.CSRC / "fused_quant_matmul.cu")]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({name}):\n{log}")
        libs[name] = (ctypes.CDLL(str(out)), log)
    return libs


def event_ms(fn, iters=50):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def kstep_bytes(bn: int) -> int:
    """Shared-memory bytes one 128 x bn k-step moves: fp8 into the ring and
    out of it, f16 into the operand tiles, and wgmma's operand reads (each
    warpgroup reads its 64 rows of A and all of B)."""
    fp8 = (ops.BM + bn) * ops.BK
    return 2 * fp8 + 2 * fp8 + 2 * (64 + bn) * ops.BK * 2


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=2048)
    ap.add_argument("--k", type=int, default=1536)
    ap.add_argument("--n", type=int, default=8960)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA device")
    m, k, n = a.m, a.k, a.n
    if m % ops.BM or k % ops.BK or n % 256:
        raise SystemExit("probe: M a multiple of 128, K of 64, N of 256")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_skips(Path(tmp))
        full = libs["full"][0]
        info = (ctypes.c_int * 4)()
        for v, (out, dims, bn) in enumerate(ops.GEMM_VARIANTS):
            _build.check(full.fqmm_variant_info(v, info), "fqmm_variant_info")
            print(f"variant {out} {dims} 128x{bn}: {info[0]} bytes of shared "
                  f"memory, {info[1]} registers, {info[2]} spill bytes a "
                  f"thread, {info[3]} blocks per SM")
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((m, k), generator=gen, device=dev).to(
            torch.float8_e4m3fn)
        w = torch.randn((k, n), generator=gen, device=dev).to(
            torch.float8_e4m3fn)
        rand8 = torch.randint(0, 256, (m, n), dtype=torch.uint8,
                              generator=gen, device=dev)
        out8 = torch.empty((m, n), dtype=torch.uint8, device=dev)
        out32 = torch.empty((m, n), dtype=torch.float32, device=dev)
        obs = torch.empty((m // ops.BM) * (n // 128), device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def k1(lib, bn, sr):
            fn = lib.fqmm_launch
            fn.argtypes, fn.restype = ops._ARGTYPES, ctypes.c_int
            return lambda: fn(x.data_ptr(), w.data_ptr(), rand8.data_ptr(),
                              out8.data_ptr(), obs.data_ptr(),
                              obs.data_ptr(), obs.data_ptr(), m, n, k, k, 1,
                              n, 1, 0, 0, 0, int(sr), 1, 64.0, m, n, 1, bn,
                              stream)

        def k5(lib, bn):
            fn = lib.fp8mm_launch
            fn.argtypes, fn.restype = mm._ARGTYPES, ctypes.c_int
            return lambda: fn(x.data_ptr(), w.data_ptr(), out32.data_ptr(),
                              m, n, k, 0, 0, 0, bn, stream)

        flop = 2.0 * m * n * k
        print(f"nn M={m} K={k} N={n}, e4m3 operands; f16 tensor-core peak "
              f"{flop / 989e12 * 1e3:.4f} ms [{card}]")
        for bn in ops.TILE_WIDTHS:
            mma_cycles = 2 * ops.BM * bn * ops.BK // F16_FLOP_PER_SM_CYCLE
            line = [f"128x{bn} (blocks {(m // ops.BM) * (n // bn)}; a k-step "
                    f"moves {kstep_bytes(bn)} bytes of shared memory, "
                    f"{kstep_bytes(bn) / 128:.0f} cycles at 128 B/cycle, "
                    f"against {mma_cycles} cycles of products):"]
            for sr in (False, True):
                line.append(f"kernel 1 {'SR' if sr else 'RNE'} "
                            f"{event_ms(k1(full, bn, sr)):.4f} ms")
            for name, (lib, _) in libs.items():
                line.append(f"kernel 5 {name} {event_ms(k5(lib, bn)):.4f} ms")
            print("\n  ".join(line))


if __name__ == "__main__":
    main()
