"""PyTorch + CUDA port of `repro` (FP8 mixed-precision training and serving).

The JAX/Pallas package `repro` is the reference; this package reproduces it
in PyTorch, with every Pallas TPU kernel on the ported path rewritten by hand
for NVIDIA Hopper (`csrc/`). It imports torch, numpy and the standard library
only — never jax and never a module of `repro`.

Ported so far (slice 1): frozen-scale FP8 paged serving of the dense decoder
(`serve.engine.PagedServeEngine`), the calibration that produces its scales
(`scaling.calibrate`), and the two kernels that path runs:
`kernels/fused_quant_matmul` and the forward of `kernels/fp8_attention`.

Public layouts follow the reference: weights are `(d_in, d_out)` so `x @ W`
is the `nn` GEMM, attention tensors are `(B, H, S, dh)`. Entry points run on
the CUDA device unless the caller passes `device="cpu"`; a CUDA tensor always
goes through its kernel, a CPU tensor through the kernel's plain version.
"""
