"""PyTorch + CUDA port of `repro` (FP8 mixed-precision training and serving).

The JAX/Pallas package `repro` is the reference; this package reproduces it
in PyTorch, with every Pallas TPU kernel on the ported path rewritten by hand
for NVIDIA Hopper (`csrc/`). It imports torch, numpy and the standard library
only — never jax and never a module of `repro`.

Ported so far: FP8 serving of the dense decoder (`serve.engine`: the paged
and the fixed-slot engines, bf16 and FP8 KV caches, fused and unfused
attention) with the calibration that produces its frozen scales
(`scaling.calibrate`); FP8 training under the hybrid delayed-scaling
recipe and the paper's own (`train.step`); and every Pallas kernel of the
reference, in `kernels/` and `csrc/`.

Public layouts follow the reference: weights are `(d_in, d_out)` so `x @ W`
is the `nn` GEMM, attention tensors are `(B, H, S, dh)`. Entry points run on
the CUDA device unless the caller passes `device="cpu"`; a CUDA tensor always
goes through its kernel, a CPU tensor through the kernel's plain version.
"""
