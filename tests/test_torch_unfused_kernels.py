"""The port's unfused fp8 GEMM and stochastic-rounding modules against
`repro`'s Pallas kernels (interpret mode on the CPU) and their oracles,
through the port's plain versions.

  * fp8_matmul (kernel 5): bit for bit on exact-accumulation fixtures
    (operand exponents {0, 1}, every f32 sum exact in any order) for
    e5m2, e4m3 and mixed operands, f32 and bf16 output, ragged M / K / N;
    on general inputs within the reference's own rtol 1e-5, atol 1e-4
    (tests/test_kernels.py), since summation order differs.
  * sr_quantize (kernel 6): bit for bit given the same uint8 bits, for
    both formats, f32 and bf16 input, both saturation modes, a scale that
    is not a power of two, and inf / NaN / subnormal / overflow inputs.
  * sr_quantize_onchip (kernel 7): its bits come from the port's counter
    hash, not the TPU's PRNG, so against the reference it is held by what
    SR promises — uniform bits and unbiased rounding (5 sigma) — and, fed
    the same bits, it is the reference's function bit for bit.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.fp8_matmul import fp8_matmul as j_fp8_matmul
from repro.kernels.fp8_matmul import fp8_matmul_ref as j_fp8_matmul_ref
from repro.kernels.stochastic_round.kernel import sr_quantize_kernel
from repro.kernels.stochastic_round.ref import stochastic_round_fp8_ref as j_sr_ref
from repro_torch.kernels.fp8_matmul import ops as tmm
from repro_torch.kernels.stochastic_round import ops as tsr
from repro_torch.kernels.stochastic_round import ref as tsr_ref

jax.config.update("jax_platform_name", "cpu")

NP_DT = {"e4m3": ml_dtypes.float8_e4m3fn, "e5m2": ml_dtypes.float8_e5m2}
T_DT = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
MAN = {"e4m3": 3, "e5m2": 2}
OUT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fp8_np(shape, fmt, rng, exact: bool) -> np.ndarray:
    sign = rng.choice([-1.0, 1.0], shape)
    if exact:
        m = rng.integers(0, 1 << MAN[fmt], shape) / (1 << MAN[fmt])
        x = sign * (1 + m) * np.exp2(rng.integers(0, 2, shape))
    else:
        x = sign * np.exp(rng.normal(size=shape))
    return x.astype(np.float32).astype(NP_DT[fmt]).astype(np.float32)


def u8(x) -> np.ndarray:
    """Payload bytes with NaNs canonicalized."""
    if isinstance(x, torch.Tensor):
        u, f = x.view(torch.uint8).numpy().copy(), x.float().numpy()
    else:
        a = np.asarray(x)
        u, f = a.view(np.uint8).copy(), a.astype(np.float32)
    u[np.isnan(f)] = 0xFF
    return u


# ---------------------------------------------------------------------------
# kernel 5: fp8_matmul
# ---------------------------------------------------------------------------

MM_SHAPES = [(64, 128, 64), (37, 200, 72), (130, 96, 40)]   # (M, K, N)
MM_FMTS = [("e5m2", "e5m2"), ("e4m3", "e4m3"), ("e4m3", "e5m2")]


def _mm_pair(shape, fa, fb, exact, seed):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    return fp8_np((m, k), fa, rng, exact), fp8_np((k, n), fb, rng, exact)


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("fmts", MM_FMTS, ids=["e5m2", "e4m3", "mixed"])
@pytest.mark.parametrize("shape", MM_SHAPES, ids=["even", "ragged",
                                                  "ragged2"])
def test_fp8_matmul_exact_bitwise(shape, fmts, out):
    fa, fb = fmts
    a, b = _mm_pair(shape, fa, fb, True, 1)
    jdt, tdt = OUT[out]
    ja, jb = jnp.asarray(a.astype(NP_DT[fa])), jnp.asarray(b.astype(NP_DT[fb]))
    want = np.asarray(j_fp8_matmul(ja, jb, out_dtype=jdt, interpret=True),
                      np.float32)
    oracle = np.asarray(j_fp8_matmul_ref(ja, jb, out_dtype=jdt), np.float32)
    got = tmm.fp8_matmul(torch.from_numpy(a).to(T_DT[fa]),
                         torch.from_numpy(b).to(T_DT[fb]), tdt)
    assert got.dtype == tdt and got.shape == shape[::2]
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(got.float().numpy(), oracle)


@pytest.mark.parametrize("fmts", MM_FMTS, ids=["e5m2", "e4m3", "mixed"])
def test_fp8_matmul_general_within_reference_tolerance(fmts):
    fa, fb = fmts
    a, b = _mm_pair((96, 384, 136), fa, fb, False, 2)
    ja, jb = jnp.asarray(a.astype(NP_DT[fa])), jnp.asarray(b.astype(NP_DT[fb]))
    want = np.asarray(j_fp8_matmul(ja, jb, interpret=True))
    got = tmm.fp8_matmul(torch.from_numpy(a).to(T_DT[fa]),
                         torch.from_numpy(b).to(T_DT[fb])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_fp8_matmul_rejects_bad_operands():
    a = torch.zeros((4, 8), dtype=torch.float8_e5m2)
    with pytest.raises(TypeError):
        tmm.fp8_matmul(a.float(), torch.zeros((8, 2), dtype=torch.float8_e5m2))
    with pytest.raises(ValueError):
        tmm.fp8_matmul(a, torch.zeros((4, 2), dtype=torch.float8_e5m2))
    with pytest.raises(ValueError):
        tmm.fp8_matmul(a, a.t().contiguous(), torch.float16)


# ---------------------------------------------------------------------------
# kernel 6: sr_quantize (random bits from an operand)
# ---------------------------------------------------------------------------

SPECIAL = np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0,
                    1e-40, -3e-39,                    # f32 subnormals
                    2.0 ** -17, -2.0 ** -15, 3e-6,    # e5m2 subnormal range
                    2.0 ** -8, -5e-3, 2.0 ** -10,     # e4m3 subnormal range
                    1e6, -7e4, 57344.0, 61440.0, 65519.0, 70000.0,
                    448.0, 464.0, 470.0, 480.0, -500.0, 1e-3, 1.0, -3.3],
                   np.float32)


def sr_inputs(seed, dtype):
    """A (48, 40) block: log-uniform magnitudes over the formats' range
    with every special value planted, rounded to `dtype`."""
    rng = np.random.default_rng(seed)
    x = (rng.choice([-1.0, 1.0], (48, 40))
         * np.exp2(rng.uniform(-22, 18, (48, 40)))).astype(np.float32)
    x.reshape(-1)[:len(SPECIAL)] = SPECIAL
    x.reshape(-1)[-len(SPECIAL):] = SPECIAL * np.float32(0.37)
    if dtype == "bf16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    return x, rng.integers(0, 256, x.shape).astype(np.uint8)


def to_dtype(x, dtype):
    if dtype == "bf16":
        return (jnp.asarray(x, jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("saturate", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
@pytest.mark.parametrize("scale", [1.0, 0.37, 1536.0])
def test_sr_quantize_bitwise(fmt, dtype, saturate, scale):
    x, r = sr_inputs(3, dtype)
    jx, tx = to_dtype(x, dtype)
    js = jnp.asarray([scale], jnp.float32)
    want = sr_quantize_kernel(jx, jnp.asarray(r), js, fmt=fmt,
                              saturate=saturate, interpret=True)
    oracle = j_sr_ref(jx, jnp.asarray(r), js, fmt=fmt, saturate=saturate)
    got = tsr.sr_quantize(tx, torch.from_numpy(r), scale, fmt=fmt,
                          saturate=saturate)
    assert got.dtype == T_DT[fmt]
    np.testing.assert_array_equal(u8(got), u8(want))
    np.testing.assert_array_equal(u8(got), u8(oracle))
    # The scale may also be a one-element tensor, as the reference's is.
    got_t = tsr.sr_quantize(tx, torch.from_numpy(r),
                            torch.tensor([scale]), fmt=fmt, saturate=saturate)
    assert torch.equal(got_t.view(torch.uint8), got.view(torch.uint8))


def test_stochastic_round_fp8_op_shapes_and_bits():
    """The public op keeps any rank and draws its bits from the generator
    (one uint8 per element, in the 2-D view's order)."""
    x = torch.randn((3, 5, 7))
    out = tsr.stochastic_round_fp8(x, torch.Generator().manual_seed(4), 0.5)
    assert out.shape == x.shape and out.dtype == torch.float8_e5m2
    r = torch.randint(0, 256, (15, 7), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(4))
    want = tsr_ref.stochastic_round_fp8_ref(x.reshape(15, 7), r, 0.5)
    assert torch.equal(out.reshape(15, 7).view(torch.uint8),
                       want.view(torch.uint8))
    scalar = tsr.stochastic_round_fp8(torch.tensor(1.3), 9, fmt="e4m3",
                                      use_onchip_prng=True)
    assert scalar.shape == () and float(scalar) in (1.25, 1.375)
    with pytest.raises(TypeError):
        tsr.stochastic_round_fp8(x, 3)                   # a seed, no PRNG flag
    with pytest.raises(TypeError):
        tsr.stochastic_round_fp8(x.half(), torch.Generator())
    with pytest.raises(ValueError):
        tsr.stochastic_round_fp8(x, torch.Generator(), fmt="e3m4")


# ---------------------------------------------------------------------------
# kernel 7: sr_quantize_onchip (bits from the in-kernel hash)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_onchip_is_reference_function_given_its_bits(fmt):
    x, _ = sr_inputs(5, "f32")
    bits = tsr_ref.sr_hash_rand8(1234, x.size, "cpu").reshape(x.shape)
    want = j_sr_ref(jnp.asarray(x), jnp.asarray(bits.numpy()),
                    jnp.asarray([0.37], jnp.float32), fmt=fmt,
                    saturate=False)
    got = tsr.sr_quantize_onchip(torch.from_numpy(x), 1234, 0.37, fmt=fmt,
                                 saturate=False)
    np.testing.assert_array_equal(u8(got), u8(want))


def test_onchip_bits_uniform():
    """The hash's bytes over 2^18 indices and 4 seeds: a chi-square over
    the 256 values below the 0.999 quantile of its 255 degrees of freedom
    (330.5), and the seeds' streams differ."""
    streams = [tsr_ref.sr_hash_rand8(s, 1 << 18, "cpu").long()
               for s in (0, 1, 2, 0xFFFFFFFF)]
    for bits in streams:
        counts = torch.bincount(bits, minlength=256).double()
        expect = bits.numel() / 256
        chi2 = float(((counts - expect) ** 2 / expect).sum())
        assert chi2 < 330.5, chi2
    assert (streams[0] != streams[1]).float().mean() > 0.99


@pytest.mark.parametrize("fmt,lo,hi,levels", [("e5m2", 1.0, 1.25, 256),
                                              ("e4m3", 1.0, 1.125, 128)])
def test_onchip_unbiased_over_seeds(fmt, lo, hi, levels):
    """Values on the (prescaled) fp16 grid between two fp8 neighbours —
    `levels` = 2^(dropped bits) steps apart — round to one of them with
    the probability that makes the expectation exact; over 64 seeds x 1024
    copies the mean of each value must lie within 5 sigma of it
    (sigma = (hi - lo) sqrt(p (1 - p) / n))."""
    vals = np.float32(lo) + np.float32(hi - lo) * np.array(
        [1, 37, levels // 2, levels - 56, levels - 1], np.float32) / levels
    x = torch.from_numpy(np.repeat(vals[None], 1024, 0))
    total = torch.zeros(len(vals), dtype=torch.float64)
    n_seeds = 64
    for seed in range(n_seeds):
        q = tsr.stochastic_round_fp8(x, seed, fmt=fmt, use_onchip_prng=True)
        qf = q.double()
        assert bool(((qf == lo) | (qf == hi)).all())
        total += qf.sum(0)
    n = n_seeds * x.shape[0]
    mean = (total / n).numpy()
    p = (vals - lo) / (hi - lo)
    sigma = (hi - lo) * np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(mean - vals) <= 5 * sigma), (mean, vals, sigma)
