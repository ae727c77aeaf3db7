"""Parity of the port's two kernel modules against `repro`'s Pallas kernels
(run in interpret mode on the CPU), through the port's plain versions.

Tiers (ROADMAP.md): B — exact-accumulation fixtures, where every f32 sum is
exact in any order, must match bit for bit (payloads, amaxes, counts, and
the attention output); C — general inputs, where summation order and `exp`
differ between the frameworks, are held to stated tolerances.

The CUDA kernels themselves are held against these plain versions on the
card by `tests/test_torch_gpu.py`.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.fp8_attention import ops as jattn
from repro.kernels.fp8_attention import ref as jattn_ref
from repro.kernels.fused_quant_matmul import ops as jfq
from repro_torch.kernels.fp8_attention import ops as tattn
from repro_torch.kernels.fp8_attention import ref as tattn_ref
from repro_torch.kernels.fused_quant_matmul import ops as tfq

jax.config.update("jax_platform_name", "cpu")

NP_DT = {"e4m3": ml_dtypes.float8_e4m3fn, "e5m2": ml_dtypes.float8_e5m2}
T_DT = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
MAN = {"e4m3": 3, "e5m2": 2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fp8_np(shape, fmt, rng, exact: bool) -> np.ndarray:
    """fp8 values as float32. exact=True: exponents {0, 1} only (all sums
    below exact in f32); otherwise log-normal magnitudes."""
    sign = rng.choice([-1.0, 1.0], shape)
    if exact:
        m = rng.integers(0, 1 << MAN[fmt], shape) / (1 << MAN[fmt])
        x = sign * (1 + m) * np.exp2(rng.integers(0, 2, shape))
    else:
        x = sign * np.exp(rng.normal(size=shape))
    return x.astype(np.float32).astype(NP_DT[fmt]).astype(np.float32)


def to_j(x, fmt):
    return jnp.asarray(x.astype(NP_DT[fmt]))


def to_t(x, fmt):
    return torch.from_numpy(x.copy()).to(T_DT[fmt])


def u8(x) -> np.ndarray:
    """Payload bytes with NaNs canonicalized."""
    if isinstance(x, torch.Tensor):
        u, f = x.view(torch.uint8).numpy().copy(), x.float().numpy()
    else:
        a = np.asarray(x)
        u, f = a.view(np.uint8).copy(), a.astype(np.float32)
    u[np.isnan(f)] = 0xFF
    return u


def bf16_ulps(a, b) -> np.ndarray:
    """Per-element distance of two arrays of bf16 values (given as f32) in
    bf16 units in the last place."""
    def ordered(x):
        i = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(i & 0x8000, -(i & 0x7FFF), i)
    return np.abs(ordered(a) - ordered(b))


def same_or_nan(a, b) -> bool:
    a, b = np.float32(a), np.float32(b)
    return bool(a == b or (np.isnan(a) and np.isnan(b)))


def one_notch(a, b, fmt) -> bool:
    """Equal, or grid neighbours of the fp8 format."""
    if same_or_nan(a, b):
        return True
    codes = np.array([a, b], np.float32).astype(NP_DT[fmt]).view(np.uint8)
    return abs(int(codes[0]) - int(codes[1])) <= 1


# ---------------------------------------------------------------------------
# fused quantize-in-epilogue GEMM
# ---------------------------------------------------------------------------

GEMM_DIMS = ("nn", "nt", "tn")
M, K, N = 48, 160, 96          # none a multiple of the reference's blocks


def gemm_operands(dims, fmt, exact, seed):
    rng = np.random.default_rng(seed)
    a = fp8_np((M, K), fmt, rng, exact)
    w = fp8_np((K, N), fmt, rng, exact)
    if dims == "nt":
        w = np.ascontiguousarray(w.T)
    elif dims == "tn":
        a = np.ascontiguousarray(a.T)
    return a, w


def run_gemm(dims, fmt, rounding, saturate, exact, seed, scale):
    a, w = gemm_operands(dims, fmt, exact, seed)
    key = jax.random.PRNGKey(seed)
    jo, ja, jh = jfq.fused_quant_matmul(
        to_j(a, fmt), to_j(w, fmt), key, jnp.float32(scale), dims=dims,
        out_format=fmt, rounding=rounding, saturate=saturate, with_amax=True,
        with_counts=True, amax_units="grid", interpret=True)
    # The reference draws its SR bits from `key`; hand the port the same.
    rand8 = torch.from_numpy(np.asarray(
        jax.random.bits(key, (M, N), jnp.uint8))) if rounding == "sr" else None
    to, ta, th = tfq.fused_quant_matmul(
        to_t(a, fmt), to_t(w, fmt), scale, dims=dims, out_format=fmt,
        rounding=rounding, saturate=saturate, rand8=rand8, with_amax=True,
        with_counts=True)
    return (jo, ja, jh), (to, ta, th)


GEMM_VARIANTS = [(d, f, r, s) for d in GEMM_DIMS for f in ("e4m3", "e5m2")
                 for r, s in (("rne", True), ("sr", False))]


class TestFusedQuantMatmulParity:
    @pytest.mark.parametrize("dims,fmt,rounding,saturate", GEMM_VARIANTS)
    def test_tier_b_bitwise(self, dims, fmt, rounding, saturate):
        """Exact-accumulation operands: payload, grid amax and health
        fractions bit for bit, across layouts, formats, RNE/SR and
        saturating / overflowing epilogues (for e4m3 the scale puts the
        largest outputs past the ceiling). The e5m2 scale keeps outputs in
        the binades where the reference's ulp (jnp.exp2) is exact on the
        CPU: its e5m2 ties near 2^15 and below 2^-12 round off-even there
        (see test_torch_quantize.py)."""
        scale = {"e4m3": 0.125, "e5m2": 1.0 / 16}[fmt]
        (jo, ja, jh), (to, ta, th) = run_gemm(dims, fmt, rounding, saturate,
                                              True, 3, scale)
        np.testing.assert_array_equal(u8(jo), u8(to))
        assert same_or_nan(ja, ta.item())
        np.testing.assert_array_equal(np.asarray(jh), th.numpy())

    @pytest.mark.parametrize("dims,fmt,rounding,saturate", GEMM_VARIANTS)
    def test_tier_c_general(self, dims, fmt, rounding, saturate):
        """General operands: summation order may flip a payload to its grid
        neighbour — at most 1% of elements, never further; the amax within
        one notch."""
        (jo, ja, jh), (to, ta, th) = run_gemm(dims, fmt, rounding, saturate,
                                              False, 5, 1.5)
        a, b = u8(jo).astype(int), u8(to).astype(int)
        diff = a != b
        assert diff.mean() <= 0.01
        assert np.all((np.abs(a - b)[diff] <= 1)
                      & ((a & 0x80) == (b & 0x80))[diff])
        assert one_notch(ja, ta.item(), fmt)

    def test_padding_and_units(self):
        """The amax is in grid units (the largest |payload|); outputs do not
        depend on the logical shape's alignment."""
        rng = np.random.default_rng(9)
        a = fp8_np((5, 7), "e5m2", rng, True)
        w = fp8_np((7, 3), "e5m2", rng, True)
        out, amax = tfq.fused_quant_matmul(to_t(a, "e5m2"), to_t(w, "e5m2"),
                                           0.5, out_format="e5m2",
                                           rounding="rne", with_amax=True)
        want = (a.astype(np.float64) @ w) / 0.5
        np.testing.assert_array_equal(out.float().numpy(),
                                      want.astype(np.float32).astype(
                                          ml_dtypes.float8_e5m2)
                                      .astype(np.float32))
        assert amax.item() == np.abs(out.float().numpy()).max()

    @pytest.mark.parametrize("m,n,k,tile", [
        # training (B=4 x S=512): forward, dgrad and wgrad of each kind
        (2048, 1536, 1536, 128), (2048, 256, 1536, 128),
        (2048, 8960, 1536, 128), (2048, 1536, 8960, 256),
        (2048, 1536, 256, 128), (1536, 1536, 2048, 128),
        (1536, 256, 2048, 128), (1536, 8960, 2048, 128),
        (8960, 1536, 2048, 128),
        # serving (M = 4 rows x 32 chunk tokens)
        (128, 1536, 1536, 128), (128, 8960, 1536, 128),
        (128, 1536, 8960, 128),
        # ragged: the choice holds for the padded shape
        (100, 72, 200, 128), (1000, 1400, 1000, 128),
        (2000, 1500, 4100, 256), (2000, 1500, 4033, 256),
        (2000, 1500, 4032, 128)])
    def test_tile_choice(self, m, n, k, tile):
        """The GEMM's tile width comes from the shape alone: 128x256 only
        where its grid fills one wave while 128x128's overloads the SMs and
        K >= 4096; the padded shape picks the same width, and the pads
        match the layout."""
        assert tfq.gemm_tile(m, n, k) == tile
        bm, bk = tfq.BM, tfq.BK
        padded = (-(-m // bm) * bm, -(-n // tile) * tile, -(-k // bk) * bk)
        assert tfq.gemm_tile(*padded) == tile
        for dims in ("nn", "nt", "tn"):
            pa, pb, pr = tfq.operand_pads(dims, tile)
            a_pad = dict(zip("km" if dims == "tn" else "mk", pa))
            b_pad = dict(zip("nk" if dims == "nt" else "kn", pb))
            assert a_pad == {"m": bm, "k": bk}
            assert b_pad == {"k": bk, "n": tile}
            assert pr == (bm, tile)

    def test_rejects_bad_inputs(self):
        a = torch.zeros((4, 4), dtype=torch.float8_e4m3fn)
        with pytest.raises(TypeError):
            tfq.fused_quant_matmul(a.float(), a)
        with pytest.raises(ValueError):
            tfq.fused_quant_matmul(a, a, with_counts=True)


# ---------------------------------------------------------------------------
# fused flash-attention forward
# ---------------------------------------------------------------------------

B, H, HKV, D = 2, 4, 2, 32


def chunk_layout(b, t, c, late=False):
    """Ragged chunk rows: a prefill chunk, a decode row, a fully masked
    chunk tail, with holes (-1) in the gathered columns. late=True puts the
    first two requests' chunks past the first 128-column kv block."""
    lengths = np.array([150, 140, 9] if late else [70, 33, 9])[:b]
    start = np.array([142, 139, 0] if late else [62, 32, 0])[:b]
    n_valid = np.array([8, 1, 5][:b])
    cols = np.arange(c)[None]
    slot_pos = np.where(cols < lengths[:, None], cols, -1).astype(np.int32)
    slot_pos[0, 3] = -1                         # a hole inside a request
    return slot_pos, np.stack([start, n_valid], 1).astype(np.int32)


def attn_case(mode, fmt, tier, seed):
    rng = np.random.default_rng(seed)
    if mode == "chunk":
        b, t, s = 3, 8, 160
    else:
        b, t, s = B, 40, 200
    if tier == "v" and mode.startswith("causal"):
        t = s                                   # rows reach every kv block
    kw = dict(mask_mode="kv" if mode == "kv" else mode.split("+")[0])
    if mode == "causal+window":
        kw["window"] = 50
    if mode == "kv":
        kw["kv_mask"] = (rng.random((b, s)) < 0.7).astype(np.int8)
        kw["kv_mask"][1] = 0                    # a fully masked batch row
    if mode == "chunk":
        kw["kv_mask"], kw["chunk_pos"] = chunk_layout(b, t, s, tier == "v")
    if tier == "b":
        # Constant keys: every score of a row is equal, so exp(x - m) is
        # exactly 1 and all sums are exact.
        q = fp8_np((b, H, t, D), fmt, rng, True) / 4
        k = np.broadcast_to(fp8_np((b, HKV, 1, D), fmt, rng, True) / 4,
                            (b, HKV, s, D)).copy()
        v = fp8_np((b, HKV, s, D), fmt, rng, True)
    elif tier == "v":
        q, k, v = stepped_scores(rng, fmt, b, t, s)
    else:
        q, k, v = (fp8_np(sh, fmt, rng, False) for sh in
                   ((b, H, t, D), (b, HKV, s, D), (b, HKV, s, D)))
    return q, k, v, kw


def stepped_scores(rng, fmt, b, t, s):
    """Exact fixture with scores that vary across kv blocks: q picks key
    dim 0, where each column holds its block index j (so the running max
    steps up by one per block and the rescale exp(m - m') is exp(-1)) or
    -224 (exp underflows to exactly 0). Every exp is then 0 or 1, every sum
    exact, and the carries' rescaling is single f32 roundings."""
    q = np.zeros((b, H, t, D), np.float32)
    q[..., 0] = 1.0
    k = fp8_np((b, HKV, s, D), fmt, rng, True)
    k[..., 0] = np.where(rng.random((b, HKV, s)) < 0.5,
                         np.arange(s) // 128, -224.0)
    return q, k, fp8_np((b, HKV, s, D), fmt, rng, True)


# [f_s, s_s, f_p, f_o]; the stepped fixture keeps scores on the grid and
# quantizes the probs off it (0.3 is not an fp8 value).
SCAL = {"b": [0.0625, 1.0, 1.0, 1.0], "c": [0.0625, 1.0, 1.0, 1.0],
        "v": [1.0, 1.0, 0.3, 1.5]}


def run_attn(mode, fmt, tier, rounding, seed):
    q, k, v, kw = attn_case(mode, fmt, tier, seed)
    scal = np.array(SCAL[tier], np.float32)
    fk = dict(fmt_s=fmt, fmt_p=fmt, rounding_s=rounding, rounding_p=rounding)
    jkw = dict(kw)
    for name in ("kv_mask", "chunk_pos"):
        if name in jkw:
            jkw[name] = jnp.asarray(jkw[name])
    jo, jas, jap = jattn.fp8_attention_fwd(
        to_j(q, fmt), to_j(k, fmt), to_j(v, fmt), jnp.uint32(seed),
        jnp.asarray(scal), interpret=True, **jkw, **fk)
    tkw = {n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()}
    to, tas, tap = tattn.fp8_attention_fwd(
        to_t(q, fmt), to_t(k, fmt), to_t(v, fmt), seed, scal, **tkw, **fk)
    return (np.asarray(jo.astype(jnp.float32)), jas, jap), \
        (to.float().numpy(), tas.item(), tap.item())


ATTN_MODES = ("causal", "causal+window", "full", "kv", "chunk")


class TestFp8AttentionParity:
    @pytest.mark.parametrize("mode", ATTN_MODES)
    @pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
    def test_tier_b_bitwise(self, mode, fmt):
        """Exact fixtures: bf16 output and both amaxes bit for bit, for
        every mask mode (GQA, ragged chunks, holes and fully masked rows
        included)."""
        (jo, jas, jap), (to, tas, tap) = run_attn(mode, fmt, "b", "rne", 1)
        np.testing.assert_array_equal(jo, to)
        assert same_or_nan(jas, tas) and same_or_nan(jap, tap)

    @pytest.mark.parametrize("mode", ATTN_MODES)
    @pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
    @pytest.mark.parametrize("rounding", ["rne", "sr"])
    def test_tier_c_stepped_scores(self, mode, fmt, rounding):
        """Fixture whose running max steps up across kv blocks, so l and acc
        are rescaled by exp(-1). Every sum is exact, but XLA on the CPU
        contracts acc*c + pv into an FMA and its exp differs from torch's in
        the last bit, so the output may move by one bf16 ulp in at most
        1e-4 of the elements (measured: 1 element of 51200); the amaxes are
        bit for bit. The kernels are held bit for bit against the plain
        version on this fixture on the card (test_torch_gpu.py)."""
        (jo, jas, jap), (to, tas, tap) = run_attn(mode, fmt, "v", rounding, 6)
        ulps = bf16_ulps(jo, to)
        assert ulps.max() <= 1 and (ulps > 0).mean() <= 1e-4
        assert same_or_nan(jas, tas) and same_or_nan(jap, tap)

    @pytest.mark.parametrize("mode", ATTN_MODES)
    @pytest.mark.parametrize("rounding", ["rne", "sr"])
    def test_tier_c_general(self, mode, rounding):
        """General inputs (SR bits from the shared counter hash): exp and
        summation order differ between the frameworks, so an output may
        move by bf16 ulps — at most 2, in at most 0.1% of the elements
        (measured: at most 1 ulp, in 1 of 10240); amaxes within one notch,
        fully masked rows exactly zero in both."""
        fmt = "e4m3"
        (jo, jas, jap), (to, tas, tap) = run_attn(mode, fmt, "c", rounding, 2)
        ulps = bf16_ulps(jo, to)
        assert ulps.max() <= 2 and (ulps > 0).mean() <= 1e-3
        assert one_notch(jas, tas, fmt) and one_notch(jap, tap, fmt)
        dead = np.all(jo == 0, axis=-1)
        np.testing.assert_array_equal(np.all(to == 0, axis=-1), dead)

    def test_stripe_span_and_mask_match(self):
        for row0, bq, bkv, nk, mode, win in [(0, 128, 128, 4, "causal", 0),
                                             (256, 64, 128, 4, "causal", 100),
                                             (384, 128, 256, 2, "causal", 0),
                                             (0, 128, 128, 3, "full", 0)]:
            assert jattn_ref.kv_stripe_span(
                row0, bq, block_kv=bkv, n_kv=nk, mask_mode=mode,
                window=win) == tattn_ref.kv_stripe_span(
                row0, bq, block_kv=bkv, n_kv=nk, mask_mode=mode, window=win)
        rows = np.arange(20)[:, None]
        cols = np.arange(30)[None]
        kvm = np.random.default_rng(0).integers(-1, 25, (1, 30))
        qpos = np.where(rows < 15, rows + 3, -1)
        for mode, win in (("causal", 0), ("causal", 5), ("full", 0),
                          ("kv", 0), ("chunk", 0), ("chunk", 4)):
            j = jattn_ref._mask_block(mode, jnp.asarray(rows),
                                      jnp.asarray(cols), 27, win,
                                      jnp.asarray(kvm), jnp.asarray(qpos))
            t = tattn_ref.mask_block(mode, torch.from_numpy(rows),
                                     torch.from_numpy(cols), 27, win,
                                     torch.from_numpy(kvm),
                                     torch.from_numpy(qpos))
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
