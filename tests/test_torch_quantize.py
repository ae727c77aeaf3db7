"""Tier A parity of the PyTorch port's quantization primitives: bit for bit
against `repro` on the CPU (formats, RNE with its overflow rules, the fp16
SR bit-twiddle given the same random bits, the attention SR hash, the
bit-pattern amax, scaled quantize, and the delayed-scaling update)."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import fp8_formats as jf
from repro.core import quantize as jq
from repro.core.precision_policy import QuantConfig as JQuantConfig
from repro.kernels.fp8_attention import ref as jattn_ref
from repro.scaling.state import DelayedScaling as JDelayedScaling
from repro.scaling.state import ScalingConfig as JScalingConfig
from repro.scaling.state import SiteRegistry as JSiteRegistry
from repro_torch.core import fp8_formats as tf
from repro_torch.core import precision_policy as tpp
from repro_torch.core import quantize as tq
from repro_torch.kernels.fp8_attention import ref as tattn_ref
from repro_torch.scaling.state import DelayedScaling, ScalingConfig, SiteRegistry

jax.config.update("jax_platform_name", "cpu")

FMTS = ("e4m3", "e5m2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(x) -> np.ndarray:
    """uint8 patterns of an fp8 payload (jax array or torch tensor), with
    every NaN canonicalized (NaN payload bits carry no meaning)."""
    if isinstance(x, torch.Tensor):
        u = x.view(torch.uint8).numpy().copy()
        nan = torch.isnan(x.float()).numpy()
    else:
        a = np.asarray(x)
        u = a.view(np.uint8).copy()
        nan = np.isnan(a.astype(np.float32))
    u[nan] = 0xFF
    return u


def all_patterns(fmt: str) -> np.ndarray:
    dt = ml_dtypes.float8_e4m3fn if fmt == "e4m3" else ml_dtypes.float8_e5m2
    return np.arange(256, dtype=np.uint8).view(dt).astype(np.float32)


def log_uniform(n, seed, lo=-20.0, hi=18.0):
    rng = np.random.default_rng(seed)
    mag = np.exp2(rng.uniform(lo, hi, n))
    return (mag * rng.choice([-1.0, 1.0], n)).astype(np.float32)


class TestFormats:
    @pytest.mark.parametrize("name", ["e5m2", "e4m3", "fp16", "bf16", "fp32"])
    def test_table_values_match(self, name):
        a, b = jf.get_format(name), tf.get_format(name)
        for attr in ("exp_bits", "man_bits", "bias", "has_inf", "max_exp",
                     "min_exp", "max_normal", "min_normal", "min_subnormal",
                     "eps", "bits"):
            assert getattr(a, attr) == getattr(b, attr), attr

    def test_table1_and_unknown(self):
        assert jf.table1() == tf.table1()
        with pytest.raises(ValueError):
            tf.get_format("e3m4")

    def test_recipe_tables_match(self):
        for recipe in ("paper_e5m2", "hybrid"):
            for ev in (False, True):
                j = JQuantConfig(recipe=recipe, scaling="delayed")
                t = tpp.QuantConfig(recipe=recipe, scaling="delayed")
                if ev:
                    j, t = j.eval_mode(), t.eval_mode()
                assert j.recipe_table() == t.recipe_table()


class TestRNE:
    @pytest.mark.parametrize("fmt", FMTS)
    @pytest.mark.parametrize("saturate", [True, False])
    def test_exhaustive_256_round_trip(self, fmt, saturate):
        """Every fp8 pattern decoded to f32 quantizes back identically."""
        x = all_patterns(fmt)
        j = jq.quantize_rne(jnp.asarray(x), jf.get_format(fmt),
                            saturate=saturate)
        t = tq.quantize_rne(torch.from_numpy(x), tf.get_format(fmt),
                            saturate=saturate)
        np.testing.assert_array_equal(bits(j), bits(t))

    @pytest.mark.parametrize("fmt", FMTS)
    @pytest.mark.parametrize("saturate", [True, False])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    def test_random_bitwise(self, fmt, saturate, dtype):
        x = log_uniform(20000, 1 + FMTS.index(fmt))
        j_in = jnp.asarray(x).astype(getattr(jnp, dtype))
        t_in = torch.from_numpy(np.asarray(j_in.astype(jnp.float32))).to(
            getattr(torch, dtype))
        j = jq.quantize_rne(j_in, jf.get_format(fmt), saturate=saturate)
        t = tq.quantize_rne(t_in, tf.get_format(fmt), saturate=saturate)
        np.testing.assert_array_equal(bits(j), bits(t))

    @pytest.mark.parametrize("fmt", FMTS)
    @pytest.mark.parametrize("saturate", [True, False])
    def test_overflow_per_class(self, fmt, saturate):
        """Around the overflow threshold, at max_normal, and non-finite
        inputs: torch's saturating e4m3 cast must not leak through."""
        f = jf.get_format(fmt)
        th = jq.rne_overflow_threshold(f)
        x = np.array([f.max_normal, np.nextafter(th, 0, dtype=np.float32),
                      th, th * 1.5, 1e30, np.inf, -np.inf, np.nan,
                      -f.max_normal, -th, -1e30, 0.0, -0.0,
                      f.min_subnormal * 0.75, f.min_subnormal * 0.25],
                     np.float32)
        j = jq.quantize_rne(jnp.asarray(x), f, saturate=saturate)
        t = tq.quantize_rne(torch.from_numpy(x), tf.get_format(fmt),
                            saturate=saturate)
        np.testing.assert_array_equal(bits(j), bits(t))

    @pytest.mark.parametrize("fmt", FMTS)
    def test_exact_ties_follow_ml_dtypes(self, fmt):
        """Exact ties go to even, as ml_dtypes rounds. (The reference builds
        its ulp with jnp.exp2, which XLA on the CPU computes inexactly for
        some integer exponents — 2^-16, 2^-15, 2^-13, 2^13, ... — so on the
        CPU its e5m2 ties in those binades round away from even: a quirk of
        the reference's platform, not of the rounding rule.)"""
        f = tf.get_format(fmt)
        ulps = [2.0 ** (e - f.man_bits)
                for e in range(f.min_exp, f.max_exp + 1)]
        x = np.array([u * k for u in ulps for k in (0.5, 1.5, 2.5, 4.5, 5.5)
                      if u * k < f.max_normal], np.float32)
        x = np.concatenate([x, -x])
        dt = ml_dtypes.float8_e4m3fn if fmt == "e4m3" else ml_dtypes.float8_e5m2
        want = x.astype(dt).view(np.uint8)
        got = tq.quantize_rne(torch.from_numpy(x), f).view(torch.uint8)
        np.testing.assert_array_equal(got.numpy(), want)


class TestSR:
    @pytest.mark.parametrize("fmt", FMTS)
    @pytest.mark.parametrize("saturate", [True, False])
    def test_exhaustive_256_fixed_points(self, fmt, saturate):
        """Grid values are SR fixed points for any random bits."""
        x = np.tile(all_patterns(fmt), 16)
        rand = np.random.default_rng(3).integers(0, 1 << 16, x.shape,
                                                 dtype=np.uint16)
        j = jq.sr_fp8_via_f16(jnp.asarray(x), jnp.asarray(rand),
                              jf.get_format(fmt), saturate=saturate)
        t = tq.sr_fp8_via_f16(torch.from_numpy(x),
                              torch.from_numpy(rand.astype(np.int32)),
                              tf.get_format(fmt), saturate=saturate)
        np.testing.assert_array_equal(bits(j), bits(t))
        finite = np.isfinite(x)
        np.testing.assert_array_equal(
            t.float().numpy()[finite], x[finite])

    @pytest.mark.parametrize("fmt", FMTS)
    @pytest.mark.parametrize("saturate", [True, False])
    def test_random_bitwise_same_bits(self, fmt, saturate):
        x = log_uniform(20000, 7, lo=-26.0, hi=17.0)
        x[:4] = [np.inf, -np.inf, np.nan, 7e4]
        rand = np.random.default_rng(4).integers(0, 1 << 16, x.shape,
                                                 dtype=np.uint16)
        j = jq.sr_fp8_via_f16(jnp.asarray(x), jnp.asarray(rand),
                              jf.get_format(fmt), saturate=saturate)
        t = tq.sr_fp8_via_f16(torch.from_numpy(x),
                              torch.from_numpy(rand.astype(np.int32)),
                              tf.get_format(fmt), saturate=saturate)
        np.testing.assert_array_equal(bits(j), bits(t))

    @pytest.mark.parametrize("fmt", FMTS)
    def test_spec_matches(self, fmt):
        assert dataclasses.astuple(jq.sr_spec(jf.get_format(fmt))) == \
            dataclasses.astuple(tq.sr_spec(tf.get_format(fmt)))


class TestHashAndAmax:
    @pytest.mark.parametrize("salt", [0x51, 0x52, 0x53, 0x54])
    def test_sr_hash_bits(self, salt):
        rows = np.arange(0, 300, 7, dtype=np.int32)[:, None]
        cols = np.arange(0, 1100, 13, dtype=np.int32)[None, :]
        for seed, bh in ((0, 0), (123456789, 5), (0xFFFFFFFF, 1023)):
            j = jattn_ref.sr_hash_bits(jnp.uint32(seed), salt, jnp.int32(bh),
                                       jnp.asarray(rows), jnp.asarray(cols))
            t = tattn_ref.sr_hash_bits(seed, salt, bh, torch.from_numpy(rows),
                                       torch.from_numpy(cols))
            np.testing.assert_array_equal(np.asarray(j), t.numpy())

    @pytest.mark.parametrize("fmt", FMTS)
    def test_fp8_amax_bits(self, fmt):
        rng = np.random.default_rng(5)
        for case in range(4):
            raw = rng.integers(0, 256, 333, dtype=np.uint8)
            if case == 0:   # no NaN patterns
                raw = raw[(raw & 0x7F) < (0x7C if fmt == "e5m2" else 0x7F)]
            dt = ml_dtypes.float8_e4m3fn if fmt == "e4m3" \
                else ml_dtypes.float8_e5m2
            j = jq.fp8_amax_bits(jnp.asarray(raw.view(dt)))
            t = tq.fp8_amax_bits(torch.from_numpy(raw).view(
                tf.get_format(fmt).dtype))
            jv, tv = np.float32(j), np.float32(t.item())
            assert (jv == tv) or (np.isnan(jv) and np.isnan(tv))


class TestScaledQuantize:
    @pytest.mark.parametrize("fmt", FMTS)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_reciprocal_multiply_path(self, fmt, dtype):
        """Explicit scale: x * (1/scale) in x's dtype, then RNE."""
        x = log_uniform(5000, 9, lo=-12.0, hi=12.0)
        j_in = jnp.asarray(x).astype(getattr(jnp, dtype))
        t_in = torch.from_numpy(np.asarray(j_in.astype(jnp.float32))).to(
            getattr(torch, dtype))
        for scale in (0.37109375, 3.1e-3, 17.0, 1.0):
            jqt = jq.quantize(j_in, fmt, rounding="rne",
                              scale=jnp.float32(scale))
            tqt = tq.quantize(t_in, fmt, rounding="rne", scale=scale)
            np.testing.assert_array_equal(bits(jqt.data), bits(tqt.data))
            jd = np.asarray(jq.dequantize(jqt, jnp.float32))
            td = tq.dequantize(tqt, torch.float32).numpy()
            np.testing.assert_array_equal(jd, td)

    def test_unit_scale_divide_path(self):
        x = log_uniform(3000, 10, lo=-10.0, hi=10.0)
        j = jq.quantize(jnp.asarray(x), "e5m2", rounding="rne")
        t = tq.quantize(torch.from_numpy(x), "e5m2", rounding="rne")
        np.testing.assert_array_equal(bits(j.data), bits(t.data))


class TestDelayedScalingUpdate:
    @pytest.mark.parametrize("recipe", ["paper_e5m2", "hybrid"])
    def test_history_and_scales_bitwise(self, recipe):
        """The forward-site update (max policy, saturation probe, inf
        observations) and freeze agree bit for bit over several steps."""
        keys = ["l/a#a.A", "l/a#b.W", "l/a#y.A", "l/a#E", "l/s#qk.A"]
        jcfg = JQuantConfig(recipe=recipe, scaling="delayed").eval_mode()
        tcfg = tpp.QuantConfig(recipe=recipe, scaling="delayed").eval_mode()
        jds = JDelayedScaling(JSiteRegistry(keys), JScalingConfig(history_len=4),
                              jcfg)
        tds = DelayedScaling(SiteRegistry(keys), ScalingConfig(history_len=4),
                             tcfg)
        js, ts = jds.init(), tds.init()
        rng = np.random.default_rng(11)
        for step in range(7):
            obs = {k: np.float32(rng.uniform(0.01, 900.0))
                   for k in keys if rng.random() < 0.8}
            if step == 3:   # pinned at the ceiling -> growth probe
                cap = np.asarray(js.scale) * jds.registry.fmt_max_vector(jcfg)
                obs[keys[0]] = np.float32(cap[0])
                obs[keys[2]] = np.float32(np.inf)
            js = jds.update(js, {k: jnp.float32(v) for k, v in obs.items()})
            ts = tds.update(ts, obs)
            np.testing.assert_array_equal(np.asarray(js.amax_history),
                                          ts.amax_history)
            np.testing.assert_array_equal(np.asarray(js.scale), ts.scale)
        assert jds.freeze(js) == tds.freeze(ts)
        assert jds.frozen_formats() == tds.frozen_formats()
