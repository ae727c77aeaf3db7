"""The port's fixed-slot serving and FP8 KV cache against `repro`: the cache
helpers, the KV-site calibration and the frozen-scales file, the fused
decode op, and the greedy streams of the fixed-slot `ServeEngine` (bf16
and e5m2 caches, fused and unfused attention), on the configuration of
`tests/test_paging.py::frozen_setup` (a 2-layer GQA decoder, frozen
calibrated scales) for both recipes, with the reference's weights carried
over by `from_jax_params`.

As in `tests/test_torch_serve.py`, the reference is compiled with XLA's
`xla_allow_excess_precision` off, under which the two agree bit for bit.
NaN payload bytes are compared as NaN: ml_dtypes and torch write
different NaN encodings of e5m2 (0x7E, 0x7F), both NaN.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision_policy import BASELINE_POLICY
from repro.core.qattention import fp8_sdpa_decode as j_decode
from repro.models import attention as jattn
from repro.models.registry import build_config as j_build_config
from repro.models.transformer import init_lm
from repro.scaling import context as jsc
from repro.scaling.calibrate import calibrate, freeze
from repro.scaling.calibrate import freeze_with_formats as j_freeze_fmt
from repro.scaling.calibrate import load_frozen as j_load_frozen
from repro.scaling.calibrate import \
    load_frozen_formats as j_load_frozen_formats
from repro.scaling.calibrate import save_frozen as j_save_frozen
from repro.scaling.state import ScalingConfig
from repro.serve import ServeConfig, ServeEngine
from repro.train.step import make_serve_decode, make_serve_prefill
from repro_torch.core import precision_policy as tpp
from repro_torch.core.qattention import fp8_sdpa_chunk, fp8_sdpa_decode
from repro_torch.models import attention as tattn
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_config as t_build_config
from repro_torch.scaling import context as tsc
from repro_torch.scaling import calibrate as tcal
from repro_torch.scaling.state import ScalingConfig as TScalingConfig
from repro_torch.serve.engine import PagedServeConfig as TPagedConfig
from repro_torch.serve.engine import PagedServeEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.engine import ServeEngine as TServeEngine
from test_torch_serve import PER_OP, PROMPTS, _cfgs, per_op_rounding

jax.config.update("jax_platform_name", "cpu")

J_FP8 = {"e5m2": jnp.float8_e5m2, "e4m3": jnp.float8_e4m3fn}
T_FP8 = {"e5m2": torch.float8_e5m2, "e4m3": torch.float8_e4m3fn}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_kv(cfg, fmt):
    return cfg.replace(policy=dataclasses.replace(cfg.policy,
                                                  kv_cache_format=fmt))


def _bits(x):
    """A tensor's or array's bytes as integers, with every NaN as -1."""
    if isinstance(x, torch.Tensor):
        nan = torch.isnan(x.float()).numpy()
        raw = x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            x.element_size()]).numpy().astype(np.int64)
    else:
        x = np.asarray(x)
        nan = np.isnan(x.astype(np.float32))
        raw = x.view({1: np.uint8, 2: np.int16, 4: np.int32}[
            x.dtype.itemsize]).astype(np.int64)
    return np.where(nan, -1, raw)


def _assert_same(t, j):
    np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.fixture(scope="module", params=["hybrid", "paper_e5m2"])
def setup(request):
    """Both packages calibrated with the e5m2 KV sites on the same weights
    and batches; the port also without them."""
    cfg, tcfg = _cfgs(request.param)
    cfg8, tcfg8 = _with_kv(cfg, "e5m2"), _with_kv(tcfg, "e5m2")
    params = init_lm(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, 64, (2, 12)).astype(np.int32) for _ in range(2)]
    with per_op_rounding():
        ds, state = calibrate(params, cfg8,
                              [{"tokens": jnp.asarray(t)} for t in toks],
                              scaling_cfg=ScalingConfig(margin=1.0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    tcal_kw = dict(scaling_cfg=TScalingConfig(margin=1.0))
    batches = [{"tokens": t} for t in toks]
    tds, tstate = tcal.calibrate(tparams, tcfg8, batches, **tcal_kw)
    tds0, tstate0 = tcal.calibrate(tparams, tcfg, batches, **tcal_kw)
    return dict(cfg=cfg, tcfg=tcfg, cfg8=cfg8, tcfg8=tcfg8, params=params,
                tparams=tparams, ds=ds, state=state,
                frozen=freeze(ds, state), tds=tds, tstate=tstate,
                tfrozen0=tcal.freeze(tds0, tstate0))


# ---------------------------------------------------------------------------
# tier A: cache helpers
# ---------------------------------------------------------------------------

def _kv_values(seed, shape=(3, 5, 2, 8)):
    """bf16-representable K/V values over a wide range, with entries past
    either format's clip, infinities, NaN and signed zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * np.exp2(rng.integers(-12, 18, shape))
         ).astype(np.float32)
    flat = x.reshape(-1)
    flat[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e6, -7e4, 500.0]
    return flat.reshape(shape)


@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
@pytest.mark.parametrize("scale", [1.0, 0.37, 3.1, 200.0])
def test_cache_dtype_conversions_match_reference(fmt, scale):
    x = _kv_values(2)
    jq = jattn._to_cache_dtype(jnp.asarray(x, jnp.bfloat16), J_FP8[fmt],
                               scale)
    tq = tattn._to_cache_dtype(torch.from_numpy(x).to(torch.bfloat16),
                               T_FP8[fmt], scale)
    assert tq.dtype == T_FP8[fmt]
    _assert_same(tq, jq)
    _assert_same(tattn._from_cache_dtype(tq, torch.bfloat16, scale),
                 jattn._from_cache_dtype(jq, jnp.bfloat16, scale))
    # A bf16 cache stores the values as they are.
    _assert_same(tattn._to_cache_dtype(torch.from_numpy(x).to(torch.bfloat16),
                                       torch.bfloat16, scale),
                 jattn._to_cache_dtype(jnp.asarray(x, jnp.bfloat16),
                                       jnp.bfloat16, scale))


def _caches(fmt, b, cap, hkv=2, dh=8):
    cfg, tcfg = _cfgs("hybrid")
    cfg = _with_kv(cfg.replace(n_kv_heads=hkv, d_model=4 * dh), fmt)
    tcfg = _with_kv(tcfg.replace(n_kv_heads=hkv, d_model=4 * dh), fmt)
    jc = jax.tree_util.tree_map(lambda x: x[0],
                                jattn.init_cache(cfg, b, cap, n_layers=1))
    return jc, tattn.init_cache(tcfg, b, cap, device="cpu")


def _assert_cache_same(tc, jc):
    assert set(tc) == set(jc)
    for key in jc:
        _assert_same(tc[key], jc[key])


@pytest.mark.parametrize("fmt", [None, "e5m2", "e4m3"])
@pytest.mark.parametrize("s", [5, 13], ids=["fits", "ring"])
def test_prefill_cache_matches_reference(fmt, s):
    """Both branches: the prompt in slots 0..S-1, and a prompt longer than
    the capacity (8) kept as its last 8 tokens at their ring slots. The
    port writes in place; with `slot` only that row, which then equals the
    reference's row while the others keep an earlier prompt's bits."""
    b, cap = 3, 8
    jc, tc = _caches(fmt, b, cap)
    k, v = _kv_values(3, (b, s, 2, 8)), _kv_values(4, (b, s, 2, 8))
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    kw = dict(k_scale=0.5, v_scale=2.0)
    tkv = [torch.from_numpy(x).to(torch.bfloat16) for x in (k, v)]
    jn = jattn._prefill_cache(jc, jnp.asarray(k, jnp.bfloat16),
                              jnp.asarray(v, jnp.bfloat16),
                              jnp.asarray(pos), **kw)
    tn = tattn._prefill_cache(tc, *tkv, torch.from_numpy(pos), **kw)
    assert tn is tc
    _assert_cache_same(tn, jn)
    before = {key: _bits(x) for key, x in tc.items()}
    pos2 = pos + 3
    jn2 = jattn._prefill_cache(jn, jnp.asarray(v, jnp.bfloat16),
                               jnp.asarray(k, jnp.bfloat16),
                               jnp.asarray(pos2), **kw)
    tattn._prefill_cache(tc, *tkv[::-1], torch.from_numpy(pos2), slot=1,
                         **kw)
    for key in jn2:
        got = _bits(tc[key])
        np.testing.assert_array_equal(got[1], _bits(jn2[key])[1])
        np.testing.assert_array_equal(np.delete(got, 1, 0),
                                      np.delete(before[key], 1, 0))


@pytest.mark.parametrize("fmt", [None, "e5m2", "e4m3"])
def test_append_cache_matches_reference(fmt):
    """Three appends, one wrapping past the capacity, after a prefill."""
    b, cap, s = 2, 6, 4
    jc, tc = _caches(fmt, b, cap)
    k, v = _kv_values(5, (b, s, 2, 8)), _kv_values(6, (b, s, 2, 8))
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jc = jattn._prefill_cache(jc, jnp.asarray(k, jnp.bfloat16),
                              jnp.asarray(v, jnp.bfloat16), jnp.asarray(pos))
    tc = tattn._prefill_cache(tc, torch.from_numpy(k).to(torch.bfloat16),
                              torch.from_numpy(v).to(torch.bfloat16),
                              torch.from_numpy(pos))
    for step in range(3):
        k1, v1 = _kv_values(7 + step, (b, 1, 2, 8)), \
            _kv_values(9 + step, (b, 1, 2, 8))
        p1 = np.array([[s + step], [s + 2 * step]], np.int32)
        jc = jattn._append_cache(jc, jnp.asarray(k1, jnp.bfloat16),
                                 jnp.asarray(v1, jnp.bfloat16),
                                 jnp.asarray(p1), k_scale=0.25, v_scale=3.0)
        tc = tattn._append_cache(tc, torch.from_numpy(k1).to(torch.bfloat16),
                                 torch.from_numpy(v1).to(torch.bfloat16),
                                 torch.from_numpy(p1), k_scale=0.25,
                                 v_scale=3.0)
        _assert_cache_same(tc, jc)


# ---------------------------------------------------------------------------
# tier A: KV-site calibration, freeze, the frozen-scales file
# ---------------------------------------------------------------------------

class TestKVCalibration:
    def test_same_sites_in_the_same_order(self, setup):
        keys = setup["tds"].registry.keys
        assert keys == setup["ds"].registry.keys
        assert sum("/kv/" in k for k in keys) == 2 * setup["cfg"].n_layers

    def test_same_scales(self, setup):
        tfrozen = tcal.freeze(setup["tds"], setup["tstate"])
        assert tfrozen == setup["frozen"]
        np.testing.assert_array_equal(setup["tstate"].amax_history,
                                      np.asarray(setup["state"].amax_history))

    def test_kv_sites_leave_the_other_scales(self, setup):
        """The W/A scales are those of a calibration without the KV sites."""
        tfrozen = tcal.freeze(setup["tds"], setup["tstate"])
        assert {k: s for k, s in tfrozen.items() if "/kv/" not in k} \
            == setup["tfrozen0"]

    def test_freeze_with_formats_matches_reference(self, setup):
        got = tcal.freeze_with_formats(setup["tds"], setup["tstate"],
                                       setup["tcfg8"])
        want = j_freeze_fmt(setup["ds"], setup["state"], setup["cfg8"])
        assert got == want
        assert {f for k, f in got[1].items() if "/kv/" in k} == {"e5m2"}
        # Without a config the KV sites record their class's format.
        fwd = setup["tcfg"].policy.quant.fwd_format
        assert set(tcal.freeze_with_formats(
            setup["tds"], setup["tstate"])[1].values()) == {fwd}


@pytest.mark.parametrize("with_formats", [False, True],
                         ids=["plain", "formats"])
def test_frozen_file_reads_the_same_in_both_packages(tmp_path, with_formats):
    scales = {"decoder/layer_0/attn/wq#a.A": 0.0123456789,
              "decoder/layer_0/attn/kv/k#A": 3.5e-3,
              "decoder/layer_1/mlp/up#b.W": 1.0 / 3.0}
    formats = {k: ("e5m2" if "/kv/" in k else "e4m3") for k in scales} \
        if with_formats else None
    want_formats = formats or {}
    # Unscanned, two layers and no remainder: the keys are the same in
    # both packages (tests/test_torch_frozen_keys.py maps the others).
    cfg = t_build_config("qwen2-1.5b", smoke=True).replace(
        n_layers=2, scan_layers=False)
    for name, save, loads in (
            (tcal.__name__, partial(tcal.save_frozen, cfg=cfg),
             (j_load_frozen, j_load_frozen_formats)),
            (j_save_frozen.__module__, j_save_frozen,
             (partial(tcal.load_frozen, cfg=cfg),
              partial(tcal.load_frozen_formats, cfg=cfg)))):
        d = tmp_path / name
        save(d, scales, formats)
        assert loads[0](d) == scales and loads[1](d) == want_formats
    a, b = (tmp_path / m / tcal.FROZEN_SCALES_FILE
            for m in (tcal.__name__, "repro.scaling.calibrate"))
    assert a.read_bytes() == b.read_bytes()


# ---------------------------------------------------------------------------
# tier B: the fused decode op
# ---------------------------------------------------------------------------

def _decode_fixture(cache):
    """`tests/test_paging.py::test_fp8_kv_decode_step_parity`'s inputs:
    e5m2 payloads (or the bf16 values they came from) and frozen scales."""
    b, h, hkv, dh, c = 2, 4, 2, 16, 24
    rng = np.random.default_rng(7)
    q = (rng.normal(size=(b, h, 1, dh)) * 0.3).astype(np.float32)
    kv = [(rng.normal(size=(b, hkv, c, dh)) * 0.3).astype(np.float32)
          for _ in range(2)]
    lengths = np.array([13, 20])
    valid = np.arange(c)[None, :] < lengths[:, None]
    scales = {f"sdpa#{n}.A": s for n, s in
              zip(("q", "k", "v", "qk", "p"), (0.5, 0.5, 0.5, 4.0, 1.0))}
    jq = jnp.asarray(q, jnp.bfloat16)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    jkv = [jnp.asarray(x, jnp.bfloat16) for x in kv]
    tkv = [torch.from_numpy(x).to(torch.bfloat16) for x in kv]
    if cache == "e5m2":
        jkv = [x.astype(jnp.float8_e5m2) for x in jkv]
        tkv = [x.to(torch.float8_e5m2) for x in tkv]
    return jq, jkv, tq, tkv, valid, lengths, scales


def _t_qcfg(recipe):
    q = tpp.QuantConfig(recipe=recipe, scaling="delayed",
                        backend="pallas_interpret").eval_mode()
    return dataclasses.replace(q, scaling="delayed")


@pytest.mark.parametrize("recipe", ["hybrid", "paper_e5m2"])
@pytest.mark.parametrize("cache", ["e5m2", "bf16"])
def test_decode_op_matches_reference(recipe, cache):
    jq, jkv, tq, tkv, valid, _, scales = _decode_fixture(cache)
    cfg, _ = _cfgs(recipe)
    jqcfg = dataclasses.replace(cfg.policy.quant.eval_mode(),
                                scaling="delayed")
    kw = dict(sm_scale=0.25, k_cache_scale=0.7, v_cache_scale=0.9,
              site="sdpa")

    def ref(q, k, v, m):
        with jsc.activate(jsc.frozen_context(scales)):
            return j_decode(q, k, v, m, cfg=jqcfg,
                            key=jax.random.PRNGKey(3), **kw)

    want = jax.jit(ref, compiler_options=PER_OP)(jq, *jkv,
                                                  jnp.asarray(valid))
    with tsc.activate(tsc.frozen_context(scales)):
        got = fp8_sdpa_decode(tq, *tkv, torch.from_numpy(valid),
                              cfg=_t_qcfg(recipe), **kw)
    _assert_same(got, want)


@pytest.mark.parametrize("cache", ["e5m2", "bf16"])
def test_decode_op_equals_chunk_op_at_one_token(cache):
    """The paged chunk op at T=1 is the decode op on the same payloads."""
    _, _, tq, tkv, valid, lengths, scales = _decode_fixture(cache)
    c = valid.shape[1]
    spos = torch.from_numpy(np.where(valid, np.arange(c)[None], -1))
    cpos = torch.from_numpy(np.stack([lengths - 1, np.ones_like(lengths)], 1))
    kw = dict(cfg=_t_qcfg("hybrid"), sm_scale=0.25, k_cache_scale=0.7,
              v_cache_scale=0.9, site="sdpa")
    with tsc.activate(tsc.frozen_context(scales)):
        dec = fp8_sdpa_decode(tq, *tkv, torch.from_numpy(valid), **kw)
        chk = fp8_sdpa_chunk(tq, *tkv, spos, cpos, **kw)
    _assert_same(dec, chk)


# ---------------------------------------------------------------------------
# streams of the fixed-slot engine
# ---------------------------------------------------------------------------

def _j_legacy(cfg, params, frozen, prompts, max_new=4):
    eng = ServeEngine(cfg, params, ServeConfig(max_batch=2, max_len=64),
                      frozen_scales=frozen)
    eng._prefill = jax.jit(make_serve_prefill(cfg, frozen),
                           compiler_options=PER_OP)
    eng._decode = jax.jit(make_serve_decode(cfg, frozen),
                          compiler_options=PER_OP)
    uids = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    out = eng.run_to_completion()
    return [out[u] for u in uids]


def _t_legacy(tcfg, tparams, frozen, prompts, max_new=4, **kw):
    eng = TServeEngine(tcfg, tparams, TServeConfig(max_batch=2, max_len=64),
                       frozen_scales=frozen, device="cpu", **kw)
    uids = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    out = eng.run_to_completion()
    return [out[u] for u in uids], eng


@pytest.mark.parametrize("cache", [None, "e5m2"], ids=["bf16", "e5m2"])
def test_legacy_streams_match_reference(setup, cache):
    """Fed the reference's frozen dict, the port's fixed-slot engine gives
    the reference engine's greedy streams, through the fused kernel's
    'causal' prefill and 'kv' decode, on a bf16 and an e5m2 cache. (Two
    prompts of one length: the reference compiles its prefill once.)"""
    cfg, tcfg = setup["cfg"], setup["tcfg"]
    if cache:
        cfg, tcfg = setup["cfg8"], setup["tcfg8"]
    prompts = [PROMPTS[0], PROMPTS[0][::-1] * 2 % 64]
    want = _j_legacy(cfg, setup["params"], setup["frozen"], prompts)
    got, eng = _t_legacy(tcfg, setup["tparams"], setup["frozen"], prompts)
    assert got == want
    st = eng.stats()
    assert (st["finished"], st["prefill_tokens"], st["decode_tokens"]) \
        == (2, 14, 6)


@pytest.mark.parametrize("chunk", [1, 16])
def test_paged_streams_equal_legacy_streams(setup, chunk):
    """The reference's contract between its two engines
    (`tests/test_paging.py::TestFrozenFusedParity`), held by the port's:
    bf16 cache, decode-only and chunked-prefill schedules."""
    legacy, _ = _t_legacy(setup["tcfg"], setup["tparams"], setup["frozen"],
                          PROMPTS)
    eng = TPagedEngine(setup["tcfg"], setup["tparams"], TPagedConfig(
        max_batch=2, max_len=64, n_pages=48, page_size=4, chunk_size=chunk,
        prefix_cache=False), frozen_scales=setup["frozen"], device="cpu")
    uids = [eng.add_request(p, max_new_tokens=4) for p in PROMPTS]
    out = eng.run_to_completion()
    assert [out[u] for u in uids] == legacy


def test_slots_recycle_and_stay_isolated(setup):
    """Prefilling a second slot leaves the first slot's cache rows bitwise
    as they were (e5m2 cache); finished slots take new requests."""
    eng = TServeEngine(setup["tcfg8"], setup["tparams"],
                       TServeConfig(max_batch=2, max_len=64),
                       frozen_scales=setup["frozen"], device="cpu")
    u1 = eng.add_request(PROMPTS[0], max_new_tokens=3)
    before = {n: {k: _bits(x[0]) for k, x in s["kv"].items()}
              for n, s in eng.states.items()}
    u2 = eng.add_request(PROMPTS[1], max_new_tokens=3)
    assert not eng.free_slots()
    for n, s in eng.states.items():
        for k, x in s["kv"].items():
            np.testing.assert_array_equal(_bits(x[0]), before[n][k])
    assert set(eng.run_to_completion()) == {u1, u2}
    assert eng.free_slots() == [0, 1]
    u3 = eng.add_request(PROMPTS[1], max_new_tokens=2)
    assert u3 in eng.run_to_completion()


@pytest.fixture(scope="module")
def baseline():
    """`tests/test_serve.py`'s setup: quantization off, so attention takes
    the unfused path in every mode."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab_size=256)
    cfg = j_build_config("qwen2-1.5b", smoke=True).replace(
        policy=BASELINE_POLICY, scan_layers=False, **kw)
    tcfg = t_build_config("qwen2-1.5b", smoke=True).replace(
        policy=tpp.BASELINE_POLICY, **kw)
    params = init_lm(jax.random.PRNGKey(0), cfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    return cfg, tcfg, params, tparams


@pytest.mark.parametrize("cache", [None, "e5m2"], ids=["bf16", "e5m2"])
def test_unfused_serving_matches_reference(baseline, cache):
    """Unfused prefill / decode (legacy engine) and unfused chunks (paged
    engine) against the reference's legacy streams."""
    cfg, tcfg, params, tparams = baseline
    cfg, tcfg = _with_kv(cfg, cache), _with_kv(tcfg, cache)
    prompts = [np.arange(9) % 256, (np.arange(6) * 3 + 1) % 256]
    want = _j_legacy(cfg, params, None, prompts)
    got, _ = _t_legacy(tcfg, tparams, None, prompts)
    assert got == want
    if cache is None:
        eng = TPagedEngine(tcfg, tparams, TPagedConfig(
            max_batch=2, max_len=64, n_pages=48, page_size=4, chunk_size=8,
            prefix_cache=False), device="cpu")
        uids = [eng.add_request(p, max_new_tokens=4) for p in prompts]
        out = eng.run_to_completion()
        assert [out[u] for u in uids] == want


def test_sampled_decoding_is_reproducible(baseline):
    """Temperature sampling on the host: the same seed gives the same
    streams, another seed other ones."""
    _, tcfg, _, tparams = baseline
    prompts = [np.arange(9) % 256, (np.arange(6) * 3 + 1) % 256]

    def run(seed):
        eng = TServeEngine(tcfg, tparams, TServeConfig(
            max_batch=2, max_len=64, temperature=0.8, seed=seed),
            device="cpu")
        uids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
        out = eng.run_to_completion()
        return [out[u] for u in uids]

    assert run(3) == run(3) != run(4)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_fp8_cache_without_kv_scales_is_refused(setup):
    no_kv = {k: s for k, s in setup["frozen"].items() if "/kv/" not in k}
    eng = TServeEngine(setup["tcfg8"], setup["tparams"],
                       TServeConfig(max_batch=1, max_len=64),
                       frozen_scales=no_kv, device="cpu")
    with pytest.raises(ValueError, match="no calibrated scale"):
        eng.add_request(PROMPTS[0], max_new_tokens=2)
    paged = TPagedEngine(setup["tcfg8"], setup["tparams"], TPagedConfig(
        max_batch=1, max_len=64, n_pages=8, page_size=4, chunk_size=8),
        frozen_scales=no_kv, device="cpu")
    paged.add_request(PROMPTS[0], max_new_tokens=2)
    with pytest.raises(ValueError, match="no calibrated scale"):
        paged.step()


def test_frozen_formats_mismatch_is_refused(setup):
    """Scales whose KV sites were calibrated for e5m2 are refused by an
    e4m3 cache (and fit an e5m2 one)."""
    _, formats = tcal.freeze_with_formats(setup["tds"], setup["tstate"],
                                          setup["tcfg8"])
    kw = dict(frozen_scales=setup["frozen"], frozen_formats=formats,
              device="cpu")
    TServeEngine(setup["tcfg8"], setup["tparams"], TServeConfig(), **kw)
    with pytest.raises(ValueError, match="calibrated under"):
        TServeEngine(_with_kv(setup["tcfg"], "e4m3"), setup["tparams"],
                     TServeConfig(), **kw)


def test_serve_engine_defaults_to_the_card():
    _, tcfg = _cfgs("hybrid")
    if torch.cuda.is_available():
        eng = TServeEngine(tcfg, {}, TServeConfig(max_batch=1, max_len=8))
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TServeEngine(tcfg, {}, TServeConfig(max_batch=1, max_len=8))


@pytest.mark.parametrize("entry", ["launch.serve", "examples.serve_batched",
                                   "examples.delayed_scaling"])
def test_serving_entry_points_run_on_the_cpu(entry, tmp_path):
    """`python -m repro_torch.launch.serve --smoke --legacy --fp8-kv
    --device cpu` and the two serving examples (serve_batched holds the
    paged streams equal to the fixed-slot ones itself). `--ckpt-dir` on a
    directory without a committed checkpoint serves the seeded weights, as
    the reference does (tests/test_torch_trainer.py restores one)."""
    import importlib
    mod = importlib.import_module(f"repro_torch.{entry}")
    if entry == "launch.serve":
        eng = mod.main(["--smoke", "--legacy", "--fp8-kv", "--device", "cpu",
                        "--n-requests", "2", "--ckpt-dir", str(tmp_path)])
        assert eng.stats()["finished"] == 2
        assert eng.states["layer_0"]["kv"]["k"].dtype == torch.float8_e5m2
    else:
        assert len(mod.main(["--device", "cpu"])) == 8
