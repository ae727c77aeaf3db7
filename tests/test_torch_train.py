"""The port's training modules against `repro`, each on its own.

  * `qeinsum`'s backward (the fused dgrad 'nt' and wgrad 'tn' GEMMs) and
    `fp8_sdpa`'s backward (the dQ and dK/dV kernels) against the JAX
    custom VJPs, given the same numpy inputs and output cotangent, under
    the all-RNE variant of both recipes (SR bits come from different
    generators in the two packages). On exact fixtures — inputs that
    quantize without rounding, every f32 sum exact in any order — the
    gradients (fp8 payloads times power-of-two scales, so bf16 holds them
    exactly) and the E / G / #da.E / #dp.E / #ds.E observations must match
    bit for bit;
  * the LossScaler state machine over a scripted finite / overflow
    sequence crossing the enhanced schedule's knots (tier A);
  * one Adam step through MixedPrecisionOptimizer (fused leaf-wise path
    and tree path), then an overflow step that keeps the old state;
  * DelayedScaling.update with backward keys, the inf-growth probe and the
    saturation probe, and the mean over uses of backward observations
    (the reference's `split_observations`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import loss_scale as jls
from repro.core import qattention as jqa
from repro.core import qlinear as jql
from repro.core.precision_policy import PrecisionPolicy, QuantConfig
from repro.models.config import ModelConfig
from repro.scaling import context as jctx
from repro.scaling import state as jstate
from repro.train.step import make_optimizer_for
from repro_torch.core import loss_scale as tls
from repro_torch.core import precision_policy as tpp
from repro_torch.core import qattention as tqa
from repro_torch.core import qlinear as tql
from repro_torch.models import config as tmc
from repro_torch.scaling import context as tctx
from repro_torch.scaling import state as tstate
from repro_torch.train.step import make_optimizer_for as t_make_optimizer_for

jax.config.update("jax_platform_name", "cpu")

NP_DT = {"e4m3": ml_dtypes.float8_e4m3fn, "e5m2": ml_dtypes.float8_e5m2}
MAN = {"e4m3": 3, "e5m2": 2}
RNE = dict(act_rounding="rne", error_rounding="rne", grad_rounding="rne")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(recipe):
    return (QuantConfig(recipe=recipe, scaling="delayed",
                        backend="pallas_interpret", **RNE),
            tpp.QuantConfig(recipe=recipe, scaling="delayed",
                            backend="pallas", **RNE))


def exact_fp8(shape, fmt, rng):
    """fp8 values (as f32) with exponents {0, 1}."""
    sign = rng.choice([-1.0, 1.0], shape)
    m = rng.integers(0, 1 << MAN[fmt], shape) / (1 << MAN[fmt])
    x = sign * (1 + m) * np.exp2(rng.integers(0, 2, shape))
    return x.astype(np.float32).astype(NP_DT[fmt]).astype(np.float32)


def t_bf16(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16).requires_grad_(grad)


def same(a, b):
    return np.array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# qeinsum backward
# ---------------------------------------------------------------------------

def qeinsum_scales():
    """Power-of-two site scales: every kernel scale of the three GEMMs is 1
    (4 for the forward output), so the exact fixtures' GEMM outputs stay in
    e5m2 binades whose RNE the reference rounds correctly on the CPU."""
    s_a, s_b, s_e = 2.0 ** -3, 2.0 ** -5, 2.0 ** 4
    return {"s#a.A": s_a, "s#b.W": s_b, "s#E": s_e, "s#G": s_a * s_e,
            "s#y.A": 4 * s_a * s_b, "s#da.E": s_e * s_b}


@pytest.mark.parametrize("recipe", ["hybrid", "paper_e5m2"])
def test_qeinsum_backward_bitwise(recipe):
    jq, tq = cfgs(recipe)
    fa, fe = jq.format_for("act"), jq.format_for("error")
    sc = qeinsum_scales()
    rng = np.random.default_rng(1)
    a = exact_fp8((2, 32, 64), fa, rng) * sc["s#a.A"]
    w = exact_fp8((64, 96), fa, rng) * sc["s#b.W"]
    dy = exact_fp8((2, 32, 96), fe, rng) * sc["s#E"]
    jscales = {k: jnp.float32(v) for k, v in sc.items()}

    def f(a_, w_, tok):
        ctx = jctx.collect_context(jscales, {"s": tok})
        with jctx.activate(ctx):
            y = jql.qeinsum("bsd,dn->bsn", a_, w_, key=jax.random.PRNGKey(0),
                            cfg=jq, site="s")
        return y, dict(ctx.collected)

    y_j, vjp, fwd = jax.vjp(f, jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(w, jnp.bfloat16), jnp.zeros((5,)),
                       has_aux=True)
    da_j, dw_j, tok_j = vjp(jnp.asarray(dy, jnp.bfloat16))

    sctx = tctx.collect_context({k: np.float32(v) for k, v in sc.items()})
    a_t, w_t = t_bf16(a, True), t_bf16(w, True)
    with tctx.activate(sctx):
        y_t = tql.qeinsum("bsd,dn->bsn", a_t, w_t, cfg=tq, site="s")
        y_t.backward(t_bf16(dy))
    obs = sctx.observations()
    assert same(y_t.detach().float(), np.asarray(y_j, np.float32))
    assert same(a_t.grad.float(), np.asarray(da_j, np.float32))
    assert same(w_t.grad.float(), np.asarray(dw_j, np.float32))
    assert np.count_nonzero(np.asarray(dw_j, np.float32)) > 0
    tok_j = np.asarray(tok_j, np.float32)
    for key, ch in (("s#E", 0), ("s#G", 1), ("s#da.E", 2)):
        assert obs[key] == tok_j[ch] and tok_j[ch] > 0, key
    for key in ("s#a.A", "s#b.W", "s#y.A"):
        assert obs[key] == np.float32(fwd[key]), key


def test_qeinsum_requires_generator_under_sr():
    tq = tpp.QuantConfig(recipe="hybrid", scaling="delayed", backend="pallas")
    a = torch.zeros((2, 4, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Generator"):
        tql.qeinsum("bsd,dn->bsn", a, torch.zeros((8, 4)), cfg=tq)


def test_qeinsum_saves_fp8_payloads():
    """The backward residuals are the fp8 payloads, not the activations."""
    tq = cfgs("hybrid")[1]
    a = torch.randn((2, 4, 8)).to(torch.bfloat16).requires_grad_(True)
    w = torch.randn((8, 16)).to(torch.bfloat16).requires_grad_(True)
    y = tql.qeinsum("bsd,dn->bsn", a, w, cfg=tq)
    saved = y.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.float8_e4m3fn] * 2


# ---------------------------------------------------------------------------
# fp8_sdpa backward
# ---------------------------------------------------------------------------

SDPA_SCALES = dict(q=8.0, k=1.0, v=1.0, s=1.0, p=1.0, do=1.0, dp=64.0,
                   ds=2.0 ** -11)


def sdpa_fixture(fe, rng, b=1, h=4, hkv=2, s=256, d=64):
    """The uniform exact fixture of tests/test_torch_attn_bwd.py, as
    high-precision inputs whose quantization at SDPA_SCALES is exact; with
    sm_scale 1/8 the ten kernel factors are its powers of two."""
    q = 8.0 * np.eye(d, dtype=np.float32)[rng.integers(0, d, (b, h, s))]
    hi = rng.random((b, hkv, s)) < 0.5
    k = np.where(hi, 4.0, -224.0)[..., None] * np.ones(d, np.float32)
    v = (rng.choice([-2.0, -1.0, 1.0, 2.0], (b, hkv, s, 1))
         * np.ones(d)).astype(np.float32)
    do = np.eye(d, dtype=np.float32)[rng.integers(0, d, (b, h, s))] \
        * (4 * exact_fp8((b, h, s, 1), fe, rng))
    return q, k, v, do


@pytest.mark.parametrize("recipe", ["hybrid", "paper_e5m2"])
@pytest.mark.parametrize("mask", ["causal", "full"])
def test_fp8_sdpa_backward_bitwise(recipe, mask):
    jq, tq = cfgs(recipe)
    rng = np.random.default_rng(2)
    q, k, v, do = sdpa_fixture(jq.format_for("error"), rng)
    keys = jctx.attention_keys("sd")
    sc = {keys[n]: v_ for n, v_ in SDPA_SCALES.items()}
    jscales = {kk: jnp.float32(x) for kk, x in sc.items()}

    def f(q_, k_, v_, tok):
        ctx = jctx.collect_context(jscales, {"sd": tok})
        with jctx.activate(ctx):
            o = jqa.fp8_sdpa(q_, k_, v_, key=jax.random.PRNGKey(0), cfg=jq,
                             sm_scale=0.125, mask_mode=mask, site="sd")
        return o, dict(ctx.collected)

    o_j, vjp, fwd = jax.vjp(
        f, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.zeros((5,)), has_aux=True)
    dq_j, dk_j, dv_j, tok_j = vjp(jnp.asarray(do, jnp.bfloat16))

    sctx = tctx.collect_context({kk: np.float32(x) for kk, x in sc.items()})
    qt, kt, vt = (t_bf16(x, True) for x in (q, k, v))
    with tctx.activate(sctx):
        o_t = tqa.fp8_sdpa(qt, kt, vt, cfg=tq, sm_scale=0.125,
                           mask_mode=mask, site="sd")
        o_t.backward(t_bf16(do))
    obs = sctx.observations()
    assert same(o_t.detach().float(), np.asarray(o_j, np.float32))
    for name, g, w in (("dq", qt, dq_j), ("dk", kt, dk_j), ("dv", vt, dv_j)):
        assert same(g.grad.float(), np.asarray(w, np.float32)), name
        assert np.count_nonzero(np.asarray(w, np.float32)) > 0, name
    tok_j = np.asarray(tok_j, np.float32)
    for n, ch in (("do", 0), ("dp", 3), ("ds", 4)):
        assert obs[keys[n]] == tok_j[ch] and tok_j[ch] > 0, n
    for n in ("q", "k", "v", "s", "p"):
        assert obs[keys[n]] == np.float32(fwd[keys[n]]), n


def test_fp8_sdpa_seed_drawn_from_generator():
    """Under SR each call draws its own kernel seed from the generator: two
    calls on one generator quantize differently, two generators with the
    same seed alike."""
    tq = tpp.QuantConfig(recipe="hybrid", scaling="delayed", backend="pallas")
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 64, 32)).to(torch.bfloat16)
    k = torch.randn((1, 2, 64, 32)).to(torch.bfloat16)

    def run(gen):
        return tqa.fp8_sdpa(q, k, k, cfg=tq, sm_scale=0.2, generator=gen)
    a, b = run(g), run(g)
    c = run(torch.Generator().manual_seed(0))
    assert not torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        tqa.fp8_sdpa(q, k, k, cfg=tq, sm_scale=0.2)


# ---------------------------------------------------------------------------
# loss scaler
# ---------------------------------------------------------------------------

SCRIPT = [True, True, True, False, True, True, True, True, False, False,
          True, True, True, True, True, False, True, True, True, True]


@pytest.mark.parametrize("mode", ["constant", "dynamic", "enhanced"])
def test_loss_scaler_state_machine(mode):
    kw = dict(mode=mode, init_scale=4096.0, growth_interval=3,
              max_scale=2.0 ** 14, min_scale_schedule=((4, 2048.0),
                                                       (9, 16384.0)))
    js, ts = jls.LossScaler(**kw), tls.LossScaler(**kw)
    jst, tst = js.init(), ts.init()
    for fin in SCRIPT:
        jst = js.update(jst, jnp.asarray(fin))
        tst = ts.update(tst, torch.tensor(fin))
        for f in ("scale", "growth_count", "step", "overflow_count"):
            jv = np.asarray(getattr(jst, f))
            tv = getattr(tst, f).numpy()
            assert jv.dtype == tv.dtype and np.array_equal(jv, tv), (fin, f)


@pytest.mark.parametrize("step", [0, 3, 4, 8, 9, 20])
def test_min_scale_schedule_knots(step):
    kw = dict(mode="enhanced", min_scale_schedule=((4, 2048.0),
                                                    (9, 16384.0)))
    want = np.asarray(jls.LossScaler(**kw).min_scale_at(jnp.int32(step)))
    got = tls.LossScaler(**kw).min_scale_at(
        torch.tensor(step, dtype=torch.int32)).numpy()
    assert np.array_equal(want, got)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"w": rng.standard_normal((8, 16)).astype(np.float32) * 0.1,
            "b": {"x": rng.standard_normal((5,)).astype(np.float32)}}


def _flat(t, path=""):
    if isinstance(t, dict):
        out = {}
        for k in t:
            out.update(_flat(t[k], f"{path}/{k}"))
        return out
    return {path: np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                             np.float32)}


@pytest.mark.parametrize("fused", [True, False])
def test_mixed_precision_adam_update(fused):
    """fp16 master, f32 Adam: the accumulators bitwise, the stored master
    within one fp16 ulp (torch's and XLA's pow / sqrt may differ in the
    last f32 bit); an overflowing step keeps master and accumulators and
    halves the loss scale."""
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 300).astype(np.float32),
        params) for _ in range(2)]
    grads[1]["b"]["x"][2] = np.inf
    jcfg = ModelConfig(policy=PrecisionPolicy())
    tcfg = tmc.ModelConfig(policy=tpp.PrecisionPolicy())
    jopt = make_optimizer_for(jcfg, learning_rate=1e-2)
    topt = t_make_optimizer_for(tcfg, learning_rate=1e-2)
    if not fused:
        jopt = dataclasses.replace(jopt, accum_names=(), leaf_update=None)
        topt = dataclasses.replace(topt, accum_names=(), leaf_update=None)
    jst = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    tst = topt.init(jax.tree_util.tree_map(torch.tensor, params))
    for g in grads:
        jst, jm = jopt.apply_gradients(
            jst, jax.tree_util.tree_map(
                lambda x: jnp.asarray(x, jnp.bfloat16), g))
        tst, tm = topt.apply_gradients(
            tst, jax.tree_util.tree_map(
                lambda x: torch.tensor(x).to(torch.bfloat16), g))
        assert bool(jm["grads_finite"]) == bool(tm["grads_finite"])
        assert float(jm["loss_scale"]) == float(tm["loss_scale"])
        for name in ("mu", "nu"):
            jf, tf = _flat(jst.opt_state[name]), _flat(tst.opt_state[name])
            for k in jf:
                assert np.array_equal(jf[k], tf[k]), (name, k)
        assert int(jst.opt_state["count"]) == int(tst.opt_state["count"])
        jm_, tm_ = _flat(jst.master), _flat(tst.master)
        for k in jm_:
            ulp = np.spacing(np.abs(jm_[k]).astype(np.float16)).astype(
                np.float32)
            assert np.all(np.abs(jm_[k] - tm_[k]) <= ulp), k
    assert not bool(tm["grads_finite"]) and float(tm["loss_scale"]) == 4096.0


# ---------------------------------------------------------------------------
# delayed scaling
# ---------------------------------------------------------------------------

KEYS = ["l/s#a.A", "l/s#b.W", "l/s#E", "l/s#G", "l/s#da.E", "l/sd#dp.E"]


def test_delayed_scaling_update_with_backward_keys():
    """Three updates: a saturated activation (probe x2), an inf error
    (cap x growth), an unobserved key (carried), a zero observation."""
    q = QuantConfig(recipe="hybrid", scaling="delayed")
    tq = tpp.QuantConfig(recipe="hybrid", scaling="delayed")
    jds = jstate.DelayedScaling(jstate.SiteRegistry(KEYS),
                                config=jstate.ScalingConfig(history_len=4),
                                qcfg=q)
    tds = tstate.DelayedScaling(tstate.SiteRegistry(KEYS),
                                config=tstate.ScalingConfig(history_len=4),
                                qcfg=tq)
    assert jds.registry.keys == tds.registry.keys
    js, ts = jds.init(), tds.init()
    rounds = [{"l/s#a.A": 3.5, "l/s#b.W": 0.25, "l/s#E": 1000.0,
               "l/s#G": 0.125, "l/s#da.E": 0.0},
              {"l/s#a.A": None, "l/s#b.W": 0.5, "l/s#E": np.inf,
               "l/s#da.E": 7.0, "l/sd#dp.E": np.nan},
              {"l/s#a.A": 2.0, "l/s#E": 5.0, "l/sd#dp.E": 0.001}]
    for obs in rounds:
        if obs.get("l/s#a.A", 0.0) is None:   # pinned at the ceiling
            obs["l/s#a.A"] = float(np.float32(ts.scale[0]) * np.float32(448))
        obs = {k: np.float32(v) for k, v in obs.items()}
        js = jds.update(js, {k: jnp.float32(v) for k, v in obs.items()})
        ts = tds.update(ts, obs)
        assert np.array_equal(np.asarray(js.amax_history), ts.amax_history)
        assert np.array_equal(np.asarray(js.scale), ts.scale)


def test_backward_observations_mean_over_uses():
    reg = jstate.SiteRegistry(["s#E", "s#G", "s#da.E"], token_sites=["s"])
    reg.token_uses["s"] = 2
    e = [np.float32(3.0), np.float32(0.7)]
    g = [np.float32(0.1), np.float32(0.3)]
    tok = jnp.asarray([e[0] + e[1], g[0] + g[1], 0.0, 0.0, 0.0], jnp.float32)
    want = jstate.split_observations({}, {"s": tok}, reg)
    ctx = tctx.collect_context({})
    for i in range(2):
        ctx.record_bwd("s#E", torch.tensor(e[i]))
        ctx.record_bwd("s#G", torch.tensor(g[i]))
    got = ctx.observations()
    for k in ("s#E", "s#G"):
        assert np.float32(want[k]) == got[k], k
