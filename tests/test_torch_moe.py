"""The mixture-of-experts FFN (`repro_torch.models.moe`) and the MoE
decoders (moonshot-v1-16b-a3b, dbrx-132b) in the port against `repro` on
the CPU, at smoke size, on inputs made from a numpy seed:

  * `capacity` on a grid of lengths, and top-k ties taken as
    `jax.lax.top_k` takes them (the lower index first);
  * `moe_ffn_per_sample` and the global `moe_ffn` on an exact fixture (one
    router logit per token far above the others, so every softmax is
    exact; fp8-exact inputs and weights, so every f32 sum is exact; 2 x 32
    tokens, a power of two, so every mean is exact): routes, top-k
    probabilities, keep, dest, output and aux bit for bit, with pairs
    dropped; on general inputs: routes equal, output within MOE_REL_L2;
    with exact ties in the router and at capacity_factor 0.5 (drops):
    routes, keep and dest pair for pair;
  * `lm_loss` of the moonshot and dbrx smoke configs under the hybrid
    delayed recipe: the loss, the aux losses and the gradients (the
    router's included) within limits;
  * the site registry with the MoE under delayed scaling (the unfused
    expert sites beside the fused attention ones) is the reference's;
  * remat=True bit for bit remat=False with the aux losses' gradients,
    and a planted double count of the aux losses breaks it;
  * greedy streams of the moonshot smoke config, calibrated and frozen,
    through both engines, equal to the reference engines' token for token.

The reference's intermediates (routes, keep, dest) are read from its own
trace: `jax.lax.top_k` and `jnp.where` are wrapped while it traces. It
runs with XLA's `xla_allow_excess_precision` off, as in
tests/test_torch_serve.py, on its "xla" backend except where a test needs
its Pallas kernels ("pallas_interpret").
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.fp8_attention.ops  # noqa: F401  (jitted before patching)
import repro.kernels.fused_quant_matmul.ops  # noqa: F401
from repro.core.precision_policy import PrecisionPolicy, QuantConfig
from repro.models import moe as jmoe
from repro.models.registry import build_config as j_build_config
from repro.models.transformer import init_lm, lm_loss
from repro.scaling import DelayedScaling as JDelayedScaling
from repro.scaling import ScaleState as JScaleState
from repro.scaling import discover_lm_sites
from repro.scaling.calibrate import calibrate, freeze
from repro.scaling.state import ScalingConfig
from repro.serve import (PagedServeConfig, PagedServeEngine, ServeConfig,
                         ServeEngine)
from repro.train.step import (make_optimizer_for, make_serve_decode,
                              make_serve_prefill)
from repro_torch.core import precision_policy as tpp
from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
from repro_torch.models import moe as tmoe
from repro_torch.models import remat as tremat
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_config
from repro_torch.optim.optimizers import tmap
from repro_torch.scaling.calibrate import discover_lm_sites as t_discover
from repro_torch.scaling.state import DelayedScaling as TDelayedScaling
from repro_torch.scaling.state import ScaleState as TScaleState
from repro_torch.serve.engine import PagedServeConfig as TPagedConfig
from repro_torch.serve.engine import PagedServeEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.engine import ServeEngine as TServeEngine
from repro_torch.train.step import make_optimizer_for as t_make_optimizer_for
from repro_torch.train.step import make_train_step as t_make_train_step

jax.config.update("jax_platform_name", "cpu")

PER_OP = {"xla_allow_excess_precision": False}
RNE = dict(act_rounding="rne", error_rounding="rne", grad_rounding="rne")
B, S = 2, 32
# Limits, set from readings on the CPU. The MoE FFN on general inputs
# (tier C: XLA's and torch's exp, silu and f32 sums differ in last bits,
# which a bf16 rounding or an fp8 notch can carry on): the output read
# bitwise equal on these seeds (9.0e-6 before the port summed its router
# logits in f64), the aux losses at most 2.0e-7 apart (relative). lm_loss under the hybrid delayed recipe: the loss 7.4e-8
# apart and the aux losses 1.3e-7 (relative); the gradients' rel L2 of
# all leaves together 0.156 (moonshot, fused) and 0.120 (dbrx, "xla"),
# worst leaf 0.198, the routers' apart 0.065 and 0.049: the e5m2 chain
# turns last-bit differences into grid notches, as in
# tests/test_torch_seq2seq.py, whose GRAD_REL_L2 these share.
MOE_REL_L2 = 1e-4
LOSS_REL = 1e-5
GRAD_REL_L2 = 0.35


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def rel_l2(got, want) -> float:
    g, w = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def flat(t, path=""):
    if isinstance(t, dict):
        out = {}
        for k in t:
            out.update(flat(t[k], f"{path}/{k}"))
        return out
    return {path: f32(t)}


def grad_rel_l2(want, got, only=None) -> float:
    w, g = flat(want), flat(got)
    assert w.keys() == g.keys()
    keys = [k for k in w if only is None or only in k]
    assert keys
    num = sum(float(np.sum((w[k].astype(np.float64) - g[k]) ** 2))
              for k in keys)
    return float(np.sqrt(num / sum(float(np.sum(w[k].astype(np.float64)
                                                ** 2)) for k in keys)))


def moe_cfgs(arch="moonshot-v1-16b-a3b", **kw):
    """(reference, port) smoke configs of `arch`, all-RNE hybrid recipe."""
    jq = QuantConfig(recipe="hybrid", **RNE)
    tq = tpp.QuantConfig(recipe="hybrid", **RNE)
    return (j_build_config(arch, smoke=True).replace(
                policy=PrecisionPolicy(quant=jq), **kw),
            build_config(arch, smoke=True).replace(
                policy=tpp.PrecisionPolicy(quant=tq), **kw))


# ---------------------------------------------------------------------------
# capacity, top-k
# ---------------------------------------------------------------------------

def test_capacity_on_a_grid():
    for arch in ("moonshot-v1-16b-a3b", "dbrx-132b"):
        for smoke in (False, True):
            jc = j_build_config(arch, smoke=smoke)
            tc = build_config(arch, smoke=smoke)
            for cf in (0.5, 1.0, 1.25, 2.0):
                for n in list(range(1, 70)) + [127, 128, 255, 512, 1088,
                                               2048, 4096, 65536]:
                    assert tmoe.capacity(n, tc.replace(capacity_factor=cf)) \
                        == jmoe.capacity(n, jc.replace(capacity_factor=cf)), \
                        (arch, smoke, cf, n)
    assert tmoe.capacity(1, build_config("moonshot-v1-16b-a3b")) == 8


@pytest.mark.parametrize("k", [1, 2, 6])
def test_top_k_ties_like_jax(k):
    """Values from a set of five, so most rows hold ties (a row of equal
    values among them): the values and indices of `jax.lax.top_k`."""
    rng = np.random.default_rng(k)
    p = rng.choice(np.float32([0.0, 0.125, 0.25, 0.5, 1.0]), (64, 16))
    p[0] = 0.25
    jv, ji = jax.lax.top_k(jnp.asarray(p), k)
    tv, ti = tmoe.top_k(torch.from_numpy(p), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti[0].numpy(), np.arange(k))


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------

def ref_moe(fn_name, jcfg, params, x):
    """The reference's MoE FFN, jitted, with its routes, top-k
    probabilities, keep and dest read from its trace."""
    e, k = jcfg.n_experts, jcfg.experts_per_token
    b, s, _ = x.shape
    pairs = (b, s * k) if fn_name == "moe_ffn_per_sample" else (b * s * k,)
    fn = getattr(jmoe, fn_name)

    def run(p, xx):
        seen = {}
        top_k, where = jax.lax.top_k, jnp.where

        def spy_top_k(probs, kk):
            seen["top"] = top_k(probs, kk)
            return seen["top"]

        def spy_where(c, *a):
            out = where(c, *a)
            if getattr(c, "dtype", None) == jnp.bool_ and c.shape == pairs \
                    and "keep" not in seen:
                seen["keep"], seen["dest"] = c, out
            return out
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.lax, "top_k", spy_top_k)
            mp.setattr(jnp, "where", spy_where)
            y, aux = fn(p, xx, cfg=jcfg, qcfg=jcfg.policy.quant, qkey=None)
        return y, aux, seen["top"], seen["keep"], seen["dest"]

    y, aux, (vals, idx), keep, dest = jax.jit(run, compiler_options=PER_OP)(
        {k_: jnp.asarray(v) for k_, v in params.items()},
        jnp.asarray(x, jnp.bfloat16))
    return dict(y=f32(y), aux={k_: np.float32(v) for k_, v in aux.items()},
                vals=np.asarray(vals).reshape(-1, k),
                idx=np.asarray(idx).reshape(-1, k),
                keep=np.asarray(keep), dest=np.asarray(dest))


def port_moe(fn_name, tcfg, params, x):
    """The port's MoE FFN, with its routes, top-k probabilities, keep and
    dest read from the call (its `top_k` and `_positions` wrapped)."""
    k = tcfg.experts_per_token
    seen = {}
    top_k, positions = tmoe.top_k, tmoe._positions

    def spy_top_k(probs, kk):
        seen["vals"], seen["idx"] = top_k(probs, kk)
        return seen["vals"], seen["idx"]

    def spy_positions(*a):
        seen["keep"], seen["dest"] = positions(*a)
        return seen["keep"], seen["dest"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmoe, "top_k", spy_top_k)
        mp.setattr(tmoe, "_positions", spy_positions)
        y, aux = getattr(tmoe, fn_name)(
            {k_: torch.from_numpy(v) for k_, v in params.items()},
            torch.from_numpy(x).bfloat16(), cfg=tcfg,
            qcfg=tcfg.policy.quant)
    return dict(y=f32(y), aux={k_: v.numpy() for k_, v in aux.items()},
                vals=seen["vals"].reshape(-1, k).numpy(),
                idx=seen["idx"].reshape(-1, k).numpy(),
                keep=seen["keep"].numpy(), dest=seen["dest"].numpy())


def fp8_exact(rng, shape, lo, hi):
    """Values +-{1, 1.5} * 2^[lo, hi]: exact in e4m3 and bf16, so every f32
    sum of their products over a small K is exact in any order."""
    return (rng.choice([-1.0, 1.0], shape) * rng.choice([1.0, 1.5], shape)
            * 2.0 ** rng.integers(lo, hi + 1, shape)).astype(np.float32)


def exact_fixture(cfg, seed=0):
    """Inputs whose first E features are 0.5, but one of 1 or 2 per token
    (the first 20 tokens of row 0 all on expert 3, past its capacity), and
    a router reading them times 256: each token's top logit leads the
    others by at least 128, so its softmax is exactly one-hot and the
    second slot a tie of zeros, taken at the lowest index."""
    rng = np.random.default_rng(seed)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    x = fp8_exact(rng, (B, S, d), -1, 1)
    lv = np.full((B, S, e), 0.5, np.float32)
    top = rng.integers(0, e, (B, S))
    top[0, :20] = 3
    lv[np.arange(B)[:, None], np.arange(S)[None], top] = rng.choice(
        [1.0, 2.0], (B, S))
    x[:, :, :e] = lv
    router = np.zeros((d, e), np.float32)
    router[np.arange(e), np.arange(e)] = 256.0
    params = {"router": router,
              "w_gate": fp8_exact(rng, (e, d, f), -3, -1),
              "w_up": fp8_exact(rng, (e, d, f), -3, -1),
              "w_down": fp8_exact(rng, (e, f, d), -3, -1)}
    return params, x


def general_fixture(cfg, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    x = (rng.normal(size=(B, S, d)) * scale).astype(np.float32)
    params = {"router": (rng.normal(size=(d, e)) / np.sqrt(d)).astype(
                  np.float32),
              "w_gate": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(
                  np.float32),
              "w_up": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(
                  np.float32),
              "w_down": (rng.normal(size=(e, f, d)) * 0.5 / np.sqrt(f))
              .astype(np.float32)}
    return params, x


DISPATCH = ["moe_ffn_per_sample", "moe_ffn"]


def same_routes(got, want):
    for k in ("idx", "keep", "dest"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fn_name", DISPATCH)
def test_moe_exact_fixture_bitwise(fn_name):
    jcfg, tcfg = moe_cfgs(moe_per_sample_dispatch=fn_name == DISPATCH[0])
    params, x = exact_fixture(tcfg)
    want = ref_moe(fn_name, jcfg, params, x)
    got = port_moe(fn_name, tcfg, params, x)
    same_routes(got, want)
    np.testing.assert_array_equal(got["vals"], want["vals"])
    np.testing.assert_array_equal(got["y"], want["y"])
    assert got["aux"].keys() == want["aux"].keys()
    for k in want["aux"]:
        np.testing.assert_array_equal(got["aux"][k], want["aux"][k],
                                      err_msg=k)
    assert 0 < want["aux"]["dropped_frac"] < 0.5
    # The second slot: a tie of zero probabilities, the lowest index.
    np.testing.assert_array_equal(want["idx"][..., 1],
                                  np.where(want["idx"][..., 0] == 0, 1, 0))


@pytest.mark.parametrize("fn_name", DISPATCH)
def test_moe_general_inputs(fn_name):
    """Routes (and so keep and dest) equal; the output within MOE_REL_L2;
    the aux losses within LOSS_REL."""
    jcfg, tcfg = moe_cfgs(moe_per_sample_dispatch=fn_name == DISPATCH[0])
    params, x = general_fixture(tcfg)
    want = ref_moe(fn_name, jcfg, params, x)
    got = port_moe(fn_name, tcfg, params, x)
    same_routes(got, want)
    np.testing.assert_allclose(got["vals"], want["vals"], rtol=1e-5)
    assert rel_l2(got["y"], want["y"]) <= MOE_REL_L2
    for k in want["aux"]:
        np.testing.assert_allclose(got["aux"][k], want["aux"][k],
                                   rtol=LOSS_REL, err_msg=k)


def test_moe_router_ties():
    """Tokens whose router logits tie exactly (zero inputs: every expert
    at 1/E; two equal features: two experts at the top) take the lower
    indices first, as `jax.lax.top_k` does; routes, keep and dest equal."""
    jcfg, tcfg = moe_cfgs()
    params, x = exact_fixture(tcfg, seed=2)
    x[0, :6] = 0.0
    x[1, :10, 5] = x[1, :10, 2] = 4.0
    want = ref_moe(DISPATCH[0], jcfg, params, x)
    got = port_moe(DISPATCH[0], tcfg, params, x)
    same_routes(got, want)
    np.testing.assert_array_equal(want["idx"][:6], [[0, 1]] * 6)
    np.testing.assert_array_equal(want["idx"][S:S + 10], [[2, 5]] * 10)
    assert rel_l2(got["y"], want["y"]) <= MOE_REL_L2


@pytest.mark.parametrize("fn_name", DISPATCH)
def test_moe_drops_at_half_capacity(fn_name):
    """capacity_factor 0.5: about half the pairs dropped, equal pair for
    pair."""
    jcfg, tcfg = moe_cfgs(capacity_factor=0.5,
                          moe_per_sample_dispatch=fn_name == DISPATCH[0])
    params, x = general_fixture(tcfg, seed=3)
    want = ref_moe(fn_name, jcfg, params, x)
    got = port_moe(fn_name, tcfg, params, x)
    same_routes(got, want)
    assert want["aux"]["dropped_frac"] > 0.1
    assert rel_l2(got["y"], want["y"]) <= MOE_REL_L2


# ---------------------------------------------------------------------------
# lm_loss and the site registry under the hybrid delayed recipe
# ---------------------------------------------------------------------------

def delayed_cfgs(arch, backend):
    """(reference, port) smoke configs, hybrid recipe with delayed
    scaling, all-RNE, unscanned and without remat (the reference's
    unscanned keys are the port's)."""
    jq = QuantConfig(recipe="hybrid", scaling="delayed", backend=backend,
                     **RNE)
    tq = tpp.QuantConfig(recipe="hybrid", scaling="delayed",
                         backend="xla" if backend == "xla" else "pallas",
                         **RNE)
    return (j_build_config(arch, smoke=True).replace(
                policy=PrecisionPolicy(quant=jq), remat=False,
                scan_layers=False),
            build_config(arch, smoke=True).replace(
                policy=tpp.PrecisionPolicy(quant=tq), remat=False))


def lm_batch(vocab, seed=0):
    return next(synthetic_lm_batches(DataConfig(
        vocab_size=vocab, seq_len=S, batch_size=B, seed=seed)))


def test_registry_matches_reference():
    """Keys and token sites in order, with the expert GEMMs' unfused
    delayed sites (no #y / #da.E keys) beside the fused attention
    projections' (#y.A, #da.E)."""
    jcfg, tcfg = delayed_cfgs("moonshot-v1-16b-a3b", "pallas_interpret")
    batch = lm_batch(tcfg.vocab_size)
    jp = jax.eval_shape(lambda: init_lm(jax.random.PRNGKey(0), jcfg))
    want = discover_lm_sites(jcfg, jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    got = t_discover(tcfg, ttr.init_lm(tcfg, device="cpu"), batch)
    assert got.keys == want.keys and got.token_sites == want.token_sites
    moe = "decoder/layer_1/moe/"
    assert {moe + s for s in ("w_gate", "w_up", "w_down")} \
        <= set(got.token_sites)
    assert moe + "w_down#b.W" in got.keys
    assert not any(k.startswith(moe) and ("#y" in k or "#da" in k)
                   for k in got.keys)
    assert "decoder/layer_1/attn/wq#y.A" in got.keys


@pytest.fixture(scope="module", params=[
    ("moonshot-v1-16b-a3b", "pallas_interpret"), ("dbrx-132b", "xla")],
    ids=["moonshot_fused", "dbrx_xla"])
def delayed_setup(request):
    """The reference's scaled loss, metrics and gradients at its weights
    under its `collect()` of a ScaleState with its own scale at every
    site (the port's state after one step)."""
    arch, backend = request.param
    jcfg, tcfg = delayed_cfgs(arch, backend)
    jp = jax.jit(init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    host = jax.tree_util.tree_map(np.asarray, jp)
    batch = lm_batch(tcfg.vocab_size)
    reg = t_discover(tcfg, from_jax_params(host, tcfg, device="cpu"), batch)
    ds = TDelayedScaling(reg, qcfg=tcfg.policy.quant)
    opt = t_make_optimizer_for(tcfg, learning_rate=1e-3)
    step = t_make_train_step(tcfg, opt, scaling=ds, device="cpu")
    (_, ss1), met = step(opt.init(from_jax_params(host, tcfg, device="cpu")),
                         ds.init(), batch, torch.Generator().manual_seed(0))
    assert np.all(np.isfinite(ss1.scale))
    assert {"lb_loss", "router_z_loss", "dropped_frac"} <= met.keys()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jds = JDelayedScaling(discover_lm_sites(jcfg, jp, jb),
                          qcfg=jcfg.policy.quant)
    jopt = make_optimizer_for(jcfg, learning_rate=1e-3)
    st = jopt.init(jp)
    jss = JScaleState(amax_history=jnp.asarray(ss1.amax_history),
                      scale=jnp.asarray(ss1.scale),
                      step=jnp.asarray(1, jnp.int32))

    def loss_fn(params, tokens, scale_state):
        with jds.collect(scale_state, tokens):
            return lm_loss(params, jb, cfg=jcfg, qkey=jax.random.PRNGKey(0),
                           loss_scale=st.loss_scale.scale)
    (loss, mets), (grads, _) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True), compiler_options=PER_OP)(
            jopt.compute_params(st), jds.zero_tokens(), jss)
    return dict(tcfg=tcfg, host=host, batch=batch, reg=reg, ss1=ss1,
                loss=float(loss), scale=float(st.loss_scale.scale),
                aux={k: float(mets[k]) for k in
                     ("lb_loss", "router_z_loss", "dropped_frac")},
                grads=jax.tree_util.tree_map(np.asarray, grads))


def test_delayed_lm_loss_within_limit(delayed_setup):
    """The loss (with the aux losses in it) and each aux loss within
    LOSS_REL, the gradients of all leaves together and of the routers
    apart within GRAD_REL_L2; the expert GEMMs took the unfused path."""
    s = delayed_setup
    tcfg = s["tcfg"]
    ds = TDelayedScaling(s["reg"], qcfg=tcfg.policy.quant)
    opt = t_make_optimizer_for(tcfg, learning_rate=1e-3)
    st = opt.init(from_jax_params(s["host"], tcfg, device="cpu"))
    params = tmap(lambda p: p.requires_grad_(True), opt.compute_params(st))
    with ds.collect(TScaleState(amax_history=s["ss1"].amax_history,
                                scale=s["ss1"].scale, step=1)):
        loss, mets = ttr.lm_loss(params, s["batch"], cfg=tcfg,
                                 qgen=torch.Generator().manual_seed(0),
                                 loss_scale=st.loss_scale.scale)
        loss.backward()
    grads = tmap(lambda p: p.grad.float().numpy(), params)
    assert abs(loss.item() - s["loss"]) <= LOSS_REL * abs(s["loss"])
    for k, v in s["aux"].items():
        assert abs(float(mets[k]) - v) <= LOSS_REL * abs(v), k
    nll = float(mets["nll"])
    assert abs(nll + sum(float(mets[k]) for k in s["aux"])
               - loss.item() / s["scale"]) <= 1e-5 * abs(nll)
    assert grad_rel_l2(s["grads"], grads) <= GRAD_REL_L2
    assert grad_rel_l2(s["grads"], grads, only="router") <= GRAD_REL_L2
    assert np.all(np.isfinite(grads["decoder"]["layer_0"]["moe"]["router"]))


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def remat_run(remat):
    """moonshot's smoke config, hybrid delayed with SR: two steps and the
    gradients of a third loss under the resulting state."""
    cfg = build_config("moonshot-v1-16b-a3b", smoke=True).replace(
        remat=remat, policy=tpp.PrecisionPolicy(quant=tpp.QuantConfig(
            recipe="hybrid", scaling="delayed", backend="pallas")))
    params = ttr.init_lm(cfg, seed=3, device="cpu")
    batch = lm_batch(cfg.vocab_size, seed=1)
    opt = t_make_optimizer_for(cfg, learning_rate=1e-2)
    gen = torch.Generator().manual_seed(7)
    ds = TDelayedScaling(t_discover(cfg, params, batch),
                         qcfg=cfg.policy.quant)
    st, ss = opt.init(params), ds.init()
    step = t_make_train_step(cfg, opt, scaling=ds, device="cpu")
    mets = []
    for _ in range(2):
        (st, ss), m = step(st, ss, batch, gen)
        mets.append(m)
    p = tmap(lambda x: x.requires_grad_(True), opt.compute_params(st))
    with ds.collect(ss):
        loss, aux = ttr.lm_loss(p, batch, cfg=cfg, qgen=gen,
                                loss_scale=st.loss_scale.scale)
        loss.backward()
    return mets, flat(st.master), ss, flat(tmap(lambda x: x.grad, p))


@pytest.fixture(scope="module")
def no_remat_run():
    return remat_run(False)


def runs_equal(a, b) -> bool:
    (ma, wa, sa, ga), (mb, wb, sb, gb) = a, b
    return (all(x.keys() == y.keys() and all(
                np.array_equal(np.asarray(x[k]), np.asarray(y[k]),
                               equal_nan=True) for k in x)
                for x, y in zip(ma, mb))
            and all(np.array_equal(wa[k], wb[k]) for k in wa)
            and all(np.array_equal(ga[k], gb[k], equal_nan=True)
                    for k in ga)
            and np.array_equal(sa.amax_history, sb.amax_history,
                               equal_nan=True))


def test_remat_equals_no_remat_bitwise(no_remat_run, monkeypatch):
    calls = []
    orig = tremat.checkpointed

    def counting(fn, gen, *args):
        calls.append(1)
        return orig(fn, gen, *args)
    monkeypatch.setattr(ttr, "checkpointed", counting)
    got = remat_run(True)
    assert calls, "no layer was recomputed"
    assert "lb_loss" in got[0][0] and got[0][0]["router_z_loss"] > 0
    assert runs_equal(got, no_remat_run)


def test_remat_double_counted_aux_breaks_the_equality(no_remat_run,
                                                      monkeypatch):
    """A checkpointed layer whose aux losses are counted twice (its first
    forward's and its recomputation's) must not equal the plain run."""
    orig = tremat.checkpointed

    def double_count(fn, gen, *args):
        h, aux = orig(fn, gen, *args)
        return h, ttr.merge_aux(dict(aux), aux)
    monkeypatch.setattr(ttr, "checkpointed", double_count)
    assert not runs_equal(remat_run(True), no_remat_run)


# ---------------------------------------------------------------------------
# serving: both engines
# ---------------------------------------------------------------------------

PROMPTS = [np.array([3, 5, 7, 11, 13, 17, 19, 23], np.int32),
           np.array([2, 4, 6, 8, 10, 12, 14, 16], np.int32)]


@pytest.fixture(scope="module")
def serve_setup():
    """moonshot's smoke config (hybrid recipe, "xla" backend), the
    reference calibrated on two seeded batches and frozen; its weights
    carried across."""
    jq = QuantConfig(recipe="hybrid", scaling="delayed", backend="xla")
    tq = tpp.QuantConfig(recipe="hybrid", scaling="delayed", backend="xla")
    jcfg = j_build_config("moonshot-v1-16b-a3b", smoke=True).replace(
        policy=PrecisionPolicy(quant=jq), remat=False, scan_layers=False)
    tcfg = build_config("moonshot-v1-16b-a3b", smoke=True).replace(
        policy=tpp.PrecisionPolicy(quant=tq), remat=False)
    params = jax.jit(init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, 512, (2, 16)).astype(np.int32) for _ in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", functools.partial(jax.jit,
                                                 compiler_options=PER_OP))
        ds, state = calibrate(params, jcfg,
                              [{"tokens": jnp.asarray(t)} for t in toks],
                              scaling_cfg=ScalingConfig(margin=1.0))
    frozen = freeze(ds, state)
    assert any("/moe/w_down#" in k for k in frozen)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, frozen=frozen,
                tparams=from_jax_params(jax.tree_util.tree_map(
                    np.asarray, params), tcfg, device="cpu"))


@pytest.mark.parametrize("engine", ["fixed_slot", "paged"])
def test_engine_streams_match_reference(serve_setup, engine):
    """Greedy streams, 6 tokens each, fed the reference's frozen scales:
    the fixed-slot engine (a prefill of 2 x 8 tokens: capacity(8), then
    decode steps: capacity(1)) and the paged one (chunks of 4)."""
    s = serve_setup
    jcfg, tcfg, frozen = s["jcfg"], s["tcfg"], s["frozen"]
    if engine == "fixed_slot":
        jeng = ServeEngine(jcfg, s["params"], ServeConfig(max_batch=2,
                                                          max_len=32),
                           frozen_scales=frozen)
        jeng._prefill = jax.jit(make_serve_prefill(jcfg, frozen),
                                compiler_options=PER_OP)
        jeng._decode = jax.jit(make_serve_decode(jcfg, frozen),
                               compiler_options=PER_OP)
        teng = TServeEngine(tcfg, s["tparams"], TServeConfig(max_batch=2,
                                                             max_len=32),
                            frozen_scales=frozen, device="cpu")
    else:
        kw = dict(max_batch=2, max_len=32, n_pages=24, page_size=4,
                  chunk_size=4, prefix_cache=False)
        jeng = PagedServeEngine(jcfg, s["params"], PagedServeConfig(**kw),
                                frozen_scales=frozen)
        jeng._step = jax.jit(jeng._step.__wrapped__, compiler_options=PER_OP)
        teng = TPagedEngine(tcfg, s["tparams"], TPagedConfig(**kw),
                            frozen_scales=frozen, device="cpu")
    streams = []
    for eng in (jeng, teng):
        uids = [eng.add_request(p, max_new_tokens=6) for p in PROMPTS]
        out = eng.run_to_completion()
        streams.append([out[u] for u in uids])
    assert streams[1] == streams[0]
    assert all(len(x) == 6 for x in streams[0])
