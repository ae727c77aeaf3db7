"""The paper's own recipe on the port's unfused path, against `repro`.

`PAPER_FP8` (e5m2 W/A/E/G at unit scales, RNE on W, SR on A/E/G, no
delayed scaling) takes the unfused `qeinsum` — forward GEMM through the
fp8 GEMM kernel under a kernel backend, the adjoint GEMMs and the 4-D
attention contractions as plain f32-accumulated products — and the
unfused attention composition (`_sdpa`, `chunked_causal_attention`).

  * qeinsum, forward and both gradients, against JAX `qeinsum` under
    `PAPER_FP8_RNE` with backend "pallas_interpret": bit for bit on exact
    fixtures (e5m2 operands with exponents {0, 1}: every f32 sum exact),
    for a projection spec and both 4-D attention specs;
  * the attention block in train mode (dense, and chunked into static
    q-chunk prefixes), all-RNE: tier C — the softmax's exp and the
    reductions differ in the last bit between XLA and torch, and the e5m2
    Q nodes turn a last-bit difference into a grid notch — so the output
    and the gradients are held to a rel L2 limit;
  * one step of a 2-layer model with `make_train_step(scaling=None)`,
    all-RNE, against the reference's jitted `train_step` (compiled without
    XLA's excess precision, as tests/test_torch_serve.py does): loss,
    grad norm and loss scale, and the gradients within a rel L2 limit that
    a planted fault in the fp8 GEMM (its last K block dropped) exceeds;
  * the SR recipe over 10 steps within 3x the band of three reference runs
    with different step keys;
  * the reference's "xla" and "pallas_interpret" backends give the same
    quickstart step (the ground for the port's quickstart running the
    kernel backend).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.kernels.fp8_matmul.ops  # noqa: F401  (jitted before patching)
from repro.core import qlinear as jql
from repro.core.loss_scale import LossScaler as JLossScaler
from repro.core.precision_policy import (PAPER_FP8_RNE, PrecisionPolicy,
                                         QuantConfig)
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import synthetic_lm_batches as j_batches
from repro.models import attention as jattn
from repro.models.config import ModelConfig
from repro.models.registry import build_config as j_build_config
from repro.models.transformer import init_lm, lm_loss
from repro.train.step import make_optimizer_for, make_train_step
from repro_torch.core import precision_policy as tpp
from repro_torch.core import qlinear as tql
from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
from repro_torch.kernels.fp8_matmul import ops as tmm
from repro_torch.models import attention as tattn
from repro_torch.models import config as tmc
from repro_torch.models.convert import from_jax_params
from repro_torch.models.transformer import lm_loss as t_lm_loss
from repro_torch.optim.optimizers import tmap
from repro_torch.train.step import make_optimizer_for as t_make_optimizer_for
from repro_torch.train.step import make_train_step as t_make_train_step

jax.config.update("jax_platform_name", "cpu")

PER_OP = {"xla_allow_excess_precision": False}
RNE = dict(act_rounding="rne", error_rounding="rne", grad_rounding="rne")
KW = dict(arch="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab_size=64, max_seq_len=64, qkv_bias=True)
# Tier-C limits (rel L2), set from readings on the CPU. Attention block:
# output, dx and the weight gradients read 0 (bitwise), the bias
# gradients (bf16 sums over batch and sequence) 0.7e-2 to 1.1e-2. Step
# gradients of all leaves together: 0.153 (worst leaf 0.20) — the e5m2
# chain grows last-bit differences into grid notches, as in
# tests/test_torch_train_step.py — and inf with the planted fault.
ATTN_REL_L2 = 5e-2
STEP_GRAD_REL_L2 = 0.3
LOSS_REL = 1e-2
BAND_FACTOR = 3.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jq_cfg(**kw):
    return QuantConfig(backend="pallas_interpret", **kw)


def tq_cfg(**kw):
    return tpp.QuantConfig(backend="pallas", **kw)


def per_op(fn):
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "jit", functools.partial(jax.jit,
                                                     compiler_options=PER_OP))
            return fn(*a, **kw)
    return wrapped


def exact_e5m2(shape, rng):
    """e5m2 values (as f32) with exponents {0, 1}."""
    sign = rng.choice([-1.0, 1.0], shape)
    m = rng.integers(0, 4, shape) / 4
    x = sign * (1 + m) * np.exp2(rng.integers(0, 2, shape))
    return x.astype(np.float32)


def t_bf16(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16).requires_grad_(grad)


def f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def rel_l2(got, want) -> float:
    got, want = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# qeinsum
# ---------------------------------------------------------------------------

SPECS = {
    "projection": ("bsd,dn->bsn", (2, 24, 64), (64, 40), ("act", "weight")),
    "scores": ("bhqd,bhkd->bhqk", (2, 3, 24, 32), (2, 3, 40, 32),
               ("act", "act")),
    "pv": ("bhqk,bhkd->bhqd", (2, 3, 24, 40), (2, 3, 40, 32),
           ("act", "act")),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_qeinsum_unfused_bitwise(name):
    spec, sa, sb, classes = SPECS[name]
    rng = np.random.default_rng(7)
    a, b = exact_e5m2(sa, rng), exact_e5m2(sb, rng)
    jq = jq_cfg(**RNE)
    assert jq == dataclasses.replace(PAPER_FP8_RNE,
                                     backend="pallas_interpret")

    def f(a_, b_):
        return jql.qeinsum(spec, a_, b_, cfg=jq, classes=classes)

    y_j, vjp = jax.vjp(f, jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16))
    dy = exact_e5m2(y_j.shape, rng)
    da_j, db_j = vjp(jnp.asarray(dy, jnp.bfloat16))
    for backend in ("pallas", "xla"):
        tq = tq_cfg(**RNE) if backend == "pallas" else tpp.PAPER_FP8_RNE
        a_t, b_t = t_bf16(a, True), t_bf16(b, True)
        y_t = tql.qeinsum(spec, a_t, b_t, cfg=tq, classes=classes)
        y_t.backward(t_bf16(dy))
        assert y_t.dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(y_t), f32(y_j))
        np.testing.assert_array_equal(f32(a_t.grad), f32(da_j))
        np.testing.assert_array_equal(f32(b_t.grad), f32(db_j))
    assert np.count_nonzero(f32(db_j)) > 0


def test_qeinsum_unfused_forward_runs_fp8_matmul(monkeypatch):
    """Under a kernel backend the projection's forward GEMM is the fp8
    GEMM op (its plain version on the CPU); the adjoints are not."""
    calls = []
    orig = tmm.fp8_matmul

    def spy(a, b, out_dtype=torch.float32):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return orig(a, b, out_dtype)
    monkeypatch.setattr(tmm, "fp8_matmul", spy)
    a = torch.randn((2, 8, 64)).to(torch.bfloat16).requires_grad_(True)
    w = torch.randn((64, 32)).requires_grad_(True)
    y = tql.qeinsum("bsd,dn->bsn", a, w, cfg=tq_cfg(),
                    generator=torch.Generator().manual_seed(0))
    y.float().sum().backward()
    assert calls == [((16, 64), (64, 32))]
    assert a.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32


def test_qeinsum_unfused_refuses_delayed_sites():
    """Delayed scaling on the unfused path, which the port used to refuse:
    with a context and a site the operands quantize at their sites' scales
    and the forward records their amaxes (the reference's sites: #a, #b,
    #E and, with a weight operand, #G; no fused-output sites)."""
    from repro_torch.scaling import context as tctx
    tq = tpp.QuantConfig(scaling="delayed", **RNE)          # backend xla
    a = torch.full((2, 4, 8), 3.0, dtype=torch.bfloat16)
    w = torch.full((8, 4), 0.5)
    ctx = tctx.collect_context({"s#a.A": 0.25, "s#b.W": 2.0})
    with tctx.activate(ctx):
        y = tql.qeinsum("bsd,dn->bsn", a, w, cfg=tq, site="s")
    assert ctx.discovered == {"s#a.A", "s#b.W", "s#E", "s#G"}
    assert float(ctx.collected["s#a.A"]) == 3.0
    assert float(ctx.collected["s#b.W"]) == 0.5
    assert torch.equal(y, torch.full((2, 4, 4), 12.0, dtype=torch.bfloat16))
    # Without a context it is the unit-scale path, as in the reference.
    assert tql.qeinsum("bsd,dn->bsn", a, torch.zeros((8, 4)),
                       cfg=tq).shape == (2, 4, 4)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def attn_cfgs(**kw):
    jq, tq = jq_cfg(**RNE), tq_cfg(**RNE)
    return (ModelConfig(policy=PrecisionPolicy(quant=jq), remat=False,
                        scan_layers=False, **{**KW, **kw}),
            tmc.ModelConfig(policy=tpp.PrecisionPolicy(quant=tq),
                            remat=False, **{**KW, **kw}))


@pytest.mark.parametrize("layout", ["dense", "chunked"])
def test_attention_block_unfused_tier_c(layout):
    kw = {} if layout == "dense" else dict(attn_chunk_threshold=16,
                                            attn_chunk_size=16)
    jcfg, tcfg = attn_cfgs(**kw)
    b, s = 2, 40
    params = jax.tree_util.tree_map(
        np.asarray, jattn.init_attention(jax.random.PRNGKey(3), jcfg))
    params = {k: (v + 0.1 * np.random.default_rng(1).normal(size=v.shape)
                  ).astype(np.float32) if k.startswith("b") else v
              for k, v in params.items()}
    x = np.random.default_rng(2).normal(size=(b, s, 64)).astype(np.float32)
    dy = np.random.default_rng(3).normal(size=(b, s, 64)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))

    def f(p, x_):
        return jattn.attention(p, x_, cfg=jcfg, qcfg=jcfg.policy.quant,
                               qkey=None, positions=jnp.asarray(pos))[0]

    @per_op
    def reference(p, x_, dy_):
        def fwd_bwd(p, x_, dy_):
            y, vjp = jax.vjp(f, p, x_)
            return (y,) + vjp(dy_)
        return jax.jit(fwd_bwd)(p, x_, dy_)

    y_j, gp_j, gx_j = reference({k: jnp.asarray(v) for k, v in params.items()},
                                jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(dy, jnp.bfloat16))

    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    xt = t_bf16(x, True)
    y_t, _ = tattn.attention(tp, xt, cfg=tcfg, qcfg=tcfg.policy.quant,
                             positions=torch.from_numpy(pos).long())
    y_t.backward(t_bf16(dy))
    assert y_t.dtype == torch.bfloat16 and y_t.shape == (b, s, 64)
    rels = {"y": rel_l2(y_t, y_j), "dx": rel_l2(xt.grad, gx_j)}
    rels.update({f"d{k}": rel_l2(tp[k].grad, gp_j[k]) for k in params})
    assert max(rels.values()) <= ATTN_REL_L2, rels


def test_chunked_attention_refuses_remat():
    """Recomputing the q chunks in the backward, which the port used to
    refuse: remat=True gives the output and the gradients of remat=False
    bit for bit (SR on, the bits replayed from the generator's state)."""
    rng = np.random.default_rng(5)
    x = [torch.tensor(rng.normal(size=(1, 2, 24, 8)).astype(np.float32))
         for _ in range(3)]
    outs = []
    for remat in (False, True):
        qkv = [t.clone().requires_grad_(True) for t in x]
        y = tattn.chunked_causal_attention(
            *qkv, chunk=8, scale=0.5, qcfg=tpp.PAPER_FP8,
            qgen=torch.Generator().manual_seed(1), remat=remat)
        y.float().square().sum().backward()
        outs.append([y] + [t.grad for t in qkv])
    for got, want in zip(*outs):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the training step without scaling
# ---------------------------------------------------------------------------

def step_cfgs(rounding):
    rd = RNE if rounding == "rne" else {}
    jq, tq = jq_cfg(**rd), tq_cfg(**rd)
    return (ModelConfig(policy=PrecisionPolicy(quant=jq), remat=False,
                        scan_layers=False, **KW),
            tmc.ModelConfig(policy=tpp.PrecisionPolicy(quant=tq),
                            remat=False, **KW))


@pytest.fixture(scope="module")
def rne_step():
    """The reference's jitted step and its gradients at the initial weights,
    and the port's pieces at the same weights and batch."""
    jcfg, tcfg = step_cfgs("rne")
    jp = init_lm(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    batch = next(synthetic_lm_batches(DataConfig(vocab_size=64, seq_len=32,
                                                 batch_size=2)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @per_op
    def reference():
        opt = make_optimizer_for(jcfg, learning_rate=1e-3)
        st = opt.init(jp)
        _, met = jax.jit(make_train_step(jcfg, opt))(st, jb,
                                                     jax.random.PRNGKey(0))
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: lm_loss(p, jb, cfg=jcfg, qkey=jax.random.PRNGKey(0),
                              loss_scale=st.loss_scale.scale),
            has_aux=True))(opt.compute_params(st))
        return met, float(loss), grads

    met, loss, grads = reference()
    return dict(tcfg=tcfg, tp=tp, batch=batch, met=met, loss=loss,
                grads=jax.tree_util.tree_map(np.asarray, grads))


def _flat(t, path=""):
    if isinstance(t, dict):
        out = {}
        for k in t:
            out.update(_flat(t[k], f"{path}/{k}"))
        return out
    return {path: f32(t)}


def grad_rel_l2(want, got) -> float:
    w, g = _flat(want), _flat(got)
    assert w.keys() == g.keys()
    num = sum(float(np.sum((w[k].astype(np.float64) - g[k]) ** 2))
              for k in w)
    return float(np.sqrt(num / sum(float(np.sum(w[k].astype(np.float64)
                                                ** 2)) for k in w)))


def port_loss_grads(s):
    opt = t_make_optimizer_for(s["tcfg"], learning_rate=1e-3)
    st = opt.init(s["tp"])
    params = tmap(lambda p: p.requires_grad_(True), opt.compute_params(st))
    loss, _ = t_lm_loss(params, s["batch"], cfg=s["tcfg"],
                        loss_scale=st.loss_scale.scale)
    loss.backward()
    return loss.item(), tmap(lambda p: p.grad, params)


def test_step_without_scaling_matches_reference(rne_step):
    s = rne_step
    opt = t_make_optimizer_for(s["tcfg"], learning_rate=1e-3)
    step = t_make_train_step(s["tcfg"], opt, device="cpu")
    state, met = step(opt.init(s["tp"]), s["batch"],
                      torch.Generator().manual_seed(0))
    want = {k: float(v) for k, v in s["met"].items() if np.ndim(v) == 0}
    assert met["grads_finite"] and want["grads_finite"]
    assert met["loss_scale"] == want["loss_scale"]
    assert abs(met["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
    assert abs(met["grad_norm"] - want["grad_norm"]) \
        <= STEP_GRAD_REL_L2 * want["grad_norm"]
    loss, grads = port_loss_grads(s)
    assert abs(loss - s["loss"]) <= LOSS_REL * abs(s["loss"])
    rel = grad_rel_l2(s["grads"], grads)
    assert rel <= STEP_GRAD_REL_L2, rel


def test_step_planted_fault_exceeds_limit(rne_step, monkeypatch):
    """The fp8 GEMM with its last 64-wide K block dropped (a kernel-5
    fault) must read above the step's gradient limit."""
    orig = tmm.fp8_matmul

    def drop_last_k(a, b, out_dtype=torch.float32):
        k = a.shape[1] - 64
        return orig(a[:, :k].contiguous(), b[:k].contiguous(), out_dtype)
    monkeypatch.setattr(tmm, "fp8_matmul", drop_last_k)
    _, grads = port_loss_grads(rne_step)
    rel = grad_rel_l2(rne_step["grads"], grads)
    assert not rel <= STEP_GRAD_REL_L2, rel


def test_sr_loss_trajectory_within_reference_band():
    jcfg, tcfg = step_cfgs("sr")
    jp = init_lm(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    dc = dict(vocab_size=64, seq_len=32, batch_size=4)
    batches = [b for _, b in zip(range(10), synthetic_lm_batches(
        DataConfig(**dc)))]
    jbatches = [b for _, b in zip(range(10), j_batches(JDataConfig(**dc)))]
    for b, jb in zip(batches, jbatches):   # the same numpy batches
        assert all(np.array_equal(b[k], jb[k]) for k in b)

    @per_op
    def reference_runs():
        opt = make_optimizer_for(jcfg, learning_rate=3e-3)
        step = jax.jit(make_train_step(jcfg, opt))
        runs = []
        for seed in (0, 1, 2):
            st, losses = opt.init(jp), []
            for i, b in enumerate(batches):
                st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()},
                             jax.random.fold_in(jax.random.PRNGKey(seed), i))
                losses.append(float(m["loss"]))
            runs.append(np.asarray(losses))
        return runs

    runs = reference_runs()
    gap = max(float(np.max(np.abs(runs[i] - runs[j])))
              for i in range(3) for j in range(i + 1, 3))
    opt = t_make_optimizer_for(tcfg, learning_rate=3e-3)
    step = t_make_train_step(tcfg, opt, device="cpu")
    st, gen, losses = opt.init(tp), torch.Generator().manual_seed(0), []
    for b in batches:
        st, m = step(st, b, gen)
        losses.append(m["loss"])
    losses = np.asarray(losses)
    assert np.all(np.isfinite(losses)) and gap > 0
    assert np.max(np.abs(losses - np.mean(runs, axis=0))) \
        <= BAND_FACTOR * gap
    assert losses[-1] < losses[0] and all(r[-1] < r[0] for r in runs)


@per_op
def test_reference_backends_agree_on_quickstart_step():
    """The reference quickstart's config and first step under backend "xla"
    (its default) and "pallas_interpret": the same loss, grad norm and
    updated fp16 master weights, bit for bit."""
    outs = []
    batch = next(j_batches(JDataConfig(vocab_size=256, seq_len=64,
                                       batch_size=16, seed=0)))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    for backend in ("xla", "pallas_interpret"):
        cfg = j_build_config("qwen2-1.5b", smoke=True).replace(
            n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
            vocab_size=256, remat=False)
        quant = dataclasses.replace(cfg.policy.quant, backend=backend)
        cfg = cfg.replace(policy=dataclasses.replace(cfg.policy, quant=quant))
        opt = make_optimizer_for(cfg, name="adam", learning_rate=3e-3,
                                 scaler=JLossScaler(mode="enhanced",
                                                    init_scale=1024.0,
                                                    min_scale_schedule=()))
        st = opt.init(init_lm(jax.random.PRNGKey(0), cfg))
        st, m = jax.jit(make_train_step(cfg, opt))(
            st, batch, jax.random.fold_in(jax.random.PRNGKey(1), 0))
        outs.append((float(m["loss"]), float(m["grad_norm"]),
                     jax.tree_util.tree_map(np.asarray, st.master)))
    (l0, g0, m0), (l1, g1, m1) = outs
    assert l0 == l1 and g0 == g1
    for a, b in zip(jax.tree_util.tree_leaves(m0),
                    jax.tree_util.tree_leaves(m1)):
        np.testing.assert_array_equal(a, b)
