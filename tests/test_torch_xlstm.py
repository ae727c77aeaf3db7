"""xlstm-125m, the mLSTM / sLSTM stack, against `repro` on the CPU at smoke
size (d 64, 2 heads) or narrower, on inputs made from a numpy seed:

  * the config's fields, full and smoke, are the reference's;
  * `from_jax_params` carries every leaf of the reference's 10-layer tree
    (scanned groups stack_0..3, remainder rem_0, rem_1; r_zifo and the
    inner norms among them) into layer_0..9;
  * `_mlstm_chunk`, `_mlstm_parallel` (chunks of 8 at S in {1, 7, 24,
    37}: the chunk carry), `_mlstm_step` and `_slstm_scan` (from zeros and
    from a carried state): outputs and gradients (autograd against
    `jax.grad`), and a fixture of tied maxima in the m stabilisers, whose
    gradients split as the reference's do;
  * `mlstm_block` / `slstm_block` in the train, prefill and decode modes at
    the reference's weights;
  * the forward logits, `lm_loss` and one hybrid delayed step's
    gradients on the fused path (all-RNE; the reference on
    `pallas_interpret`, one compile; two chunks of 8);
  * prefill -> decode equals the train forward across chunk boundaries;
  * calibrated frozen-scale keys equal the reference's;
  * the fixed-slot `ServeEngine`'s greedy streams equal the reference
    engine's token for token (5 requests over 4 slots: one slot reused,
    whose sLSTM prefill starts from the state the slot carries);
  * recomputation of the 8-layer stack, bit for bit the step without it;
  * the launchers (`--arch xlstm-125m`) and paged serving's refusal.

The reference's jitted programs run with XLA's `xla_allow_excess_precision`
off, as in tests/test_torch_serve.py. Torch runs on one intra-op thread.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision_policy import PrecisionPolicy, QuantConfig
from repro.models import transformer as jtr
from repro.models import xlstm as jx
from repro.models.registry import build_config as j_build_config
from repro.scaling import DelayedScaling as JDelayedScaling
from repro.scaling import ScaleState as JScaleState
from repro.scaling import discover_lm_sites
from repro.serve import ServeConfig, ServeEngine
from repro.train.step import make_optimizer_for as j_make_optimizer_for
from repro.train.step import make_serve_decode, make_serve_prefill
from repro_torch.core import precision_policy as tpp
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.launch import train as tlaunch_train
from repro_torch.models import transformer as ttr
from repro_torch.models import xlstm as tx
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import ARCHS, build_config
from repro_torch.optim.optimizers import tmap
from repro_torch.scaling import calibrate as tcal
from repro_torch.scaling.calibrate import discover_lm_sites as t_discover
from repro_torch.scaling.state import DelayedScaling as TDelayedScaling
from repro_torch.scaling.state import ScaleState as TScaleState
from repro_torch.scaling.state import ScalingConfig as TScalingConfig
from repro_torch.serve.engine import PagedServeConfig as TPagedConfig
from repro_torch.serve.engine import PagedServeEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.engine import ServeEngine as TServeEngine
from repro_torch.train.step import make_optimizer_for as t_make_optimizer_for
from repro_torch.train.step import make_serve_chunk
from repro_torch.train.step import make_train_step as t_make_train_step

jax.config.update("jax_platform_name", "cpu")

ARCH = "xlstm-125m"
PER_OP = {"xla_allow_excess_precision": False}
RNE = dict(act_rounding="rne", error_rounding="rne", grad_rounding="rne")
CHUNK = 8        # the tests' attn_chunk_size: S > CHUNK runs the carry
B, S = 2, 28     # four chunks, the last one short
# Limits. The block functions in f32 (XLA's and torch's exp, log1p and
# f32 sums differ in last bits): outputs and gradients within FN_REL of
# their max |value| (read on the CPU: at most 2.0e-6, the decode step, on
# these seeds). The blocks: the bf16 output's rel L2 within BLOCK_REL_L2
# (read: 0, bit for bit; an fp8 notch that a last bit flips may move it),
# the state within FN_REL (read: at most 1.5e-7). The model (all-RNE,
# unit scales), as in tests/test_torch_recurrent.py: the logits' rel L2,
# the loss (relative), the gradients' rel L2 of all leaves together (an
# fp8 notch flipped by a last-bit difference carries through the e5m2
# chain).
FN_REL = 2e-5
BLOCK_REL_L2 = 1e-3
LOGITS_REL_L2 = 1e-3
LOSS_REL = 1e-5
GRAD_REL_L2 = 0.35
PAGED = "paged serving supports attention stacks only"


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


def max_rel(got, want) -> float:
    """max |got - want| over max |want|."""
    g, w = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def flat(t, path=""):
    if isinstance(t, dict):
        out = {}
        for k in t:
            out.update(flat(t[k], f"{path}/{k}"))
        return out
    return {path: t}


def grad_rel_l2(want, got) -> float:
    w = {k: f32(v).astype(np.float64) for k, v in flat(want).items()}
    g = {k: f32(v).astype(np.float64) for k, v in flat(got).items()}
    assert w.keys() == g.keys()
    num = sum(float(np.sum((w[k] - g[k]) ** 2)) for k in w)
    return float(np.sqrt(num / sum(float(np.sum(w[k] ** 2)) for k in w)))


def cfgs(**quant):
    """(reference, port) smoke configs with chunks of CHUNK, no remat, the
    reference unscanned (its keys are the port's): the hybrid recipe's
    formats, by default all-RNE at unit scales on the "xla" backends;
    `quant` overrides the QuantConfig fields."""
    q = dict(recipe="hybrid", backend="xla", **RNE)
    q.update(quant)
    tq = dict(q, backend="xla" if q["backend"] == "xla" else "pallas")
    kw = dict(remat=False, attn_chunk_size=CHUNK)
    return (j_build_config(ARCH, smoke=True).replace(
                policy=PrecisionPolicy(quant=QuantConfig(**q)),
                scan_layers=False, **kw),
            build_config(ARCH, smoke=True).replace(
                policy=tpp.PrecisionPolicy(quant=tpp.QuantConfig(**tq)),
                **kw))


@functools.lru_cache(maxsize=None)
def ref_params(n_layers=4):
    """The reference's smoke weights at `n_layers` (numpy leaves; scanned
    groups past one group, its default), one compile of its initializer."""
    jcfg = j_build_config(ARCH, smoke=True).replace(n_layers=n_layers)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jtr.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg))


def batch_for(vocab, seed=0, s=S, b=B):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def jgrad(fn, args, cot):
    """The reference's value and gradients of sum(out * cot) over the
    leaves of fn's output, with respect to every argument (one jit)."""
    def loss(*a):
        out = jax.tree_util.tree_leaves(fn(*a))
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(out, cot)), fn(*a)
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True),
        compiler_options=PER_OP)(*[jnp.asarray(a) for a in args])
    return jax.tree_util.tree_leaves(out), grads


def tgrad(fn, args, cot):
    """The port's output leaves and autograd gradients of the same sum."""
    ts = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    out = fn(*ts)
    leaves = []

    def walk(o):
        if isinstance(o, dict):
            for k in sorted(o):
                walk(o[k])
        elif isinstance(o, (tuple, list)):
            for x in o:
                walk(x)
        else:
            leaves.append(o)
    walk(out)
    total = sum(torch.sum(o.float() * torch.from_numpy(c))
                for o, c in zip(leaves, cot))
    grads = torch.autograd.grad(total, ts, allow_unused=True)
    return leaves, grads


def assert_close(got, want, what, rel=FN_REL):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None, (what, i)
        assert g.shape == tuple(np.shape(w)), (what, i)
        assert np.all(np.isfinite(f32(g))), (what, i)
        r = max_rel(g, w)
        assert r <= rel, (what, i, r)


def cotangents(rng, shapes):
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# config, weights
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    assert ARCH in ARCHS
    for smoke in (False, True):
        want = dataclasses.asdict(j_build_config(ARCH, smoke=smoke))
        got = dataclasses.asdict(build_config(ARCH, smoke=smoke))
        want.pop("policy"), got.pop("policy")
        assert got == want
        build_config(ARCH, smoke=smoke).check_ported()
        build_config(ARCH, smoke=smoke).check_ported(serving=True)
    cfg = build_config(ARCH)
    assert cfg.layer_kinds() == ("mlstm", "mlstm", "mlstm", "slstm") * 3
    assert cfg.attn_chunk_size == 1024 and cfg.remat
    params = ttr.init_lm(build_config(ARCH, smoke=True), device="cpu")
    m, s = (params["decoder"][f"layer_{i}"] for i in (0, 3))
    # inner 128 = 2 x 64, 2 heads: w_if (128, 4); r_zifo (2, 32, 128);
    # the FFN's int(64 * 4 / 3) = 85.
    assert tuple(m["mlstm"]["w_if"].shape) == (128, 4)
    assert tuple(s["slstm"]["r_zifo"].shape) == (2, 32, 128)
    assert tuple(s["slstm"]["w_up"].shape) == (64, 85)


def test_from_jax_params_covers_every_leaf_at_10_layers():
    """Ten layers: the reference's tree holds stack_0..3 (two groups each)
    and rem_0, rem_1; each lands in its layer_{i} bit for bit (r_zifo and
    the inner norms among the leaves), in the shapes of the port's own
    init_lm."""
    _, tcfg = cfgs()
    tcfg = tcfg.replace(n_layers=10)
    jp = ref_params(10)
    assert set(jp["decoder"]) == {"stack_0", "stack_1", "stack_2",
                                  "stack_3", "rem_0", "rem_1"}
    tp = from_jax_params(jp, tcfg, device="cpu")
    assert list(tp["decoder"]) == [f"layer_{i}" for i in range(10)]
    n_ref = sum(int(np.shape(x)[0]) if "/stack_" in k else 1
                for k, x in flat(jp).items())
    assert len(flat(tp)) == n_ref
    for i in range(10):
        src = jp["decoder"][f"stack_{i % 4}"] if i < 8 \
            else jp["decoder"][f"rem_{i - 8}"]
        want = flat(jax.tree_util.tree_map(lambda x: x[i // 4], src)
                    if i < 8 else src)
        got = flat(tp["decoder"][f"layer_{i}"])
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(f32(got[k]), v)
    assert set(tp["decoder"]["layer_3"]["slstm"]) \
        == {"w_zifo", "r_zifo", "norm", "w_up", "w_gate", "w_down"}
    assert set(tp["decoder"]["layer_9"]["mlstm"]) \
        == {"w_up", "w_gate", "wq", "wk", "wv", "w_if", "norm", "w_down"}
    assert tp["decoder"]["layer_7"]["slstm"]["r_zifo"].dtype == torch.float32
    own = ttr.init_lm(tcfg, device="cpu")
    assert tmap(lambda x: tuple(x.shape), tp) \
        == tmap(lambda x: tuple(x.shape), own)


# ---------------------------------------------------------------------------
# the mLSTM and sLSTM functions, forward and gradients
# ---------------------------------------------------------------------------

DH = 24          # not a square: sqrt(dh) is inexact


def mlstm_inputs(rng, s, b=2, h=2, dh=DH, ties=False):
    """q, k, v (B, H, S, dh), i and f gate pre-activations (B, H, S). With
    `ties`: i in {-2, -1, 0} and f = 200 at random places (log sigmoid 200
    is -0.0 in f32: F_i - F_j is exact and whole rows of D tie), so the
    stabilisers' maxima tie among entries and with 0 and b_i."""
    q, k, v = (rng.normal(size=(b, h, s, dh)).astype(np.float32)
               for _ in range(3))
    if ties:
        i = rng.integers(-2, 1, (b, h, s)).astype(np.float32)
        f = np.where(rng.random((b, h, s)) < 0.7, 200.0,
                     rng.normal(size=(b, h, s)) + 2.0).astype(np.float32)
    else:
        i = rng.normal(size=(b, h, s)).astype(np.float32)
        f = (rng.normal(size=(b, h, s)) + 2.0).astype(np.float32)
    return [q, k, v, i, f]


def mlstm_state(rng, b=2, h=2, dh=DH):
    return [(rng.normal(size=(b, h, dh, dh)) * 0.3).astype(np.float32),
            (rng.normal(size=(b, h, dh)) * 0.3).astype(np.float32),
            rng.normal(size=(b, h)).astype(np.float32)]


@pytest.mark.parametrize("ties", [False, True], ids=["general", "ties"])
def test_mlstm_chunk_matches_reference(ties):
    """One chunk of 16 from a carried (C, n, m): h and the new state, and
    the gradients of every input and of the carried state."""
    rng = np.random.default_rng(1 + ties)
    q, k, v, i, f = mlstm_inputs(rng, 16, ties=ties)
    c0, n0, m0 = mlstm_state(rng)
    if ties:
        m0[:] = 0.0
    args = [q, k, v, i, np.asarray(jax.nn.log_sigmoid(f)), c0, n0, m0]
    cot = cotangents(rng, [q.shape, c0.shape, n0.shape, m0.shape])
    want, jg = jgrad(lambda *a: jx._mlstm_chunk(*a[:5], tuple(a[5:])), args,
                     cot)
    got, tg = tgrad(lambda *a: tx._mlstm_chunk(*a), args, cot)
    assert_close(got, want, "outputs")
    assert_close(tg, jg, "gradients")


@pytest.mark.parametrize("s", [1, 7, 24, 37])
def test_mlstm_parallel_matches_reference(s):
    """Chunks of CHUNK: S = 1 and 7 one chunk, 24 three, 37 five (the last
    short): h, the final (C, n, m) and the gradients."""
    rng = np.random.default_rng(s)
    args = mlstm_inputs(rng, s)
    b, h, _, dh = args[0].shape
    cot = cotangents(rng, [(b, h, dh, dh), (b, h), (b, h, dh),
                           (b, h, s, dh)])

    def ref(*a):
        hs, st = jx._mlstm_parallel(*a, chunk=CHUNK)
        return (st, hs)     # leaves: C, m, n (sorted keys), then h

    def port(*a):
        hs, st = tx._mlstm_parallel(*a, chunk=CHUNK)
        return (st, hs)
    want, jg = jgrad(ref, args, cot)
    got, tg = tgrad(port, args, cot)
    assert_close(got, want, "outputs")
    assert_close(tg, jg, "gradients")


def test_mlstm_parallel_ties_and_remat():
    """The tie fixture over three chunks, with and without recomputation
    of each chunk: the same outputs and gradients (bit for bit), within
    FN_REL of the reference's."""
    rng = np.random.default_rng(8)
    args = mlstm_inputs(rng, 21, ties=True)
    b, h, s, dh = args[0].shape
    cot = cotangents(rng, [(b, h, dh, dh), (b, h), (b, h, dh),
                           (b, h, s, dh)])
    want, jg = jgrad(lambda *a: tuple(reversed(jx._mlstm_parallel(
        *a, chunk=CHUNK))), args, cot)
    runs = [tgrad(lambda *a: tuple(reversed(tx._mlstm_parallel(
        *a, chunk=CHUNK, remat=r))), args, cot) for r in (False, True)]
    for got, tg in runs:
        assert_close(got, want, "outputs")
        assert_close(tg, jg, "gradients")
    for x, y in zip(runs[0][1], runs[1][1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("ties", [False, True], ids=["general", "ties"])
def test_mlstm_step_matches_reference(ties):
    """One decode step, q / k / v in bf16 (the outer product v k^T and q /
    sqrt(dh) round to bf16 as the reference's do), from a carried state:
    h, the new state and the gradients of the f32 inputs."""
    rng = np.random.default_rng(3 + ties)
    q, k, v, i, f = (x[:, :, 0] for x in mlstm_inputs(rng, 1, ties=ties))
    c0, n0, m0 = mlstm_state(rng)
    if ties:
        m0[:] = 0.0
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
               for x in (q, k, v))
    cot = cotangents(rng, [c0.shape, m0.shape, n0.shape, q.shape])

    def ref(i_raw, f_raw, c, n, m):
        bq, bk, bv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        hh, st = jx._mlstm_step(bq, bk, bv, i_raw, f_raw,
                                {"C": c, "n": n, "m": m})
        return (st, hh)

    def port(i_raw, f_raw, c, n, m):
        bq, bk, bv = (torch.from_numpy(np.array(x)).to(torch.bfloat16)
                      for x in (q, k, v))
        hh, st = tx._mlstm_step(bq, bk, bv, i_raw, f_raw,
                                {"C": c, "n": n, "m": m})
        return (st, hh)
    args = [i, f, c0, n0, m0]
    want, jg = jgrad(ref, args, cot)
    got, tg = tgrad(port, args, cot)
    assert_close(got, want, "outputs")
    assert_close(tg, jg, "gradients")


def slstm_inputs(rng, s, d=32, h=2, ties=False):
    """The params {"r_zifo"} (H, dh, 4 dh) and z_in (B, S, 4D). With
    `ties`: r_zifo zero, i pre-activations in {-1, 0} and f = 200 (log
    sigmoid -0.0) or 0 at random: m_new's two operands tie, and n = 1
    ties with max(n, 1)."""
    dh = d // h
    r = (rng.normal(size=(h, dh, 4 * dh)) / np.sqrt(dh)).astype(np.float32)
    z = rng.normal(size=(2, s, 4 * d)).astype(np.float32)
    if ties:
        r[:] = 0.0
        z[..., d:2 * d] = rng.integers(-1, 1, (2, s, d))
        z[..., 2 * d:3 * d] = np.where(rng.random((2, s, d)) < 0.5, 200.0,
                                       0.0)
    return r, z


@pytest.mark.parametrize("carried", [False, True],
                         ids=["from_zeros", "carried"])
@pytest.mark.parametrize("ties", [False, True], ids=["general", "ties"])
def test_slstm_scan_matches_reference(carried, ties):
    """The loop over S = 13 steps: the outputs, the final (h, c, n, m) and
    the gradients of z_in, r_zifo and the carry."""
    rng = np.random.default_rng(5 + 2 * carried + ties)
    r, z = slstm_inputs(rng, 13, ties=ties)
    b, s, d = 2, 13, 32
    carry = [np.zeros((b, d), np.float32) for _ in range(4)]
    if carried:
        carry = [rng.normal(size=(b, d)).astype(np.float32) * 0.5,
                 rng.normal(size=(b, d)).astype(np.float32),
                 np.abs(rng.normal(size=(b, d))).astype(np.float32) + 0.5,
                 rng.normal(size=(b, d)).astype(np.float32)]
    cot = cotangents(rng, [(b, s, d)] + [(b, d)] * 4)
    args = [r, z, *carry]
    want, jg = jgrad(lambda r_, z_, *c: jx._slstm_scan({"r_zifo": r_},
                                                        z_, *c), args, cot)
    got, tg = tgrad(lambda r_, z_, *c: tx._slstm_scan({"r_zifo": r_},
                                                       z_, *c), args, cot)
    assert_close(got, want, "outputs")
    assert_close(tg, jg, "gradients")
    if ties and not carried:
        # The fixture ties: after the first step n = 1 where i >= log f.
        zeros = [torch.zeros((b, d)) for _ in range(4)]
        _, (_, _, n1, _) = tx._slstm_scan({"r_zifo": torch.from_numpy(r)},
                                          torch.from_numpy(z[:, :1]), *zeros)
        assert bool((n1 == 1.0).any())


# ---------------------------------------------------------------------------
# the blocks at the reference's weights
# ---------------------------------------------------------------------------

def block_state(kind, rng, cfg):
    if kind == "mlstm":
        inner = int(cfg.d_model * cfg.ssm_proj_factor)
        dh = inner // cfg.n_heads
        c, n, m = mlstm_state(rng, b=B, h=cfg.n_heads, dh=dh)
        return {"C": c, "n": n, "m": m}
    d = cfg.d_model
    return {"h": rng.normal(size=(B, d)).astype(np.float32) * 0.5,
            "c": rng.normal(size=(B, d)).astype(np.float32),
            "n": np.abs(rng.normal(size=(B, d))).astype(np.float32) + 0.5,
            "m": rng.normal(size=(B, d)).astype(np.float32)}


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_matches_reference(kind, mode):
    """The block at the reference's weights (layer 0 or 3 of its smoke
    tree), S = 19 (three chunks) or 1 (decode), from a carried state in
    prefill and decode (an mLSTM prefill ignores it, as the reference's
    does): the output and the new state."""
    jcfg, tcfg = cfgs()
    layer = "layer_0" if kind == "mlstm" else "layer_3"
    p = ref_params()["decoder"][layer][kind]
    rng = np.random.default_rng(9)
    s = 1 if mode == "decode" else 19
    x = np.asarray(jnp.asarray(rng.normal(size=(B, s, tcfg.d_model)),
                               jnp.bfloat16).astype(jnp.float32))
    state = None if mode == "train" else block_state(kind, rng, tcfg)
    jblock = jx.mlstm_block if kind == "mlstm" else jx.slstm_block
    tblock = tx.mlstm_block if kind == "mlstm" else tx.slstm_block

    def ref(pp, xx, st):
        return jblock(pp, xx.astype(jnp.bfloat16), cfg=jcfg,
                      qcfg=jcfg.policy.quant, qkey=None, mode=mode, state=st)
    want, wst = jax.jit(ref, compiler_options=PER_OP)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
        None if state is None else {k: jnp.asarray(v)
                                    for k, v in state.items()})
    got, gst = tblock(
        tmap(lambda a: torch.from_numpy(np.array(a)), p),
        torch.from_numpy(np.array(x)).to(torch.bfloat16), cfg=tcfg,
        qcfg=tcfg.policy.quant, mode=mode,
        state=None if state is None else {
            k: torch.from_numpy(v) for k, v in state.items()})
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert rel_l2(got, want) <= BLOCK_REL_L2
    assert (gst is None) == (wst is None)
    if gst is not None:
        assert gst.keys() == wst.keys()
        for k in gst:
            assert gst[k].dtype == torch.float32
            assert max_rel(gst[k], wst[k]) <= FN_REL, k


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_prefill_then_decode_equals_train_forward():
    """A prompt of 13 tokens prefilled (two chunks of 8), then 6 tokens
    decoded one at a time (past position 16, the next chunk boundary of
    the train forward): each step's logits equal the train forward's at
    that position within the reference test's bound (baseline numerics,
    tests/test_models.py::test_decode_matches_train)."""
    _, tcfg = cfgs()
    tcfg = tcfg.replace(policy=tpp.BASELINE_POLICY)
    params = ttr.init_lm(tcfg, seed=1, device="cpu")
    p_len, n_dec = 13, 6
    tokens = torch.from_numpy(batch_for(tcfg.vocab_size, seed=2,
                                        s=p_len + n_dec)["tokens"]).long()
    with torch.no_grad():
        full, _ = ttr.forward(params, tokens, cfg=tcfg)
        states = ttr.init_stack_state(tcfg, B, 64, device="cpu")
        assert set(states["layer_0"]["rec"]) == {"C", "n", "m"}
        assert set(states["layer_3"]["rec"]) == {"h", "c", "n", "m"}
        logits, states = ttr.forward(params, tokens[:, :p_len], cfg=tcfg,
                                     mode="prefill", states=states)
        steps = [logits[:, -1]]
        for t in range(p_len, p_len + n_dec - 1):
            pos = torch.full((B, 1), t, dtype=torch.long)
            ld, states = ttr.forward(params, tokens[:, t:t + 1], cfg=tcfg,
                                     mode="decode", states=states,
                                     positions=pos)
            steps.append(ld[:, 0])
    for i, got in enumerate(steps):
        want = full[:, p_len - 1 + i]
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) < max(0.05 * scale, 0.05), i



@functools.lru_cache(maxsize=None)
def hybrid_setup():
    """The hybrid recipe with delayed scaling on the fused path (RNE),
    chunks of CHUNK at S = 12 (two chunks: a short one follows a whole
    one; S = 28's four cost the compile 7 s more), from the ScaleState one
    port step left
    (the reference's weights, one seeded batch): the reference's logits,
    scaled loss and gradients on `pallas_interpret` (one compile), the
    port's on its kernels' plain versions. The ScaleState's margin is 8,
    not 2: at 2, layer 0's wk error amax reads 512 in the reference and
    576 in the port (one e5m2 notch apart, as the rest of the chain
    differs), past the 512 that the scale holds, so one of them turns
    that cotangent into inf and the other does not."""
    jcfg, tcfg = cfgs(scaling="delayed", backend="pallas_interpret")
    jp = jax.jit(jtr.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    host = jax.tree_util.tree_map(np.asarray, jp)
    batch = batch_for(tcfg.vocab_size, seed=3, s=12)
    reg = t_discover(tcfg, from_jax_params(host, tcfg, device="cpu"), batch)
    ds = TDelayedScaling(reg, qcfg=tcfg.policy.quant,
                         config=TScalingConfig(margin=8.0))
    opt = t_make_optimizer_for(tcfg, learning_rate=1e-3)
    step = t_make_train_step(tcfg, opt, scaling=ds, device="cpu")
    (_, ss1), met = step(opt.init(from_jax_params(host, tcfg, device="cpu")),
                         ds.init(), batch, torch.Generator().manual_seed(0))
    assert np.all(np.isfinite(ss1.scale)) and np.isfinite(met["loss"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jds = JDelayedScaling(discover_lm_sites(jcfg, jp, jb),
                          qcfg=jcfg.policy.quant)
    assert jds.registry.keys == reg.keys
    jopt = j_make_optimizer_for(jcfg, learning_rate=1e-3)
    jst = jopt.init(jp)
    jss = JScaleState(amax_history=jnp.asarray(ss1.amax_history),
                      scale=jnp.asarray(ss1.scale),
                      step=jnp.asarray(1, jnp.int32))

    def loss_fn(params, tokens, scale_state):
        with jds.collect(scale_state, tokens):
            logits, _, _ = jtr.forward(params, jb["tokens"], cfg=jcfg)
            loss, _ = jtr.lm_loss(params, jb, cfg=jcfg,
                                  qkey=jax.random.PRNGKey(0),
                                  loss_scale=jst.loss_scale.scale)
        return loss, logits
    (want_loss, want_logits), (want_grads, _) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True), compiler_options=PER_OP)(
            jopt.compute_params(jst), jds.zero_tokens(), jss)
    st = opt.init(from_jax_params(host, tcfg, device="cpu"))
    params = tmap(lambda p: p.requires_grad_(True), opt.compute_params(st))
    with ds.collect(TScaleState(amax_history=ss1.amax_history,
                                scale=ss1.scale, step=1)):
        with torch.no_grad():
            logits, _ = ttr.forward(params, torch.from_numpy(
                batch["tokens"]), cfg=tcfg)
        loss, _ = ttr.lm_loss(params, batch, cfg=tcfg,
                              qgen=torch.Generator().manual_seed(0),
                              loss_scale=st.loss_scale.scale)
        loss.backward()
    want = from_jax_params(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), want_grads), tcfg, device="cpu")
    return dict(
        want=(want_logits, float(want_loss), want),
        got=(logits, loss.item(),
             tmap(lambda p: p.grad.float().numpy(), params)),
        master=st.master)


def test_forward_and_lm_loss_match_reference():
    """The forward's logits and the scaled loss (hybrid delayed, fused
    path, two chunks) against the reference's."""
    s = hybrid_setup()
    (want_logits, want_loss, _), (logits, loss, _) = s["want"], s["got"]
    assert logits.shape == want_logits.shape
    assert rel_l2(logits, want_logits) <= LOGITS_REL_L2
    assert abs(loss - want_loss) <= LOSS_REL * abs(want_loss)


def test_hybrid_delayed_step_matches_reference():
    """The step's gradients of every leaf against the reference's
    (GRAD_REL_L2), finite; the fp16 master copy covers r_zifo, as the
    reference's core/master_weights.py does every leaf."""
    s = hybrid_setup()
    want, grads = s["want"][2], s["got"][2]
    assert grad_rel_l2(want, grads) <= GRAD_REL_L2
    assert all(np.all(np.isfinite(g)) for g in flat(grads).values())
    r_zifo = s["master"]["decoder"]["layer_3"]["slstm"]["r_zifo"]
    assert r_zifo.dtype == torch.float16 and r_zifo.shape == (2, 32, 128)


def test_registry_matches_reference():
    """Keys and token sites in the reference's order on the fused path
    (its unscanned keys are the port's): the mLSTM's seven projections and
    the sLSTM's w_zifo and FFN sites at the layer's scope."""
    jcfg, tcfg = cfgs(scaling="delayed", backend="pallas_interpret")
    batch = batch_for(tcfg.vocab_size, s=16)
    jp = jax.eval_shape(lambda: jtr.init_lm(jax.random.PRNGKey(0), jcfg))
    want = discover_lm_sites(jcfg, jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    got = t_discover(tcfg, ttr.init_lm(tcfg, device="cpu"), batch)
    assert got.keys == want.keys and got.token_sites == want.token_sites
    for site in ("w_up", "w_gate", "wq", "wk", "wv", "w_if", "w_down"):
        assert f"decoder/layer_1/{site}#b.W" in got.keys, site
    for site in ("w_zifo", "ff_up", "ff_gate", "ff_down"):
        assert f"decoder/layer_3/{site}#y.A" in got.keys, site


# ---------------------------------------------------------------------------
# serving: calibration and the fixed-slot engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def serving_setup():
    """Reference and port configs under delayed scaling ("xla" backends),
    the reference's weights, and scales the port calibrated on two seeded
    batches, frozen."""
    jcfg, tcfg = cfgs(scaling="delayed")
    jp = ref_params()
    tp = from_jax_params(jp, tcfg, device="cpu")
    batches = [{"tokens": batch_for(tcfg.vocab_size, seed=s, s=16)["tokens"]}
               for s in (6, 7)]
    frozen = tcal.freeze(*tcal.calibrate(tp, tcfg, batches))
    return jcfg, tcfg, jp, tp, frozen


def test_calibrated_keys_match_reference():
    """The frozen W/A sites (every projection's #a.A and #b.W) of the
    port's calibration are those the reference freezes from its registry
    (its freeze keeps the W/A keys of the registry, in order), with finite
    positive scales."""
    jcfg, _, jp, _, frozen = serving_setup()
    batch = batch_for(jcfg.vocab_size, s=16)
    jds = JDelayedScaling(discover_lm_sites(jcfg, jp, {
        k: jnp.asarray(v) for k, v in batch.items()}), qcfg=jcfg.policy.quant)
    assert list(frozen) == list(jds.freeze(jds.init()))
    for site in ("w_if#a.A", "w_if#b.W", "w_down#a.A"):
        assert f"decoder/layer_2/{site}" in frozen
    for site in ("w_zifo#b.W", "ff_down#a.A"):
        assert f"decoder/layer_3/{site}" in frozen
    vals = np.array(list(frozen.values()))
    assert np.all(np.isfinite(vals)) and np.all(vals > 0)


def serve_all(eng, prompts, max_new):
    """Admit the prompts in turn as slots free (one slot is reused once
    there are more prompts than slots); their greedy streams in order."""
    uids, out = [], {}
    for p, n in zip(prompts, max_new):
        while not eng.free_slots():
            out.update(eng.step())
        uids.append(eng.add_request(p, max_new_tokens=n))
    out.update(eng.run_to_completion())
    return [out[u] for u in uids]


def engine_prompts(vocab):
    """Five prompts of 12 > CHUNK tokens (one length: the reference compiles
    its prefill once); the first request ends first, so the fifth is
    admitted into its slot while the others decode."""
    rng = np.random.default_rng(11)
    return ([rng.integers(0, vocab, 12).astype(np.int32) for _ in range(5)],
            [2, 6, 6, 6, 5])


def test_engine_streams_match_reference():
    """The fixed-slot engines, 4 slots and 5 requests under the port's
    frozen scales: the port's greedy streams are the reference's, token
    for token, through the mLSTM's and sLSTM's states, with a reused slot
    (the fifth request's sLSTM prefill starts from what slot 0 carries)."""
    jcfg, tcfg, jp, tp, frozen = serving_setup()
    prompts, max_new = engine_prompts(tcfg.vocab_size)
    serve = dict(max_batch=4, max_len=64)
    jeng = ServeEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, jp),
                       ServeConfig(**serve), frozen_scales=frozen)
    jeng._prefill = jax.jit(make_serve_prefill(jcfg, frozen),
                            compiler_options=PER_OP)
    jeng._decode = jax.jit(make_serve_decode(jcfg, frozen),
                           compiler_options=PER_OP)
    want = serve_all(jeng, prompts, max_new)
    teng = TServeEngine(tcfg, tp, TServeConfig(**serve),
                        frozen_scales=frozen, device="cpu")
    got = serve_all(teng, prompts, max_new)
    assert got == want
    assert [len(x) for x in got] == max_new
    assert teng.stats()["finished"] == 5


def test_reused_slot_slstm_prefill_starts_from_its_state(monkeypatch):
    """Kept from the reference: a prefill passes the slot's carried state
    to the sLSTM, whose loop starts from it (left by an earlier request,
    or by decode steps over the idle row); the mLSTM's prefill starts from
    zero whatever the slot carries. A prompt admitted into a reused slot:
    the sLSTM's new row state is the loop's from the carried one and
    differs from a loop from zeros; the mLSTM's row state is that of a
    prefill from a zero state and ignores the carried one; the other
    rows keep their states."""
    _, tcfg, _, tp, frozen = serving_setup()
    prompts, _ = engine_prompts(tcfg.vocab_size)
    eng = TServeEngine(tcfg, tp, TServeConfig(max_batch=2, max_len=64),
                       frozen_scales=frozen, device="cpu")
    eng.add_request(prompts[0], max_new_tokens=2)
    eng.add_request(prompts[1], max_new_tokens=6)
    assert eng.step() and eng.slots[0] is None   # slot 0 frees
    eng.step()                                   # a decode over idle row 0
    recs = {k: eng.states[f"layer_{i}"]["rec"] for i, k in ((0, "mlstm"),
                                                           (3, "slstm"))}
    carried = {k: {n: v.clone() for n, v in r.items()}
               for k, r in recs.items()}
    assert bool(carried["slstm"]["c"][0].abs().sum() > 0)
    assert bool(carried["mlstm"]["C"][0].abs().sum() > 0)
    seen = {}

    def spy(orig, kind):
        def block(p, x, **kw):
            y, st = orig(p, x, **kw)
            if kw["mode"] == "prefill" and kind not in seen:
                zero = {n: torch.zeros_like(v)
                        for n, v in kw["state"].items()}
                seen[kind] = dict(
                    given={n: v.clone() for n, v in kw["state"].items()},
                    new={n: v.clone() for n, v in st.items()},
                    from_zero=orig(p, x, **dict(kw, state=zero))[1])
            return y, st
        return block

    monkeypatch.setattr(ttr, "mlstm_block", spy(tx.mlstm_block, "mlstm"))
    monkeypatch.setattr(ttr, "slstm_block", spy(tx.slstm_block, "slstm"))
    eng.add_request(prompts[2], max_new_tokens=1)
    assert eng.slots[0] is not None
    for kind in ("mlstm", "slstm"):
        s = seen[kind]
        for n in s["new"]:
            np.testing.assert_array_equal(f32(s["given"][n]),
                                          f32(carried[kind][n]))
            np.testing.assert_array_equal(f32(recs[kind][n][0]),
                                          f32(s["new"][n][0]))
            np.testing.assert_array_equal(f32(recs[kind][n][1]),
                                          f32(carried[kind][n][1]))
    for n in ("C", "n", "m"):
        np.testing.assert_array_equal(f32(seen["mlstm"]["new"][n][0]),
                                      f32(seen["mlstm"]["from_zero"][n][0]))
    assert not torch.equal(seen["slstm"]["from_zero"]["c"][0],
                           seen["slstm"]["new"]["c"][0])


# ---------------------------------------------------------------------------
# recomputation, the launchers, the paged path
# ---------------------------------------------------------------------------

def test_remat_xlstm_layers_bit_for_bit():
    """Eight layers (two groups, the reference's scanned stack recomputed,
    each mLSTM chunk within it too): the hybrid delayed step's loss and
    gradients with SR on, with recomputation, equal those without it bit
    for bit."""
    _, tcfg = cfgs(scaling="delayed", backend="pallas", act_rounding="sr",
                   error_rounding="sr", grad_rounding="sr")
    tcfg = tcfg.replace(n_layers=8)
    assert ttr._remat(tcfg.replace(remat=True), 8, 4) == 8
    params = ttr.init_lm(tcfg, seed=3, device="cpu")
    batch = batch_for(tcfg.vocab_size, seed=4, s=20)
    ds = TDelayedScaling(t_discover(tcfg, params, batch),
                         qcfg=tcfg.policy.quant)
    out = []
    for remat in (False, True):
        p = tmap(lambda x: x.clone().requires_grad_(True), params)
        with ds.collect(ds.init()):
            loss, _ = ttr.lm_loss(p, batch, cfg=tcfg.replace(remat=remat),
                                  qgen=torch.Generator().manual_seed(9))
            loss.backward()
        out.append((loss.detach(), tmap(lambda x: x.grad, p)))
    assert torch.equal(out[0][0], out[1][0])
    for k, v in flat(out[0][1]).items():
        assert torch.equal(v, flat(out[1][1])[k]), k


def test_launchers_run_xlstm(tmp_path, capsys):
    """`launch/train.py --arch xlstm-125m` (the config's paper recipe) and
    `launch/serve.py --arch xlstm-125m --legacy` on the CPU."""
    out = tlaunch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--steps", "2", "--batch", "2", "--seq", "12",
                              "--ckpt-dir", str(tmp_path)])
    assert out["last_step"] == 2 and np.isfinite(out["metrics"]["loss"])
    eng = tlaunch_serve.main(["--arch", ARCH, "--smoke", "--legacy",
                              "--device", "cpu", "--n-requests", "5"])
    assert eng.stats()["finished"] == 5
    assert "all requests served" in capsys.readouterr().out


def test_paged_serving_refuses_the_xlstm_stack():
    """The reference's ValueError from every paged path (the config check,
    its pools, the engine, the chunk step, the launcher without
    --legacy); the fixed-slot engine takes the stack."""
    jcfg, tcfg = cfgs()
    params = ttr.init_lm(tcfg, device="cpu")
    with pytest.raises(ValueError, match=PAGED):
        jtr.init_paged_stack_state(jcfg, 64, n_layers=jcfg.n_layers)
    for make in (lambda: tcfg.check_ported(serving=True, paged=True),
                 lambda: ttr.init_paged_stack_state(tcfg, 64, device="cpu"),
                 lambda: TPagedEngine(tcfg, params, TPagedConfig(),
                                      device="cpu"),
                 lambda: make_serve_chunk(tcfg),
                 lambda: tlaunch_serve.main(["--arch", ARCH, "--smoke",
                                             "--device", "cpu"])):
        with pytest.raises(ValueError, match=PAGED):
            make()
    TServeEngine(tcfg, params, TServeConfig(max_batch=2, max_len=32),
                 device="cpu")
