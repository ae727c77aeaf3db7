"""recurrentgemma-9b, the RG-LRU / local-attention hybrid, against `repro`
on the CPU at smoke size (a window of W = 8 positions, so that sequences
of 12-32 tokens leave it and the ring of cache slots wraps):

  * the config's fields, full and smoke, are the reference's;
  * `from_jax_params` carries every leaf of the reference's 8-layer tree
    (scanned groups stack_0..2 and the remainder rem_0, rem_1) into
    layer_0..7;
  * the log-depth scan and the causal conv against the reference's (run
    op by op: bit for bit; jitted: within the limit XLA's fused
    multiply-adds leave), and `rglru_block` in its three modes at the
    reference's weights;
  * the forward logits, `lm_loss` and its gradients at the reference's
    weights (all-RNE hybrid formats at unit scales, "xla" backends), S = 32;
  * prefill -> decode equals the train forward (the port's counterpart of
    tests/test_models.py::test_decode_matches_train);
  * the fixed-slot `ServeEngine`'s greedy streams, bf16 and e5m2 KV cache,
    equal the reference engine's bit for bit (5 requests over 4 slots, so
    one slot is reused, prompts longer than the window), and a reused
    slot's prefill starts from the conv window the slot carries (the
    reference's behaviour, kept);
  * the site registry under delayed scaling, in the reference's order;
  * recomputation of an RG-LRU layer, bit for bit the step without it;
  * paged serving refuses the stack with the reference's ValueError.

The reference's jitted programs run with XLA's `xla_allow_excess_precision`
off, as in tests/test_torch_serve.py. Its model-level compiles: the
initializer at 3 and 8 layers, the forward with its loss and gradients,
and the engine's prefill and decode on each cache (one prompt length);
the block-level checks run it op by op (the scan and conv jitted too:
tiny programs). About 65 s alone on one torch thread.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision_policy import PrecisionPolicy, QuantConfig
from repro.models import rglru as jrg
from repro.models import transformer as jtr
from repro.models.registry import build_config as j_build_config
from repro.scaling import discover_lm_sites
from repro.serve import ServeConfig, ServeEngine
from repro.train.step import make_serve_decode, make_serve_prefill
from repro_torch.core import precision_policy as tpp
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.models import rglru as trg
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import ARCHS, build_config
from repro_torch.optim.optimizers import tmap
from repro_torch.scaling import calibrate as tcal
from repro_torch.scaling.calibrate import discover_lm_sites as t_discover
from repro_torch.serve.engine import PagedServeConfig as TPagedConfig
from repro_torch.serve.engine import PagedServeEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.engine import ServeEngine as TServeEngine
from repro_torch.train.step import make_serve_chunk

jax.config.update("jax_platform_name", "cpu")

ARCH = "recurrentgemma-9b"
PER_OP = {"xla_allow_excess_precision": False}
RNE = dict(act_rounding="rne", error_rounding="rne", grad_rounding="rne")
W = 8            # the window of the tests' configs
B, S = 2, 32     # S > W: the window bites
# Limits, as in tests/test_torch_archs.py (all-RNE, unit scales): the
# logits' rel L2, the loss (relative), the gradients' rel L2 of all
# leaves together.
LOGITS_REL_L2 = 1e-4
LOSS_REL = 1e-5
GRAD_REL_L2 = 0.35
# The scan and the f32 conv against the reference jitted: XLA contracts
# a * h + b into fused multiply-adds, which round once where the port
# rounds twice. Read on the CPU: at most 9.5e-7 of max|h| (S = 4096) and
# 4.8e-7 (conv). Op by op the reference rounds as the port does: equal.
JIT_REL = 2e-6
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
    """(reference, port) smoke configs at window W without remat: the
    hybrid recipe's formats, by default all-RNE at unit scales on the "xla"
    backends; `quant` overrides the QuantConfig fields."""
    q = dict(recipe="hybrid", backend="xla", **RNE)
    q.update(quant)
    tq = dict(q, backend="pallas_interpret" if q["backend"] != "xla"
              else "xla")
    return (j_build_config(ARCH, smoke=True).replace(
                policy=PrecisionPolicy(quant=QuantConfig(**q)), remat=False,
                window=W),
            build_config(ARCH, smoke=True).replace(
                policy=tpp.PrecisionPolicy(quant=tpp.QuantConfig(**tq)),
                remat=False, window=W))


def with_kv(cfg, fmt):
    return cfg.replace(policy=dataclasses.replace(cfg.policy,
                                                  kv_cache_format=fmt))


@functools.lru_cache(maxsize=None)
def ref_params(n_layers=3):
    """The reference's smoke weights at `n_layers` (numpy leaves; scanned
    groups past one group, its default), one compile of its initializer."""
    jcfg, _ = cfgs()
    jcfg = jcfg.replace(n_layers=n_layers)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jtr.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg))


def batch_for(vocab, seed=0, s=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, s)).astype(np.int32)}


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
    assert cfg.layer_kinds()[-2:] == ("rglru", "rglru")
    assert cfg.resolved_head_dim == 256


def test_from_jax_params_covers_every_leaf_at_8_layers():
    """Eight layers: the reference's tree holds stack_0..2 (two groups
    each) and rem_0, rem_1; each lands in its layer_{i} bit for bit, with
    the rglru leaves, in the shapes of the port's own init_lm."""
    _, tcfg = cfgs()
    tcfg = tcfg.replace(n_layers=8)
    jp = ref_params(8)
    assert set(jp["decoder"]) == {"stack_0", "stack_1", "stack_2", "rem_0",
                                  "rem_1"}
    tp = from_jax_params(jp, tcfg, device="cpu")
    assert list(tp["decoder"]) == [f"layer_{i}" for i in range(8)]
    n_ref = sum(int(np.shape(x)[0]) if "/stack_" in k else 1
                for k, x in flat(jp).items())
    assert len(flat(tp)) == n_ref
    for i in range(8):
        src = jp["decoder"][f"stack_{i % 3}"] if i < 6 \
            else jp["decoder"][f"rem_{i - 6}"]
        want = flat(jax.tree_util.tree_map(lambda x: x[i // 3], src)
                    if i < 6 else src)
        got = flat(tp["decoder"][f"layer_{i}"])
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(f32(got[k]), v)
    assert set(tp["decoder"]["layer_7"]["rglru"]) \
        == {"wx", "wg", "wa", "wi", "lam", "conv", "wo"}
    assert "attn" in tp["decoder"]["layer_5"]
    own = ttr.init_lm(tcfg, device="cpu")
    assert tmap(lambda x: tuple(x.shape), tp) \
        == tmap(lambda x: tuple(x.shape), own)
    # The port's own Lambda init: a = exp(-8 softplus(lam)) in [0.9, 0.999].
    lam = own["decoder"]["layer_0"]["rglru"]["lam"]
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 7, 32, 4096])
def test_scan_matches_reference(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32)
    g = rng.normal(size=(2, s, 8)).astype(np.float32)
    got = trg._rglru_scan(torch.from_numpy(g), torch.from_numpy(a)).numpy()
    with jax.disable_jit():
        eager = np.asarray(jrg._rglru_scan(jnp.asarray(g), jnp.asarray(a)))
    np.testing.assert_array_equal(got, eager)
    jit = np.asarray(jax.jit(jrg._rglru_scan)(jnp.asarray(g),
                                              jnp.asarray(a)))
    assert np.abs(got - jit).max() <= JIT_REL * np.abs(jit).max()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(dtype, with_state):
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 9, 16)), jnp.float32).astype(dtype)
    kernel = rng.normal(size=(4, 16)).astype(np.float32)
    state = jnp.asarray(rng.normal(size=(2, 3, 16)), jnp.bfloat16) \
        if with_state else None

    def t(v, dt):
        return None if v is None else torch.from_numpy(
            np.array(v.astype(jnp.float32))).to(dt)
    got = trg._causal_conv(t(x, getattr(torch, dtype)),
                           torch.from_numpy(kernel), t(state, torch.bfloat16))
    with jax.disable_jit():
        eager = jrg._causal_conv(x, jnp.asarray(kernel), state)
    jit = jax.jit(jrg._causal_conv)(x, jnp.asarray(kernel), state)
    for g, e, j in zip(got, eager, jit):
        assert str(g.dtype).endswith(dtype)
        np.testing.assert_array_equal(f32(g), f32(e))
        assert np.abs(f32(g) - f32(j)).max() \
            <= JIT_REL * np.abs(f32(j)).max()


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_rglru_block_matches_reference(mode):
    """The block at the reference's weights (layer 0 of its smoke tree),
    the reference run op by op: the outputs and the conv state bit for bit,
    h within JIT_REL; the prefill's conv starting from a carried window,
    the decode from a carried (h, conv)."""
    jcfg, tcfg = cfgs()
    p = ref_params()["decoder"]["layer_0"]["rglru"]
    rng = np.random.default_rng(5)
    s = 1 if mode == "decode" else 12
    x = jnp.asarray(rng.normal(size=(B, s, tcfg.d_model)),
                    jnp.float32).astype(jnp.bfloat16)
    state = None
    if mode != "train":
        state = {"h": jnp.asarray(rng.normal(size=(B, tcfg.lru_dim)),
                                  jnp.float32),
                 "conv": jnp.asarray(rng.normal(size=(B, 3, tcfg.lru_dim)),
                                     jnp.bfloat16)}
    with jax.disable_jit():
        want, wst = jrg.rglru_block(
            jax.tree_util.tree_map(jnp.asarray, p), x, cfg=jcfg,
            qcfg=jcfg.policy.quant, qkey=None, mode=mode, state=state)
    tst = None if state is None else {
        k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
            torch.float32 if k == "h" else torch.bfloat16)
        for k, v in state.items()}
    got, gst = trg.rglru_block(
        {k: torch.from_numpy(np.array(v)) for k, v in p.items()},
        torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16), cfg=tcfg, qcfg=tcfg.policy.quant, mode=mode,
        state=tst)
    np.testing.assert_array_equal(f32(got), f32(want))
    assert (gst is None) == (wst is None)
    if gst is not None:
        assert gst["h"].dtype == torch.float32
        assert gst["conv"].dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(gst["conv"]), f32(wst["conv"]))
        # h in f32: XLA's sigmoid, softplus and exp round a last bit
        # otherwise than torch's now and then (the scan itself is equal).
        h, hw = f32(gst["h"]), f32(wst["h"])
        assert np.abs(h - hw).max() <= JIT_REL * np.abs(hw).max()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_and_lm_loss_match_reference():
    jcfg, tcfg = cfgs()
    jp = ref_params()
    batch = batch_for(tcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def run(p):
        logits, _, _ = jtr.forward(p, jb["tokens"], cfg=jcfg)
        (loss, _), grads = jax.value_and_grad(
            lambda q: jtr.lm_loss(q, jb, cfg=jcfg), has_aux=True)(p)
        return logits, loss, grads

    logits_j, loss_j, grads_j = jax.jit(run, compiler_options=PER_OP)(
        jax.tree_util.tree_map(jnp.asarray, jp))
    tp = tmap(lambda x: x.requires_grad_(True),
              from_jax_params(jp, tcfg, device="cpu"))
    with torch.no_grad():
        logits, _ = ttr.forward(tp, torch.from_numpy(batch["tokens"]),
                                cfg=tcfg)
    loss, _ = ttr.lm_loss(tp, batch, cfg=tcfg)
    loss.backward()
    assert logits.shape == logits_j.shape
    assert rel_l2(logits, logits_j) <= LOGITS_REL_L2
    assert abs(loss.item() - float(loss_j)) <= LOSS_REL * abs(float(loss_j))
    want = from_jax_params(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), grads_j), tcfg, device="cpu")
    assert grad_rel_l2(want, tmap(lambda x: x.grad, tp)) <= GRAD_REL_L2


def test_prefill_then_decode_equals_train_forward():
    """A prompt of 20 > W tokens prefilled (the local layer's ring wraps),
    then 4 tokens decoded one at a time: each step's logits equal the
    train forward's at that position within the reference test's bound
    (baseline numerics)."""
    _, tcfg = cfgs()
    tcfg = tcfg.replace(policy=tpp.BASELINE_POLICY)
    params = ttr.init_lm(tcfg, seed=1, device="cpu")
    p_len, n_dec = 20, 4
    tokens = torch.from_numpy(batch_for(tcfg.vocab_size, seed=2,
                                        s=p_len + n_dec)["tokens"]).long()
    with torch.no_grad():
        full, _ = ttr.forward(params, tokens, cfg=tcfg)
        states = ttr.init_stack_state(tcfg, B, 64, device="cpu")
        assert states["layer_2"]["kv"]["k"].shape[1] == W
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
    slot_pos = states["layer_2"]["kv"]["slot_pos"]
    assert sorted(slot_pos[0].tolist()) == list(range(p_len + n_dec - 1 - W,
                                                      p_len + n_dec - 1))


@functools.lru_cache(maxsize=None)
def serving_setup():
    """Reference and port configs on the fused path (delayed, hybrid;
    "pallas_interpret" in the reference, the kernels' plain versions in
    the port), the reference's weights, and scales calibrated by the port
    with the e5m2 KV sites and without, frozen."""
    jcfg, tcfg = cfgs(scaling="delayed", backend="pallas_interpret",
                      act_rounding="sr", error_rounding="sr",
                      grad_rounding="sr")
    jp = ref_params()
    tp = from_jax_params(jp, tcfg, device="cpu")
    batches = [{"tokens": batch_for(tcfg.vocab_size, seed=s, s=16)["tokens"]}
               for s in (6, 7)]
    frozen = {kv: tcal.freeze(*tcal.calibrate(tp, with_kv(tcfg, kv),
                                              batches))
              for kv in (None, "e5m2")}
    return jcfg, tcfg, jp, tp, frozen


def serve_all(eng, prompts, max_new=6):
    """Admit the prompts in turn as slots free (one slot is reused once
    there are more prompts than slots); their greedy streams in order."""
    uids, out = [], {}
    for p in prompts:
        while not eng.free_slots():
            out.update(eng.step())
        uids.append(eng.add_request(p, max_new_tokens=max_new))
    out.update(eng.run_to_completion())
    return [out[u] for u in uids]


def engine_prompts(vocab):
    """Five prompts of 12 > W tokens (one length: the reference compiles its
    prefill once)."""
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, 12).astype(np.int32) for _ in range(5)]


@pytest.mark.parametrize("kv", [None, "e5m2"], ids=["bf16", "e5m2"])
def test_engine_streams_match_reference(kv):
    """The fixed-slot engines, 4 slots and 5 requests: the port's greedy
    streams are the reference's, token for token, through the local
    layer's ring (prefill past the window, decode wrapping) and the RG-LRU
    states, with a reused slot."""
    jcfg, tcfg, jp, tp, frozen = serving_setup()
    jcfg, tcfg = with_kv(jcfg, kv), with_kv(tcfg, kv)
    prompts = engine_prompts(tcfg.vocab_size)
    serve = dict(max_batch=4, max_len=64)
    jeng = ServeEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, jp),
                       ServeConfig(**serve), frozen_scales=frozen[kv])
    jeng._prefill = jax.jit(make_serve_prefill(jcfg, frozen[kv]),
                            compiler_options=PER_OP)
    jeng._decode = jax.jit(make_serve_decode(jcfg, frozen[kv]),
                           compiler_options=PER_OP)
    want = serve_all(jeng, prompts)
    teng = TServeEngine(tcfg, tp, TServeConfig(**serve),
                        frozen_scales=frozen[kv], device="cpu")
    assert teng.states["layer_2"]["kv"]["k"].shape[1] == W
    assert teng.states["layer_0"]["rec"]["conv"].dtype == torch.bfloat16
    got = serve_all(teng, prompts)
    assert got == want
    assert teng.stats()["finished"] == 5


def test_reused_slot_prefill_starts_from_its_conv_window(monkeypatch):
    """Kept from the reference: a prefill passes the slot's carried state
    to the RG-LRU, so its causal conv starts from the window an earlier
    request, or decode steps over the idle row, left there; h starts from
    zero. A prompt admitted into a reused slot: the state handed to the
    block is the carried one; the row's new (h, conv) is the prefill's
    from that conv, whatever the carried h, and differs from a prefill
    from a zero window; the other row keeps its state."""
    _, tcfg, _, tp, frozen = serving_setup()
    prompts = engine_prompts(tcfg.vocab_size)
    eng = TServeEngine(tcfg, tp, TServeConfig(max_batch=2, max_len=64),
                       frozen_scales=frozen[None], device="cpu")
    eng.add_request(prompts[0], max_new_tokens=2)
    eng.add_request(prompts[1], max_new_tokens=6)
    assert eng.step() and eng.slots[0] is None   # slot 0 frees
    eng.step()                                   # a decode over idle row 0
    rec = eng.states["layer_0"]["rec"]
    carried = {k: v.clone() for k, v in rec.items()}
    assert bool(carried["conv"][0].abs().sum() > 0)
    seen = {}
    orig = ttr.rglru_block

    def spy(p, x, **kw):
        y, st = orig(p, x, **kw)
        if kw["mode"] == "prefill" and not seen:
            other_h = dict(kw["state"], h=torch.full_like(kw["state"]["h"],
                                                          7.0))
            zero_conv = dict(kw["state"],
                             conv=torch.zeros_like(kw["state"]["conv"]))
            seen.update(given={k: v.clone() for k, v in kw["state"].items()},
                        new=st, other_h=orig(p, x, **dict(kw,
                                                          state=other_h))[1],
                        zero_conv=orig(p, x, **dict(kw,
                                                    state=zero_conv))[1])
        return y, st

    monkeypatch.setattr(ttr, "rglru_block", spy)
    eng.add_request(prompts[2], max_new_tokens=1)
    assert eng.slots[0] is not None
    for k in ("h", "conv"):
        np.testing.assert_array_equal(f32(seen["given"][k]),
                                      f32(carried[k]))
        np.testing.assert_array_equal(f32(rec[k][0]), f32(seen["new"][k][0]))
        np.testing.assert_array_equal(f32(seen["other_h"][k][0]),
                                      f32(seen["new"][k][0]))
        np.testing.assert_array_equal(f32(rec[k][1]), f32(carried[k][1]))
    assert not torch.equal(seen["zero_conv"]["h"][0], seen["new"]["h"][0])


# ---------------------------------------------------------------------------
# delayed scaling, recomputation, the paged path
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    """Keys and token sites in the reference's order (its unscanned keys
    are the port's): the RG-LRU layers' wx, wg, wa, wi, wo at the layer's
    scope and their MLP under "mlp", the local layer's attention sites."""
    jcfg, tcfg = cfgs(scaling="delayed", backend="pallas_interpret")
    jcfg = jcfg.replace(scan_layers=False)
    batch = batch_for(tcfg.vocab_size, s=16)
    jp = jax.eval_shape(lambda: jtr.init_lm(jax.random.PRNGKey(0), jcfg))
    want = discover_lm_sites(jcfg, jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    got = t_discover(tcfg, ttr.init_lm(tcfg, device="cpu"), batch)
    assert got.keys == want.keys and got.token_sites == want.token_sites
    for site in ("wx", "wg", "wa", "wi", "wo", "mlp/up"):
        assert f"decoder/layer_1/{site}#b.W" in got.keys, site
    assert "decoder/layer_2/attn/wq#y.A" in got.keys


def test_remat_rglru_layers_bit_for_bit():
    """Six layers (two groups, the reference's scanned stack recomputed):
    the hybrid delayed step's loss and gradients with SR on, with
    recomputation, equal those without it bit for bit."""
    _, tcfg = cfgs(scaling="delayed", backend="pallas_interpret",
                   act_rounding="sr", error_rounding="sr",
                   grad_rounding="sr")
    tcfg = tcfg.replace(n_layers=6)
    assert ttr._remat(tcfg.replace(remat=True), 6, 3) == 6
    params = ttr.init_lm(tcfg, seed=3, device="cpu")
    batch = batch_for(tcfg.vocab_size, seed=4, s=16)
    reg = t_discover(tcfg, params, batch)
    from repro_torch.scaling.state import DelayedScaling
    ds = DelayedScaling(reg, qcfg=tcfg.policy.quant)
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


def test_paged_serving_refuses_the_recurrent_stack():
    """The reference's ValueError from every paged path (its pools, the
    engine, the chunk step, the launcher without --legacy); the
    fixed-slot engine serves the stack."""
    _, tcfg = cfgs()
    params = ttr.init_lm(tcfg, device="cpu")
    jcfg, _ = cfgs()
    with pytest.raises(ValueError, match=PAGED):
        jtr.init_paged_stack_state(jcfg, 64, n_layers=jcfg.n_layers)
    for make in (lambda: ttr.init_paged_stack_state(tcfg, 64, device="cpu"),
                 lambda: TPagedEngine(tcfg, params, TPagedConfig(),
                                      device="cpu"),
                 lambda: make_serve_chunk(tcfg),
                 lambda: tlaunch_serve.main(["--arch", ARCH, "--smoke",
                                             "--device", "cpu"])):
        with pytest.raises(ValueError, match=PAGED):
            make()
    TServeEngine(tcfg, params, TServeConfig(max_batch=2, max_len=32),
                 device="cpu")
