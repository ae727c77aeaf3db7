"""The port's serving slice against `repro`: calibration + freeze, greedy
streams of the paged engine, and one serving step's logits, on the
configuration of `tests/test_paging.py::frozen_setup` (a 2-layer GQA
decoder, frozen calibrated scales, bf16 KV cache) for both recipes, with
the reference's weights carried over by `from_jax_params`.

The reference runs here with XLA's `xla_allow_excess_precision` off. With
it on (XLA's default), XLA may keep a bf16 intermediate in f32 inside a
fusion — skipping the per-op rounding the program writes — and the fp8
payloads downstream then differ by a notch here and there. The port rounds
every op as written; so does the reference without excess precision, and
then the two agree bit for bit. Against the default compile the step's
logits are held to a tolerance instead.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.fp8_attention.ops  # noqa: F401  (jitted before patching)
import repro.kernels.fused_quant_matmul.ops  # noqa: F401
from repro.core.precision_policy import PrecisionPolicy, QuantConfig
from repro.models.config import ModelConfig
from repro.models.transformer import init_lm, init_paged_stack_state
from repro.scaling.calibrate import calibrate, freeze
from repro.scaling.state import ScalingConfig
from repro.serve import PagedServeConfig, PagedServeEngine
from repro.serve import sampling as jsampling
from repro.serve.paging import flat_slots, gather_plan
from repro.train.step import make_serve_chunk
from repro_torch.core import precision_policy as tpp
from repro_torch.models import config as tmc
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_config
from repro_torch.models.transformer import \
    init_paged_stack_state as t_init_paged
from repro_torch.scaling.calibrate import calibrate as t_calibrate
from repro_torch.scaling.calibrate import freeze as t_freeze
from repro_torch.scaling.calibrate import freeze_with_formats
from repro_torch.scaling.state import ScalingConfig as TScalingConfig
from repro_torch.serve import sampling as tsampling
from repro_torch.serve.engine import PagedServeConfig as TServeConfig
from repro_torch.serve.engine import PagedServeEngine as TEngine
from repro_torch.train.step import make_optimizer_for, make_train_step
from repro_torch.train.step import make_serve_chunk as t_make_serve_chunk

jax.config.update("jax_platform_name", "cpu")

PER_OP = {"xla_allow_excess_precision": False}
PROMPTS = [np.array([3, 5, 7, 11, 13, 17, 19], np.int32),
           np.array([2, 4, 6], np.int32)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def per_op_rounding():
    """Top-level jits created inside compile with per-op bf16 rounding."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", functools.partial(jax.jit,
                                                 compiler_options=PER_OP))
        yield


def _cfgs(recipe):
    kw = dict(arch="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab_size=64, max_seq_len=64)
    jq = QuantConfig(recipe=recipe, scaling="delayed",
                     backend="pallas_interpret")
    tq = tpp.QuantConfig(recipe=recipe, scaling="delayed",
                         backend="pallas_interpret")
    return (ModelConfig(policy=PrecisionPolicy(quant=jq), remat=False,
                        scan_layers=False, **kw),
            tmc.ModelConfig(policy=tpp.PrecisionPolicy(quant=tq), **kw))


@pytest.fixture(scope="module", params=["hybrid", "paper_e5m2"])
def setup(request):
    cfg, tcfg = _cfgs(request.param)
    params = init_lm(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, 64, (2, 12)).astype(np.int32) for _ in range(2)]
    with per_op_rounding():
        ds, state = calibrate(params, cfg,
                              [{"tokens": jnp.asarray(t)} for t in toks],
                              scaling_cfg=ScalingConfig(margin=1.0))
    frozen = freeze(ds, state)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    tds, tstate = t_calibrate(tparams, tcfg, [{"tokens": t} for t in toks],
                              scaling_cfg=TScalingConfig(margin=1.0))
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                frozen=frozen, tds=tds, tstate=tstate)


def _jax_streams(cfg, params, frozen, chunk):
    eng = PagedServeEngine(cfg, params, PagedServeConfig(
        max_batch=2, max_len=64, n_pages=48, page_size=4, chunk_size=chunk,
        prefix_cache=False), frozen_scales=frozen)
    eng._step = jax.jit(eng._step.__wrapped__, compiler_options=PER_OP)
    uids = [eng.add_request(p, max_new_tokens=4) for p in PROMPTS]
    out = eng.run_to_completion()
    return [out[u] for u in uids]


def _torch_streams(tcfg, tparams, frozen, chunk, prefix_cache=False):
    eng = TEngine(tcfg, tparams, TServeConfig(
        max_batch=2, max_len=64, n_pages=48, page_size=4, chunk_size=chunk,
        prefix_cache=prefix_cache), frozen_scales=frozen, device="cpu")
    uids = [eng.add_request(p, max_new_tokens=4) for p in PROMPTS]
    out = eng.run_to_completion()
    return [out[u] for u in uids], eng


class TestCalibration:
    def test_same_sites_and_scales(self, setup):
        """calibrate + freeze: the reference's key set (unscanned keys) and
        the same f32 scale for every site."""
        tfrozen = t_freeze(setup["tds"], setup["tstate"])
        assert set(tfrozen) == set(setup["frozen"])
        assert tfrozen == setup["frozen"]

    def test_formats_sidecar(self, setup):
        _, formats = freeze_with_formats(setup["tds"], setup["tstate"])
        fmt = setup["tcfg"].policy.quant.fwd_format
        assert set(formats) == set(setup["frozen"])
        assert set(formats.values()) == {fmt}


class TestServing:
    @pytest.mark.parametrize("chunk", [1, 16])
    def test_greedy_streams_match(self, setup, chunk):
        """Fed the reference's frozen dict, the port's engine produces the
        reference engine's greedy streams (decode-only and chunked
        prefill)."""
        ref = _jax_streams(setup["cfg"], setup["params"], setup["frozen"],
                           chunk)
        got, eng = _torch_streams(setup["tcfg"], setup["tparams"],
                                  setup["frozen"], chunk)
        assert got == ref
        assert eng.pager.n_live == 0
        eng.pager.check()

    def test_step_logits(self, setup):
        """One chunked-prefill step: logits bit for bit against the per-op
        reference; within 0.25 (logits are O(1)) of XLA's default compile."""
        cfg, tcfg, frozen = setup["cfg"], setup["tcfg"], setup["frozen"]
        b, t, psize, cap = 2, 8, 4, 64
        lengths = [7, 3]
        tables = [[1, 2], [3]]
        batch = {"tokens": np.zeros((b, t), np.int32),
                 "positions": np.tile(np.arange(t, dtype=np.int32), (b, 1)),
                 "write_slots": np.zeros((b, t), np.int32),
                 "chunk_pos": np.array([[0, 7], [0, 3]], np.int32),
                 "last_row": np.array([6, 2], np.int32)}
        for i, p in enumerate(PROMPTS):
            batch["tokens"][i, :len(p)] = p
            batch["write_slots"][i, :len(p)] = flat_slots(tables[i], psize,
                                                          0, len(p))
        batch["read_slots"], batch["slot_pos"] = gather_plan(
            tables, lengths, psize, cap)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        step = make_serve_chunk(cfg, frozen)
        outs = []
        for opts in (PER_OP, None):
            st = init_paged_stack_state(cfg, 48 * psize, n_layers=2)
            lg, _ = jax.jit(step, compiler_options=opts)(setup["params"], jb,
                                                         st)
            outs.append(np.asarray(lg.astype(jnp.float32)))
        tst = t_init_paged(tcfg, 48 * psize, device="cpu")
        tl, _ = t_make_serve_chunk(tcfg, frozen)(
            setup["tparams"], {k: torch.from_numpy(v) for k, v in
                               batch.items()}, tst)
        tl = tl.float().numpy()
        np.testing.assert_array_equal(tl, outs[0])
        assert np.abs(tl - outs[1]).max() <= 0.25

    def test_prefix_cache_hit_equals_cold(self, setup):
        prompt = np.array([9, 8, 7, 6, 5, 4, 3, 2, 1], np.int32)
        eng = TEngine(setup["tcfg"], setup["tparams"], TServeConfig(
            max_batch=1, max_len=64, n_pages=48, page_size=4, chunk_size=8),
            frozen_scales=setup["frozen"], device="cpu")
        u1 = eng.add_request(prompt, max_new_tokens=3)
        cold = eng.run_to_completion()[u1]
        u2 = eng.add_request(prompt, max_new_tokens=3)
        warm = eng.run_to_completion()[u2]
        assert warm == cold
        assert eng.stats()["prefix_cache_hits"] == 1

    def test_refuses_format_mismatch(self, setup):
        bad = {k: "e5m2" if setup["tcfg"].policy.quant.fwd_format == "e4m3"
               else "e4m3" for k in setup["frozen"]}
        with pytest.raises(ValueError, match="calibrated under"):
            TEngine(setup["tcfg"], setup["tparams"], TServeConfig(),
                    frozen_scales=setup["frozen"], frozen_formats=bad,
                    device="cpu")


def test_engine_defaults_to_the_card():
    """Without device='cpu' the engine runs on CUDA — and raises when there
    is no card instead of falling back to the CPU."""
    _, tcfg = _cfgs("hybrid")
    if torch.cuda.is_available():
        assert TEngine(tcfg, {}, TServeConfig(n_pages=4)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TEngine(tcfg, {}, TServeConfig(n_pages=4))


def test_from_jax_params_splits_scanned_stacks():
    """A scanned `stack_0` tree (leading layer axis) converts to the same
    per-layer tensors as the unscanned tree it stacks."""
    cfg, tcfg = _cfgs("hybrid")
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_lm(jax.random.PRNGKey(3), cfg))
    layers = [tree["decoder"][f"layer_{i}"] for i in range(2)]
    stacked = dict(tree, decoder={"stack_0": jax.tree_util.tree_map(
        lambda *xs: np.stack(xs), *layers)})
    a = from_jax_params(tree, tcfg, device="cpu")
    b = from_jax_params(stacked, tcfg, device="cpu")
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(flat_a) == len(flat_b)
    for path, x in flat_a:
        assert torch.equal(x, flat_b[path]), path


def test_unported_archs_are_refused():
    """What stays unported is refused, naming ROADMAP.md: an arch outside
    the registry, and make_train_step's plan= with tensor parallelism for
    a slice-10d family (a mixture-of-experts model). amax_sync= (slice
    10a), ZeRO-1 plans (slice 10b, tests/test_torch_zero.py) and tensor
    parallelism for the dense decoders (slice 10c, tests/test_torch_tp.py)
    are ported: a ZeRO-1 plan on a two-rank 'data' mesh and a TP plan
    build a step (their process groups are looked up at the first
    call)."""
    import types

    from repro_torch.core.precision_policy import DistConfig
    from repro_torch.distributed.strategy import (DataParallel,
                                                  ParallelPlan,
                                                  TensorParallel,
                                                  ZeRO1Sharded)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        build_config("gpt-unknown-1b")
    cfg = build_config("qwen2-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_kv_heads) == (28, 1536, 2)
    small = build_config("qwen2-1.5b", smoke=True)
    opt = make_optimizer_for(small)
    make_train_step(small, opt, device="cpu", amax_sync=lambda v: v)
    dp = DataParallel(("data",))
    mesh = types.SimpleNamespace(mesh_dim_names=("data",),
                                 mesh=torch.arange(2))
    tp = ParallelPlan(mesh, DistConfig(zero1=False), dp, None,
                      TensorParallel())
    assert callable(make_train_step(small, opt, device="cpu", plan=tp))
    moe = build_config("moonshot-v1-16b-a3b", smoke=True)
    with pytest.raises(NotImplementedError, match="slice 10d"):
        make_train_step(moe, make_optimizer_for(moe), device="cpu", plan=tp)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_step(moe, make_optimizer_for(moe), device="cpu", plan=tp)
    for z in (DistConfig(), DistConfig(wire_zero_gather="fp8")):
        zero1 = ParallelPlan(mesh, z, dp, ZeRO1Sharded(), None)
        assert callable(make_train_step(small, opt, device="cpu",
                                        plan=zero1))
    # Under "full" a tied embedding under a quantized head would take its
    # gradient summed through the head alone.
    assert small.tie_embeddings
    quantized_head = small.replace(policy=dataclasses.replace(
        small.policy, quantize_logits_head=True))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_step(quantized_head, opt, device="cpu", plan=zero1)


@pytest.mark.parametrize("k,p", [(5, 1.0), (0, 0.7), (8, 0.9)])
def test_sampling_masks_match_reference(k, p):
    logits = np.random.default_rng(4).normal(size=(3, 50)).astype(np.float32)
    logits[1, :10] = logits[1, 10]                      # ties at the cut
    j = jsampling.top_p_mask(jsampling.top_k_mask(jnp.asarray(logits), k), p)
    t = tsampling.top_p_mask(tsampling.top_k_mask(torch.from_numpy(logits),
                                                  k), p)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    greedy = tsampling.sample(torch.from_numpy(logits), None, temperature=0)
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.asarray(jsampling.sample(
                                      jnp.asarray(logits), None,
                                      temperature=0)))


def test_sampling_is_per_request():
    """A row's sample depends on its (seed, step) only, not on its batch
    row or neighbours."""
    logits = torch.from_numpy(
        np.random.default_rng(5).normal(size=(3, 40)).astype(np.float32))
    gens = tsampling.row_generators([7, 8, 9], [0, 3, 1], "cpu")
    a = tsampling.sample(logits, gens, temperature=0.8, top_k=10)
    gens = tsampling.row_generators([9, 7], [1, 0], "cpu")
    b = tsampling.sample(logits[[2, 0]], gens, temperature=0.8, top_k=10)
    assert a[2] == b[0] and a[0] == b[1]
