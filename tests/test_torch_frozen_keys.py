"""Frozen-scales files across the two packages at a depth the block pattern
does not divide: recurrentgemma-9b's smoke config at 5 layers (one group of
(rglru, rglru, local_attn) and two remainder layers), whose remainder
layers' scale sites the reference keeps under `rem_{i}` and the port under
`layer_{3 + i}`:

  * a file the reference wrote serves in the port (`load_frozen(dir,
    cfg)`): its keys are the port's own calibration's, and the port's
    engine streams equal the reference engine's on that file;
  * a file the port wrote for the config (`save_frozen(..., cfg=)`) loads
    in the reference's `load_frozen` under the reference's keys, and the
    reference's engine on it streams as the port's engine on the port's
    scales;
  * at a scanned depth (8 layers: two groups under stack_0..2, and two
    remainder layers) the same crossings: the reference's per-layer
    freeze and its envelope freeze serve in the port, and the port's file
    loads in the reference as per-layer lists, with the served streams
    equal; and the key maps alone, in both directions.

The reference runs on its "xla" backend with XLA's
`xla_allow_excess_precision` off, as in tests/test_torch_serve.py; torch
on one intra-op thread.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision_policy import PrecisionPolicy, QuantConfig
from repro.models import transformer as jtr
from repro.models.registry import build_config as j_build_config
from repro.scaling.calibrate import calibrate as j_calibrate
from repro.scaling.calibrate import freeze_with_formats as j_freeze_fmt
from repro.scaling.calibrate import load_frozen as j_load_frozen
from repro.scaling.calibrate import load_frozen_formats as j_load_formats
from repro.scaling.calibrate import save_frozen as j_save_frozen
from repro.serve import ServeConfig, ServeEngine
from repro.train.step import make_serve_decode, make_serve_prefill
from repro_torch.core import precision_policy as tpp
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_config
from repro_torch.scaling import calibrate as tcal
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.engine import ServeEngine as TServeEngine

jax.config.update("jax_platform_name", "cpu")

ARCH = "recurrentgemma-9b"
PER_OP = {"xla_allow_excess_precision": False}
LAYERS = 5       # 1 group of 3 + 2 remainder layers
W = 8            # the window: the prompts leave it
_PARAMS = {}     # id -> the reference's weights drawn by `setup`


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(n_layers=LAYERS):
    """(reference, port) smoke configs at `n_layers`, hybrid recipe with
    delayed scaling on the "xla" backends, no remat."""
    q = dict(recipe="hybrid", scaling="delayed", backend="xla")
    kw = dict(n_layers=n_layers, window=W, remat=False)
    return (j_build_config(ARCH, smoke=True).replace(
                policy=PrecisionPolicy(quant=QuantConfig(**q)), **kw),
            build_config(ARCH, smoke=True).replace(
                policy=tpp.PrecisionPolicy(quant=tpp.QuantConfig(**q)),
                **kw))


@functools.lru_cache(maxsize=None)
def setup(n_layers=LAYERS):
    """The reference's weights at `n_layers`, and each package's scales
    and formats calibrated on the same two seeded batches (the
    reference's envelope freeze; at a scanned depth also its per-layer
    one, last)."""
    jcfg, tcfg = cfgs(n_layers)
    jp = jax.jit(jtr.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    _PARAMS[id(jp)] = jp
    assert {"rem_0", "rem_1"} <= set(jp["decoder"])
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    rng = np.random.default_rng(3)
    toks = [rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
            for _ in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", functools.partial(jax.jit,
                                                 compiler_options=PER_OP))
        jds, jstate = j_calibrate(jp, jcfg, [{"tokens": jnp.asarray(t)}
                                             for t in toks])
    jfrozen = j_freeze_fmt(jds, jstate, jcfg)
    tfrozen = tcal.freeze_with_formats(*tcal.calibrate(
        tp, tcfg, [{"tokens": t} for t in toks]), tcfg)
    if n_layers == LAYERS:
        return jcfg, tcfg, jp, tp, jfrozen, tfrozen
    return (jcfg, tcfg, jp, tp, jfrozen, tfrozen,
            j_freeze_fmt(jds, jstate, jcfg, per_layer=True))


def prompts(vocab):
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, 10).astype(np.int32) for _ in range(3)]


def streams(eng, vocab):
    uids = [eng.add_request(p, max_new_tokens=5) for p in prompts(vocab)]
    out = eng.run_to_completion()
    return [out[u] for u in uids]


def ref_streams(jcfg, jp, frozen):
    """The reference engine's greedy streams on `frozen` (one compile of
    its prefill and decode programs for each distinct file: the scales
    are baked into them)."""
    return _ref_streams(jcfg, id(jp), json.dumps(frozen, sort_keys=True))


@functools.lru_cache(maxsize=None)
def _ref_streams(jcfg, jp_id, frozen_json):
    jp = _PARAMS[jp_id]
    frozen = json.loads(frozen_json)
    eng = ServeEngine(jcfg, jp, ServeConfig(max_batch=3, max_len=32),
                      frozen_scales=frozen)
    eng._prefill = jax.jit(make_serve_prefill(jcfg, frozen),
                           compiler_options=PER_OP)
    eng._decode = jax.jit(make_serve_decode(jcfg, frozen),
                          compiler_options=PER_OP)
    return streams(eng, jcfg.vocab_size)


def port_streams(tcfg, tp, frozen):
    eng = TServeEngine(tcfg, tp, TServeConfig(max_batch=3, max_len=32),
                       frozen_scales=frozen, device="cpu")
    return streams(eng, tcfg.vocab_size)


def test_reference_file_serves_in_the_port(tmp_path):
    jcfg, tcfg, jp, tp, (jscales, jformats), (tscales, tformats) = setup()
    assert any("/rem_1/" in k for k in jscales)
    j_save_frozen(tmp_path, jscales, jformats)
    # Unmapped, the remainder layers' sites would miss (unit scales).
    assert j_load_frozen(tmp_path).keys() != tscales.keys()
    scales = tcal.load_frozen(tmp_path, cfg=tcfg)
    formats = tcal.load_frozen_formats(tmp_path, cfg=tcfg)
    assert scales.keys() == tscales.keys() and formats == tformats

    def to_port(key):
        for ref, port in (("decoder/rem_0/", "decoder/layer_3/"),
                          ("decoder/rem_1/", "decoder/layer_4/")):
            if key.startswith(ref):
                return port + key[len(ref):]
        return key
    assert scales == {to_port(k): v for k, v in jscales.items()}
    got = port_streams(tcfg, tp, scales)
    assert got == ref_streams(jcfg, jp, jscales)


def test_port_file_loads_in_the_reference(tmp_path):
    jcfg, tcfg, jp, tp, (jscales, jformats), (tscales, tformats) = setup()
    tcal.save_frozen(tmp_path, tscales, tformats, cfg=tcfg)
    scales, formats = j_load_frozen(tmp_path), j_load_formats(tmp_path)
    assert scales.keys() == jscales.keys() and formats == jformats
    assert scales["decoder/rem_0/wx#b.W"] \
        == tscales["decoder/layer_3/wx#b.W"]
    # And back: the port reads its own file under its keys.
    assert tcal.load_frozen(tmp_path, cfg=tcfg) == tscales
    assert ref_streams(jcfg, jp, scales) == port_streams(tcfg, tp, tscales)


def test_key_maps_at_a_scanned_depth():
    """8 layers, scanned (two groups of 3, then rem_0, rem_1): the port's
    layer_{g * 3 + p} sites are the reference's stack_{p} lists in group
    order, its layer_6 / layer_7 the rem_0 / rem_1; a stack's envelope
    float reaches each of its layers; formats map alike; unscanned, the
    group layers keep their keys."""
    _, tcfg = cfgs(8)
    assert tcfg.scan_layers
    port = {f"decoder/layer_{i}/wx#b.W": float(i + 1) for i in range(8)}
    port["head#a.A"] = 0.5
    ref = tcal.reference_keys(port, tcfg)
    assert ref == {"decoder/stack_0/wx#b.W": [1.0, 4.0],
                   "decoder/stack_1/wx#b.W": [2.0, 5.0],
                   "decoder/stack_2/wx#b.W": [3.0, 6.0],
                   "decoder/rem_0/wx#b.W": 7.0, "decoder/rem_1/wx#b.W": 8.0,
                   "head#a.A": 0.5}
    assert tcal.port_keys(ref, tcfg) == port
    envelope = tcal.port_keys({"decoder/stack_1/wx#b.W": 5.0}, tcfg)
    assert envelope == {"decoder/layer_1/wx#b.W": 5.0,
                        "decoder/layer_4/wx#b.W": 5.0}
    fmts = {k: "e4m3" for k in port}
    assert tcal.reference_keys(fmts, tcfg)["decoder/stack_2/wx#b.W"] \
        == "e4m3"
    assert tcal.port_keys(tcal.reference_keys(fmts, tcfg), tcfg) == fmts
    flat_cfg = tcfg.replace(scan_layers=False)
    unscanned = tcal.reference_keys(port, flat_cfg)
    assert "decoder/layer_5/wx#b.W" in unscanned \
        and "decoder/rem_1/wx#b.W" in unscanned
    assert tcal.port_keys(unscanned, flat_cfg) == port


SCANNED = 8      # two groups of 3 (stack_0..2) + rem_0, rem_1


def scanned_port_key(key):
    """The port's key of a reference key at SCANNED layers with a group
    index (stack_{p} -> layer_{3 g + p}; rem_{i} -> layer_{6 + i})."""
    def at(g):
        for p in range(3):
            ref = f"decoder/stack_{p}/"
            if key.startswith(ref):
                return f"decoder/layer_{3 * g + p}/" + key[len(ref):]
        for i in range(2):
            ref = f"decoder/rem_{i}/"
            if key.startswith(ref):
                return f"decoder/layer_{6 + i}/" + key[len(ref):]
        return key
    return at


@pytest.mark.parametrize("freeze", ["per_layer", "envelope"])
def test_reference_file_serves_in_the_port_at_a_scanned_depth(tmp_path,
                                                              freeze):
    """The reference's file at 8 scanned layers (its per-layer freeze:
    a stack_{p} site holds one scale a group; its envelope freeze: one
    max for the stack) read by the port: the keys are the port's own
    calibration's, each layer gets its group's scale (or the envelope),
    and the port's engine streams as the reference's on that file."""
    jcfg, tcfg, jp, tp, envelope, (tscales, tformats), per_layer = \
        setup(SCANNED)
    assert jcfg.scan_layers and tcfg.scan_layers
    jscales, jformats = per_layer if freeze == "per_layer" else envelope
    stacked = [k for k in jscales if k.startswith("decoder/stack_")]
    assert stacked and any("/rem_1/" in k for k in jscales)
    assert all(isinstance(jscales[k], list) == (freeze == "per_layer")
               for k in stacked)
    j_save_frozen(tmp_path, jscales, jformats)
    scales = tcal.load_frozen(tmp_path, tcfg)
    formats = tcal.load_frozen_formats(tmp_path, tcfg)
    assert scales.keys() == tscales.keys() and formats == tformats
    want = {}
    for k, v in jscales.items():
        for g in range(2):
            want[scanned_port_key(k)(g)] = v[g] if isinstance(v, list) \
                else v
    assert scales == want
    assert port_streams(tcfg, tp, scales) == ref_streams(jcfg, jp, jscales)


def test_port_file_loads_in_the_reference_at_a_scanned_depth(tmp_path):
    """The port's own calibration at 8 scanned layers, saved for the
    config, loads in the reference's `load_frozen` as its per-layer
    layout (stack_{p} lists in group order, rem_{i}); the reference's
    engine on that file streams as the port's engine on the port's
    scales, and the port reads its file back."""
    jcfg, tcfg, jp, tp, _, (tscales, tformats), (jscales, jformats) = \
        setup(SCANNED)
    tcal.save_frozen(tmp_path, tscales, tformats, cfg=tcfg)
    scales, formats = j_load_frozen(tmp_path), j_load_formats(tmp_path)
    assert scales.keys() == jscales.keys() and formats == jformats
    for k, v in scales.items():
        if k.startswith("decoder/stack_"):
            assert v == [tscales[scanned_port_key(k)(g)] for g in range(2)]
    # The two calibrations agree value for value here, so the file is the
    # reference's own per-layer freeze.
    assert scales == jscales
    assert tcal.load_frozen(tmp_path, tcfg) == tscales
    assert ref_streams(jcfg, jp, scales) == port_streams(tcfg, tp, tscales)
