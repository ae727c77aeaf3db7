"""The port's precision-health telemetry against `repro` on the CPU.

  * `obs.counters`: the payload thresholds, `payload_health`,
    `value_counts` and `counts_to_frac` bit for bit on random payloads of
    both formats, inf / NaN / zeros / subnormals included;
  * the plain count versions of kernels 2 and 3 (`fp8_attention_fwd_ref` /
    `fp8_attention_bwd_ref` with `with_counts`): their S / P and dP / dS
    fractions bit for bit the reference Pallas kernels' count variants run
    in interpret mode, on the exact fixtures of tests/test_torch_attn_bwd.py
    (causal and full masks, both recipes, RNE and SR) and on a 'saturating'
    fixture whose S, P, dP and dS reach their formats' max normal, and the
    observed count the attended positions; a planted fault (P counted over
    the masked positions too) fails;
  * `obs.health.HealthMonitor`: identical event lists on the same record
    streams (hypothesis), every detector and the cooldown;
  * `obs.metrics.MetricsLogger`: identical jsonl records and sidecar;
  * `checkpoint.Checkpointer`: `_escape_key` equal to the reference's and
    round-tripping, and a checkpoint of a dict of arrays written by either
    package read back by the other.
"""
import json
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import checkpointer as jck
from repro.core.loss_scale import LossScaler as JLossScaler
from repro.kernels.fp8_attention import ops as jattn
from repro.obs import counters as jcounters
from repro.obs import health as jhealth
from repro.obs import metrics as jmetrics
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.core.fp8_formats import get_format
from repro_torch.core.loss_scale import LossScaler
from repro_torch.kernels.fp8_attention import ops as tattn
from repro_torch.kernels.fp8_attention import ref as tref
from repro_torch.obs import counters, health, metrics

jax.config.update("jax_platform_name", "cpu")

NP_DT = {"e4m3": ml_dtypes.float8_e4m3fn, "e5m2": ml_dtypes.float8_e5m2}
T_DT = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread for this file (the suite's workers
    share a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# obs.counters
# ---------------------------------------------------------------------------

def random_payload(fmt, seed, n=4096):
    """Random bytes of `fmt` with every special value planted."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, n).astype(np.uint8)
    special = [0x00, 0x80, 0x01, 0x81, 0x7F, 0xFF, 0x7E, 0x7B, 0x7C, 0x7D,
               0x03, 0x04, 0x07, 0x08]
    raw[:len(special)] = special
    # A second stretch of small magnitudes: flushes and near-flushes.
    raw[len(special):len(special) + 200] = rng.integers(0, 16, 200)
    return raw.view(NP_DT[fmt])


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_payload_thresholds_match_reference(fmt):
    assert counters.payload_thresholds(fmt) == \
        jcounters.payload_thresholds(fmt)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_payload_health_bitwise(fmt, seed):
    data = random_payload(fmt, seed)
    want = np.asarray(jcounters.payload_health(jnp.asarray(data), fmt))
    got = counters.payload_health(
        torch.from_numpy(data.view(np.uint8)).view(T_DT[fmt]), fmt).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_value_counts_and_fractions_bitwise(fmt):
    data = random_payload(fmt, 3).astype(np.float32)
    mask = np.random.default_rng(4).random(data.shape) < 0.6
    jf = get_format(fmt)
    from repro.core.fp8_formats import get_format as j_format
    for m in (None, mask):
        want = jcounters.value_counts(
            jnp.asarray(data), j_format(fmt),
            None if m is None else jnp.asarray(m))
        got = counters.value_counts(
            torch.from_numpy(data), jf,
            None if m is None else torch.from_numpy(m))
        assert [float(x) for x in got] == [float(x) for x in want]
    c = np.asarray([[3.0, 5.0, 17.0], [0.0, 0.0, 0.0], [7.0, 1.0, 9.0]],
                   np.float32)
    assert np.array_equal(
        counters.counts_to_frac(torch.from_numpy(c)).numpy(),
        np.asarray(jcounters.counts_to_frac(jnp.asarray(c))))


# ---------------------------------------------------------------------------
# the plain count versions of kernels 2 and 3
# ---------------------------------------------------------------------------

B, HKV, G, S, D = 1, 2, 2, 256, 64


def exact_fixture(fmt_a, fmt_e, rng, saturating=False):
    """tests/test_torch_attn_bwd.py's 'stepped' fixture: one-hot q and dO
    rows, keys constant across the head dim (32 x the kv block index on
    half the columns, -224 on the rest), V rows of +-1, +-2: every f32 sum
    is exact in any order. `saturating`: chip_smoke.py's fixture of that
    name (keys of 4 and -224, dO of +-7 x 2^-r, and scales that drive S,
    P, dP and dS to their formats' max normal)."""
    h = HKV * G
    q = np.eye(D, dtype=np.float32)[rng.integers(0, D, (B, h, S))]
    top = 4.0 + 0.0 * np.arange(S) if saturating \
        else 32.0 * (np.arange(S) // 128)
    hi = rng.random((B, HKV, S)) < 0.5
    k = np.where(hi, top, -224.0)[..., None] * np.ones(D, np.float32)
    v = (rng.choice([-2.0, -1.0, 1.0, 2.0], (B, HKV, S, 1))
         * np.ones(D)).astype(np.float32)
    if saturating:
        mag = rng.choice([-7.0, 7.0], (B, h, S, 1)) \
            * 2.0 ** -rng.integers(0, 4, (B, h, S, 1))
        scal = [256.0, 1.0, 2.0 ** 16, 2.0 ** -16, 2.0 ** 12, 2.0 ** -12,
                2.0 ** 21, 1.0, 1.0, 1.0]
    else:
        mag = 4 * rng.choice([1.0, 1.5, 2.0, 3.0], (B, h, S, 1))
        scal = [1.0, 1.0, 1.0, 1.0, 2.0 ** -6, 64.0, 256.0, 1.0, 1.0, 1.0]
    do = np.eye(D, dtype=np.float32)[rng.integers(0, D, (B, h, S))] \
        * mag.astype(np.float32)
    scal = np.asarray(scal, np.float32)
    cast = {"a": NP_DT[fmt_a], "e": NP_DT[fmt_e]}
    return (q.astype(cast["a"]), k.astype(cast["a"]), v.astype(cast["a"]),
            do.astype(cast["e"]), scal)


COUNT_CASES = [("causal", "hybrid", "rne"), ("full", "paper", "sr"),
               ("causal", "paper", "sr"), ("full", "hybrid", "rne"),
               ("causal", "hybrid", "sr", "saturating"),
               ("full", "paper", "rne", "saturating")]
RECIPES = {"hybrid": ("e4m3", "e5m2"), "paper": ("e5m2", "e5m2")}


def _t(x, fmt):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.uint8)).view(
        T_DT[fmt])


def frac(counts):
    """(2, 3) int counts -> the reference's (2,) f32 fractions a row."""
    return counters.counts_to_frac(counts).numpy()


@pytest.mark.parametrize("case", COUNT_CASES,
                         ids=["-".join(c) for c in COUNT_CASES])
def test_plain_counts_match_reference_kernels(case):
    mask, recipe, rounding = case[:3]
    saturating = case[3:] == ("saturating",)
    fa, fe = RECIPES[recipe]
    rng = np.random.default_rng(len(mask) * 7 + len(recipe) + len(rounding))
    q, k, v, do, scal = exact_fixture(fa, fe, rng, saturating)
    fkw = dict(mask_mode=mask, fmt_s=fa, fmt_p=fa, rounding_s=rounding,
               rounding_p=rounding)
    kw = dict(fkw, fmt_e=fe, rounding_e=rounding, saturate_e=False)
    jf = jattn.fp8_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), 5, jnp.asarray(scal[:4]),
                                 with_counts=True, interpret=True, **fkw)
    jb = jattn.fp8_attention_bwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(do), 5,
                                 jnp.asarray(scal), with_counts=True,
                                 interpret=True, **kw)
    tf = tattn.fp8_attention_fwd(_t(q, fa), _t(k, fa), _t(v, fa), 5,
                                 scal[:4].tolist(), with_counts=True, **fkw)
    tb = tattn.fp8_attention_bwd(_t(q, fa), _t(k, fa), _t(v, fa),
                                 _t(do, fe), 5, scal.tolist(),
                                 with_counts=True, **kw)
    attended = B * HKV * G * (S * (S + 1) // 2 if mask == "causal"
                              else S * S)
    for got, want in ((tf[3], jf[3:5]), (tb[5], jb[5:7])):
        assert got.dtype == torch.int64
        assert got[:, 2].tolist() == [attended, attended]
        assert np.array_equal(frac(got), np.stack([np.asarray(w)
                                                   for w in want]))
        if saturating:
            assert bool((got[:, 0] > 0).all()), got.tolist()
    # Counting with counts on leaves every output bit for bit as it is.
    off_f = tattn.fp8_attention_fwd(_t(q, fa), _t(k, fa), _t(v, fa), 5,
                                    scal[:4].tolist(), **fkw)
    assert all(torch.equal(a, b) for a, b in zip(off_f, tf[:3]))


def test_planted_count_fault_is_caught(monkeypatch):
    """P counted over every position of the block, masked ones too: the
    causal fractions part from the reference kernel's."""
    fa, fe = RECIPES["hybrid"]
    q, k, v, _, scal = exact_fixture(fa, fe, np.random.default_rng(9))
    fkw = dict(mask_mode="causal", fmt_s=fa, fmt_p=fa, rounding_s="rne",
               rounding_p="rne")
    want = jattn.fp8_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), 5, jnp.asarray(scal[:4]),
                                   with_counts=True, interpret=True, **fkw)
    orig = tref.health_counts

    def everywhere(vals, obs, fmt_name):
        return orig(vals, torch.ones_like(obs, dtype=torch.bool), fmt_name)
    monkeypatch.setattr(tref, "health_counts", everywhere)
    got = tattn.fp8_attention_fwd(_t(q, fa), _t(k, fa), _t(v, fa), 5,
                                  scal[:4].tolist(), with_counts=True, **fkw)
    assert not np.array_equal(frac(got[3]),
                              np.stack([np.asarray(w) for w in want[3:5]]))


# ---------------------------------------------------------------------------
# obs.health.HealthMonitor
# ---------------------------------------------------------------------------

SITES = ["a#A", "b#W", "c#E"]


@st.composite
def record_streams(draw):
    """Streams of records that reach every detector: overflow counts that
    step up, loss scales that flap or land on the schedule's floor,
    per-site health pairs around the thresholds, amax vectors that repeat,
    turn non-finite or move, straggler counts that climb."""
    n = draw(st.integers(8, 40))
    recs = []
    oc, strag = 0, 0
    amax = [1.0, 2.0, 3.0]
    for _ in range(n):
        oc += draw(st.sampled_from([0, 0, 1]))
        strag += draw(st.sampled_from([0, 1, 1]))
        scale = draw(st.sampled_from([64.0, 128.0, 256.0, 8192.0]))
        pair = st.sampled_from([0.0, 0.01, 0.06, 0.5, 0.95, 1.0])
        rec = {"overflow_count": float(oc), "loss_scale": scale,
               "stragglers": float(strag)}
        for s in SITES[:draw(st.integers(0, 3))]:
            rec[f"health/{s}"] = [draw(pair), draw(pair)]
        if draw(st.booleans()):
            rec["health/layers#A"] = [[draw(pair), draw(pair)]
                                      for _ in range(2)]
        move = draw(st.sampled_from(["keep", "keep", "move", "nan"]))
        if move == "move":
            amax = [a * 2 for a in amax]
        rec["health/amax_sites"] = [math.nan if move == "nan" and i == 1
                                    else a for i, a in enumerate(amax)]
        rec["health/scale_churn"] = 0.5
        recs.append(rec)
    return recs


@given(record_streams(),
       st.builds(dict, flap_window=st.integers(2, 10),
                 flap_min_changes=st.integers(1, 4),
                 stuck_window=st.integers(1, 6),
                 straggler_streak=st.integers(1, 4),
                 cooldown=st.integers(0, 5)))
@settings(max_examples=40, deadline=None)
def test_health_monitor_events_match_reference(records, knobs):
    sched = ((3, 128.0), (6, 256.0))
    ref = jhealth.HealthMonitor(
        jhealth.HealthConfig(**knobs), site_names=SITES,
        scaler=JLossScaler(mode="enhanced", min_scale_schedule=sched))
    port = health.HealthMonitor(
        health.HealthConfig(**knobs), site_names=SITES,
        scaler=LossScaler(mode="enhanced", min_scale_schedule=sched))
    for step, rec in enumerate(records):
        assert port.observe(step, rec) == ref.observe(step, rec)


def test_health_monitor_reaches_every_detector():
    """One hand-made stream in which each of the nine detectors fires, in
    both packages alike."""
    cfg = dict(flap_window=4, flap_min_changes=2, stuck_window=2,
               straggler_streak=2, cooldown=0)
    sched = ((3, 256.0),)
    ref = jhealth.HealthMonitor(
        jhealth.HealthConfig(**cfg), site_names=SITES,
        scaler=JLossScaler(mode="enhanced", min_scale_schedule=sched))
    port = health.HealthMonitor(
        health.HealthConfig(**cfg), site_names=SITES,
        scaler=LossScaler(mode="enhanced", min_scale_schedule=sched))
    scales = [512.0, 256.0, 512.0, 256.0, 256.0, 512.0]
    kinds = set()
    for step in range(6):
        rec = {"overflow_count": float(step), "loss_scale": scales[step],
               "stragglers": float(step),
               "health/a#A": [0.5, 0.0], "health/b#W": [0.0, 0.95],
               "health/c#E": [0.5, 0.95],
               "health/amax_sites": [1.0, math.nan, 3.0]}
        got = port.observe(step, rec)
        assert got == ref.observe(step, rec)
        kinds |= {e["kind"] for e in got}
    assert kinds == {"overflow", "scale_floor", "loss_scale_flapping",
                     "saturation", "underflow", "range_overflow",
                     "stuck_amax", "nan_amax", "straggler_streak"}


# ---------------------------------------------------------------------------
# obs.metrics.MetricsLogger
# ---------------------------------------------------------------------------

def test_metrics_logger_lines_match_reference(tmp_path):
    recs = [{"loss": 2.5, "step": 0, "grads_finite": True,
             "health/x#A": np.asarray([0.0, 0.25], np.float32),
             "health/amax_sites": np.arange(3, dtype=np.float32),
             "nan": float("nan"), "inf": np.float32(np.inf),
             "i32": np.int32(7), "events": [{"kind": "overflow", "step": 0}]},
            {"loss": np.float32(1.25), "step": 1, "list": [1, 2.5, None]}]
    meta = {"arch": "t", "sites": ["a", "b"], "track_health": True}
    with jmetrics.MetricsLogger(str(tmp_path / "ref.jsonl"), meta=meta) as j:
        for r in recs:
            j.log(r)
    port_recs = [{k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                      else v) for k, v in r.items()} for r in recs]
    with metrics.MetricsLogger(str(tmp_path / "port.jsonl"), meta=meta) as t:
        for r in port_recs:
            t.log(r)
        assert t.mean("loss") == j.mean("loss")
        assert t.percentile("loss", 50) == j.percentile("loss", 50)
    for suffix in ("", ".meta.json"):
        assert (tmp_path / f"port.jsonl{suffix}").read_text() == \
            (tmp_path / f"ref.jsonl{suffix}").read_text()
    assert metrics.SCHEMA_VERSION == jmetrics.SCHEMA_VERSION


# ---------------------------------------------------------------------------
# checkpoint.Checkpointer
# ---------------------------------------------------------------------------

@given(st.lists(st.text(alphabet="ab_/.u0", min_size=1, max_size=8),
                min_size=1, max_size=4))
@settings(max_examples=60, deadline=None)
def test_escape_key_matches_reference_and_round_trips(parts):
    key = "/".join(parts)
    esc = tck._escape_key(key)
    assert esc == jck._escape_key(key)
    assert tck._unescape_key(esc, "v2") == key
    assert tck._unescape_key(esc, None) == jck._unescape_key(esc, None)


def _arrays():
    rng = np.random.default_rng(5)
    return {"w__gate": rng.standard_normal((3, 4)).astype(np.float32),
            "w": {"gate": rng.standard_normal((2,)).astype(np.float16),
                  "count": np.asarray(3, np.int32)},
            "under_score": {"x__y": np.asarray([True, False])}}


def test_reference_checkpoint_reads_in_port(tmp_path):
    tree = _arrays()
    jck.Checkpointer(tmp_path, async_save=False).save(
        4, jax.tree_util.tree_map(jnp.asarray, tree), extra={"k": 1})
    proto = {"w__gate": torch.zeros((3, 4)),
             "w": {"gate": np.zeros((2,), np.float16),
                   "count": torch.tensor(0, dtype=torch.int32)},
             "under_score": {"x__y": np.zeros((2,), bool)}}
    ck = tck.Checkpointer(tmp_path, async_save=False)
    got, step = ck.restore(proto)
    assert step == 4 and ck.manifest()["extra"] == {"k": 1}
    assert np.array_equal(got["w__gate"].numpy(), tree["w__gate"])
    assert np.array_equal(got["w"]["gate"], tree["w"]["gate"])
    assert int(got["w"]["count"]) == 3
    assert np.array_equal(got["under_score"]["x__y"],
                          tree["under_score"]["x__y"])


def test_port_checkpoint_reads_in_reference(tmp_path):
    tree = _arrays()
    port_tree = {"w__gate": torch.from_numpy(tree["w__gate"]),
                 "w": {"gate": tree["w"]["gate"],
                       "count": torch.tensor(3, dtype=torch.int32)},
                 "under_score": {"x__y": tree["under_score"]["x__y"]},
                 "bf": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)}
    ck = tck.Checkpointer(tmp_path, async_save=True)
    ck.save(2, port_tree)
    ck.wait()
    man = json.loads((tmp_path / "step_0000000002" /
                      "manifest.json").read_text())
    assert man["key_escape"] == "v2" and man["dtypes"]["bf"] == "bfloat16"
    proto = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
        {**tree, "bf": np.zeros((2,), ml_dtypes.bfloat16)})
    got, step = jck.Checkpointer(tmp_path, async_save=False).restore(proto)
    assert step == 2
    assert np.array_equal(np.asarray(got["w__gate"]), tree["w__gate"])
    assert int(got["w"]["count"]) == 3
    assert np.asarray(got["bf"], np.float32).tolist() == [1.5, -2.0]
