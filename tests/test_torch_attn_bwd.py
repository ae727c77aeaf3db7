"""Parity of the port's FP8 attention backward (the plain version of the dQ
and dK/dV kernels) against `repro`'s Pallas backward, run in interpret mode
on the CPU, and against its unfused oracle `fp8_attention_bwd_ref`.

Tiers (ROADMAP.md):
  A — `core.qattention._bwd_factors`, the ten host-f32 kernel factors, bit
      for bit;
  B — exact fixtures, on which every f32 sum of the backward is exact in
      any order, so dq / dk / dv and the dP / dS amaxes must match bit for
      bit:
        uniform — one-hot queries, and keys constant across the head dim
          that take one value on a random half of the columns and -224 on
          the rest, so every attended score of a row is equal (each exp
          is 1 or 0 and l is a count); one-hot dO rows (values 4x an fp8
          with exponent 0 or 1) and V rows constant across the head dim
          (+-1, +-2), so each dP is one product, an integer;
        stepped — the same, with the keys' value 32 times the column's
          128-column block index: the running max steps up across kv
          blocks and every exp of an earlier block is below exp(-32), so
          it vanishes from l in any order;
  C — general inputs: summation order and `exp` differ between the
      frameworks, so an fp8 intermediate may land one notch apart; the
      gradients are held to a relative L2 bound, the amaxes to equality.
Cases: causal and full masks, GQA groups 1 and 2, both recipes (hybrid:
e4m3 S/P with e5m2 errors; paper: all e5m2), RNE and SR from one seed.
"""
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import qattention as jqa
from repro.kernels.fp8_attention import ops as jattn
from repro.kernels.fp8_attention import ref as jattn_ref
from repro_torch.core import qattention as tqa
from repro_torch.kernels.fp8_attention import ops as tattn

jax.config.update("jax_platform_name", "cpu")

NP_DT = {"e4m3": ml_dtypes.float8_e4m3fn, "e5m2": ml_dtypes.float8_e5m2}
T_DT = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
MAN = {"e4m3": 3, "e5m2": 2}
RECIPES = {"hybrid": ("e4m3", "e5m2"), "paper": ("e5m2", "e5m2")}
B, HKV, S, D = 1, 2, 256, 64
SEED = 11
# Tier C: relative L2 of dq / dk / dv, general inputs. Read: at most
# 3.2e-5 over these cases (a dS or dP notch in a few elements); an
# unquantized dS reads at least 5.1e-2.
GENERAL_REL_L2 = 1e-3

CASES = [(mask, group, recipe, rounding)
         for mask in ("causal", "full") for group in (1, 2)
         for recipe in RECIPES for rounding in ("rne", "sr")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _id(case):
    return "-".join(str(c) for c in case)


def exact_fp8(shape, fmt, rng):
    """fp8 values (as f32) with exponents {0, 1}."""
    sign = rng.choice([-1.0, 1.0], shape)
    m = rng.integers(0, 1 << MAN[fmt], shape) / (1 << MAN[fmt])
    x = sign * (1 + m) * np.exp2(rng.integers(0, 2, shape))
    return x.astype(np.float32).astype(NP_DT[fmt]).astype(np.float32)


def general_fp8(shape, fmt, rng):
    x = rng.standard_normal(shape).astype(np.float32)
    return x.astype(NP_DT[fmt]).astype(np.float32)


def fixture(kind, group, fmt_a, fmt_e, rng):
    """(q, k, v, do, scal) as f32 arrays of fp8 values + 10 f32 factors."""
    h = HKV * group
    if kind == "general":
        q = general_fp8((B, h, S, D), fmt_a, rng)
        k = general_fp8((B, HKV, S, D), fmt_a, rng)
        v = general_fp8((B, HKV, S, D), fmt_a, rng)
        do = general_fp8((B, h, S, D), fmt_e, rng)
        scal = [0.125, 1.0, 1.0, 1.0, 1.0, 1.0, 0.125, 1.0, 1.0, 1.0]
        return q, k, v, do, np.asarray(scal, np.float32)
    # One-hot rows of q and dO (at random dims), rows of k and v that are
    # constant across the head dim: S = k's value, dP = dO's value times
    # v's, and every product and sum below is exact in f32.
    q = np.eye(D, dtype=np.float32)[rng.integers(0, D, (B, h, S))]
    top = 32.0 * (np.arange(S) // 128) if kind == "stepped" else 4.0
    hi = rng.random((B, HKV, S)) < 0.5
    k = np.where(hi, top, -224.0)[..., None] * np.ones(D, np.float32)
    k = k.astype(NP_DT[fmt_a]).astype(np.float32)
    v = (rng.choice([-2.0, -1.0, 1.0, 2.0], (B, HKV, S, 1))
         * np.ones(D)).astype(np.float32)
    do = np.eye(D, dtype=np.float32)[rng.integers(0, D, (B, h, S))] \
        * (4 * exact_fp8((B, h, S, 1), fmt_e, rng))
    # dP = dO value x V value is an integer with <= 3 significant bits, on
    # the grid after f_dp; rd is then a multiple of P8's grid step, so every
    # nonzero dS lies in [2^-18, 2^5] and f_ds = 2^8 puts all of them in
    # e5m2 binades whose RNE ties the reference rounds correctly on the
    # CPU (ROADMAP.md queue 3: XLA's inexact exp2 below 2^-10).
    scal = [1.0, 1.0, 1.0, 1.0, 2.0 ** -6, 64.0, 256.0, 1.0, 1.0, 1.0]
    return q, k, v, do, np.asarray(scal, np.float32)


def to_j(x, fmt):
    return jnp.asarray(x.astype(NP_DT[fmt]))


def to_t(x, fmt):
    return torch.from_numpy(x.copy()).to(T_DT[fmt])


def run_both(kind, case, reference):
    mask, group, recipe, rounding = case
    fmt_a, fmt_e = RECIPES[recipe]
    rng = np.random.default_rng(zlib.crc32((_id(case) + kind).encode()))
    q, k, v, do, scal = fixture(kind, group, fmt_a, fmt_e, rng)
    kw = dict(mask_mode=mask, fmt_s=fmt_a, fmt_p=fmt_a, fmt_e=fmt_e,
              rounding_s=rounding, rounding_p=rounding, rounding_e=rounding,
              saturate_e=False)
    got = tattn.fp8_attention_bwd(to_t(q, fmt_a), to_t(k, fmt_a),
                                  to_t(v, fmt_a), to_t(do, fmt_e), SEED,
                                  scal.tolist(), **kw)
    jargs = (to_j(q, fmt_a), to_j(k, fmt_a), to_j(v, fmt_a), to_j(do, fmt_e),
             SEED, jnp.asarray(scal))
    if reference == "kernel":
        want = jattn.fp8_attention_bwd(*jargs, interpret=True, **kw)
    else:
        want = jattn_ref.fp8_attention_bwd_ref(*jargs, payload=False,
                                               **kw)[:5]
    return ([g.numpy() for g in got],
            [np.asarray(w, np.float32) for w in want])


# Every case and fixture against the Pallas kernel (interpret mode); the
# unfused oracle, which shares the kernel's stripe functions, on the
# uniform fixture.
EXACT = [(c, kind, "kernel") for c in CASES for kind in ("uniform",
                                                         "stepped")] \
    + [(c, "uniform", "oracle") for c in CASES]


@pytest.mark.parametrize("case,kind,reference", EXACT,
                         ids=[f"{_id(c)}-{k}-{r}" for c, k, r in EXACT])
def test_exact_fixtures_bitwise(case, kind, reference):
    got, want = run_both(kind, case, reference)
    for name, g, w in zip(("dq", "dk", "dv", "amax_dp", "amax_ds"), got,
                          want):
        assert g.shape == w.shape, name
        assert np.array_equal(g, w), (
            f"{name}: {np.sum(g != w)} of {g.size} differ, max "
            f"{np.max(np.abs(g - w))}")


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == 2], ids=_id)
def test_general_inputs_within_bound(case):
    got, want = run_both("general", case, "kernel")
    for name, g, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= GENERAL_REL_L2, f"{name}: rel L2 {rel:.3e}"
    assert got[3] == want[3] and got[4] == want[4]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bwd_factors_bitwise(seed):
    """Tier A: the ten host-f32 factors from eight site scales and the
    softmax scale, in the reference's order of operations."""
    rng = np.random.default_rng(seed)
    scales = np.exp2(rng.uniform(-20, 10, 8)).astype(np.float32) \
        * rng.uniform(1, 2, 8).astype(np.float32)
    sm = float(1.0 / np.sqrt(rng.choice([64, 96, 128])))
    want = np.asarray(jqa._bwd_factors(jnp.asarray(scales), sm), np.float32)
    got = np.asarray(tqa._bwd_factors(dict(zip(tqa._ORDER, scales)), sm),
                     np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_rejects_other_masks():
    q = torch.zeros((1, 2, 8, 16), dtype=torch.float8_e4m3fn)
    do = q.to(torch.float8_e5m2)
    with pytest.raises(ValueError, match="causal/full"):
        tattn.fp8_attention_bwd(q, q, q, do, 0, [1.0] * 10, mask_mode="kv")


# (Q = S padded to 128, mask, window, the most kv blocks a q tile spans,
# the dQ kernel's variant): the stash holds STASH_BLOCKS = 4 blocks.
VARIANT_CASES = [
    (256, "causal", 0, 2, "stash"),
    (512, "causal", 0, 4, "stash"),     # the training shape: at the cap
    (640, "causal", 0, 5, "long"),      # one block past it
    (2048, "causal", 0, 16, "long"),
    (512, "full", 0, 4, "stash"),
    (640, "full", 0, 5, "long"),
    (1024, "full", 0, 8, "long"),
    (2048, "full", 256, 16, "long"),    # the window binds causal only
    (2048, "causal", 256, 3, "stash"),  # a window bounds the span
    (2048, "causal", 385, 4, "stash"),
    (2048, "causal", 386, 5, "long"),
]


@pytest.mark.parametrize("s,mask,window,blocks,variant", VARIANT_CASES,
                         ids=[f"{m}-S{s}-w{w}" for s, m, w, _, _ in
                              VARIANT_CASES])
def test_dq_variant_from_shape_mask_and_window(s, mask, window, blocks,
                                               variant):
    """The host picks the dQ kernel's variant from the shape, mask and
    window alone: the span is the reference's kv_stripe_span at the 128-row
    query tiles (the backward's skip set), the stash variant up to its
    cap."""
    spans = [jattn_ref.kv_stripe_span(t0, 128, block_kv=128, n_kv=s // 128,
                                      mask_mode=mask, window=window)
             for t0 in range(0, s, 128)]
    assert max(hi - lo + 1 for lo, hi in spans) == blocks
    assert tattn.dq_span_blocks(s, s, mask, window) == blocks
    assert tattn.dq_variant(s, s, mask, window) == variant


# The dK/dV kernel's schedule: (S = Q, mask, window) over causal and full
# masks, windows and ragged lengths (S not a multiple of 128: the wrapper
# pads the kv length, the query rows stay ragged).
DKV_SCHEDULES = [(s, mask, window) for s in (200, 512, 968, 2048)
                 for mask, window in (("causal", 0), ("full", 0),
                                      ("causal", 256), ("causal", 385),
                                      ("full", 256))]


@pytest.mark.parametrize("s,mask,window", DKV_SCHEDULES,
                         ids=[f"{m}-S{s}-w{w}" for s, m, w in
                              DKV_SCHEDULES])
def test_dkv_schedule_is_the_plain_versions_skip_set(s, mask, window):
    """Each dK/dV block (DKV_ROWS kv rows) visits exactly the 128-row query
    tiles whose rows the plain version keeps for its 128-column kv block
    (`ref._live`, the skip set: `kv_stripe_span` of the row's tile), as
    one ascending interval (the kernel walks it as one), and the blocks
    launch in an order along which the chains never grow."""
    from repro_torch.kernels.fp8_attention import ref as tref
    s_pad = -(-s // 128) * 128
    order = tattn.dkv_block_order(s_pad)
    assert sorted(order) == list(range(s_pad // tattn.DKV_ROWS))
    chains = []
    for kb in order:
        tiles = tattn.dkv_live_tiles(kb, q_rows=s, s_pad=s_pad,
                                     mask_mode=mask, window=window)
        j = kb * tattn.DKV_ROWS // 128
        rows = torch.arange(0, s, 128)
        live = tref._live(rows, j, mask, window)
        want = list(range(len(rows))) if live is None else [
            int(i) for i in torch.nonzero(live).flatten()]
        assert tiles == want
        assert tiles == list(range(tiles[0], tiles[-1] + 1)) if tiles else True
        chains.append(len(tiles))
    assert chains == sorted(chains, reverse=True)


def _dkv_parts(monkeypatch, q, k, v, do, scal, kw):
    """The plain backward's per-column-block dS8 and P8 parts (as its `_keep`
    hands them to the dK / dV sums) and its (dk, dv)."""
    from repro_torch.kernels.fp8_attention import ref as tref
    seen = []
    keep = tref._keep

    def record(live, x):
        out = keep(live, x)
        seen.append(out)
        return out
    monkeypatch.setattr(tref, "_keep", record)
    out = tref.fp8_attention_bwd_ref(q, k, v, do, SEED, scal, **kw)
    monkeypatch.setattr(tref, "_keep", keep)
    nb = len(seen) // 3
    tail = seen[nb:]    # pass B: dS8 then P8, per column block
    return (torch.cat(tail[0::2], dim=-1), torch.cat(tail[1::2], dim=-1),
            out[1], out[2])


@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("kind", ["uniform", "stepped", "general"])
@pytest.mark.parametrize("mask", ["causal", "full"])
@pytest.mark.parametrize("group", [2, 3])
def test_dkv_member_then_head_order_association(monkeypatch, recipe, kind,
                                                mask, group):
    """The association of the dK/dV kernel's design, modelled on the plain
    version's parts: each GQA member's chain of 128-row query tiles (one
    matmul product a tile), then the members added in head order
    ((P_0 + P_1) + P_2), against the plain version's flat (member, tile)
    chain: bit for bit on the exact fixtures, within 1e-6 relative on
    general inputs. This is a model of the order, not of the kernel: the
    kernel adds 16-row k slices into its wgmma accumulator in the
    hardware's order. The kernel itself is held on the card against the
    backward's limit of 1e-3 (ATTN_BWD_REL_L2 in chip_smoke.py, which logs
    dq, dk and dv apart)."""
    fmt_a, fmt_e = RECIPES[recipe]
    rng = np.random.default_rng(
        zlib.crc32(f"{recipe}{kind}{mask}{group}".encode()))
    q, k, v, do, scal = fixture(kind, group, fmt_a, fmt_e, rng)
    kw = dict(mask_mode=mask, fmt_s=fmt_a, fmt_p=fmt_a, fmt_e=fmt_e,
              rounding_s="sr", rounding_p="sr", rounding_e="sr",
              saturate_e=False)
    qt, dot = to_t(q, fmt_a), to_t(do, fmt_e)
    ds, p8, dk_ref, dv_ref = _dkv_parts(
        monkeypatch, qt, to_t(k, fmt_a), to_t(v, fmt_a), dot, scal.tolist(),
        kw)
    b, h, s, d = q.shape
    qf = qt.float().reshape(b, HKV, group * s, d)
    dof = dot.float().reshape(b, HKV, group * s, d)
    f_dk, f_dv = (float(np.float32(x)) for x in scal[8:10])
    flat = [torch.zeros(b, HKV, ds.shape[-1], d) for _ in range(2)]
    members = []
    for i in range(group):
        chain = [torch.zeros(b, HKV, ds.shape[-1], d) for _ in range(2)]
        for t0 in range(0, s, 128):
            r = slice(i * s + t0, i * s + min(t0 + 128, s))
            parts = (ds[:, :, r].transpose(-1, -2) @ qf[:, :, r],
                     p8[:, :, r].transpose(-1, -2) @ dof[:, :, r])
            flat = [x + y for x, y in zip(flat, parts)]
            chain = [x + y for x, y in zip(chain, parts)]
        members.append(chain)
    # The flat chain is the plain version's own.
    assert torch.equal(flat[0] * f_dk, dk_ref)
    assert torch.equal(flat[1] * f_dv, dv_ref)
    total = members[0]
    for chain in members[1:]:
        total = [x + y for x, y in zip(total, chain)]
    for got, want, f in zip(total, flat, (f_dk, f_dv)):
        got, want = got * f, want * f
        if kind == "general":
            rel = ((got - want).norm() / want.norm()).item()
            assert rel <= 1e-6, rel
        else:
            assert torch.equal(got, want)
