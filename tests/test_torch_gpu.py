"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the `gpu` marker and skips without a CUDA device. The
file imports neither jax nor the reference package, so it also runs on a
GPU host without jax (`--noconftest` skips the JAX fixtures of conftest):

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Inputs are exact-accumulation fixtures (operand exponents {0, 1}; for
attention, constant keys so every exp is exactly 1, or scores that step up
across kv blocks so every exp is 0 or 1), on which the kernels must match
the plain versions bit for bit — NaN payload bytes compared as
NaN, since GPU arithmetic returns a canonical NaN.
"""
import math

import pytest
import torch

from repro_torch.kernels.fp8_attention import ops as attn
from repro_torch.kernels.fp8_matmul import ops as mm
from repro_torch.kernels.fused_quant_matmul import ops as fq
from repro_torch.kernels.stochastic_round import ops as sr
from repro_torch.kernels.stochastic_round import ref as sr_ref

FP8 = {"e4m3": (torch.float8_e4m3fn, 3), "e5m2": (torch.float8_e5m2, 2)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def exact_fp8(shape, fmt, gen):
    """fp8 payload with exponents {0, 1}: every f32 partial sum of the
    products below is exact, in any order."""
    dt, man = FP8[fmt]
    sign = torch.randint(0, 2, shape, generator=gen) * 2 - 1
    mant = torch.randint(0, 1 << man, shape, generator=gen) / (1 << man)
    ex = torch.randint(0, 2, shape, generator=gen).float()
    return (sign * (1 + mant) * torch.exp2(ex)).to(dt)


def canon(q):
    u = q.view(torch.uint8).clone()
    u[torch.isnan(q.float())] = 0xFF
    return u


# (M, K, N) of the GEMM kernel's cases: ragged shapes the wrapper pads
# (128x128 tiles; 128x256 tiles for the last), and the serving path's M=128.
GEMM_CASES = [(100, 200, 72), (128, 1536, 1536), (2000, 4100, 1500)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GEMM_CASES,
                         ids=["x".join(map(str, c)) for c in GEMM_CASES])
@pytest.mark.parametrize("dims", ["nn", "nt", "tn"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_gemm_kernel_matches_plain(card, dims, fmt, shape):
    gen = torch.Generator().manual_seed(7)
    m, k, n = shape
    scale = 0.125 if k <= 256 else 8.0   # keeps most outputs in range
    tile = fq.gemm_tile(m, n, k)
    a, w = exact_fp8((m, k), fmt, gen), exact_fp8((k, n), fmt, gen)
    if dims == "nt":
        w = w.t().contiguous()
    elif dims == "tn":
        a = a.t().contiguous()
    rand8 = torch.randint(0, 256, (m, n), dtype=torch.uint8, generator=gen)
    for rounding, saturate in (("rne", True), ("rne", False), ("sr", True),
                               ("sr", False)):
        kw = dict(dims=dims, out_format=fmt, rounding=rounding,
                  saturate=saturate, with_amax=True, with_counts=True)
        cpu = fq.fused_quant_matmul(a, w, scale, rand8=rand8, **kw)
        launches = fq.fused_quant_matmul.launches
        by_tile = fq.fused_quant_matmul.launches_by_tile[tile]
        gpu = fq.fused_quant_matmul(a.to(card), w.to(card), scale,
                                    rand8=rand8.to(card), **kw)
        torch.cuda.synchronize()
        assert fq.fused_quant_matmul.launches == launches + 1
        assert fq.fused_quant_matmul.launches_by_tile[tile] == by_tile + 1
        assert torch.equal(canon(cpu[0]), canon(gpu[0].cpu()))
        assert torch.equal(cpu[1], gpu[1].cpu()) or (
            cpu[1].isnan() and gpu[1].isnan().cpu())
        assert torch.equal(cpu[2], gpu[2].cpu())


def _holes_layout(s):
    """Chunk rows whose kv blocks the forward kernel skips or whose warps
    are dead: no live row; one live row with slots past its position; 150
    live rows (22 in the second 128-row tile) over two blocks of holes."""
    cols = torch.arange(s)
    blk = cols // 128
    none = torch.full_like(cols, -1)
    kv_mask = torch.stack([torch.where((cols < 300) & (blk != 1), cols, none),
                           cols,
                           torch.where((blk == 0) | (blk == 2), cols, none)])
    return kv_mask.int(), torch.tensor([[0, 0], [299, 1], [200, 150]]).int()


def _attn_case(mode, gen):
    b, h, hkv, d = 3, 4, 2, 64        # head dim padded to 128 by the wrapper
    t, s = {"chunk": (8, 160), "chunk_window": (8, 160),
            "holes": (160, 640)}.get(mode, (70, 200))
    kw = {"mask_mode": {"window": "causal", "holes": "chunk",
                        "chunk_window": "chunk"}.get(mode, mode)}
    if mode in ("window", "chunk_window"):
        kw["window"] = 50 if mode == "window" else 20
    if mode == "kv":
        kw["kv_mask"] = (torch.rand((b, s), generator=gen) < 0.7).to(torch.int8)
        kw["kv_mask"][1] = 0
    if mode in ("chunk", "chunk_window"):
        lengths = torch.tensor([70, 33, 9])
        cols = torch.arange(s)[None]
        kw["kv_mask"] = torch.where(cols < lengths[:, None], cols, -1).int()
        kw["chunk_pos"] = torch.tensor([[62, 8], [32, 1], [0, 5]]).int()
    if mode == "holes":
        kw["kv_mask"], kw["chunk_pos"] = _holes_layout(s)
    q = (exact_fp8((b, h, t, d), "e4m3", gen).float() / 4).to(torch.float8_e4m3fn)
    k = (exact_fp8((b, hkv, 1, d), "e4m3", gen).float() / 4).to(
        torch.float8_e4m3fn).expand(b, hkv, s, d).contiguous()
    v = exact_fp8((b, hkv, s, d), "e4m3", gen)
    return q, k, v, kw


ATTN_MODES = ["causal", "window", "full", "kv", "chunk", "chunk_window",
              "holes"]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ATTN_MODES)
def test_attention_kernel_matches_plain(card, mode):
    gen = torch.Generator().manual_seed(4)
    q, k, v, kw = _attn_case(mode, gen)
    scal = [0.0625, 1.0, 1.0, 1.0]
    fk = dict(fmt_s="e4m3", fmt_p="e4m3", rounding_s="rne", rounding_p="rne")
    cpu = attn.fp8_attention_fwd(q, k, v, 4, scal, **kw, **fk)
    gkw = {n: x.to(card) if isinstance(x, torch.Tensor) else x
           for n, x in kw.items()}
    gpu = attn.fp8_attention_fwd(q.to(card), k.to(card), v.to(card), 4, scal,
                                 **gkw, **fk)
    torch.cuda.synchronize()
    assert torch.equal(cpu[0], gpu[0].cpu())
    assert torch.equal(cpu[1], gpu[1].cpu())
    assert torch.equal(cpu[2], gpu[2].cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ATTN_MODES)
@pytest.mark.parametrize("rounding", ["rne", "sr"])
def test_attention_kernel_matches_plain_stepped_scores(card, mode, rounding):
    """Scores that step up by one per 128-column kv block (or sit at -224,
    whose exp is exactly 0): the running max rises, l and acc are rescaled
    by exp(-1), and P is quantized off the grid (f_p = 0.3). Held against
    the plain version run on the card (the same exp), bit for bit."""
    from repro_torch.kernels.fp8_attention import ref
    q, k, v, kw = _stepped_case(mode, "e4m3", card)
    fk = dict(fmt_s="e4m3", fmt_p="e4m3", rounding_s=rounding,
              rounding_p=rounding)
    scal = [1.0, 1.0, 0.3, 1.5]
    got = attn.fp8_attention_fwd(q, k, v, 4, scal, **kw, **fk)
    want = ref.fp8_attention_fwd_ref(q, k, v, 4, scal, **kw, **fk)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _stepped_case(mode, fmt, card):
    """The stepped-scores fixture (q picks key dim 0, which holds the
    column's kv block index or -224) on the card, in `fmt`."""
    gen = torch.Generator().manual_seed(5)
    _, _, v, kw = _attn_case(mode, gen)
    b, hkv, s, d = v.shape
    if mode in ("chunk", "chunk_window"):
        kw["chunk_pos"] = torch.tensor([[142, 8], [130, 1], [0, 5]]).int()
        kw["kv_mask"] = torch.where(torch.arange(s)[None] < torch.tensor(
            [[150], [131], [9]]), torch.arange(s)[None], -1).int()
    t = {"chunk": 8, "chunk_window": 8, "holes": 160}.get(mode, s)
    q = torch.zeros((b, 4, t, d))
    q[..., 0] = 1
    k = exact_fp8((b, hkv, s, d), "e4m3", gen).float()
    k[..., 0] = torch.where(torch.rand((b, hkv, s), generator=gen) < 0.5,
                            (torch.arange(s) // 128).float(), -224.0)
    dt = FP8[fmt][0]
    q, k, v = (x.float().to(dt).to(card) for x in (q, k, v))
    kw = {n: x.to(card) if isinstance(x, torch.Tensor) else x
          for n, x in kw.items()}
    return q, k, v, kw


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("rounding", ["rne", "sr"])
def test_attention_kernel_matches_plain_unsaturated_overflow(card, fmt,
                                                             rounding):
    """The stepped fixture with f_s so large (64 e4m3, 512 e5m2) that the
    -224 scores pass the format's max normal, unsaturated: they become NaN
    (e4m3: their rows and the S amax turn NaN) or -inf (e5m2: they act as
    masked, the S amax is inf); the block steps become 64 / 512, whose exp
    is negligible beside 1, so every sum stays exact. Held against the
    plain version run on the card, bit for bit with NaN where NaN."""
    from repro_torch.kernels.fp8_attention import ref
    q, k, v, kw = _stepped_case("causal", fmt, card)
    fk = dict(fmt_s=fmt, fmt_p=fmt, rounding_s=rounding, rounding_p=rounding,
              saturate_s=False, saturate_p=False)
    scal = [64.0 if fmt == "e4m3" else 512.0, 1.0, 0.3, 1.5]
    got = attn.fp8_attention_fwd(q, k, v, 4, scal, **kw, **fk)
    want = ref.fp8_attention_fwd_ref(q, k, v, 4, scal, **kw, **fk)
    torch.cuda.synchronize()
    assert not torch.isfinite(want[1])
    for x, y in zip(got, want):
        assert bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


@pytest.fixture(scope="module")
def fwd_probe_lib(tmp_path_factory):
    """Kernel 2 built with -DFWD_PROBE: it records the schedule it ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run on the card")
    from repro_torch.kernels.fp8_attention import probe
    return probe.build_fwd_probe(tmp_path_factory.mktemp("fwd_probe"))[0]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ATTN_MODES)
def test_attention_kernel_runs_the_stated_schedule(card, fwd_probe_lib, mode):
    """The q tile each block took, the kv blocks it visited and the warps
    that skipped their epilogue, as the kernel recorded them, are those
    ops.fwd_tile_order / fwd_live_blocks / fwd_dead_warps state (the rule
    the CPU tests hold against the plain mask)."""
    from repro_torch.kernels.fp8_attention import probe
    q, k, v, kw = _attn_case(mode, torch.Generator().manual_seed(4))
    gkw = {n: x.to(card) if isinstance(x, torch.Tensor) else x
           for n, x in kw.items()}
    assert probe.fwd_schedule_faults(fwd_probe_lib, q.to(card), k.to(card),
                                     v.to(card), gkw) == []


@pytest.mark.gpu
def test_decode_equals_chunk_at_one_token(card):
    """The fixed-slot decode op ('kv' mask) and the paged chunk op at T=1
    ('chunk' mask) on the same e5m2 cache payloads, with the hybrid
    recipe's e4m3 q and frozen scales, at the decode shape (B=4, H=12,
    Hkv=2, C=512, D=128): bit for bit, each through kernel 2."""
    from repro_torch.core.precision_policy import QuantConfig
    from repro_torch.core.qattention import fp8_sdpa_chunk, fp8_sdpa_decode
    from repro_torch.scaling import context as scale_ctx
    qcfg = QuantConfig(recipe="hybrid", scaling="delayed",
                       backend="pallas").eval_mode()
    gen = torch.Generator().manual_seed(8)
    b, c = 4, 512
    q = torch.randn((b, 12, 1, 128), generator=gen).to(torch.bfloat16)
    k8, v8 = ((torch.randn((b, 2, c, 128), generator=gen) * 8).to(
        torch.float8_e5m2) for _ in range(2))
    lengths = torch.tensor([101, 38, 480, 6])
    cols = torch.arange(c)[None]
    valid = cols < lengths[:, None]
    spos = torch.where(valid, cols, torch.full_like(cols, -1)).int()
    cpos = torch.stack([lengths - 1, torch.ones_like(lengths)], 1).int()
    scales = {f"sdpa#{n}.A": x for n, x in zip(
        ("q", "k", "v", "qk", "p"), (0.01, 0.02, 0.02, 0.05, 1.0 / 448))}
    kw = dict(cfg=qcfg, sm_scale=128 ** -0.5, k_cache_scale=0.125,
              v_cache_scale=0.0625, site="sdpa")
    masks = dict(attn.fp8_attention_fwd.launches_by_mask)
    with scale_ctx.activate(scale_ctx.frozen_context(scales)):
        dec = fp8_sdpa_decode(q.to(card), k8.to(card), v8.to(card),
                              valid.to(card), **kw)
        chk = fp8_sdpa_chunk(q.to(card), k8.to(card), v8.to(card),
                             spos.to(card), cpos.to(card), **kw)
    torch.cuda.synchronize()
    assert attn.fp8_attention_fwd.launches_by_mask["kv"] == masks["kv"] + 1
    assert attn.fp8_attention_fwd.launches_by_mask["chunk"] \
        == masks["chunk"] + 1
    assert torch.equal(dec.view(torch.int16), chk.view(torch.int16))


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.zeros((2, 2, 8, 320), dtype=torch.float8_e4m3fn, device=card)
    with pytest.raises(ValueError, match="head dim"):
        attn.fp8_attention_fwd(x, x, x, 0, [1.0] * 4)
    with pytest.raises(ValueError):
        fq.fused_quant_matmul(x[0, 0], x[0, 0].cpu())


def _bwd_case(kind, group, fmt_a, fmt_e, gen, s=200, d=64):
    """The exact backward fixture of tests/test_torch_attn_bwd.py (ragged
    length, head dim padded by the wrapper): one-hot q and dO rows, k and v
    rows constant across the head dim; every f32 sum is exact.
    'saturating': chip_smoke.py's fixture of that name (scales that drive
    S, P, dP and dS to their formats' max normal)."""
    b, hkv = 2, 2
    h = hkv * group
    dt_a, dt_e = FP8[fmt_a][0], FP8[fmt_e][0]
    eye = torch.eye(d)
    q = eye[torch.randint(0, d, (b, h, s), generator=gen)]
    top = (32.0 * (torch.arange(s) // 128).float() if kind == "stepped"
           else torch.full((s,), 4.0))
    hi = torch.rand((b, hkv, s), generator=gen) < 0.5
    k = torch.where(hi, top, torch.full_like(top, -224.0))[..., None] \
        * torch.ones(d)
    v = torch.tensor([-2.0, -1.0, 1.0, 2.0])[
        torch.randint(0, 4, (b, hkv, s, 1), generator=gen)] * torch.ones(d)
    if kind == "saturating":
        sign = torch.randint(0, 2, (b, h, s, 1), generator=gen) * 2.0 - 1
        dval = sign * 7.0 * torch.exp2(
            -torch.randint(0, 4, (b, h, s, 1), generator=gen).float())
        scal = [256.0, 1.0, 2.0 ** 16, 2.0 ** -16, 2.0 ** 12, 2.0 ** -12,
                2.0 ** 21, 1.0, 1.0, 1.0]
    else:
        dval = 4 * exact_fp8((b, h, s, 1), fmt_e, gen).float()
        scal = [1.0, 1.0, 1.0, 1.0, 2.0 ** -6, 64.0, 256.0, 1.0, 1.0, 1.0]
    do = eye[torch.randint(0, d, (b, h, s), generator=gen)] * dval
    return q.to(dt_a), k.to(dt_a), v.to(dt_a), do.to(dt_e), scal


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "stepped"])
@pytest.mark.parametrize("mask", ["causal", "full"])
@pytest.mark.parametrize("recipe", [("e4m3", "e5m2"), ("e5m2", "e5m2")],
                         ids=["hybrid", "paper"])
@pytest.mark.parametrize("rounding", ["rne", "sr"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("s, variant", [(200, "stash"), (700, "long")],
                         ids=["stash", "long"])
def test_attention_bwd_kernels_match_plain(card, kind, mask, recipe,
                                           rounding, group, s, variant):
    """The dQ and dK/dV kernels against the plain backward run on the card,
    bit for bit on the exact fixtures: dq, dk, dv, the amaxes, and the dQ
    kernel's row statistics; each kernel launches once, the dQ kernel on
    the variant the span selects (ragged lengths: 200 pads to 2 kv blocks,
    within the stash's cap; 700 to 6, past it)."""
    from repro_torch.kernels.fp8_attention import ref
    gen = torch.Generator().manual_seed(6)
    fa, fe = recipe
    q, k, v, do, scal = (x.to(card) if isinstance(x, torch.Tensor) else x
                         for x in _bwd_case(kind, group, fa, fe, gen, s=s))
    kw = dict(mask_mode=mask, fmt_s=fa, fmt_p=fa, fmt_e=fe,
              rounding_s=rounding, rounding_p=rounding, rounding_e=rounding)
    n_dq = attn.fp8_attention_bwd_dq.launches
    n_var = attn.fp8_attention_bwd_dq.launches_by_variant[variant]
    n_dkv = attn.fp8_attention_bwd_dkv.launches
    got = attn.fp8_attention_bwd(q, k, v, do, 9, scal, **kw)
    want = ref.fp8_attention_bwd_ref(q, k, v, do, 9, scal, with_stats=True,
                                     **kw)
    torch.cuda.synchronize()
    assert attn.fp8_attention_bwd_dq.launches == n_dq + 1
    assert attn.fp8_attention_bwd_dq.launches_by_variant[variant] == n_var + 1
    assert attn.fp8_attention_bwd_dkv.launches == n_dkv + 1
    for x, y in zip(got, want[:5]):
        assert torch.equal(x, y)
    pad = torch.nn.functional.pad
    qp, dop = (pad(x.view(torch.uint8), (0, 64)).view(x.dtype)
               for x in (q, do))
    kp, vp = (pad(x.view(torch.uint8), (0, 64, 0, -s % 128)).view(x.dtype)
              for x in (k, v))
    stats = attn.fp8_attention_bwd_dq(qp, kp, vp, dop, 9, scal,
                                      q_len=q.shape[2], s_len=k.shape[2],
                                      **kw)[1:4]
    for x, y in zip(stats, want[5:]):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "stepped"])
@pytest.mark.parametrize("d", [256, 192])
@pytest.mark.parametrize("rounding", ["rne", "sr"])
@pytest.mark.parametrize("group, window", [(1, 0), (16, 0), (16, 300)],
                         ids=["mha", "mqa", "mqa_window"])
@pytest.mark.parametrize("s, variant", [(200, "stash"), (700, "long")],
                         ids=["stash", "long"])
def test_attention_kernels_at_head_dim_256_match_plain(card, kind, d,
                                                       rounding, group,
                                                       window, s, variant):
    """Kernels 2-4 on their D = 256 build (recurrentgemma-9b's heads; 192
    pads to it) against the plain versions run on the card, bit for bit on
    the exact fixtures (hybrid recipe): the forward's output and amaxes,
    the backward's dq, dk, dv and amaxes; MQA (a GQA group of 16, the
    dK/dV kernel's group sum) with and without a window; the dQ kernel on
    the variant the span selects (ids: the variant without a window)."""
    from repro_torch.kernels.fp8_attention import ref
    gen = torch.Generator().manual_seed(12)
    q, k, v, do, scal = (x.to(card) if isinstance(x, torch.Tensor) else x
                         for x in _bwd_case(kind, group, "e4m3", "e5m2", gen,
                                            s=s, d=d))
    q, do = q[:1], do[:1]
    k, v = k[:1, :1].contiguous(), v[:1, :1].contiguous()
    if group == 1:
        q, do = q[:, :1].contiguous(), do[:, :1].contiguous()
    fk = dict(mask_mode="causal", window=window, fmt_s="e4m3", fmt_p="e4m3",
              rounding_s=rounding, rounding_p=rounding)
    got = attn.fp8_attention_fwd(q, k, v, 9, scal[:4], **fk)
    want = ref.fp8_attention_fwd_ref(q, k, v, 9, scal[:4], **fk)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    kw = dict(fk, fmt_e="e5m2", rounding_e=rounding)
    # The window narrows the span: 300 at S = 700 fits the stash.
    variant = attn.dq_variant(s, -(-s // 128) * 128, "causal", window)
    n_var = attn.fp8_attention_bwd_dq.launches_by_variant[variant]
    got = attn.fp8_attention_bwd(q, k, v, do, 9, scal, **kw)
    want = ref.fp8_attention_bwd_ref(q, k, v, do, 9, scal, **kw)
    torch.cuda.synchronize()
    assert attn.fp8_attention_bwd_dq.launches_by_variant[variant] \
        == n_var + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _bwd_overflow_case(group, fmt_a, fmt_e, gen, s=200, d=64):
    """_bwd_case's uniform fixture with dP overflowing e5m2 (unsaturated)
    at masked positions inside a visited pair only: rows r < 32 take dO =
    2^14 at dim d-1, columns 64 <= c < 128 take V = 256 there, the other
    rows' dO stays below dim d-1 and V is 0 at dim d-1 elsewhere. dP =
    2^16 after f_dp (inf) where c > r in the (q tile 0, kv block 0) pair:
    P * dP = 0 * inf makes rd and the dS of rows 0-31 NaN, which reaches dq
    rows 0-31 and dk rows 0-127; the rest stays exact (as chip_smoke.py's
    bwd_overflow_fixture at the training shape)."""
    q, k, v, do, scal = _bwd_case("uniform", group, fmt_a, fmt_e, gen, s=s,
                                  d=d)
    b, h = q.shape[:2]
    rows = torch.arange(s)
    eye = torch.eye(d)
    dof = do.float()
    dval = dof.abs().amax(-1, keepdim=True) * torch.sign(dof.sum(-1, True))
    normal = eye[torch.randint(0, d - 1, (b, h, s), generator=gen)] * dval
    do = torch.where((rows < 32)[:, None], eye[d - 1] * 2.0 ** 14, normal)
    vf = v.float()
    vf[..., d - 1] = torch.where((rows >= 64) & (rows < 128), 256.0, 0.0)
    return q, k, vf.to(v.dtype), do.to(FP8[fmt_e][0]), scal


def _same_bits(a, b):
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.gpu
@pytest.mark.parametrize("recipe", [("e4m3", "e5m2"), ("e5m2", "e5m2")],
                         ids=["hybrid", "paper"])
@pytest.mark.parametrize("rounding", ["rne", "sr"])
@pytest.mark.parametrize("group", [1, 2])
def test_attention_bwd_kernels_match_plain_unsaturated_overflow(
        card, recipe, rounding, group):
    """dq, dk, dv and the amaxes on the overflow fixture equal the plain
    backward run on the card, bit for bit with NaN where NaN (the masked
    positions' 0 * inf reaches dk), and two dK/dV launches agree."""
    from repro_torch.kernels.fp8_attention import ref
    gen = torch.Generator().manual_seed(13)
    fa, fe = recipe
    q, k, v, do, scal = (x.to(card) if isinstance(x, torch.Tensor) else x
                         for x in _bwd_overflow_case(group, fa, fe, gen))
    kw = dict(mask_mode="causal", fmt_s=fa, fmt_p=fa, fmt_e=fe,
              rounding_s=rounding, rounding_p=rounding, rounding_e=rounding,
              saturate_e=False)
    got = attn.fp8_attention_bwd(q, k, v, do, 9, scal, **kw)
    again = attn.fp8_attention_bwd(q, k, v, do, 9, scal, **kw)
    want = ref.fp8_attention_bwd_ref(q, k, v, do, 9, scal, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isnan(want[1]).any())
    for x, y, z in zip(got, want, again):
        assert _same_bits(x, y) and _same_bits(x, z)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "stepped"])
@pytest.mark.parametrize("rounding", ["rne", "sr"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("window", [100, 200])
def test_attention_bwd_kernels_match_plain_window(card, kind, rounding,
                                                  group, window):
    """The backward under a causal sliding window (ragged S=456: the
    window bounds the kv span of later q tiles and of each dK/dV block's
    rows) equals the plain version on the card, bit for bit on the exact
    fixtures (hybrid recipe)."""
    from repro_torch.kernels.fp8_attention import ref
    gen = torch.Generator().manual_seed(15)
    q, k, v, do, scal = (x.to(card) if isinstance(x, torch.Tensor) else x
                         for x in _bwd_case(kind, group, "e4m3", "e5m2",
                                            gen, s=456))
    kw = dict(mask_mode="causal", window=window, fmt_s="e4m3",
              fmt_p="e4m3", fmt_e="e5m2", rounding_s=rounding,
              rounding_p=rounding, rounding_e=rounding)
    got = attn.fp8_attention_bwd(q, k, v, do, 9, scal, **kw)
    want = ref.fp8_attention_bwd_ref(q, k, v, do, 9, scal, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("recipe", [("e4m3", "e5m2"), ("e5m2", "e5m2")],
                         ids=["hybrid", "paper"])
@pytest.mark.parametrize("rounding", ["rne", "sr"])
@pytest.mark.parametrize("group", [1, 2])
def test_attention_dkv_kernel_is_deterministic(card, recipe, rounding,
                                               group):
    """Two launches of the dK/dV kernel on the same general inputs (B=2,
    S=512, D=128, causal) give the same bits: no atomics, the GQA group
    added in head order."""
    gen = torch.Generator().manual_seed(14)
    fa, fe = recipe
    b, hkv, s, d = 2, 2, 512, 128
    q, do = (torch.randn((b, hkv * group, s, d), generator=gen).to(
        FP8[f][0]).to(card) for f in (fa, fe))
    k, v = (torch.randn((b, hkv, s, d), generator=gen).to(
        FP8[fa][0]).to(card) for _ in range(2))
    scal = [0.088388, 1.0, 1.0, 1.0, 1.0, 1.0, 0.088388, 1.0, 1.0, 1.0]
    kw = dict(mask_mode="causal", fmt_s=fa, fmt_p=fa, fmt_e=fe,
              rounding_s=rounding, rounding_p=rounding, rounding_e=rounding,
              saturate_e=False, q_len=s, s_len=s)
    stats = attn.fp8_attention_bwd_dq(q, k, v, do, 9, scal, **kw)[1:4]
    one, two = (attn.fp8_attention_bwd_dkv(q, k, v, do, 9, scal, *stats,
                                           **kw) for _ in range(2))
    torch.cuda.synchronize()
    for x, y in zip(one, two):
        assert _same_bits(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "stepped", "saturating"])
@pytest.mark.parametrize("mask", ["causal", "full"])
@pytest.mark.parametrize("recipe", [("e4m3", "e5m2"), ("e5m2", "e5m2")],
                         ids=["hybrid", "paper"])
@pytest.mark.parametrize("s, variant", [(200, "stash"), (700, "long")],
                         ids=["stash", "long"])
def test_attention_count_variants_match_plain(card, kind, mask, recipe, s,
                                              variant):
    """The count variants of the forward and of both dQ variants: the S / P
    and dP / dS [saturated, flushed, observed] counts equal the plain
    versions' on the exact fixtures ('saturating': every saturated count
    above 0), and every other output is bit for bit the same with counts
    on and off."""
    from repro_torch.kernels.fp8_attention import ref
    gen = torch.Generator().manual_seed(8)
    fa, fe = recipe
    q, k, v, do, scal = (x.to(card) if isinstance(x, torch.Tensor) else x
                         for x in _bwd_case(kind, 2, fa, fe, gen, s=s))
    fkw = dict(mask_mode=mask, fmt_s=fa, fmt_p=fa, rounding_s="sr",
               rounding_p="sr")
    kw = dict(fkw, fmt_e=fe, rounding_e="sr")
    n_f = attn.fp8_attention_fwd.launches_with_counts
    n_var = attn.fp8_attention_bwd_dq.launches_by_variant[variant]
    off_f = attn.fp8_attention_fwd(q, k, v, 9, scal[:4], **fkw)
    on_f = attn.fp8_attention_fwd(q, k, v, 9, scal[:4], with_counts=True,
                                  **fkw)
    off_b = attn.fp8_attention_bwd(q, k, v, do, 9, scal, **kw)
    on_b = attn.fp8_attention_bwd(q, k, v, do, 9, scal, with_counts=True,
                                  **kw)
    want_f = ref.fp8_attention_fwd_ref(q, k, v, 9, scal[:4],
                                       with_counts=True, **fkw)
    want_b = ref.fp8_attention_bwd_ref(q, k, v, do, 9, scal,
                                       with_counts=True, **kw)
    torch.cuda.synchronize()
    assert attn.fp8_attention_fwd.launches_with_counts == n_f + 1
    assert attn.fp8_attention_bwd_dq.launches_by_variant[variant] \
        == n_var + 2
    assert all(_same_bits(a, b) for a, b in zip(off_f, on_f[:3]))
    assert all(_same_bits(a, b) for a, b in zip(off_b, on_b[:5]))
    assert torch.equal(on_f[3], want_f[3])
    assert torch.equal(on_b[5], want_b[5])
    if kind == "saturating":
        assert bool((want_f[3][:, 0] > 0).all()), want_f[3].tolist()
        assert bool((want_b[5][:, 0] > 0).all()), want_b[5].tolist()


@pytest.mark.gpu
def test_attention_dkv_kernel_residency(card):
    """The dK/dV kernel runs two blocks an SM with no spills."""
    import ctypes
    from repro_torch.kernels import build
    info = (ctypes.c_int * 6)()
    assert build.load("fp8_attention_bwd").attn_bwd_dkv_info(128, info) == 0
    assert info[2] == 0 and info[3] >= 2 and info[5] == 0, list(info)


@pytest.fixture(scope="module")
def dkv_probe_lib(tmp_path_factory):
    """The backward built with -DDKV_PROBE: its dK/dV kernel records the
    schedule it ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run on the card")
    from repro_torch.kernels.fp8_attention import probe
    return probe.build_dkv_probe(tmp_path_factory.mktemp("dkv_probe"))[0]


@pytest.mark.gpu
@pytest.mark.parametrize("case", [0, 1, 2],
                         ids=["train", "causal-window", "full-ragged"])
def test_attention_dkv_kernel_runs_the_stated_schedule(card, dkv_probe_lib,
                                                       case):
    """Each dK/dV block's head, batch row and kv block, and the q tiles it
    visited, as the kernel recorded them, are those ops.dkv_block_order /
    dkv_live_tiles state (the rule the CPU tests hold against the plain
    version's skip set)."""
    from repro_torch.kernels.fp8_attention import probe
    assert probe.dkv_schedule_faults(
        dkv_probe_lib, probe.dkv_case_list(card)[case]) == []


@pytest.mark.gpu
def test_attention_bwd_rejects_other_masks(card):
    x = torch.zeros((1, 2, 8, 64), dtype=torch.float8_e4m3fn, device=card)
    with pytest.raises(ValueError, match="causal/full"):
        attn.fp8_attention_bwd(x, x, x, x.to(torch.float8_e5m2), 0,
                               [1.0] * 10, mask_mode="chunk")


# (K, N) of the forward projection GEMMs of qwen2-1.5b (wq / wo, wk / wv,
# up / gate, down) at M = 2048 rows (B=4 x S=512; 'down' takes 128x256
# tiles, the others 128x128), the largest at the serving path's M = 128,
# and ragged shapes that the wrapper pads (128x128 and 128x256 tiles).
MM_CASES = [(2048, 1536, 1536), (2048, 1536, 256), (2048, 1536, 8960),
            (2048, 8960, 1536), (100, 200, 72), (128, 1536, 8960),
            (2000, 4100, 1500)]


@pytest.mark.gpu
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fmts", [("e5m2", "e5m2"), ("e4m3", "e5m2")],
                         ids=["paper", "mixed"])
@pytest.mark.parametrize("shape", MM_CASES,
                         ids=["x".join(map(str, c)) for c in MM_CASES])
def test_fp8_matmul_kernel_matches_plain(card, shape, fmts, out):
    """Kernel 5 against its plain version on the card, bit for bit on exact
    inputs (exponents {0, 1}: every f32 sum below 2^24 units, exact in any
    order); one launch."""
    m, k, n = shape
    gen = torch.Generator().manual_seed(10)
    a = exact_fp8((m, k), fmts[0], gen).to(card)
    b = exact_fp8((k, n), fmts[1], gen).to(card)
    tile = fq.gemm_tile(m, n, k)
    launches = mm.fp8_matmul.launches
    by_tile = mm.fp8_matmul.launches_by_tile[tile]
    got = mm.fp8_matmul(a, b, out)
    want = (a.float() @ b.float()).to(out)
    torch.cuda.synchronize()
    assert mm.fp8_matmul.launches == launches + 1
    assert mm.fp8_matmul.launches_by_tile[tile] == by_tile + 1
    assert got.dtype == out and torch.equal(got, want)


# xlstm-125m's projections, (C, N): the mLSTM's w_up / w_gate, wq / wk /
# wv, w_if (N = 2 x 4 heads = 8), w_down; the sLSTM's w_zifo, ff_up /
# ff_gate, ff_down. Its training step runs each at M = B x S = 4 x 2048
# rows in the forward (nn), dgrad (nt: w_if's contracts K = 8) and wgrad
# (tn: w_if's writes N = 8) layouts; serving's decode runs the forward at
# M = 4.
XLSTM_PROJ = [(768, 1536), (1536, 1536), (1536, 8), (1536, 768),
              (768, 3072), (768, 1024), (1024, 768)]
XLSTM_M = 4 * 2048


@pytest.mark.gpu
@pytest.mark.parametrize("proj", XLSTM_PROJ,
                         ids=["x".join(map(str, p)) for p in XLSTM_PROJ])
def test_gemm_kernels_at_xlstm_shapes_match_plain(card, proj):
    """Kernel 1 in each layout of the training step (the recipe's formats:
    e4m3 forward, e5m2 adjoints; RNE and SR) and kernel 5 at the forward
    shapes (e5m2 x e5m2, f32 out), at xlstm-125m's shapes, against their
    plain versions on the card: bit for bit on exact inputs, amax and
    counts equal; the padding of N = 8 / K = 8 to a whole tile moves
    neither."""
    from repro_torch.kernels.fused_quant_matmul import ref as fq_ref
    c, n = proj
    gen = torch.Generator().manual_seed(12)
    cases = [("nn", (XLSTM_M, c), (c, n), "e4m3", "e4m3"),
             ("nt", (XLSTM_M, n), (c, n), "e5m2", "e4m3"),
             ("tn", (XLSTM_M, c), (XLSTM_M, n), "e4m3", "e5m2"),
             ("nn", (4, c), (c, n), "e4m3", "e4m3")]
    for dims, sa, sb, fa, fb in cases:
        a = exact_fp8(sa, fa, gen).to(card)
        b = exact_fp8(sb, fb, gen).to(card)
        m, nn, k = fq_ref.gemm_shape(a.shape, b.shape, dims)
        out = "e4m3" if dims == "nn" else "e5m2"
        scale = 2.0 ** round(math.log2(
            fq_ref.dot_f32(a, b, dims).abs().max().item() / 200.0))
        rand8 = torch.randint(0, 256, (m, nn), dtype=torch.uint8,
                              generator=gen).to(card)
        for rounding in ("rne", "sr"):
            kw = dict(dims=dims, out_format=out, rounding=rounding,
                      saturate=dims == "nn")
            launches = fq.fused_quant_matmul.launches
            q, amax, counts = fq.fused_quant_matmul(
                a, b, scale, rand8=rand8, with_amax=True, with_counts=True,
                **kw)
            qp, ap, cp = fq_ref.fused_quant_matmul_ref(
                a, b, rand8 if rounding == "sr" else None, scale, **kw)
            torch.cuda.synchronize()
            assert fq.fused_quant_matmul.launches == launches + 1
            assert q.shape == (m, nn)
            assert torch.equal(canon(q), canon(qp)), (dims, sa, rounding)
            assert torch.equal(amax, ap)
            assert torch.equal(counts, cp / torch.tensor(float(m * nn),
                                                         device=card))
        if dims == "nn":
            a5 = exact_fp8(sa, "e5m2", gen).to(card)
            b5 = exact_fp8(sb, "e5m2", gen).to(card)
            launches = mm.fp8_matmul.launches
            got = mm.fp8_matmul(a5, b5, torch.float32)
            want = a5.float() @ b5.float()
            torch.cuda.synchronize()
            assert mm.fp8_matmul.launches == launches + 1
            assert torch.equal(got, want), (sa, sb)


SPECIAL = [float("inf"), float("-inf"), float("nan"), 0.0, -0.0, 1e-40,
           2.0 ** -17, -3e-6, 2.0 ** -8, -5e-3, 1e6, -7e4, 57344.0, 61440.0,
           65519.0, 70000.0, 448.0, 464.0, 470.0, 480.0, -500.0]


def _sr_input(shape, dtype, gen):
    x = torch.randn(shape, generator=gen) * torch.exp2(
        torch.randint(-20, 17, shape, generator=gen).float())
    x.view(-1)[:len(SPECIAL)] = torch.tensor(SPECIAL)
    return x.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("saturate", [True, False])
@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2048, 8960), (37, 51)],
                         ids=["train", "ragged"])
def test_sr_kernels_match_plain(card, shape, dtype, fmt, saturate):
    """Kernels 6 (bits from a uint8 operand) and 7 (bits from the in-kernel
    hash) against their plain versions on the card, bit for bit on every
    input (NaNs compared as NaN), inf / NaN / subnormal / overflow values
    included; the ragged shape runs the kernel's scalar tail, and a view
    that starts off a 16-byte boundary goes through the wrapper's copy."""
    gen = torch.Generator().manual_seed(11)
    x = _sr_input(shape, dtype, gen).to(card)
    rand8 = torch.randint(0, 256, shape, dtype=torch.uint8,
                          generator=gen).to(card)
    kw = dict(fmt=fmt, saturate=saturate)
    n6, n7 = sr.sr_quantize.launches, sr.sr_quantize_onchip.launches
    got6 = sr.sr_quantize(x, rand8, 0.37, **kw)
    want6 = sr_ref.stochastic_round_fp8_ref(x, rand8, 0.37, **kw)
    got7 = sr.sr_quantize_onchip(x, 12345, 0.37, **kw)
    want7 = sr_ref.stochastic_round_fp8_onchip_ref(x, 12345, 0.37, **kw)
    flat = x.reshape(-1)[1:]
    got_off = sr.sr_quantize_onchip(flat, 7, **kw)
    want_off = sr_ref.stochastic_round_fp8_onchip_ref(flat, 7, **kw)
    torch.cuda.synchronize()
    assert sr.sr_quantize.launches == n6 + 1
    assert sr.sr_quantize_onchip.launches == n7 + 2
    assert torch.equal(canon(got6), canon(want6))
    assert torch.equal(canon(got7), canon(want7))
    assert torch.equal(canon(got_off), canon(want_off))


@pytest.mark.gpu
def test_two_rank_fp8_wire_step_on_the_card(card, tmp_path):
    """The data-parallel launcher's fp8_ef step, two ranks on the card
    over gloo (NCCL refuses two ranks on one device): each rank runs the
    smoke qwen2's hybrid step through the kernels; afterwards the ranks'
    master weights, optimizer and loss-scale state and ScaleState are
    equal bit for bit, and the bytes comm counted for the step's
    reduction are the ring model's fp8 figure plus each leaf's padding to
    an even count, half of bf16's."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    import numpy as np

    import repro_torch
    from repro_torch.launch.train import _leaves
    from repro_torch.models.registry import build_config
    from repro_torch.models.transformer import init_lm
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    report = tmp_path / "report"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
           "--backend", "gloo", "--smoke", "--wire", "fp8_ef", "--steps",
           "1", "--recipe", "hybrid", "--seq", "64", "--ckpt-dir",
           str(tmp_path / "ckpt"), "--report", str(report)]
    res = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    reps = [json.loads((report / f"rank{r}.json").read_text())
            for r in range(2)]
    for key in ("state_digest", "scale_state_digest"):
        assert reps[0][key] == reps[1][key]
    assert reps[0]["launches"]["fused_quant_matmul.nn"] > 0
    shapes = [tuple(p.shape) for p in _leaves(init_lm(
        build_config("qwen2-1.5b", smoke=True), device="cpu"))]
    numel = sum(int(np.prod(s)) for s in shapes)
    pad = sum(int(np.prod(s)) % 2 for s in shapes)
    for rep in reps:
        rec = rep["records"][0]
        assert rec["comm/bytes_fp8_ef"] == numel
        assert rec["comm/sent_payload_bytes"] == numel + pad
        assert rec["comm/ratio_fp8_vs_bf16"] <= 0.55


ZERO_CHILD = """
import sys
from repro_torch.launch import train
if sys.argv[1] == "off":
    real = train.build_plan
    train.build_plan = lambda *a, **k: real(*a, **dict(k, zero1=False))
train.main(sys.argv[2:])
"""


@pytest.mark.gpu
def test_two_rank_zero1_moe_full_step_on_the_card(card, tmp_path):
    """The launcher's "full" step of the smoke moonshot (mixture of
    experts, per-sample dispatch), two ranks on the card over gloo, with
    ZeRO-1 on (the launcher's default) against ZeRO-1 off: at two ranks
    the gathered master weights, moments, loss scale and ScaleState are
    equal bit for bit, and equal on both ranks."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    import repro_torch
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    script = tmp_path / "zero_child.py"
    script.write_text(ZERO_CHILD)
    reps = {}
    for mode in ("on", "off"):
        report = tmp_path / f"report_{mode}"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", str(script), mode, "--backend",
               "gloo", "--arch", "moonshot-v1-16b-a3b", "--smoke", "--wire",
               "full", "--steps", "1", "--recipe", "hybrid", "--seq", "64",
               "--checkpoint-every", "0", "--ckpt-dir",
               str(tmp_path / f"ckpt_{mode}"), "--report", str(report)]
        res = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=src),
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        reps[mode] = [json.loads((report / f"rank{r}.json").read_text())
                      for r in range(2)]
    assert reps["on"][0]["plan"]["zero1_axis"] == "data"
    assert reps["off"][0]["plan"]["zero1_axis"] is None
    for key in ("state_digest", "scale_state_digest"):
        assert len({rep[key] for rr in reps.values() for rep in rr}) == 1
    rec = reps["on"][0]["records"][0]
    assert rec["comm/sent_zero_gather_bytes"] > 0
    assert "lb_loss" in rec and rec["loss"] == reps["off"][0]["records"][0][
        "loss"]
