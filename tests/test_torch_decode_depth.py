"""xlstm-125m's prefill -> decode against its train forward at depth, in
both packages on the same weights (the reference's smoke config, baseline
numerics, chunks of 8 at S = 28, seeded prompts): the reference's own gap
grows with the depth past its test's bound
(tests/test_models.py::test_decode_matches_train) on some prompts, and
the port reads the same gap prompt by prompt. The reference's jitted
program runs with XLA's `xla_allow_excess_precision` off; torch on one
intra-op thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision_policy import BASELINE_POLICY
from repro.models import transformer as jtr
from repro.models.registry import build_config as j_build_config
from repro_torch.core import precision_policy as tpp
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import from_jax_params
from test_torch_xlstm import ARCH, B, CHUNK, PER_OP, S, cfgs, f32, ref_params

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The gap between prefill(S) + decode(1) and the train forward over S + 1
# tokens is the reference test's reading (its bound: 0.05 max|logit|,
# tests/test_models.py::test_decode_matches_train). Per prompt, the port's
# gap lies within GAP_TOL of max|logit| of the reference's on the same
# weights (read: at most 0.0088 at 12 layers, 0.0014 at 4).
GAP_TOL = 0.02
GAP_PROMPTS = 10


@pytest.mark.parametrize("n_layers", [4, 12])
def test_decode_gap_is_the_references(n_layers):
    """Baseline numerics at smoke width on the reference's weights (12
    layers: three scanned groups), chunks of 8 at S = 28, GAP_PROMPTS
    seeded prompts: the port's and the reference's own prefill -> decode
    against their train forwards, prompt by prompt. The decode step
    rounds v k^T and q / sqrt(dh) to bf16 where the train forward's
    chunkwise form does not, and the seeded stack carries such last-bit
    differences into the logits more the deeper it is: at 12 layers the
    reference's own gap reads 0.025-0.106 of max|logit| and passes its
    test's bound on 8 of the 10 prompts; the port reads the same prompts
    past it (at 4 layers both read 0.009-0.024)."""
    _, tcfg = cfgs()
    tcfg = tcfg.replace(n_layers=n_layers, policy=tpp.BASELINE_POLICY)
    # ref_params' own config: scanned where it has groups to scan.
    jcfg = j_build_config(ARCH, smoke=True).replace(
        n_layers=n_layers, policy=BASELINE_POLICY, remat=False,
        attn_chunk_size=CHUNK)
    host = ref_params(n_layers)
    tp = from_jax_params(host, tcfg, device="cpu")
    s = S

    def ref(params, toks):
        full, _, _ = jtr.forward(params, toks, cfg=jcfg)
        st = jtr.init_stack_state(jcfg, B, max_len=64, n_layers=n_layers)
        _, st, _ = jtr.forward(params, toks[:, :s], cfg=jcfg, mode="prefill",
                               states=st)
        ld, _, _ = jtr.forward(params, toks[:, s:], cfg=jcfg, mode="decode",
                               states=st,
                               positions=jnp.full((B, 1), s, jnp.int32))
        return full[:, s], ld[:, 0]
    ref = jax.jit(ref, compiler_options=PER_OP)
    jparams = jax.tree_util.tree_map(jnp.asarray, host)
    gaps = []
    for seed in range(GAP_PROMPTS):
        toks = np.random.default_rng(100 + seed).integers(
            0, tcfg.vocab_size, (B, s + 1)).astype(np.int32)
        jf, jd = (f32(x) for x in ref(jparams, jnp.asarray(toks)))
        t = torch.from_numpy(toks).long()
        with torch.no_grad():
            full, _ = ttr.forward(tp, t, cfg=tcfg)
            st = ttr.init_stack_state(tcfg, B, 64, device="cpu")
            _, st = ttr.forward(tp, t[:, :s], cfg=tcfg, mode="prefill",
                                states=st)
            ld, _ = ttr.forward(tp, t[:, s:], cfg=tcfg, mode="decode",
                                states=st,
                                positions=torch.full((B, 1), s))
        scale = float(np.abs(jf).max())
        gaps.append((float(np.abs(jd - jf).max()) / scale,
                     float(np.abs(f32(ld[:, 0]) - f32(full[:, s])).max())
                     / scale))
    for i, (g_ref, g_port) in enumerate(gaps):
        assert abs(g_port - g_ref) <= GAP_TOL, (i, g_ref, g_port)
    if n_layers == 12:
        # The reference's own check does not hold at this depth.
        assert max(g for g, _ in gaps) > 0.05
    else:
        assert max(max(g) for g in gaps) < 0.05
