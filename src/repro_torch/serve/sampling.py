"""Batched sampling for the serving engine (counterpart of
`repro.serve.sampling`), on the device that holds the logits.

Reproducibility: each row draws from its own `torch.Generator`, seeded from
(request seed, tokens generated so far), so a request's samples do not
depend on its batch row or its neighbours. The numbers differ from the
reference's jax.random streams; the distributions are the same. Greedy
(temperature <= 0) is the argmax, first index on ties, as in the reference.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

NEG_INF = -1e30


def row_generators(seeds: Sequence[int], steps: Sequence[int],
                   device) -> List[torch.Generator]:
    """One generator per row from per-request (seed, n_generated)."""
    return [torch.Generator(device=device).manual_seed(
                (int(s) * 1_000_003 + int(t)) % (1 << 63))
            for s, t in zip(seeds, steps)]


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row (ties at the threshold all kept)."""
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= thresh, logits,
                       torch.full_like(logits, NEG_INF))


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus mask: the smallest descending-probability prefix whose mass
    reaches p (the crossing token is kept; the top token always is)."""
    if p >= 1.0:
        return logits
    sorted_logits, idx = torch.sort(logits, dim=-1, descending=True,
                                    stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < p
    keep = torch.zeros_like(keep_sorted).scatter(-1, idx, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def sample(logits: torch.Tensor, generators, *, temperature: float,
           top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """One token id per row of (B, V) logits; `generators` from
    row_generators (unused when greedy)."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = top_p_mask(top_k_mask(logits / temperature, top_k), top_p)
    probs = torch.softmax(scaled, dim=-1)
    return torch.cat([torch.multinomial(probs[i], 1, generator=g)
                      for i, g in enumerate(generators)]).to(torch.int32)
