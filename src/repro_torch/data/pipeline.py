"""Deterministic synthetic LM data (counterpart of the LM half of
`repro.data.pipeline`): numpy only, so the port and the reference read the
very same batches.

An affine-bigram language — next = (a * prev + b) mod V, replaced by a
uniform token with probability `temperature`. Unigram entropy is ~log V,
so a loss well below log V shows that the model learned the bigram map.
Every batch is a pure function of (seed, step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 512
    seq_len: int = 128
    batch_size: int = 32
    seed: int = 0
    temperature: float = 0.3


def _bigram_params(vocab: int, seed: int):
    rng = np.random.default_rng(seed + 1234)
    a = int(rng.integers(1, vocab - 1)) | 1
    b = int(rng.integers(0, vocab))
    return a, b


def synthetic_lm_batches(cfg: DataConfig, *, start_step: int = 0
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {'tokens', 'labels', 'loss_mask'} — labels[t] = next token."""
    a, b = _bigram_params(cfg.vocab_size, cfg.seed)
    step = start_step
    while True:
        rng = np.random.default_rng((cfg.seed, step))
        toks = np.empty((cfg.batch_size, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, cfg.batch_size)
        noise = rng.random((cfg.batch_size, cfg.seq_len)) < cfg.temperature
        rand_next = rng.integers(0, cfg.vocab_size,
                                 (cfg.batch_size, cfg.seq_len))
        for t in range(cfg.seq_len):
            det = (a * toks[:, t] + b) % cfg.vocab_size
            toks[:, t + 1] = np.where(noise[:, t], rand_next[:, t], det)
        yield {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
            "loss_mask": np.ones((cfg.batch_size, cfg.seq_len), np.float32),
        }
        step += 1
