"""Deterministic synthetic data (counterpart of `repro.data.pipeline`):
numpy only, so the port and the reference read the very same batches.

LM batches: an affine-bigram language — next = (a * prev + b) mod V,
replaced by a uniform token with probability `temperature`. Unigram
entropy is ~log V, so a loss well below log V shows that the model learned
the bigram map. Seq2seq batches: embedded source frames for the encoder
and the bigram map of the source as the decoder's target. Image batches:
class-dependent 2-D sinusoids plus noise (a CIFAR-scale stand-in). Every
batch is a pure function of (seed, step).
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


def synthetic_seq2seq_batches(cfg: DataConfig, *, d_model: int,
                              start_step: int = 0
                              ) -> Iterator[Dict[str, np.ndarray]]:
    """Encoder-decoder batches: 'enc_inputs' (B, S, d_model) f32 are the
    source tokens' frame embeddings; the decoder predicts tgt[t + 1] =
    (a * src[t + 1] + b) mod V from tgt[:t + 1] ('tokens' / 'labels' /
    'loss_mask', (B, S - 1))."""
    a, b = _bigram_params(cfg.vocab_size, cfg.seed)
    emb_rng = np.random.default_rng(cfg.seed + 77)
    emb = emb_rng.standard_normal((cfg.vocab_size, d_model)).astype(
        np.float32) * 0.5
    step = start_step
    while True:
        rng = np.random.default_rng((cfg.seed, 10_000 + step))
        src = rng.integers(0, cfg.vocab_size,
                           (cfg.batch_size, cfg.seq_len)).astype(np.int32)
        tgt = (a * src + b) % cfg.vocab_size
        yield {
            "enc_inputs": emb[src],
            "tokens": tgt[:, :-1],
            "labels": tgt[:, 1:].astype(np.int32),
            "loss_mask": np.ones((cfg.batch_size, cfg.seq_len - 1),
                                 np.float32),
        }
        step += 1


def synthetic_image_batches(*, batch_size: int = 64, image_size: int = 32,
                            n_classes: int = 10, seed: int = 0,
                            task_seed: int = 0, start_step: int = 0,
                            noise: float = 0.3
                            ) -> Iterator[Dict[str, np.ndarray]]:
    """{'image' (B, H, W, 3) f32, 'label' (B,) int32}: class-dependent 2-D
    sinusoids plus Gaussian noise. task_seed fixes the class prototypes
    apart from the sampling stream `seed`, so train and validation streams
    draw from the same task."""
    proto_rng = np.random.default_rng(task_seed + 55)
    freqs = proto_rng.uniform(1.0, 4.0, (n_classes, 2))
    phases = proto_rng.uniform(0, 2 * np.pi, (n_classes, 3))
    xx, yy = np.meshgrid(np.linspace(0, 2 * np.pi, image_size),
                         np.linspace(0, 2 * np.pi, image_size))
    step = start_step
    while True:
        rng = np.random.default_rng((seed, 20_000 + step))
        labels = rng.integers(0, n_classes, batch_size).astype(np.int32)
        f = freqs[labels]
        p = phases[labels]
        base = np.stack([
            np.sin(f[:, 0, None, None] * xx[None] + p[:, c, None, None])
            * np.cos(f[:, 1, None, None] * yy[None])
            for c in range(3)], axis=-1).astype(np.float32)
        eps = rng.standard_normal(base.shape).astype(np.float32) * noise
        yield {"image": base + eps, "label": labels}
        step += 1


def host_shard(batch: Dict[str, np.ndarray], host_id: int,
               n_hosts: int) -> Dict[str, np.ndarray]:
    """This rank's slice of the global batch: rows [host_id * per,
    (host_id + 1) * per) of every entry, per = rows // n_hosts (the
    reference's pure slice)."""
    def slc(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per:(host_id + 1) * per]
    return {k: slc(v) for k, v in batch.items()}


def microbatch_shard(batch: Dict[str, np.ndarray], host_id: int,
                     n_hosts: int, n_microbatches: int
                     ) -> Dict[str, np.ndarray]:
    """This rank's rows for a data-parallel "full" step of n microbatches:
    for each microbatch i in turn, its `host_shard` of the reference's
    microbatch i, the global rows [i B / n, (i + 1) B / n), so that the
    step's split of these rows into n gives, in microbatch i, this rank's
    share of the reference's. One microbatch: `host_shard`."""
    def slc(x):
        per = x.shape[0] // (n_microbatches * n_hosts)
        return np.concatenate([
            x[(i * n_hosts + host_id) * per:(i * n_hosts + host_id + 1)
              * per] for i in range(n_microbatches)])
    return {k: slc(v) for k, v in batch.items()}
