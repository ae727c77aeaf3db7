"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
        act="silu", rope_theta=1_000_000.0, max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return full().replace(n_layers=4, d_model=96, n_heads=6, n_kv_heads=2,
                          d_ff=192, vocab_size=512, max_seq_len=256)
