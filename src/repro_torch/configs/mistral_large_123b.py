"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407; unverified]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="mistral-large-123b", family="dense",
        n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
        d_ff=28672, vocab_size=32768,
        act="silu", rope_theta=1_000_000.0, max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return full().replace(n_layers=4, d_model=128, n_heads=8, n_kv_heads=2,
                          d_ff=256, vocab_size=512, max_seq_len=256)
