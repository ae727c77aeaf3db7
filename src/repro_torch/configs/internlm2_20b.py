"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA [arXiv:2403.17297; hf]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=92544,
        act="silu", rope_theta=1_000_000.0, max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return full().replace(n_layers=4, d_model=128, n_heads=8, n_kv_heads=2,
                          d_ff=256, vocab_size=512, max_seq_len=256)
