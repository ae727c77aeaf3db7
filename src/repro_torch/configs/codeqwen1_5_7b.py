"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (GQA kv=32, i.e. MHA)
d_ff=13440 vocab=92416 — qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="codeqwen1.5-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=13440, vocab_size=92416, qkv_bias=True,
        act="silu", rope_theta=1_000_000.0, max_seq_len=65536,
    )


def smoke() -> ModelConfig:
    return full().replace(n_layers=4, d_model=128, n_heads=8, n_kv_heads=8,
                          d_ff=256, vocab_size=512, max_seq_len=256)
