"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1, i.e. MQA)
d_ff=12288 vocab=256000 — RG-LRU + local attention, pattern 2 recurrent : 1
local-attn [arXiv:2402.19427; unverified]. Window 2048 per Griffin."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab_size=256000,
        block_pattern=("rglru", "rglru", "local_attn"),
        window=2048, lru_dim=4096,
        act="gelu", max_seq_len=1_048_576,
    )


def smoke() -> ModelConfig:
    return full().replace(n_layers=3, d_model=128, n_heads=4, n_kv_heads=1,
                          d_ff=256, vocab_size=512, window=64, lru_dim=128,
                          max_seq_len=512)
