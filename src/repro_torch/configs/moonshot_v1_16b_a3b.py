"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 (kimi/moonlight)
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=163840,
        n_experts=64, experts_per_token=6,
        act="silu", rope_theta=50_000.0, max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          d_ff=64, vocab_size=512, n_experts=8,
                          experts_per_token=2, max_seq_len=256)
