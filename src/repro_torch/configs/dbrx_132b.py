"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained [hf:databricks/dbrx-base; unverified]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab_size=100352,
        n_experts=16, experts_per_token=4,
        act="silu", rope_theta=500_000.0, max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                          d_ff=128, vocab_size=512, n_experts=4,
                          experts_per_token=2, max_seq_len=256)
