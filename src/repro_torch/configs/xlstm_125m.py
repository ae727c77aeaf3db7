"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks [arXiv:2405.04517; unverified]. Pattern: 3 mLSTM : 1 sLSTM (the
xLSTM paper places a handful of sLSTM blocks among mLSTM ones). d_ff=0:
blocks carry their own projections (the mLSTM's up-projection sandwich at
factor 2, the sLSTM's gated FFN)."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        ssm_proj_factor=2.0,
        act="gelu", max_seq_len=1_048_576,
    )


def smoke() -> ModelConfig:
    return full().replace(n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                          vocab_size=512, max_seq_len=512)
