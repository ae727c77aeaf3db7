"""The paper's own Transformer workload (6 + 6 layers, WMT16 En->De; its
Table 4): an encoder-decoder with d_model 1024, 16 heads (head dim 64),
d_ff 4096, vocab 32000 and a gelu-gated MLP."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="paper-transformer", family="dense",
        n_layers=6, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=32000,
        is_encoder_decoder=True, n_encoder_layers=6,
        act="gelu", max_seq_len=1024,
    )


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, n_encoder_layers=2, d_model=128,
                          n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
                          max_seq_len=128)
