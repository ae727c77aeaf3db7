"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 — encoder-decoder, multimodal [arXiv:2308.11596; hf].
The speech frontend is a stub: a batch's "enc_inputs" holds
precomputed frame embeddings (B, T, D) consumed directly by the encoder;
24 encoder + 24 decoder layers."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch="seamless-m4t-large-v2", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab_size=256206,
        is_encoder_decoder=True, n_encoder_layers=24,
        frontend="audio_stub",
        act="gelu", max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, n_encoder_layers=2, d_model=128,
                          n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
                          max_seq_len=256)
