"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]. The vision tower is a stub: a batch's
"extra_embeds" holds precomputed anyres patch embeddings (B, P, D) that the
backbone prepends to the token embeddings."""
from repro_torch.models.config import ModelConfig

# anyres 2x2 tiles + base view, 24x24 patches each -> 576 * 5 = 2880; we use
# one base view (576) to keep the train_4k text budget dominant.
N_PATCHES = 576


def full() -> ModelConfig:
    return ModelConfig(
        arch="llava-next-34b", family="vlm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab_size=64000,
        frontend="patch_stub", n_frontend_tokens=N_PATCHES,
        act="silu", rope_theta=5_000_000.0, max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                          d_ff=256, vocab_size=512, n_frontend_tokens=16,
                          max_seq_len=256)
