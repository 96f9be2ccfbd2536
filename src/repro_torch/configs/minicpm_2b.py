"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753. WSD schedule (arch=llama-like). [arXiv:2404.06395]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab_size=122753,
        act="silu", norm="rmsnorm", pos="rope", rope_theta=10000.0,
        tie_embeddings=True, dtype="bfloat16", remat="full",
        attn_impl="blocked",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=72, n_heads=6, n_kv_heads=6, d_ff=144,
        vocab_size=256, dtype="float32", remat="none", attn_impl="xla")
