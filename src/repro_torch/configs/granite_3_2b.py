"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155. GQA. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab_size=49155,
        act="silu", norm="rmsnorm", pos="rope", rope_theta=10000.0,
        tie_embeddings=True, dtype="bfloat16", remat="full",
        attn_impl="blocked",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, dtype="float32", remat="none", attn_impl="xla")
