"""llama2-7b — the paper's MODEL_OPT small variant.
32L d_model=4096 32H (MHA) d_ff=11008 vocab=32000. [arXiv:2307.09288]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11008, vocab_size=32000,
        act="silu", norm="rmsnorm", pos="rope",
        dtype="bfloat16", remat="full", attn_impl="blocked",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, dtype="float32", remat="none", attn_impl="xla")
