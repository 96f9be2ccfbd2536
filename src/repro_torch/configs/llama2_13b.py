"""llama2-13b — the paper's inference model (SPROUT serves this).
40L d_model=5120 40H (MHA) d_ff=13824 vocab=32000. [arXiv:2307.09288]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama2-13b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=13824, vocab_size=32000,
        act="silu", norm="rmsnorm", pos="rope",
        dtype="bfloat16", remat="full", attn_impl="blocked",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab_size=256, dtype="float32", remat="none", attn_impl="xla")
