"""Model configuration and device helpers (counterpart of
``repro/models/common.py``).

``ModelConfig`` carries the reference's fields unchanged, so a config
built for the JAX package describes the same model here. The jnp dtype
properties become ``torch_dtype`` / ``kv_torch_dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description (one per assigned architecture)."""

    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 0          # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab_size: int = 256

    # --- norm / activation / embeddings ---
    act: str = "silu"            # silu | gelu | relu2
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    use_bias: bool = False
    tie_embeddings: bool = False
    pos: str = "rope"            # rope | learned | sinusoidal | none
    rope_theta: float = 10000.0
    max_position: int = 1 << 20
    logit_softcap: float = 0.0

    # --- attention ---
    attn_type: str = "gqa"       # gqa | mla
    sliding_window: int = 0      # 0 = full attention
    global_layer_every: int = 0  # >0: every k-th layer is full-attn (hybrid)

    # --- MLA (deepseek-style) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0      # leading dense-FFN layers (deepseek: 3, kimi: 1)
    capacity_factor: float = 1.25
    router_scale: float = 1.0

    # --- SSM (mamba) / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: int = 0             # 0 -> 2 * d_model
    ssm_dt_rank: int = 0         # 0 -> ceil(d_model / 16)

    # --- xLSTM ---
    block_pattern: Tuple[str, ...] = ()  # e.g. ("m",)*7 + ("s",) repeated
    proj_factor: float = 2.0
    chunk_size: int = 64

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0             # encoder context (stub frontend frames)
    enc_d_model: int = 0         # 0 -> d_model

    # --- VLM ---
    n_patches: int = 0           # stub ViT patch-embedding count

    # --- multi-token prediction (deepseek-v3) ---
    mtp_depth: int = 0

    # --- numerics / runtime ---
    dtype: str = "float32"       # compute/param dtype ("bfloat16" on the card)
    kv_cache_dtype: str = ""     # "" -> dtype; "int8" enables quantized KV
    remat: str = "none"          # none | full | selective
    attn_impl: str = "xla"       # xla | pallas | blocked (reference names)
    moe_impl: str = "sorted"     # sorted (capacity, sort-based dispatch)
    scan_layers: bool = True

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.attn_type == "mla":
            return self.qk_nope_dim + self.qk_rope_dim
        return self.d_head or (self.d_model // self.n_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --- layer segmentation: contiguous runs of identical block types ----
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind; layers run in equal-kind segments."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "moe":
                kinds.append("dense" if i < self.n_dense_layers else "moe")
            elif self.family == "hybrid":
                g = self.global_layer_every
                full = g > 0 and (i % g == 0 or i == self.n_layers - 1)
                kinds.append("hyb_full" if full else "hyb_local")
            elif self.family == "ssm":
                pat = self.block_pattern or ("m",)
                kinds.append({"m": "mlstm", "s": "slstm"}[pat[i % len(pat)]])
            else:
                kinds.append("dense")
        return tuple(kinds)

    def segments(self) -> Tuple[Tuple[str, int], ...]:
        kinds = self.layer_kinds()
        segs = []
        for k in kinds:
            if segs and segs[-1][0] == k:
                segs[-1][1] += 1
            else:
                segs.append([k, 1])
        return tuple((k, n) for k, n in segs)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """Compute/parameter dtype (the reference's ``cfg.compute_dtype``)."""
    return _DTYPES[cfg.dtype]


def kv_torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """KV page dtype (the reference's ``cfg.kv_dtype``)."""
    return _DTYPES[cfg.kv_cache_dtype or cfg.dtype]


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for. A CUDA device on a
    machine without one raises here: nothing quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
