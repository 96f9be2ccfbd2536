"""Shared layers: norm, gated MLP, embeddings, RoPE (counterpart of
``repro/models/layers.py``): the variants the port's dense decoders use
(RMSNorm, bias-free SwiGLU, tied or untied embeddings, half-split RoPE);
``model._check_supported`` rejects configs that need others. Every norm runs through
``kernels.ops.fused_rmsnorm`` (the CUDA kernel on the card, its plain
version on the CPU)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig


def add_norm(cfg: ModelConfig, p, x, residual=None, eps: float = 1e-6):
    """(rmsnorm(x + residual) * scale, x + residual) over the last axis in
    one fused pass; the sum is rounded to x's dtype before the norm, as
    the reference block's ``x = x + a; apply_norm(x)`` rounds it."""
    d = x.shape[-1]
    y, r = ops.fused_rmsnorm(
        x.reshape(-1, d).contiguous(), p["scale"],
        None if residual is None else residual.reshape(-1, d).contiguous(),
        eps=eps)
    return y.reshape(x.shape), r.reshape(x.shape)


def apply_norm(cfg: ModelConfig, p, x, eps: float = 1e-6):
    """RMSNorm in fp32, cast back to x's dtype (``layers.py:24-37``)."""
    return add_norm(cfg, p, x, None, eps)[0]


def apply_mlp(cfg: ModelConfig, p, x):
    """SwiGLU: silu(x @ w_gate) * (x @ w_up) @ w_down (``layers.py:72-87``)."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def embed_tokens(cfg: ModelConfig, p, tokens):
    return p["tok"][tokens]


def unembed(cfg: ModelConfig, p, x):
    """Logits: x @ tok.T when the embeddings are tied, else x @ unembed,
    a (d, V) leaf (``layers.py:114-122``)."""
    if cfg.tie_embeddings:
        return x @ p["tok"].T
    return x @ p["unembed"]


def apply_rope(cfg: ModelConfig, x, positions):
    """Half-split RoPE. x: (..., S, H, D) or (..., S, D); positions (..., S)."""
    d = x.shape[-1]
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions[..., None].float() * inv                # (..., S, d/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    if x.dim() == positions.dim() + 2:                      # head axis present
        sin, cos = sin[..., None, :], cos[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
