"""Plain PyTorch versions of the port's kernels (transcribed from
``repro/kernels/ref.py``). The CPU path runs them; ``chip_smoke.py`` holds
each hand-written kernel against them on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_table, lengths,
                        k_scale=None, v_scale=None):
    """Decode attention over a paged cache.

    q: (B, H, D); k_pages/v_pages: (P, ps, KVH, D) (int8 when scales given,
    scales (P, ps, KVH) f32); block_table: (B, max_pages) int32;
    lengths: (B,) tokens per slot. Returns (B, H, D) in q's dtype.
    """
    B, H, D = q.shape
    P, ps, KVH, _ = k_pages.shape
    max_pages = block_table.shape[1]
    S = max_pages * ps
    g = H // KVH
    pages = block_table.long().clamp(0, P - 1)                 # (B, max_pages)
    kk = k_pages[pages].reshape(B, S, KVH, D).float()
    vv = v_pages[pages].reshape(B, S, KVH, D).float()
    if k_scale is not None:
        kk = kk * k_scale[pages].reshape(B, S, KVH)[..., None]
        vv = vv * v_scale[pages].reshape(B, S, KVH)[..., None]
    qh = q.reshape(B, KVH, g, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qh, kk) / math.sqrt(D)
    valid = torch.arange(S, device=q.device)[None, :] < lengths.long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, vv).reshape(B, H, D)
    return out.to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Prefill attention in the reference layout, fp32 scores and fp32 P·V.

    q: (B, H, Tq, D); k/v: (B, KVH, Tk, D); head h reads KV head
    h // (H // KVH). Masks are top-left aligned (query i, key j):
    causal keeps j <= i, window > 0 keeps j > i - window. Returns
    (B, H, Tq, D) in q's dtype.
    """
    B, H, Tq, D = q.shape
    KVH, Tk = k.shape[1], k.shape[2]
    g = H // KVH
    qg = q.reshape(B, KVH, g, Tq, D).float()
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) / math.sqrt(D)
    qpos = torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", p, v.float())
    return out.reshape(B, H, Tq, D).to(q.dtype)


def fused_rmsnorm_ref(x, scale, residual=None, eps: float = 1e-6):
    """(rmsnorm(x + residual) * scale, x + residual) for rows x (N, d).

    The sum is rounded to x's dtype and the rounded sum is normalized, as
    the reference model's block does (``x = x + a; apply_norm(x)``); the
    reduction runs in fp32 and y is cast to x's dtype.
    """
    r = x if residual is None else x + residual
    rf = r.float()
    ms = rf.square().mean(dim=-1, keepdim=True)
    y = rf * torch.rsqrt(ms + eps) * scale.float()
    return y.to(x.dtype), r
