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
