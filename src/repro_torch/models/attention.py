"""GQA attention for the dense family (counterpart of
``repro/models/attention.py``).

Two modes:
  * prefill — whole prompt, causal, plain matmul + fp32 softmax (the
    reference computes it outside any Pallas kernel); the prompt's K/V can
    be written straight into pages.
  * decode  — one token per row: append K/V through the block table, then
    attend over the slot's pages through ``kernels.ops.paged_attention``
    (the CUDA kernel on the card, the plain version on the CPU).

Paged store, one layer: {"k": (P + 1, page, n_kv, Dh), "v": ...} and, for
int8 KV, "k_scale"/"v_scale" (P + 1, page, n_kv) f32. Page ``P`` is a trash
page that no block table maps: the reference redirects dead-lane and pad
writes to the out-of-bounds page ``P`` and relies on JAX dropping them;
in PyTorch an out-of-bounds write raises (CPU) or asserts (CUDA), so those
writes land in the trash page instead. The port writes the store in place
(JAX returns a new one), which keeps one copy of the cache in memory.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, kv_torch_dtype
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


# ======================================================================
# KV quantization helpers (int8 per-token-per-head symmetric)
# ======================================================================

def quantize_kv(x):
    """x: (..., n_kv, Dh) -> (int8 values, float32 scales (..., n_kv))."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


# ======================================================================
# projections + prefill
# ======================================================================

def _project_qkv(cfg: ModelConfig, p, x, positions):
    B, T = x.shape[:2]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, T, h, dh)
    k = (x @ p["wk"]).reshape(B, T, kv, dh)
    v = (x @ p["wv"]).reshape(B, T, kv, dh)
    if cfg.pos == "rope":
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    return q, k, v


def gqa_full(cfg: ModelConfig, p, x, positions):
    """Causal prefill attention over the whole sequence. Returns
    (y, (k, v)) with k/v (B, T, n_kv, Dh)."""
    B, T = x.shape[:2]
    h, kv_h, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(cfg, p, x, positions)
    qg = q.reshape(B, T, kv_h, h // kv_h, dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k).float() / math.sqrt(dh)
    mask = positions[:, None, :] <= positions[:, :, None]          # (B,T,S)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
    return out.reshape(B, T, h * dh) @ p["wo"], (k, v)


# ======================================================================
# paged store
# ======================================================================

def init_paged_gqa_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                         *, layers: int, device):
    """``layers`` stacked page stores of ``n_pages`` pages plus the trash
    page: leaves (layers, n_pages + 1, page, n_kv, Dh)."""
    shape = (layers, n_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    dt = kv_torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def write_pages(cache, k, v, page, off):
    """Write K/V rows into one layer's page store in place. k/v
    (..., n_kv, Dh); page/off index tensors of the same leading shape.
    Rows aimed at the trash page land there and are never read."""
    if "k_scale" in cache:
        qk, sk = quantize_kv(k)
        qv, sv = quantize_kv(v)
        cache["k"][page, off] = qk
        cache["v"][page, off] = qv
        cache["k_scale"][page, off] = sk
        cache["v_scale"][page, off] = sv
    else:
        cache["k"][page, off] = k.to(cache["k"].dtype)
        cache["v"][page, off] = v.to(cache["v"].dtype)


def _paged_cache_write(cache, new_k, new_v, positions, block_table, live):
    """Append one token per row through the block table.

    Rows whose table entry is unmapped (-1) or out of the table, and rows
    whose lane is dead (``live`` False), go to the trash page, so a dead
    lane can never corrupt a page that was re-allocated to another slot.
    """
    trash = cache["k"].shape[0] - 1
    ps = cache["k"].shape[1]
    idx = (positions // ps).long()
    inb = idx < block_table.shape[1]
    entry = torch.take_along_dim(
        block_table, idx.clamp_max(block_table.shape[1] - 1)[:, None], dim=1)[:, 0]
    ok = inb & (entry >= 0)
    if live is not None:
        ok = ok & live
    page = torch.where(ok, entry.long(), trash)
    write_pages(cache, new_k[:, 0], new_v[:, 0], page, (positions % ps).long())


def gqa_decode_paged(cfg: ModelConfig, p, x, positions, cache, block_table,
                     *, live=None):
    """Paged decode step: append the new token's K/V through the block
    table, then attend over the slot's pages.

    x: (B, 1, d); positions: (B,) absolute position of the new token;
    block_table: (B, max_pages) int32 (-1 = unmapped); live: (B,) bool or
    None. ``cache`` is one layer's page store, updated in place.
    """
    B = x.shape[0]
    h, dh = cfg.n_heads, cfg.head_dim
    q, k_new, v_new = _project_qkv(cfg, p, x, positions[:, None])
    _paged_cache_write(cache, k_new, v_new, positions, block_table, live)
    # append-only pages: validity == index < length, causality is implicit
    lengths = (positions + 1).to(torch.int32)
    out = ops.paged_attention(
        q[:, 0].contiguous(), cache["k"], cache["v"], block_table, lengths,
        cache.get("k_scale"), cache.get("v_scale"))
    return out.reshape(B, 1, h * dh) @ p["wo"]
