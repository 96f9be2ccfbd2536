"""GQA attention for the dense family (counterpart of
``repro/models/attention.py``).

Three modes:
  * prefill — whole prompt, causal, through ``kernels.ops.flash_attention``
    (the CUDA flash kernel on the card, its plain version on the CPU):
    fp32 scores and fp32 P·V, the arithmetic of the reference's full
    configs (``attn_impl="blocked"``, ``blocked_attn.flash_sdpa``); the
    prompt's K/V can be written straight into pages.
  * chunk   — one lane's prompt chunk: append its K/V through the lane's
    block-table row, then attend over the lane's pages with the
    reference's ``_sdpa`` arithmetic, in plain PyTorch on the card too, as
    the reference computes it outside any Pallas kernel.
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


def _sdpa(q, k, v, mask):
    """The reference's ``_sdpa`` (``attention.py:117-130``): scores rounded
    to the compute dtype before the fp32 softmax, probabilities rounded to
    v's dtype before P·V. q (B,Tq,KV,G,D), k/v (B,Tk,KV,D), mask (B,Tq,Tk)."""
    scores = torch.einsum("btkgd,bskd->bkgts", q, k).float()
    scores = scores / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)


def gqa_full(cfg: ModelConfig, p, x, positions):
    """Causal prefill attention over the whole sequence. Returns
    (y, (k, v)) with k/v (B, T, n_kv, Dh).

    Always the reference's blocked arithmetic (fp32 scores and P·V),
    whatever ``cfg.attn_impl`` says: at fp32 the xla path computes the
    same, and ``model._check_supported`` refuses xla at bf16.

    The mask is by index (query t sees keys s <= t), as in the flash
    kernel; ``positions`` only rotate q and k, so rows whose positions are
    one offset plus arange(T), such as the engine's prefill, mask as the
    reference's position mask does."""
    B, T = x.shape[:2]
    h, dh = cfg.n_heads, cfg.head_dim
    q, k, v = _project_qkv(cfg, p, x, positions)
    # (B, T, H, D) -> the kernel's (B, H, T, D) as views, no copy; the
    # output comes back with q's strides, so the reshape below is free
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True)
    return out.transpose(1, 2).reshape(B, T, h * dh) @ p["wo"], (k, v)


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


def gqa_chunk_append(cfg: ModelConfig, p, x, positions, valid, lane, cache,
                     *, block_table):
    """Append one lane's prompt chunk and attend causally over everything
    that lane has written (the paged branch of the reference's
    ``gqa_chunk_append``, ``attention.py:262-359``).

    x: (1, C, d) chunk hidden states; positions: (C,) absolute positions;
    valid: (C,) bool (False rows are pad); lane: 0-dim integer tensor, the
    block-table row this chunk owns, read on the device (no host value, so
    a CUDA graph can capture the call); block_table: (rows, max_pages)
    int32 (-1 = unmapped).
    ``cache`` is one layer's page store, written in place: pad rows and
    unmapped entries go to the trash page. The read gathers the lane's
    pages (entries clamped to real pages; rows past q_pos are masked by
    absolute index) and attends with the reference's ``_sdpa`` arithmetic.
    """
    C = x.shape[1]
    h, dh = cfg.n_heads, cfg.head_dim
    q, k_new, v_new = _project_qkv(cfg, p, x, positions[None, :])
    trash = cache["k"].shape[0] - 1          # == the reference's page count P
    ps = cache["k"].shape[1]
    # a 0-dim index would be read back to the host: select by a 1-row index
    bt = block_table.index_select(0, lane.reshape(1))[0]       # (max_pages,)
    entry = bt[(positions // ps).clamp(0, bt.shape[0] - 1)]
    page = torch.where(valid & (entry >= 0), entry.long(), trash)
    write_pages(cache, k_new[0], v_new[0], page, (positions % ps).long())
    safe = bt.long().clamp(0, trash - 1)
    kv_h = cache["k"].shape[2]
    kp = cache["k"][safe].reshape(-1, kv_h, dh)
    vp = cache["v"][safe].reshape(-1, kv_h, dh)
    dt = x.dtype
    if "k_scale" in cache:
        k = dequantize_kv(kp, cache["k_scale"][safe].reshape(-1, kv_h), dt)
        v = dequantize_kv(vp, cache["v_scale"][safe].reshape(-1, kv_h), dt)
    else:
        k, v = kp.to(dt), vp.to(dt)
    kidx = torch.arange(k.shape[0], device=x.device)
    mask = kidx[None, None, :] <= positions[None, :, None]
    qg = q.reshape(1, C, kv_h, h // kv_h, dh)
    out = _sdpa(qg, k[None], v[None], mask)
    return out.reshape(1, C, h * dh) @ p["wo"]


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
