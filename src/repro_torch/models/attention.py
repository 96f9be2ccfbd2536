"""GQA attention for the dense family (counterpart of
``repro/models/attention.py``).

Three modes:
  * prefill — whole prompt, causal, through ``kernels.ops.flash_attention``
    (the CUDA flash kernel on the card, its plain version on the CPU):
    fp32 scores and fp32 P·V, the arithmetic of the reference's full
    configs (``attn_impl="blocked"``, ``blocked_attn.flash_sdpa``); the
    prompt's K/V can be written straight into the store (``write_prompt``).
  * chunk   — one lane's prompt chunk: append its K/V to the lane's rows or
    pages, then attend over everything the lane has written with the
    reference's ``_sdpa`` arithmetic, in plain PyTorch on the card too, as
    the reference computes it outside any Pallas kernel.
  * decode  — one token per row: append K/V, then attend over the slot's
    K/V: over its dense row with ``_sdpa``'s arithmetic in plain PyTorch
    (the reference's ``gqa_decode``, plain jnp there too), or over its pages
    through ``kernels.ops.paged_attention`` (the CUDA kernel on the card,
    the plain version on the CPU).

Two stores; the one a caller passes picks the layout (a block table comes
with a page store).

Dense store, one layer (the reference's default layout):
{"k": (B + 1, S, n_kv, Dh), "v": ..., "kpos": (B + 1, S) int32} and, for
int8 KV, "k_scale"/"v_scale" (B + 1, S, n_kv) f32. ``kpos`` holds each
row's absolute position (``EMPTY_POS`` = empty); a row's token at position
p sits at index min(p, S - 1). Row ``B`` is a sink row that no slot owns:
the reference aims dropped writes (a chunk's pad rows, a bucket's pad
lanes, a prefill group's pad rows) out of bounds and relies on JAX dropping
them; here they land in the sink instead.

Paged store, one layer: {"k": (P + 1, page, n_kv, Dh), "v": ...} and, for
int8 KV, "k_scale"/"v_scale" (P + 1, page, n_kv) f32. Page ``P`` is a trash
page that no block table maps: the reference redirects dead-lane and pad
writes to the out-of-bounds page ``P`` and relies on JAX dropping them;
in PyTorch an out-of-bounds write raises (CPU) or asserts (CUDA), so those
writes land in the trash page instead.

The port writes either store in place (JAX returns a new one), which keeps
one copy of the cache in memory.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, kv_torch_dtype
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30
EMPTY_POS = -(1 << 30)


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


def write_kv(cache, k, v, i, j):
    """Write K/V into one layer's store in place, int8-quantized where the
    store is: k/v (..., n_kv, Dh) at (i, j), index tensors of their leading
    shape (or broadcasting to it): (page, offset) in a page store, (row,
    index) in a dense one. Rows aimed at the trash page or the sink row
    land there and are never read."""
    if "k_scale" in cache:
        qk, sk = quantize_kv(k)
        qv, sv = quantize_kv(v)
        cache["k"][i, j] = qk
        cache["v"][i, j] = qv
        cache["k_scale"][i, j] = sk
        cache["v_scale"][i, j] = sv
    else:
        cache["k"][i, j] = k.to(cache["k"].dtype)
        cache["v"][i, j] = v.to(cache["v"].dtype)


# ======================================================================
# masks
# ======================================================================

def _causal_window_mask(q_pos, k_pos):
    """The reference's mask at window 0, causal: q_pos (..., Tq), k_pos
    (..., Tk) -> bool (..., Tq, Tk), valid rows at or before the query."""
    dk = k_pos[..., None, :]
    return (dk > EMPTY_POS // 2) & (dk <= q_pos[..., :, None])


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
    v's dtype before P·V. q (B, Tq, KV, G, D), k/v (B, S, KV, D), mask
    (B, Tq, S). Each row's two matmuls run over its KV heads as strided
    batched GEMMs, which read the row's (S, KV, D) K and V where they lie
    (``torch.einsum`` would first copy both into its bmm layout, about
    three times the bytes of the read); only q is reordered."""
    B, tq, kv_h, g, d = q.shape
    S = k.shape[1]
    qh = q.permute(0, 2, 1, 3, 4).reshape(B, kv_h, tq * g, d)
    scores = q.new_empty(B, kv_h, tq * g, S)
    for b in range(B):
        torch.bmm(qh[b], k[b].permute(1, 2, 0), out=scores[b])
    scores = scores.view(B, kv_h, tq, g, S).float() / math.sqrt(d)
    scores = scores.masked_fill(~mask[:, None, :, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).view(B, kv_h, tq * g, S)
    out = v.new_empty(B, kv_h, tq * g, d)
    for b in range(B):
        torch.bmm(probs[b], v[b].permute(1, 0, 2), out=out[b])
    return out.view(B, kv_h, tq, g, d).permute(0, 2, 1, 3, 4)


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
# dense store
# ======================================================================

def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, *, layers: int,
                   device):
    """``layers`` stacked dense stores of ``batch`` rows of ``max_len``
    tokens plus the sink row: leaves (layers, batch + 1, max_len, ...),
    ``kpos`` filled with ``EMPTY_POS`` (the reference's ``init_gqa_cache``
    at window 0)."""
    shape = (layers, batch + 1, max_len, cfg.n_kv_heads, cfg.head_dim)
    c = {"kpos": torch.full(shape[:3], EMPTY_POS, dtype=torch.int32,
                            device=device)}
    if cfg.kv_cache_dtype == "int8":
        c.update(k=torch.zeros(shape, dtype=torch.int8, device=device),
                 v=torch.zeros(shape, dtype=torch.int8, device=device),
                 k_scale=torch.zeros(shape[:-1], device=device),
                 v_scale=torch.zeros(shape[:-1], device=device))
    else:
        dt = kv_torch_dtype(cfg)
        c.update(k=torch.zeros(shape, dtype=dt, device=device),
                 v=torch.zeros(shape, dtype=dt, device=device))
    return c


def _read_rows(cache, rows, dtype):
    """(k, v, kpos) of the store rows ``rows`` (a 1-D index tensor, or a
    slice), K/V dequantized or cast to ``dtype``."""
    pick = ((lambda x: x[rows]) if isinstance(rows, slice)
            else (lambda x: x.index_select(0, rows)))
    k, v = pick(cache["k"]), pick(cache["v"])
    if "k_scale" in cache:
        k = dequantize_kv(k, pick(cache["k_scale"]), dtype)
        v = dequantize_kv(v, pick(cache["v_scale"]), dtype)
    else:
        k, v = k.to(dtype), v.to(dtype)
    return k, v, pick(cache["kpos"])


def _cache_write(cache, new_k, new_v, positions, rows):
    """One token per batch row into its store row at index min(pos, S - 1)
    (the linear branch of the reference's ``_cache_write``), its position
    into ``kpos``."""
    S = cache["k"].shape[1]
    idx = positions.clamp_max(S - 1).long()
    write_kv(cache, new_k[:, 0], new_v[:, 0], rows, idx)
    cache["kpos"][rows, idx] = positions.to(torch.int32)


def gqa_decode(cfg: ModelConfig, p, x, positions, cache, *, rows=None,
               in_place=False):
    """Dense decode step (the reference's ``gqa_decode`` at window 0):
    write the new token's K/V first, then attend over the slot's whole row
    (``attend_rows``).

    x: (B, 1, d); positions: (B,) absolute position of the new token;
    ``cache`` is one layer's dense store, written in place; ``rows`` (B,)
    the store row of each batch row (None: row b, read in place), and
    ``in_place`` as in ``attend_rows``. Every row writes, dead or not, as
    in the reference's dense path."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions[:, None])
    if rows is None:
        rows, in_place = torch.arange(B, device=x.device), True
    _cache_write(cache, k_new, v_new, positions, rows)
    out = attend_rows(cache, q, positions, rows, in_place=in_place)
    return out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]


def attend_rows(cache, q, positions, rows, *, in_place=False):
    """One query a batch row, q (B, 1, H, Dh), over its store row under the
    ``kpos`` causal mask, with the reference's ``_sdpa`` arithmetic (scores
    and P rounded to q's dtype): (B, 1, KV, H / KV, Dh). Batch row b reads
    store row ``rows[b]`` through a gather of the batch's rows; with
    ``in_place`` batch row b reads store row b where it lies, no gather,
    so ``rows`` must be 0..B-1 (or the sink row, in a lane whose output
    nobody reads: the engine's full bucket and its dead capture inputs)."""
    B, _, h, dh = q.shape
    if in_place and B > cache["k"].shape[0] - 1:
        raise ValueError(f"an in-place read of {B} rows from a store of "
                         f"{cache['k'].shape[0] - 1} slot rows")
    k, v, kpos = _read_rows(cache, slice(0, B) if in_place else rows, q.dtype)
    mask = _causal_window_mask(positions[:, None], kpos)
    kv_h = k.shape[2]
    return _sdpa(q.reshape(B, 1, kv_h, h // kv_h, dh), k, v, mask)


def write_prompt(cache, k, v, dest):
    """Write a prompt's K/V (B, T, n_kv, Dh) into one layer's store.

    Dense store: ``dest = (rows (B,), kpos (B, T))``: row b's tokens go to
    indices 0..T-1 of store row ``rows[b]`` and the whole row's ``kpos``
    becomes ``kpos[b]`` there, ``EMPTY_POS`` past it (the reference's
    ``_fill_gqa_cache`` into a fresh row, then ``_insert``). Pad rows aim
    at the sink row.
    Page store: ``dest = (page (B, T), off (B, T))``."""
    if "kpos" not in cache:
        write_kv(cache, k, v, *dest)
        return
    rows, kpos = dest
    B, T = kpos.shape
    S = cache["k"].shape[1]
    if T > S:
        raise ValueError(f"prompt ({T}) exceeds the dense row ({S})")
    t = torch.arange(T, device=k.device)
    write_kv(cache, k, v, rows[:, None], t[None, :])
    row_pos = torch.full((B, S), EMPTY_POS, dtype=torch.int32, device=k.device)
    row_pos[:, :T] = kpos.to(torch.int32)
    cache["kpos"][rows] = row_pos


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
    write_kv(cache, new_k[:, 0], new_v[:, 0], page, (positions % ps).long())


def gqa_chunk_append(cfg: ModelConfig, p, x, positions, valid, lane, cache,
                     *, block_table=None):
    """Append one lane's prompt chunk and attend causally over everything
    that lane has written (the reference's ``gqa_chunk_append``,
    ``attention.py:262-359``).

    x: (1, C, d) chunk hidden states; positions: (C,) absolute positions;
    valid: (C,) bool (False rows are pad); lane: integer tensor of one
    element, the store row (dense) or block-table row (paged) this chunk
    owns, read on the device (no host value, so a CUDA graph can capture
    the call). ``cache`` is one layer's store, written in place.

    Dense store (``block_table`` None): the chunk's K/V go to the lane's
    row at index min(pos, S - 1), pad rows to the sink row; then the
    lane's whole row is read back under the ``kpos`` causal mask. Rows the
    request has not written yet hold a previous occupant's positions, all
    past q_pos, which the mask excludes.
    Paged store (``block_table`` (rows, max_pages) int32, -1 = unmapped):
    pad rows and unmapped entries go to the trash page; the read gathers
    the lane's pages (entries clamped to real pages; rows past q_pos are
    masked by absolute index).
    Both attend with the reference's ``_sdpa`` arithmetic."""
    C = x.shape[1]
    h, dh = cfg.n_heads, cfg.head_dim
    q, k_new, v_new = _project_qkv(cfg, p, x, positions[None, :])
    at = lane.reshape(1)          # a 0-dim index would be read to the host
    dt = x.dtype
    if block_table is None:
        sink = cache["k"].shape[0] - 1
        row = torch.where(valid, at, sink)
        idx = positions.clamp(0, cache["k"].shape[1] - 1).long()
        write_kv(cache, k_new[0], v_new[0], row, idx)
        cache["kpos"][row, idx] = positions.to(torch.int32)
        k, v, kpos = _read_rows(cache, at, dt)
        mask = _causal_window_mask(positions[None, :], kpos)
    else:
        trash = cache["k"].shape[0] - 1      # == the reference's page count P
        ps = cache["k"].shape[1]
        bt = block_table.index_select(0, at)[0]                  # (max_pages,)
        entry = bt[(positions // ps).clamp(0, bt.shape[0] - 1)]
        page = torch.where(valid & (entry >= 0), entry.long(), trash)
        write_kv(cache, k_new[0], v_new[0], page, (positions % ps).long())
        safe = bt.long().clamp(0, trash - 1)
        kv_h = cache["k"].shape[2]
        kp = cache["k"][safe].reshape(1, -1, kv_h, dh)
        vp = cache["v"][safe].reshape(1, -1, kv_h, dh)
        if "k_scale" in cache:
            k = dequantize_kv(kp, cache["k_scale"][safe].reshape(1, -1, kv_h), dt)
            v = dequantize_kv(vp, cache["v_scale"][safe].reshape(1, -1, kv_h), dt)
        else:
            k, v = kp.to(dt), vp.to(dt)
        kidx = torch.arange(k.shape[1], device=x.device)
        mask = kidx[None, None, :] <= positions[None, :, None]
    kv_h = k.shape[2]
    qg = q.reshape(1, C, kv_h, h // kv_h, dh)
    out = _sdpa(qg, k, v, mask)
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
