"""Wrapper of the hand-written CUDA paged decode-attention kernels
(``csrc/paged_attention.cu``), the port of the TPU kernel
``repro/kernels/paged_attention.py``.

One call launches the split kernel, grid (n_splits, KVH, B): each block
attends over its own run of ``pages_per_split`` pages of a slot's table
and writes an fp32 partial (max, sum, accumulator); then, when there is
more than one split, the combine kernel merges the live splits into the
output. ``split_plan`` picks the split from static shapes only, never from
``lengths``, so a call adds no host sync and a CUDA graph can capture it.
The wrapper allocates the partials with ``torch.empty``.

It takes CUDA tensors only and raises on anything the kernels do not take;
there is no fallback. The plain version is ``ref.paged_attention_ref``.
``paged_attention.launches`` counts calls (one per call, whether one
kernel launched or two).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import (check_cp_async_rows, check_launch,
                                        check_one_device, check_tensor)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
HEAD_DIMS = (16, 64, 128)  # the reduced config's, granite's, Llama 2's
MAX_PAGE = 256
MAX_GROUP = 16
# four, not two: the longest slot's chain of tiles is what a call waits
# for, and shorter splits cut it (the combine reads only live splits)
BLOCKS_PER_SM = 4
# each of a block's four warps gets at least one 32-token tile
MIN_SPLIT_TOKENS = 128
_check = functools.partial(check_tensor, "paged_attention")


@functools.cache
def split_plan(B: int, KVH: int, max_pages: int, page: int,
               n_sm: int) -> tuple:
    """(pages_per_split, n_splits) for a call of these static shapes on a
    card of ``n_sm`` SMs: about ``BLOCKS_PER_SM`` blocks an SM when every
    slot's table is full, and no
    split under ``MIN_SPLIT_TOKENS`` tokens. Splits cover the table's
    ``max_pages`` entries in order, each page exactly once."""
    want = max(1, -(-BLOCKS_PER_SM * n_sm // (B * KVH)))
    pps = max(-(-max_pages // want), -(-MIN_SPLIT_TOKENS // page))
    pps = min(pps, max_pages)
    return pps, -(-max_pages // pps)


def check_shapes(B: int, H: int, KVH: int, D: int, page: int,
                 max_pages: int) -> None:
    """Raise ValueError unless the kernels take this geometry: head_dim in
    ``HEAD_DIMS``, 1 <= page <= ``MAX_PAGE``, H a multiple of KVH with
    H / KVH <= ``MAX_GROUP``, 1 <= B and KVH <= 65535 (grid limits) and
    at least one table entry."""
    if (D not in HEAD_DIMS or not 1 <= page <= MAX_PAGE or KVH < 1
            or H % KVH or not 1 <= H // KVH <= MAX_GROUP
            or not 1 <= B <= 65535 or KVH > 65535 or max_pages < 1):
        raise ValueError(
            f"paged_attention: kernel takes head_dim in {HEAD_DIMS}, page in "
            f"[1, {MAX_PAGE}], H/KVH in [1, {MAX_GROUP}], 1 <= B, KVH <= "
            f"65535, max_pages >= 1; got B={B} H={H} KVH={KVH} D={D} "
            f"page={page} max_pages={max_pages}")


@functools.cache
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_attention(q, k_pages, v_pages, block_table, lengths,
                    k_scale=None, v_scale=None):
    """Decode attention over a block-table cache on the card.

    q (B, H, D) f32/bf16; k/v pages (P, page, KVH, D) in q's dtype, or
    int8 with f32 scales (P, page, KVH), their bases 16-byte aligned for
    the kernel's ``cp.async`` copies; block_table (B, max_pages) int32;
    lengths (B,) int32 >= 1. Returns (B, H, D) in q's dtype.
    """
    _check("q", q, 3)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_attention: q must be f32 or bf16, got {q.dtype}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("paged_attention: pass both scales or neither")
    kv_dtype = torch.int8 if quantized else q.dtype
    _check("k_pages", k_pages, 4, kv_dtype)
    _check("v_pages", v_pages, 4, kv_dtype)
    _check("block_table", block_table, 2, torch.int32)
    _check("lengths", lengths, 1, torch.int32)
    B, H, D = q.shape
    P, page, KVH, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(
            f"paged_attention: pages {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if quantized:
        _check("k_scale", k_scale, 3, torch.float32)
        _check("v_scale", v_scale, 3, torch.float32)
        if k_scale.shape != (P, page, KVH) or v_scale.shape != (P, page, KVH):
            raise ValueError("paged_attention: scales must be (P, page, KVH)")
    max_pages = block_table.shape[1]
    check_shapes(B, H, KVH, D, page, max_pages)
    if block_table.shape[0] != B or lengths.shape[0] != B:
        raise ValueError("paged_attention: block_table/lengths rows != B")
    check_cp_async_rows("paged_attention", "k_pages", k_pages)
    check_cp_async_rows("paged_attention", "v_pages", v_pages)
    check_one_device("paged_attention", q, k_pages, v_pages, block_table,
                     lengths, k_scale, v_scale)
    pps, n_splits = split_plan(B, KVH, max_pages, page, _n_sm(q.device.index))
    out = torch.empty_like(q)
    part_ml = part_acc = None
    if n_splits > 1:
        # the partials, fp32: (max, sum) (n_splits, B, H, 2), then the
        # accumulators (n_splits, B, H, D), in one allocation
        rows = n_splits * B * H
        scratch = torch.empty(rows * (2 + D), dtype=torch.float32, device=q.device)
        part_ml = scratch.data_ptr()
        part_acc = part_ml + rows * 2 * scratch.element_size()
    err = build.load().paged_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_ml, part_acc,
        B, H, KVH, D, P, page, max_pages, pps,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[kv_dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("paged_attention", err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
