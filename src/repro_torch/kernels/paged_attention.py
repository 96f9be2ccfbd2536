"""Wrapper of the hand-written CUDA paged decode-attention kernel
(``csrc/paged_attention.cu``), the port of the TPU kernel
``repro/kernels/paged_attention.py``.

It takes CUDA tensors only and raises on anything the kernel does not
take; there is no fallback. The plain version is ``ref.paged_attention_ref``.
``paged_attention.launches`` counts launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check_launch, check_one_device, check_tensor

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
HEAD_DIMS = (16, 64)  # the reduced config's and granite's
MAX_PAGE = 32
MAX_GROUP = 8
_check = functools.partial(check_tensor, "paged_attention")


def paged_attention(q, k_pages, v_pages, block_table, lengths,
                    k_scale=None, v_scale=None):
    """Decode attention over a block-table cache on the card.

    q (B, H, D) f32/bf16; k/v pages (P, page, KVH, D) in q's dtype, or
    int8 with f32 scales (P, page, KVH); block_table (B, max_pages) int32;
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
    if (D not in HEAD_DIMS or page > MAX_PAGE or H % KVH
            or H // KVH > MAX_GROUP):
        raise ValueError(
            f"paged_attention: kernel takes head_dim in {HEAD_DIMS}, page <= "
            f"{MAX_PAGE}, H/KVH <= {MAX_GROUP}; got D={D} page={page} "
            f"H={H} KVH={KVH}")
    if block_table.shape[0] != B or lengths.shape[0] != B or B == 0:
        raise ValueError("paged_attention: block_table/lengths rows != B >= 1")
    check_one_device("paged_attention", q, k_pages, v_pages, block_table,
                     lengths, k_scale, v_scale)
    out = torch.empty_like(q)
    err = build.load().paged_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, H, KVH, D, P, page, block_table.shape[1],
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[kv_dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("paged_attention", err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
