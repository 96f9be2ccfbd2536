"""Wrapper of the hand-written CUDA flash-attention forward kernel
(``csrc/flash_attention.cu``), the port of the TPU kernel
``repro/kernels/flash_attention.py``.

It takes CUDA tensors only and raises on anything the kernel does not
take; there is no fallback. The plain version is
``ref.flash_attention_ref``. ``flash_attention.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import (check_cp_async_rows, check_launch,
                                        check_one_device, check_tensor)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)  # reduced granite and Llama 2; granite, minicpm; Llama 2
_check = functools.partial(check_tensor, "flash_attention", contiguous=False)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, H, Tq, D), k/v (B, KVH, Tk, D) on the card, f32 or bf16 alike,
    any strides with a unit stride along D (so a (B, T, H, D) tensor passes
    as its ``transpose(1, 2)`` view, with no copy); in bf16 the bases and
    strides 16-byte aligned (``check_cp_async_rows``). Returns (B, H, Tq, D)
    in q's dtype, laid out with q's strides."""
    _check("q", q, 4)
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: q must be f32 or bf16, got {q.dtype}")
    _check("k", k, 4, q.dtype)
    _check("v", v, 4, q.dtype)
    B, H, Tq, D = q.shape
    _, KVH, Tk, _ = k.shape
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape
            or D not in HEAD_DIMS or H % KVH or min(B, H, Tq, Tk) == 0
            or max(B, H) > 65535 or window < 0):
        raise ValueError(
            f"flash_attention: kernel takes q (B, H, Tq, D), k/v (B, KVH, Tk, "
            f"D) with D in {HEAD_DIMS}, H % KVH == 0, window >= 0; got q "
            f"{tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
            f"window {window}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v need a unit stride along D")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_cp_async_rows("flash_attention", name, t)
    check_one_device("flash_attention", q, k, v)
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in t.stride()[:3]))
    err = build.load().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KVH, Tq, Tk, D, strides, int(causal), window,
        1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
