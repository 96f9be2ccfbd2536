"""Wrapper of the hand-written CUDA fused residual + RMSNorm kernel
(``csrc/rmsnorm.cu``), the port of the TPU kernel
``repro/kernels/rmsnorm.py``.

It takes CUDA tensors only and raises on anything the kernel does not
take; there is no fallback. The plain version is ``ref.fused_rmsnorm_ref``.
``fused_rmsnorm.launches`` counts launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check_launch, check_one_device, check_tensor

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 8192          # two 16-byte vectors a thread in f32 (Llama 2 needs 5120)
MAX_THREADS = 1024
_check = functools.partial(check_tensor, "fused_rmsnorm")


def launch_shape(N: int, d: int, itemsize: int):
    """The kernel's launch shape for N rows of d elements of ``itemsize``
    bytes: (blocks, threads per block). One block per row, one 16-byte
    vector of the row per thread, in whole warps, so every load of a row is
    in flight at once and N rows run as N blocks; a row of more than 1024
    vectors (f32 above d 4096) takes two vectors a thread."""
    nvec = d * itemsize // 16
    per = -(-nvec // MAX_THREADS)        # vectors a thread
    return N, -(-nvec // (32 * per)) * 32


def fused_rmsnorm(x, scale, residual=None, *, eps: float = 1e-6):
    """x (N, d) f32/bf16, contiguous and 16-byte aligned, with d a multiple
    of 16 bytes and at most ``MAX_D``; scale (d,) f32, 16-byte aligned; residual
    optional (N, d) like x. Returns (y, r): r = x + residual rounded to x's
    dtype (x itself without a residual), y = rmsnorm(r) * scale in x's
    dtype."""
    _check("x", x, 2)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_rmsnorm: x must be f32 or bf16, got {x.dtype}")
    N, d = x.shape
    _check("scale", scale, 1, torch.float32)
    if residual is not None:
        _check("residual", residual, 2, x.dtype)
        if residual.shape != x.shape:
            raise ValueError(f"fused_rmsnorm: residual {tuple(residual.shape)} "
                             f"!= x {tuple(x.shape)}")
    vec = 16 // x.element_size()
    if N == 0 or d > MAX_D or d % vec or scale.shape != (d,):
        raise ValueError(
            f"fused_rmsnorm: kernel takes N >= 1 rows of d <= {MAX_D} with d % "
            f"{vec} == 0 and scale (d,); got x {tuple(x.shape)} scale "
            f"{tuple(scale.shape)}")
    if any(t is not None and t.data_ptr() % 16 for t in (x, residual, scale)):
        raise ValueError("fused_rmsnorm: x, residual and scale must be 16-byte "
                         "aligned (the kernel reads 16-byte vectors)")
    check_one_device("fused_rmsnorm", x, scale, residual)
    y = torch.empty_like(x)
    r = torch.empty_like(x) if residual is not None else None
    _, threads = launch_shape(N, d, x.element_size())
    err = build.load().fused_rmsnorm_fwd(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        scale.data_ptr(), y.data_ptr(), r.data_ptr() if r is not None else None,
        N, d, eps, _DTYPE_CODES[x.dtype], threads,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("fused_rmsnorm", err)
    fused_rmsnorm.launches += 1
    return y, (r if r is not None else x)


fused_rmsnorm.launches = 0
