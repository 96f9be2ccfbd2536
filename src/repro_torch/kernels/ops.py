"""Kernel dispatch by tensor device (counterpart of ``repro/kernels/ops.py``).

A CUDA tensor goes to the hand-written kernel, which launches or raises.
Only a tensor the caller put on the CPU takes the plain PyTorch version.
There is no switch that overrides this, and no fallback on a shape the
kernel does not take: the kernels mask ragged tails themselves.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.paged_attention import paged_attention as _paged
from repro_torch.kernels.rmsnorm import fused_rmsnorm as _rmsnorm


def _no_kernel(name, t):
    return ValueError(f"{name}: no kernel for device {t.device}")


def paged_attention(q, k_pages, v_pages, block_table, lengths,
                    k_scale=None, v_scale=None):
    """Decode attention over a block-table cache; see paged_attention.py."""
    if q.device.type == "cuda":
        return _paged(q, k_pages, v_pages, block_table, lengths, k_scale,
                      v_scale)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                       lengths, k_scale, v_scale)
    raise _no_kernel("paged_attention", q)


def flash_attention(q, k, v, *, causal=True, window=0):
    """Prefill attention, q (B,H,Tq,D), k/v (B,KVH,Tk,D) -> (B,H,Tq,D);
    see flash_attention.py."""
    if q.device.type == "cuda":
        return _flash(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    raise _no_kernel("flash_attention", q)


def fused_rmsnorm(x, scale, residual=None, *, eps=1e-6):
    """(N,d) residual add + RMSNorm -> (y, x + residual); see rmsnorm.py."""
    if x.device.type == "cuda":
        return _rmsnorm(x, scale, residual, eps=eps)
    if x.device.type == "cpu":
        return ref.fused_rmsnorm_ref(x, scale, residual, eps)
    raise _no_kernel("fused_rmsnorm", x)
