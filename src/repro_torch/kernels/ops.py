"""Kernel dispatch by tensor device (counterpart of ``repro/kernels/ops.py``).

A CUDA tensor goes to the hand-written kernel, which launches or raises.
Only a tensor the caller put on the CPU takes the plain PyTorch version.
There is no switch that overrides this.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import paged_attention as _paged


def paged_attention(q, k_pages, v_pages, block_table, lengths,
                    k_scale=None, v_scale=None):
    """Decode attention over a block-table cache; see paged_attention.py."""
    if q.device.type == "cuda":
        return _paged(q, k_pages, v_pages, block_table, lengths, k_scale,
                      v_scale)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, block_table,
                                       lengths, k_scale, v_scale)
    raise ValueError(f"paged_attention: no kernel for device {q.device}")
