"""Token sampling (counterpart of ``repro/serving/sampler.py``): greedy
only so far. Sampled modes need the reference's threefry key stream to
give the same tokens, and are ROADMAP.md work; the engine rejects a
request with ``temperature > 0`` at submit."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => off
    top_p: float = 1.0         # 1 => off


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocabulary: logits (B, V) -> (B,) int64."""
    return torch.argmax(logits, dim=-1)
