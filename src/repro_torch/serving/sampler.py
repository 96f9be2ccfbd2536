"""Token sampling: greedy / temperature / top-k / top-p (counterpart of
``repro/serving/sampler.py``, line for line), with jax's threefry key
stream (``serving/prng.py``), so a seeded stream draws the reference's
tokens.

Entry points sharing the same masking math:

* ``sample_logits``          — one ``SamplingParams`` for the whole batch
                               (Python-level branching; fine outside an
                               entry).
* ``sample_logits_batched``  — per-row parameter tensors (temperature,
                               top_k, top_p): greedy and sampled rows
                               coexist in one batch, with no host read, so
                               a CUDA graph captures it. Row ``i`` draws
                               with ``fold_in(key, i)`` (or ``fold_ids[i]``)
                               so a batched call is token-for-token equal
                               to a per-row loop that folds the same index.
* ``sample_temperature_only`` — the same minus the sort-based threshold,
                               for batches known on the host to use no
                               top-k/top-p (the threshold would mask
                               nothing, so draws are equal).
* ``greedy_sample``          — argmax with the batched calling convention,
                               for batches known on the host to be
                               all-greedy (no sampler at all).

``sample_logits_batched`` performs exactly one sort per call: the top-k
threshold and the top-p nucleus cutoff are both read off the same
descending-sorted copy of the scaled logits. Every function returns (B,)
int64 tokens; a greedy row takes the first of tied maxima, as
``jnp.argmax`` does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.serving import prng


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => off
    top_p: float = 1.0         # 1 => off


def _mask_threshold(scaled, top_k, top_p):
    """Per-row mask threshold from one descending sort of ``scaled``.

    Returns (B, 1) threshold: entries with ``scaled < threshold`` leave the
    candidate set. Rows with top_k == 0 / top_p == 1 contribute -inf (off).
    """
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.take_along_dim(sorted_desc, (top_k.long() - 1).clamp(0, V - 1)[:, None], -1)
    k_thresh = torch.where(top_k[:, None] > 0, kth, -torch.inf)
    # top-p runs on the top-k-masked distribution; in sorted order that is
    # just "entries below the kth value become -inf" (order is unchanged)
    sorted_masked = torch.where(sorted_desc < k_thresh, -torch.inf, sorted_desc)
    # jax.nn.softmax's arithmetic: exp(x - max) / sum
    unnorm = torch.exp(sorted_masked - sorted_masked.amax(-1, keepdim=True))
    probs = unnorm / unnorm.sum(-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    # smallest set with cumulative prob >= top_p; clamp so top_p <= 0
    # collapses to the single top token instead of wrapping to index -1
    # (= smallest logit = no masking at all)
    keep_sorted = cum - probs < top_p[:, None]
    cutoff_idx = (keep_sorted.sum(-1) - 1).clamp_min(0)
    cutoff = torch.take_along_dim(sorted_masked, cutoff_idx[:, None], -1)
    p_thresh = torch.where(top_p[:, None] < 1.0, cutoff, -torch.inf)
    return torch.maximum(k_thresh, p_thresh)


def _row_keys(key, B, fold_ids):
    """Per-row PRNG keys (B, 2). ``fold_ids`` (B,) overrides the fold index
    so a bucketed sub-batch folds by *slot id* rather than lane position —
    tokens are then invariant to which bucket served the row."""
    ids = torch.arange(B, device=key.device) if fold_ids is None else fold_ids
    return prng.fold_in(key, ids)


def _draw(scaled, key, fold_ids):
    """One categorical draw a row of ``scaled`` (B, V), row i with its own
    key (what ``vmap(jax.random.categorical)`` over the row keys gives)."""
    row_keys = _row_keys(key, scaled.shape[0], fold_ids)
    return prng.categorical(row_keys, scaled, axis=-1)


def sample_logits_batched(logits, key, temperature, top_k, top_p,
                          fold_ids=None):
    """Per-row sampling. logits (B,V); temperature/top_k/top_p (B,) tensors.

    Rows with temperature <= 0 are argmax; the rest are categorical draws
    over temperature-scaled, top-k- then top-p-masked logits, upcast to
    float32. Row ``i`` uses ``fold_in(key, i)`` (or ``fold_ids[i]`` when
    given) so the draw for a row does not depend on batch composition.
    Returns (B,) int64.
    """
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / temperature.clamp_min(1e-6)[:, None]
    thresh = _mask_threshold(scaled, top_k, top_p)
    masked = torch.where(scaled < thresh, -torch.inf, scaled)
    return torch.where(temperature > 0.0, _draw(masked, key, fold_ids), greedy)


def greedy_sample(logits, key=None, *unused, fold_ids=None):
    """Argmax with the (logits, key, *params) batched signature."""
    return torch.argmax(logits, dim=-1)


def sample_temperature_only(logits, key, temperature, top_k, top_p,
                            fold_ids=None):
    """`sample_logits_batched` minus the sort-based threshold, for batches
    known on the host to use no top-k/top-p. Draws are bit-identical to the
    full path in that case (the threshold there is -inf and masks
    nothing), without paying the per-step vocab sort."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / temperature.clamp_min(1e-6)[:, None]
    return torch.where(temperature > 0.0, _draw(scaled, key, fold_ids), greedy)


def sample_logits(logits, key, params: SamplingParams):
    """logits: (B, V) -> (B,) int64 tokens. One SamplingParams per batch."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / params.temperature
    if params.top_k > 0 or params.top_p < 1.0:
        B = logits.shape[0]
        thresh = _mask_threshold(
            logits,
            torch.full((B,), params.top_k, dtype=torch.int64, device=logits.device),
            torch.full((B,), params.top_p, dtype=torch.float32, device=logits.device))
        logits = torch.where(logits < thresh, -torch.inf, logits)
    return prng.categorical(key, logits, axis=-1)
