"""Dense decoder: init / prefill / decode over a dense or paged KV store
(counterpart of ``repro/models/model.py``, dense family only).

Parameters are a plain dict of tensors in the reference's layout, so the
JAX tree converts leaf for leaf (``params_from_jax``): per-segment stacked
leaves ``params["segs"][i]`` shaped (n_layers, ...), and layer ``l`` of a
segment is the view ``leaf[l]``. Each dense layer runs
RMSNorm -> QKV + RoPE -> attention -> wo + residual -> RMSNorm -> SwiGLU +
residual; then the final norm and the unembedding (tied to the token
embedding, or its own (d, V) leaf ``embed.unembed``). Every norm goes
through the fused RMSNorm op (``layers.add_norm``), which also adds the
attention residual in the same pass: 2·n_layers + 1 norm launches per
forward. A prompt chunk (``prefill_chunk_step``) runs the same block over
one lane's chunk against its rows or pages.

The KV store is the caller's: ``init_cache`` builds the dense one (the
reference's default; per slot, ``max_len`` rows of K/V and their
positions), ``init_paged_cache`` the paged one. Decode and chunk steps
take a block table with a page store and none with a dense store; the
store alone decides the layout, and each layout has one code path.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import attention as A
from repro_torch.models.common import ModelConfig, resolve_device, torch_dtype
from repro_torch.models.layers import (add_norm, apply_mlp, apply_norm,
                                       embed_tokens, unembed)


def _check_supported(cfg: ModelConfig) -> None:
    """The port serves dense full-attention GQA decoders (MHA included)
    with RoPE, RMSNorm and bias-free SwiGLU, with tied or untied
    embeddings: granite, Llama 2 and minicpm. Prefill attention always
    computes the reference's blocked arithmetic (fp32 scores and P·V); at
    fp32 the reference's ``attn_impl="xla"`` computes the same, at lower
    precision it rounds the scores first."""
    if (cfg.family != "dense" or cfg.attn_type != "gqa"
            or cfg.sliding_window > 0 or cfg.pos != "rope"
            or cfg.norm != "rmsnorm" or cfg.act != "silu" or cfg.use_bias
            or cfg.logit_softcap > 0):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}/{cfg.attn_type}): the port serves "
            "dense full-attention GQA decoders with RoPE, RMSNorm and "
            "bias-free SwiGLU only; other families are ROADMAP.md, modules "
            "still to port: other families")
    if cfg.attn_impl == "xla" and cfg.dtype != "float32":
        raise NotImplementedError(
            f"{cfg.name}: attn_impl='xla' at {cfg.dtype} rounds attention "
            "scores to the compute dtype; the port computes prefill "
            "attention in fp32 only, as attn_impl='blocked' does")


# ======================================================================
# init
# ======================================================================

def _dense(gen, shape, fan_in, dtype, device, scale=None):
    """Truncated-normal fan-in init (the reference's ``dense_init``). A
    stacked (n_layers, ...) leaf is drawn one layer at a time, so the fp32
    draw beside the weights is one layer's (llama2-13b's whole ``w_up``
    would be 11.3 GB in fp32)."""
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in (out if len(shape) == 3 else (out,)):
        w = torch.empty(part.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        part.copy_(w.mul_(std))
    return out


def init_model(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random weights in the reference's layout, drawn from ``generator``
    (which must live on ``device``); an untied config also draws
    ``embed.unembed`` (d, V) with fan-in d, as the reference's
    ``init_embeddings`` does."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def w(shape, fan_in, scale=None):
        return _dense(generator, shape, fan_in, dt, dev, scale)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    segs = []
    for _, n in cfg.segments():
        segs.append({
            "ln1": {"scale": ones(n, d)},
            "attn": {"wq": w((n, d, hd), d), "wk": w((n, d, kvd), d),
                     "wv": w((n, d, kvd), d),
                     "wo": w((n, hd, d), hd, 1.0 / math.sqrt(hd))},
            "ln2": {"scale": ones(n, d)},
            "mlp": {"w_up": w((n, d, f), d),
                    "w_down": w((n, f, d), f, 1.0 / math.sqrt(f)),
                    "w_gate": w((n, d, f), d)},
        })
    embed = {"tok": w((V, d), V, 1.0 / math.sqrt(d))}
    if not cfg.tie_embeddings:
        embed["unembed"] = w((d, V), d)
    return {"embed": embed, "segs": segs, "norm": {"scale": ones(d)}}


def params_from_jax(tree, device="cuda"):
    """Convert the reference's parameter tree (leaves as numpy arrays, e.g.
    ``np.asarray`` of ``repro.models.model.init_model`` output) into the
    port's parameters: the same nested layout, leaf for leaf (an untied
    config's ``embed.unembed`` included), stacked per segment."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x)).to(dev)

    return conv(tree)


def param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, list):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def _layer(seg: Dict[str, Any], i: int):
    return {name: {k: v[i] for k, v in sub.items()} for name, sub in seg.items()}


# ======================================================================
# stores
# ======================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Per-segment stacked dense stores (axis 0 = layer within segment) of
    ``batch`` slots of ``max_len`` tokens, each with a sink row past the
    slots (``attention.init_gqa_cache``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return [A.init_gqa_cache(cfg, batch, max_len, layers=n, device=dev)
            for _, n in cfg.segments()]


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     device="cuda"):
    """Per-segment stacked page stores (axis 0 = layer within segment).
    Every layer owns its pages; one block table addresses all layers."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return [A.init_paged_gqa_cache(cfg, n_pages, page_size, layers=n,
                                   device=dev)
            for _, n in cfg.segments()]


def _layer_cache(seg_cache, i: int):
    return {k: v[i] for k, v in seg_cache.items()}


# ======================================================================
# forward
# ======================================================================

def _block(cfg, p, x, positions, mode, cache, block_table, live, rows,
           in_place, prompt_to):
    h = apply_norm(cfg, p["ln1"], x)
    if mode == "decode" and block_table is None:
        a = A.gqa_decode(cfg, p["attn"], h, positions, cache, rows=rows,
                         in_place=in_place)
    elif mode == "decode":
        a = A.gqa_decode_paged(cfg, p["attn"], h, positions, cache,
                               block_table, live=live)
    else:
        a, (k, v) = A.gqa_full(cfg, p["attn"], h, positions)
        if cache is not None:
            A.write_prompt(cache, k, v, prompt_to)
    h2, x = add_norm(cfg, p["ln2"], a, x)       # x + a, then its norm
    return x + apply_mlp(cfg, p["mlp"], h2)


def block_apply_chunk(cfg: ModelConfig, p, x, positions, valid, lane, cache,
                      *, block_table=None):
    """One block over a single lane's prompt chunk (1, C, d)
    (``model.py:352-365``): attention appends the chunk's K/V to the
    lane's rows or pages and attends over everything written so far; the
    FFN is position-wise as usual."""
    h = apply_norm(cfg, p["ln1"], x)
    a = A.gqa_chunk_append(cfg, p["attn"], h, positions, valid, lane, cache,
                           block_table=block_table)
    h2, x = add_norm(cfg, p["ln2"], a, x)
    return x + apply_mlp(cfg, p["mlp"], h2)


def _hidden(cfg, params, tokens, mode, positions, cache, block_table, live,
            rows, in_place, prompt_to):
    _check_supported(cfg)
    B, T = tokens.shape
    x = embed_tokens(cfg, params["embed"], tokens)
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)
    for s, seg in enumerate(params["segs"]):
        n = seg["ln1"]["scale"].shape[0]
        for i in range(n):
            c = _layer_cache(cache[s], i) if cache is not None else None
            x = _block(cfg, _layer(seg, i), x, positions, mode, c,
                       block_table, live, rows, in_place, prompt_to)
    return apply_norm(cfg, params["norm"], x)


def forward(cfg: ModelConfig, params, tokens, *, mode: str = "prefill",
            positions=None, cache=None, block_table=None, live=None,
            rows=None, in_place=False, prompt_to=None):
    """``tokens``: (B, T) integer ids (decode: (B, 1)).

    prefill: positions (B, T) or None (= arange); with ``cache`` each layer
      writes the prompt's K/V through ``prompt_to``: ``(rows (B,), kpos
      (B, T))`` into a dense store, ``(page (B, T), off (B, T))`` into a
      page store (``attention.write_prompt``; pad rows aim at the sink row
      or the trash page). Returns logits (B, T, V).
    decode: positions (B,); ``cache`` is updated in place. A dense store
      (``init_cache``) takes no block table; ``rows`` (B,) names each
      batch row's store row (None: row b; ``in_place``: the batch is every
      slot row in order; see ``attention.attend_rows``), and every row
      writes, as in the reference's dense path. A page store
      (``init_paged_cache``) takes block_table (B, max_pages) int32; live
      (B,) bool gates dead-lane writes. Returns logits (B, V).
    """
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(
            f"mode {mode!r}: the port serves prefill and decode only")
    x = _hidden(cfg, params, tokens, mode, positions, cache, block_table,
                live, rows, in_place, prompt_to)
    logits = unembed(cfg, params["embed"], x)
    return logits[:, 0] if mode == "decode" else logits


def kpos_of(lengths, T: int):
    """Each row's prompt positions 0..T-1, ``EMPTY_POS`` at and past its
    length (the reference's ``kpos_of`` with ``lengths``): (B, T) int32."""
    t = torch.arange(T, device=lengths.device, dtype=torch.int32)
    return torch.where(t[None, :] < lengths[:, None], t[None, :],
                       A.EMPTY_POS)


def prefill(cfg: ModelConfig, params, tokens, *, max_len: int, lengths=None):
    """Whole-prompt prefill into a fresh dense store (the reference's
    ``prefill(max_len=...)``): returns (logits (B, T, V), the store of B
    slots of ``max_len`` tokens holding the prompts at positions 0..T-1,
    ``kpos`` empty at pad positions (t >= lengths) and past T)."""
    B, T = tokens.shape
    if lengths is None:
        lengths = torch.full((B,), T, device=tokens.device)
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    rows = torch.arange(B, device=tokens.device)
    logits = forward(cfg, params, tokens, mode="prefill", cache=cache,
                     prompt_to=(rows, kpos_of(lengths, T)))
    return logits, cache


def prefill_last(cfg: ModelConfig, params, tokens, lengths, cache=None,
                 prompt_to=None):
    """Whole-prompt prefill returning only each row's last valid logits
    (B, V); ``lengths`` (B,) valid tokens per row; with ``cache`` the
    prompts' K/V go through ``prompt_to`` (``forward``)."""
    x = _hidden(cfg, params, tokens, "prefill", None, cache, None, None,
                None, False, prompt_to)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    return unembed(cfg, params["embed"], x[rows, lengths - 1])


def prefill_chunk_step(cfg: ModelConfig, params, tokens, pos0, clen, lane,
                       cache, *, block_table=None):
    """Run ONE prompt chunk for one lane through the whole stack
    (``model.py:368-404``).

    tokens: (C,) chunk token ids (pad beyond ``clen``); pos0: absolute
    position of tokens[0]; clen: valid length (0 = every write goes to the
    sink row or the trash page); lane: the store row (dense ``cache``, no
    block table) or the block-table row (page store). ``pos0``, ``clen``
    and ``lane`` are integer tensors of one element on the tokens' device,
    as the reference's scan passes them, so nothing here reads a host
    value and a CUDA graph can capture the step. ``cache`` (``init_cache``
    or ``init_paged_cache`` output) is written in place. Returns the logits (V,) at position pos0 + clen - 1,
    meaningful on a request's final chunk."""
    _check_supported(cfg)
    C = tokens.shape[0]
    idx = torch.arange(C, device=tokens.device)
    positions, valid = pos0 + idx, idx < clen
    x = embed_tokens(cfg, params["embed"], tokens[None])
    for s, seg in enumerate(params["segs"]):
        for i in range(seg["ln1"]["scale"].shape[0]):
            x = block_apply_chunk(cfg, _layer(seg, i), x, positions, valid,
                                  lane, _layer_cache(cache[s], i),
                                  block_table=block_table)
    x = apply_norm(cfg, params["norm"], x)
    last = (clen - 1).clamp(0, C - 1).reshape(1)
    return unembed(cfg, params["embed"], x[0].index_select(0, last)[0])


def decode_sample_step(cfg: ModelConfig, params, tokens, positions, cache,
                       key, sampling, sample_fn, *, block_table=None, live=None,
                       rows=None, in_place=False, fold_ids=None):
    """One decode step with sampling (``model.py:631-661``), over a dense
    store (no block table; ``rows`` and ``in_place`` as in ``forward``) or a
    page store (``block_table``, ``live``).

    ``sampling`` is a tuple of per-row tensors ``(temperature (B,) f32,
    top_k (B,) int, top_p (B,) f32)`` and ``sample_fn(logits, key,
    *sampling, fold_ids=fold_ids) -> (B,)`` performs the draw (the serving
    layer passes its sampler, so models/ stays independent of serving/).
    ``fold_ids`` (B,) overrides the sampler's per-row fold, so a bucketed
    caller folds by slot id. A greedy caller passes ``key=None`` and
    ``sampling=()``.

    Returns the next tokens (B,) and each row's finiteness verdict ``ok``
    (B,) bool, ``isfinite(logits).all(-1)`` on the logits before the draw
    (the reference's ``with_ok=True``): the engine catches a poisoned lane
    inside the block, and the verdict leaves with the block's one
    device-to-host copy."""
    logits = forward(cfg, params, tokens, mode="decode", positions=positions,
                     cache=cache, block_table=block_table, live=live,
                     rows=rows, in_place=in_place)
    toks = sample_fn(logits, key, *sampling, fold_ids=fold_ids)
    return toks, torch.isfinite(logits).all(-1)
