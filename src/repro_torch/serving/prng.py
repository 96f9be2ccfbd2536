"""jax's threefry2x32 key stream in torch, under ``jax.random``'s names
(the reference draws with ``jax.random``, which has no module in the
reference package; this is its counterpart).

It reproduces the variant that jax 0.9 runs by default
(``jax_threefry_partitionable = True``, ``jax_default_prng_impl =
threefry2x32``): ``split`` hashes a 64-bit iota of the output's shape as
(hi, lo) counter words (``_threefry_split_foldlike``), and ``bits`` is
``bits1 ^ bits2`` over the same iota (``_threefry_random_bits_partitionable``).
So ``split(k, 3)[:2]`` equals ``split(k, 2)``, and ``split(k, n)[i]``
equals ``fold_in(k, i)``.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words (hi, lo).
Every word is an int64 in [0, 2**32): sums are masked to 32 bits and
rotations are ``((x << r) | (x >> (32 - r))) & MASK``, so the arithmetic is
exact on every device (``torch.uint32`` lacks CUDA ops). The functions run
on the device of the key: the engine splits its host key on the CPU, and
the entries split and draw on the card, inside their graphs; nothing here
reads a device value back.

Functions taking a key also take a batch of keys ``(*B, 2)``: the result
is then ``(*B, *shape)``, what ``jax.vmap`` over the keys gives.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# jnp.finfo(float32).tiny: the Gumbel draw's lower bound on its uniform
_TINY = torch.finfo(torch.float32).tiny

Shape = Union[int, Sequence[int]]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry_2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under key
    words (k1, k2), broadcast together; all uint32 values held in int64
    (``jax._src.prng._threefry2x32_lowering``)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x[0], x[1]


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """The key of an integer seed, as ``jax.random.PRNGKey`` makes it with
    64-bit mode off (the reference's setting): the seed wraps to 32 bits,
    so the key is (0, seed mod 2**32) (``jax._src.prng.threefry_seed`` of
    an int32)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _hash_iota(key: torch.Tensor, shape: Tuple[int, ...]):
    """threefry of each key over the 64-bit iota of ``shape`` (jax's
    ``iota_2x32_shape``): two (*B, *shape) word tensors."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    return threefry_2x32(k1, k2, idx >> 32, idx & MASK)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``num`` new keys (an int or a shape): (*B, *shape, 2)
    (``_threefry_split_foldlike``)."""
    return torch.stack(_hash_iota(key, _shape(num)), dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """The key ``key`` folded with ``data`` (an int, or an integer tensor of
    any shape, folded element by element): threefry over the counter
    (0, data mod 2**32) (``_threefry_fold_in``). A key (2,) with data
    (*D,) gives (*D, 2)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y1, y2 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def bits(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """Uniform 32-bit words (as int64 in [0, 2**32)) of ``shape``:
    ``bits1 ^ bits2`` over the iota (``_threefry_random_bits_partitionable``)."""
    b1, b2 = _hash_iota(key, _shape(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval), built bit for bit as
    ``jax.random.uniform`` builds them: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled, shifted and clamped at ``minval``."""
    f = ((bits(key, shape) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # minval and the range rounded to float32 on the host, as jax rounds
    # them, and passed as scalars (a tensor made here would be a host copy,
    # which a CUDA graph capture refuses)
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return (f * span + lo).clamp_min(lo)


def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """float32 standard Gumbel draws, jax's mode "low":
    ``-log(-log(uniform(minval=tiny)))``."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_TINY)))


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """One draw from each categorical distribution of ``logits`` along
    ``axis`` (the Gumbel-max trick, ``replace=True``), float32 logits:
    int64 indices of ``logits``'s shape without ``axis``. A batch of keys
    (*B, 2) draws for logits (*B, ...), key i over row i."""
    noise = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(noise + logits, dim=axis)
