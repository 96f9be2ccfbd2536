"""The arithmetic of the bf16 flash-attention kernel's P·V, held on the CPU.

``kernels/csrc/flash_attention.cu`` multiplies P by V on the tensor cores,
which take bf16 operands. The reference keeps P in fp32
(``repro/kernels/flash_attention.py``, ``repro/models/blocked_attn.py``),
so the kernel splits each probability into p_hi = bf16(p) and
p_lo = bf16(p - p_hi) and accumulates p_hi·V + p_lo·V in fp32. The kernel
runs only on the card; these tests form P·V the three ways in torch from
the plain version's fp32 probabilities and hold the split to the criterion
``chip_smoke.py`` and ``test_bf16_prefill_attention_matches_blocked_reference``
apply: at most one bf16 ulp of the output scale, on under 1 % of the
outputs. P rounded to one bf16 term fails it (about 40 % of the outputs
move), so the criterion tells the two designs apart."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

B, H, KVH, D = 2, 4, 2, 64

CASES = {
    # T, causal, window
    "causal": (128, True, 0),
    "windowed": (128, True, 48),
    "ragged causal": (100, True, 0),
    "ragged non-causal": (77, False, 0),
}


def _inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(torch.bfloat16)
            for shape in ((B, H, T, D), (B, KVH, T, D), (B, KVH, T, D))]


def _probs_and_pv(q, k, v, causal, window):
    """fp32 probabilities as ``ref.flash_attention_ref`` forms them, and
    P·V with P given (fp32 accumulation), back in (B, H, T, D)."""
    T = q.shape[2]
    qg = q.reshape(B, KVH, H // KVH, T, D).float()
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) / math.sqrt(D)
    i = torch.arange(T)[:, None]
    j = torch.arange(T)[None, :]
    mask = torch.ones(T, T, dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= j > i - window
    p = torch.softmax(s.masked_fill(~mask, ref.NEG_INF), dim=-1)

    def pv(pp):
        return torch.einsum("bkgts,bksd->bkgtd", pp, v.float()).reshape(B, H, T, D)

    return p, pv


def _bf16_ulp(x):
    """One bf16 ulp at magnitude x: 2^(e - 7) for x in [2^e, 2^(e + 1))."""
    return math.ldexp(1.0, math.frexp(x)[1] - 8) if x > 0 else 0.0


def _meets_criterion(got, want):
    """Within one bf16 ulp of the output scale, on under 1 % of outputs."""
    ulp = _bf16_ulp(want.float().abs().max().item())
    return ((got.float() - want.float()).abs().max().item() <= ulp
            and (got != want).float().mean().item() < 0.01)


@pytest.mark.parametrize("case", CASES)
def test_fp32_pv_is_the_plain_version_and_the_jax_oracle(case):
    """P·V with P in fp32 is what the plain version computes, bit for bit,
    and within the criterion of the JAX oracle (``repro.kernels.ref``)."""
    T, causal, window = CASES[case]
    q, k, v = _inputs(T)
    p, pv = _probs_and_pv(q, k, v, causal, window)
    want = pv(p).to(torch.bfloat16)
    assert torch.equal(want, ref.flash_attention_ref(q, k, v, causal=causal,
                                                     window=window))
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert _meets_criterion(want, torch.from_numpy(
        np.asarray(oracle, np.float32)).to(torch.bfloat16))


@pytest.mark.parametrize("case", CASES)
def test_split_p_meets_the_bf16_criterion_and_one_bf16_term_does_not(case):
    T, causal, window = CASES[case]
    q, k, v = _inputs(T)
    p, pv = _probs_and_pv(q, k, v, causal, window)
    want = pv(p).to(torch.bfloat16)
    p_hi = p.to(torch.bfloat16).float()
    p_lo = (p - p_hi).to(torch.bfloat16).float()
    split = (pv(p_hi) + pv(p_lo)).to(torch.bfloat16)      # the kernel's design
    single = pv(p_hi).to(torch.bfloat16)                  # P rounded once
    assert _meets_criterion(split, want)
    assert not _meets_criterion(single, want)
    # the margins both ways are wide: about 0.2 % of the outputs move with
    # the split, about 40 % with one term
    assert (split != want).float().mean().item() < 0.005
    assert (single != want).float().mean().item() > 0.2
