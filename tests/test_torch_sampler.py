"""The port's sampler (``repro_torch.serving.sampler``) against the JAX
package's (``repro.serving.sampler``) on the same seeded logits and keys:
every entry, with and without ``fold_ids``, over greedy, temperature-only
and top-k/top-p rows (top_k past the vocabulary, top_p <= 0 and
temperature 0 included), fp32 and bf16 logits. Tokens must be equal: the
keys and uniforms are bit-equal (``test_torch_prng.py``), so only a
near-tie within the Gumbel draw's 2 ulp, or a top-p cumulative sum within
an ulp of its cut, could part them, and none of these inputs has one.
Then mirrors of the reference's sampler property tests
(``tests/test_serving.py``) and the constants ``chip_smoke.py`` holds the
card to."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampler as JS
from repro_torch.serving import prng
from repro_torch.serving.sampler import (SamplingParams, greedy_sample,
                                         sample_logits, sample_logits_batched,
                                         sample_temperature_only)

# per-row (temperature, top_k, top_p): greedy rows, temperature only, top-k
# past V, top_p <= 0, top-k and top-p together
ROWS = [(0.0, 0, 1.0), (0.7, 0, 1.0), (1.3, 10, 1.0), (0.9, 0, 0.8),
        (1.1, 7, 0.9), (0.0, 5, 0.5), (1.0, 4096, 1.0), (0.8, 0, 0.0),
        (0.9, 50, 0.95), (2.0, 1, 1.0), (0.5, 0, -0.3), (1.0, 3, 0.05)]
# the constants of chip_smoke.py: sample_logits_batched on
# default_rng(0).standard_normal((4, 512)), key PRNGKey(0)
CONST_PARAMS = ([0.9, 0.7, 0.0, 1.0], [50, 0, 5, 8], [0.95, 0.8, 1.0, 1.0])
CONST_FOLD = [3, 1, 0, 2]
CONST_TOKENS = [403, 249, 27, 270]
CONST_TOKENS_FOLDED = [270, 249, 27, 74]
# and sample_temperature_only on the same logits, key and temperatures,
# top_k 0 and top_p 1
CONST_TEMP_TOKENS = [403, 211, 27, 503]
CONST_TEMP_TOKENS_FOLDED = [53, 211, 27, 466]


def _logits(seed, B, V, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((B, V)) * scale).astype(np.float32)


def _params(rows):
    t, k, p = zip(*rows)
    return (np.asarray(t, np.float32), np.asarray(k, np.int32), np.asarray(p, np.float32))


def _both(fn_j, fn_t, logits, seed, params, fold=None, dtype="float32"):
    """(reference tokens, port tokens) of one call on the same inputs."""
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    jp = tuple(jnp.asarray(x) for x in params)
    tp = tuple(torch.from_numpy(x) for x in params)
    jf = None if fold is None else jnp.asarray(fold, jnp.int32)
    tf = None if fold is None else torch.as_tensor(fold)
    want = np.asarray(fn_j(jl, jax.random.PRNGKey(seed), *jp, fold_ids=jf))
    got = fn_t(tl, prng.PRNGKey(seed), *tp, fold_ids=tf)
    assert got.dtype == torch.int64 and got.shape == (logits.shape[0],)
    return want.tolist(), got.tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("folded", [False, True])
def test_batched_matches_reference(folded, dtype):
    params = _params(ROWS)
    fold = np.random.default_rng(4).permutation(64)[:len(ROWS)] if folded else None
    for seed in range(8):
        logits = _logits(seed, len(ROWS), 512)
        want, got = _both(JS.sample_logits_batched, sample_logits_batched, logits,
                          seed, params, fold, dtype)
        assert got == want, seed


@pytest.mark.parametrize("folded", [False, True])
def test_temperature_only_matches_reference(folded):
    rows = [r for r in ROWS if r[1] == 0 and r[2] >= 1.0] * 2
    params = _params(rows)
    fold = np.arange(len(rows))[::-1].copy() if folded else None
    for seed in range(8):
        logits = _logits(100 + seed, len(rows), 512)
        want, got = _both(JS.sample_temperature_only, sample_temperature_only,
                          logits, seed, params, fold)
        assert got == want, seed
        # the full sampler draws the same where no row masks
        _, full = _both(JS.sample_logits_batched, sample_logits_batched, logits, seed,
                        params, fold)
        assert full == got


def test_greedy_sample_matches_reference():
    logits = _logits(5, 6, 512)
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1   # a tie: the first wins
    want, got = _both(JS.greedy_sample, greedy_sample, logits, 0, _params(ROWS[:6]))
    assert got == want and got[2] == 7


@pytest.mark.parametrize("params", [
    SamplingParams(), SamplingParams(temperature=0.8), SamplingParams(temperature=1.0, top_k=3),
    SamplingParams(temperature=1.2, top_p=0.7), SamplingParams(temperature=0.9, top_k=50,
                                                               top_p=0.95)])
def test_sample_logits_matches_reference(params):
    logits = _logits(9, 16, 512)
    for seed in range(6):
        want = np.asarray(JS.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(seed),
                                           JS.SamplingParams(params.temperature,
                                                             params.top_k, params.top_p)))
        got = sample_logits(torch.from_numpy(logits), prng.PRNGKey(seed), params)
        assert got.tolist() == want.tolist(), seed


@pytest.mark.parametrize("folded", [False, True])
def test_known_answers(folded):
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 512))
                              .astype(np.float32))
    t, k, p = CONST_PARAMS
    got = sample_logits_batched(
        logits, prng.PRNGKey(0), torch.tensor(t), torch.tensor(k), torch.tensor(p),
        fold_ids=torch.tensor(CONST_FOLD) if folded else None)
    want = CONST_TOKENS_FOLDED if folded else CONST_TOKENS
    assert got.tolist() == want
    ref = JS.sample_logits_batched(
        jnp.asarray(logits.numpy()), jax.random.PRNGKey(0), jnp.asarray(t, jnp.float32),
        jnp.asarray(k, jnp.int32), jnp.asarray(p, jnp.float32),
        fold_ids=jnp.asarray(CONST_FOLD, jnp.int32) if folded else None)
    assert np.asarray(ref).tolist() == want


@pytest.mark.parametrize("folded", [False, True])
def test_temperature_only_known_answers(folded):
    logits = np.random.default_rng(0).standard_normal((4, 512)).astype(np.float32)
    t = np.asarray(CONST_PARAMS[0], np.float32)
    params = (t, np.zeros(4, np.int32), np.ones(4, np.float32))
    want, got = _both(JS.sample_temperature_only, sample_temperature_only, logits, 0,
                      params, CONST_FOLD if folded else None)
    assert got == want == (CONST_TEMP_TOKENS_FOLDED if folded else CONST_TEMP_TOKENS)


# ---- mirrors of the reference's property tests (tests/test_serving.py) ----

def test_sampler_modes():
    key = prng.PRNGKey(0)
    logits = torch.tensor([[0.0, 5.0, 1.0, -2.0]] * 4)
    assert (sample_logits(logits, key, SamplingParams()) == 1).all()
    many = logits.repeat(16, 1)
    topk = sample_logits(many, key, SamplingParams(temperature=1.0, top_k=2))
    assert set(topk.tolist()) <= {1, 2}
    topp = sample_logits(many, key, SamplingParams(temperature=1.0, top_p=0.6))
    assert set(topp.tolist()) <= {1}


def test_sampler_greedy_deterministic():
    logits = torch.from_numpy(_logits(3, 8, 128, 1.0))
    outs = [sample_logits(logits, prng.PRNGKey(k), SamplingParams()) for k in range(4)]
    for o in outs[1:]:   # greedy ignores the key entirely
        assert torch.equal(outs[0], o)
    assert torch.equal(outs[0], torch.argmax(logits, -1))


def test_sampler_top_k_masks_exactly_k():
    V, k = 64, 5
    logits = torch.from_numpy(_logits(7, 16, V, 1.0))
    draws = torch.stack([sample_logits(logits, prng.PRNGKey(s),
                                       SamplingParams(temperature=1.0, top_k=k))
                         for s in range(200)])
    top = torch.argsort(logits, dim=-1)[:, -k:]
    for row in range(logits.shape[0]):
        assert set(draws[:, row].tolist()) <= set(top[row].tolist())
    # an un-masked token CAN appear given enough draws (k-th largest allowed)
    assert sum(len(set(draws[:, r].tolist())) for r in range(16)) > 16


def test_sampler_top_p_smallest_nucleus():
    probs = np.array([0.55, 0.25, 0.12, 0.05, 0.03])
    logits = torch.from_numpy(np.log(probs)[None, :].repeat(64, 0).astype(np.float32))
    d1 = sample_logits(logits, prng.PRNGKey(0), SamplingParams(temperature=1.0, top_p=0.5))
    assert set(d1.tolist()) == {0}
    d2 = torch.cat([sample_logits(logits, prng.PRNGKey(s),
                                  SamplingParams(temperature=1.0, top_p=0.7))
                    for s in range(50)])
    assert set(d2.tolist()) <= {0, 1} and 1 in set(d2.tolist())
    d3 = sample_logits(logits, prng.PRNGKey(1), SamplingParams(temperature=1.0, top_p=0.0))
    assert set(d3.tolist()) == {0}


def test_sampler_batched_matches_per_slot_loop():
    """The per-row-parameter path equals sampling each row on its own with
    the row-folded key."""
    key = prng.PRNGKey(11)
    logits = torch.from_numpy(_logits(5, 6, 96))
    params = [SamplingParams(), SamplingParams(temperature=0.7),
              SamplingParams(temperature=1.3, top_k=10),
              SamplingParams(temperature=0.9, top_p=0.8),
              SamplingParams(temperature=1.1, top_k=7, top_p=0.9), SamplingParams()]
    batched = sample_logits_batched(
        logits, key, torch.tensor([p.temperature for p in params]),
        torch.tensor([p.top_k for p in params]), torch.tensor([p.top_p for p in params]))
    for i, p in enumerate(params):
        ref = int(sample_logits(logits[i:i + 1], prng.fold_in(key, i), p)[0])
        assert batched[i] == ref, f"slot {i} ({p}) diverged"


def test_sampler_batched_mixed_greedy_and_sampled():
    logits = torch.tensor([[0.0, 9.0, 1.0, -2.0]] * 4)
    out = sample_logits_batched(
        logits, prng.PRNGKey(0), torch.tensor([0.0, 1.0, 0.0, 1.0]),
        torch.tensor([0, 2, 0, 0]), torch.tensor([1.0, 1.0, 1.0, 0.6])).tolist()
    assert out[0] == 1 and out[2] == 1          # greedy rows
    assert out[1] in (1, 2) and out[3] == 1     # top-k=2 / top-p=0.6 rows
