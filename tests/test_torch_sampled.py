"""Seeded sampled decoding in the port's paged engine, held against the JAX
package's engine on the same weights (``params_from_jax``), seed and
traffic: greedy, temperature-only and top-k/top-p requests mixed in one
batch give the same tokens, finish order, page ledgers, entry names
(``decode_…_{greedy,temp,full}``, ``mixed_…_{mode}``, ``prefill_…``) and
counts, through whole-prompt prefill groups, bucketed decode blocks (4
slots, 1–3 live), chunked admission (the chunk lane's first token drawn in
the block), prefix-cache hits, int8 KV and ``CarbonAwareScheduler``.
fp32 on the reduced granite config (vocab 512): tokens must be equal. The
keys are bit-equal (``test_torch_prng.py``) and the logits agree to 1e-4
(``test_torch_model.py``), so a stream could part only at a near-tie
within that margin, and none of these drives has one. Then the port
alone: the same seed gives the same streams and another seed others, and
a greedy request is unaffected by a sampled neighbour (the reference's
``tests/test_fused_decode.py`` and ``tests/test_chunked_prefill.py``)."""
import jax
import numpy as np
import pytest

from repro.configs import reduced as jreduced
from repro.models import model as JMD
from repro.serving import InferenceEngine as JEngine
from repro.serving.sampler import SamplingParams as JSamplingParams
from repro.serving.scheduler import CarbonAwareScheduler as JScheduler
from repro.serving.scheduler import ServeRequest as JServeRequest
from repro_torch.configs import reduced
from repro_torch.models import model as MD
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import CarbonAwareScheduler, ServeRequest
from repro_torch.serving.tokenizer import ByteTokenizer

GREEDY, TEMP, FULL = (0.0, 0, 1.0), (0.8, 0, 1.0), (0.9, 50, 0.95)
# prompt lengths straddle the 16/32/64 prefill buckets, budgets differ, and
# every mode is present: greedy, temperature only, top-k/top-p (top_k past
# the vocabulary and top_p <= 0 among them)
TRAFFIC = [("hello world", 24, GREEDY), ("the quick brown fox jumps over it", 12, TEMP),
           ("a", 30, FULL), ("carbon aware serving of llms " * 2, 20, (1.0, 0, 1.0)),
           ("xyz", 8, (0.7, 5, 1.0)), ("generation directives", 16, GREEDY),
           ("top k past the vocabulary", 10, (1.2, 4096, 0.9)),
           ("a nucleus of one", 6, (0.9, 0, 0.0))]
BG_PROMPT = "background request keeps its lane decoding"
ARRIVAL = "newcomer arrives with a much longer prompt that spans chunks"
SEED = 5


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced("granite_3_2b").replace(vocab_size=512)
    cfg = reduced("granite_3_2b").replace(vocab_size=512)
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    params = MD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, params


def _pair(models, **kw):
    """A reference engine and a port engine, alike."""
    jcfg, cfg, jp, params = models
    kw = dict(paged=True, seed=SEED, **kw)
    return JEngine(jcfg, jp, **kw), InferenceEngine(cfg, params, device="cpu", **kw)


def _submit(eng, ids, n, sampling):
    cls = JSamplingParams if isinstance(eng, JEngine) else SamplingParams
    return eng.submit(ids, max_new_tokens=n, sampling=cls(*sampling))


def _record_tables(eng):
    """rid -> the request's block-table row as it stood at finish."""
    seen = {}
    finish = eng._finish

    def wrapped(slot):
        seen[eng.slots[slot].rid] = eng.pages.block_table[slot].tolist()
        finish(slot)

    eng._finish = wrapped
    return seen


def _streams(eng):
    return {f.rid: f.token_ids for f in eng.finished}


def _assert_same(ref, port, tables=None):
    """Tokens, finish order, entry names, forward passes, syncs and pages."""
    assert _streams(port) == _streams(ref)
    assert [f.rid for f in port.finished] == [f.rid for f in ref.finished]
    assert set(port.entry_points) == set(ref.entry_points)
    assert (port.steps, port.chunk_steps, port.decode_syncs, port.peak_pages_in_use,
            port.peak_concurrent) == (ref.steps, ref.chunk_steps, ref.decode_syncs,
                                      ref.peak_pages_in_use, ref.peak_concurrent)
    if tables is not None:
        assert tables[1] == tables[0]
    # drained: nothing reserved or pinned (the prefix cache keeps its
    # cached pages mapped, as the reference's does)
    assert port.pages.pages_in_use() == ref.pages.pages_in_use()
    assert port._committed == 0 and port.pages.pinned == 0


def _drive(eng, traffic=TRAFFIC):
    tok = ByteTokenizer()
    for text, n, sampling in traffic:
        _submit(eng, tok.encode(text, bos=True), n, sampling)
    eng.run_to_completion()


def _waves(eng):
    """One mode at a time: two greedy requests served to idle, then two
    temperature-only ones, then two top-k/top-p ones, so each mode's
    entries run alone."""
    for mode in (GREEDY, TEMP, FULL):
        _drive(eng, [("one mode at a time", 9, mode), ("then the next", 5, mode)])


def _interleaved(eng, bg=TEMP, arrivals=((ARRIVAL, 10, FULL), ("third", 6, GREEDY))):
    """One background request decoding, then arrivals admitted against it
    (as chunk tasks on a chunked engine)."""
    tok = ByteTokenizer()
    _submit(eng, tok.encode(BG_PROMPT), 30, bg)
    eng.step()
    for text, n, sampling in arrivals:
        _submit(eng, tok.encode(text), n, sampling)
    eng.run_to_completion()


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("decode_block", [1, 8])
def test_sampled_engine_matches_reference(models, decode_block, kv_int8):
    """Greedy, temp-only and top-k/top-p requests in one batch, admitted
    under a page budget (so buckets of 1, 2 and 4 rows of 4 slots serve
    them): the same tokens, tables and entries as the reference."""
    ref, port = _pair(models, n_slots=4, max_len=96, page_size=16, n_pages=12,
                      decode_block=decode_block, kv_int8=kv_int8)
    tables = [_record_tables(e) for e in (ref, port)]
    for eng in (ref, port):
        _drive(eng)
        _waves(eng)
    _assert_same(ref, port, tables)
    assert len(port.finished) == len(TRAFFIC) + 6
    names = sorted(port.entry_points)
    for mode in ("greedy", "temp", "full"):
        assert any(n.startswith("decode_") and n.endswith(mode) for n in names), mode
    # a bucket smaller than n_slots drew (its rows fold by slot id)
    assert any(n.startswith(("decode_bs1_", "decode_bs2_")) and not n.endswith("greedy")
               for n in names), names
    # the sampled requests drew: most streams part from their greedy ones
    _, cfg, _, params = models
    greedy = InferenceEngine(cfg, params, device="cpu", n_slots=4, max_len=96,
                             paged=True, page_size=16, n_pages=12,
                             decode_block=decode_block, kv_int8=kv_int8)
    _drive(greedy, [(t, n, GREEDY) for t, n, _ in TRAFFIC])
    solo, got = _streams(greedy), _streams(port)
    assert sum(solo[rid] != got[rid] for rid in solo) >= 3


@pytest.mark.parametrize("decode_block", [1, 8])
def test_chunked_sampled_matches_reference(models, decode_block):
    """Chunked admission: a sampled arrival's prompt streams into the
    background lane's blocks, and its first token is drawn in the mixed
    entry with the step's third key, folded by its slot id."""
    ref, port = _pair(models, n_slots=2, max_len=64, page_size=16,
                      decode_block=decode_block, prefill_chunk=8)
    tables = [_record_tables(e) for e in (ref, port)]
    _interleaved(ref)
    _interleaved(port)
    _assert_same(ref, port, tables)
    assert port.chunk_steps > 0 and port.chunk_passes >= port.chunk_steps
    assert any(n.startswith("mixed_") and n.endswith("_full") for n in port.entry_points)


def test_prefix_hit_sampled_matches_reference(models):
    """Sampled requests whose prompts share two full pages: the later ones
    adopt them and stream their suffix through the chunk lane, where the
    first token is drawn; tokens, cached spans and tables as the
    reference's."""
    rng = np.random.default_rng(3)
    head = [1] + rng.integers(3, 250, 39).tolist()
    traffic = [(head + rng.integers(3, 250, 5 + 3 * i).tolist(), 8 + 2 * i, mode)
               for i, mode in enumerate((FULL, TEMP, GREEDY, FULL, TEMP))]
    ref, port = _pair(models, n_slots=2, max_len=96, page_size=16, decode_block=4,
                      prefix_cache=True)
    tables = [_record_tables(e) for e in (ref, port)]
    for eng in (ref, port):
        for ids, n, sampling in traffic:
            _submit(eng, ids, n, sampling)
            eng.step()
        eng.run_to_completion()
    _assert_same(ref, port, tables)
    cached = {f.rid: f.cached_tokens for f in port.finished}
    assert cached == {f.rid: f.cached_tokens for f in ref.finished}
    assert sum(c > 0 for c in cached.values()) >= 3
    assert any(n.startswith("mixed_") and not n.endswith("greedy")
               for n in port.entry_points)


def test_scheduler_sampled_matches_reference(models):
    """``ServeRequest.sampling`` through ``CarbonAwareScheduler`` (directive
    levels from one seed, budgets by level) reaches the engine's draws."""
    ref, port = _pair(models, n_slots=4, max_len=160, page_size=16, decode_block=4)
    modes = (GREEDY, TEMP, FULL)
    prompts = ["What is a generation directive?", "Why do brief answers cost less?",
               "Name a benefit of continuous batching.", "Define grams of CO2 per kWh.",
               "How does a KV cache grow?", "Write a haiku about solar power."]
    out = []
    for eng, sched_cls, req_cls, sp_cls in (
            (ref, JScheduler, JServeRequest, JSamplingParams),
            (port, CarbonAwareScheduler, ServeRequest, SamplingParams)):
        rng = np.random.default_rng(0)
        sched = sched_cls([eng], level_fn=lambda: int(rng.choice(3)))
        for i, p in enumerate(prompts):
            sched.submit(req_cls(0, p, max_new_tokens=24, max_new_by_level=(24, 16, 8),
                                 sampling=sp_cls(*modes[i % 3])))
        sched.run()
        assert not sched.rejected
        out.append({f.rid: (f.directive_level, f.token_ids) for f in sched.finished})
    assert out[1] == out[0] and len(out[1]) == len(prompts)
    _assert_same(ref, port)


def test_same_seed_same_streams_other_seed_others(models):
    def run(seed):
        _, cfg, _, params = models
        eng = InferenceEngine(cfg, params, device="cpu", n_slots=4, max_len=96,
                              paged=True, page_size=16, decode_block=4, seed=seed,
                              prefill_chunk=8)
        _drive(eng)
        return _streams(eng)

    first = run(9)
    assert run(9) == first
    other = run(10)
    assert other != first
    # the greedy requests draw nothing: equal under either seed
    for rid, (_, _, sampling) in zip(sorted(first), TRAFFIC):
        if sampling == GREEDY:
            assert other[rid] == first[rid]


@pytest.mark.parametrize("chunk", [0, 8])
def test_greedy_request_unaffected_by_sampled_neighbour(models, chunk):
    """A greedy request decodes the same tokens alone and beside a sampled
    request in the same blocks, whole-prompt and with the sampled request
    admitted in chunks."""
    _, cfg, _, params = models
    tok = ByteTokenizer()

    def run(neighbour):
        eng = InferenceEngine(cfg, params, device="cpu", n_slots=2, max_len=64,
                              paged=True, page_size=16, decode_block=8,
                              prefill_chunk=chunk)
        rid = eng.submit(tok.encode("greedy req"), max_new_tokens=12)
        if chunk:
            eng.step()
        if neighbour:
            eng.submit(tok.encode("sampled req"), max_new_tokens=12,
                       sampling=SamplingParams(temperature=1.0, top_k=50, top_p=0.9))
        eng.run_to_completion()
        assert all(1 <= f.gen_tokens <= 12 for f in eng.finished)
        return next(f.token_ids for f in eng.finished if f.rid == rid), eng

    paired, eng = run(True)
    assert len(eng.finished) == 2
    assert any(not n.endswith("greedy") for n in eng.entry_points
               if n.startswith(("decode_", "mixed_")))
    assert paired == run(False)[0]
