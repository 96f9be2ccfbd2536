"""Chunked prefill in the port's paged engine, held against the JAX
package's engine on the same weights and traffic (the greedy, paged cases
of ``tests/test_chunked_prefill.py``): identical tokens, block tables,
chunk passes and per-chunk page growth; chunked equal to whole-prompt;
chunks straddling a page boundary; the first token arriving while the
background lane still decodes; eviction and drain mid-chunk; and the
scheduler's preference for chunked engines on a load tie."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced as jreduced
from repro.models import model as JMD
from repro.serving import InferenceEngine as JEngine
from repro_torch.configs import reduced
from repro_torch.models import model as MD
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.scheduler import CarbonAwareScheduler, ServeRequest
from repro_torch.serving.tokenizer import ByteTokenizer

BG_PROMPT = "background request keeps its lane decoding"
ARRIVAL = "newcomer arrives with a much longer prompt that spans chunks"


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced("granite_3_2b").replace(vocab_size=512)
    cfg = reduced("granite_3_2b").replace(vocab_size=512)
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    params = MD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, params


def _port(models, **kw):
    _, cfg, _, params = models
    return InferenceEngine(cfg, params, device="cpu", **kw)


def _record_tables(eng):
    """rid -> the request's block-table row as it stood at finish."""
    seen = {}
    finish = eng._finish

    def wrapped(slot):
        seen[eng.slots[slot].rid] = eng.pages.block_table[slot].tolist()
        finish(slot)

    eng._finish = wrapped
    return seen


def _interleaved(eng, arrival_mnt=10):
    """One background request decoding, then an arrival admitted against
    it. Returns {rid: token_ids}."""
    tok = ByteTokenizer()
    eng.submit(tok.encode(BG_PROMPT), max_new_tokens=30)
    eng.step()                      # the background lane is now live
    eng.submit(tok.encode(ARRIVAL), max_new_tokens=arrival_mnt)
    eng.run_to_completion()
    return {f.rid: tuple(f.token_ids) for f in eng.finished}


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("decode_block", [1, 8])
@pytest.mark.parametrize("chunk,page_size", [(8, 16), (12, 16)])
def test_chunked_engine_matches_reference(models, decode_block, kv_int8, chunk,
                                          page_size):
    """Same tokens, finish order, block tables, chunk passes, per-chunk page
    growth and decode steps as the reference's chunked engine; chunk 12 on
    16-token pages writes chunks across a page boundary."""
    jcfg, _, jp, _ = models
    kw = dict(n_slots=2, max_len=64, decode_block=decode_block, paged=True,
              page_size=page_size, kv_int8=kv_int8, prefill_chunk=chunk)
    ref = JEngine(jcfg, jp, **kw)
    port = _port(models, **kw)
    tables = [_record_tables(e) for e in (ref, port)]
    want, got = _interleaved(ref), _interleaved(port)
    assert port.chunk_steps > 0 and got == want
    assert [f.rid for f in port.finished] == [f.rid for f in ref.finished]
    assert tables[1] == tables[0]
    assert (port.chunk_steps, port.pages_grown_chunked, port.steps,
            port.decode_syncs, port.peak_pages_in_use, port.prefill_tokens_computed) == (
        ref.chunk_steps, ref.pages_grown_chunked, ref.steps, ref.decode_syncs,
        ref.peak_pages_in_use, ref.prefill_tokens_computed)


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("decode_block", [1, 8])
def test_chunked_matches_whole_prompt(models, decode_block, kv_int8):
    """Greedy tokens, for the arrival AND the background lane it
    interleaves with, are the whole-prompt engine's."""
    kw = dict(n_slots=2, max_len=64, decode_block=decode_block, paged=True,
              page_size=16, kv_int8=kv_int8)
    whole = _interleaved(_port(models, **kw))
    eng = _port(models, prefill_chunk=8, **kw)
    assert _interleaved(eng) == whole
    assert eng.chunk_steps > 0 and eng.prefill_groups == 1


def test_chunk_straddles_page_boundary(models):
    """chunk 12 against page 16: the second chunk covers positions [12, 24)
    and crosses the page boundary at 16; tokens do not change."""
    kw = dict(n_slots=2, max_len=64, decode_block=8, paged=True, page_size=16)
    whole = _interleaved(_port(models, **kw))
    eng = _port(models, prefill_chunk=12, **kw)
    assert _interleaved(eng) == whole and eng.chunk_steps > 0


def test_chunked_pages_grow_per_chunk(models):
    """Pages are mapped as chunks land, not the whole prompt at admission,
    and the allocator's ledger is exact after completion."""
    eng = _port(models, n_slots=2, max_len=64, decode_block=8, paged=True,
                page_size=16, prefill_chunk=8)
    _interleaved(eng)
    assert eng.pages_grown_chunked > 0
    assert eng.pages.pages_in_use() == 0 and eng._committed == 0


def test_chunked_first_token_before_background_finishes(models):
    """Admission proceeds while the lane keeps decoding: the arrival's first
    token lands, in band with a decode block, before the background
    request completes."""
    eng = _port(models, n_slots=2, max_len=64, decode_block=8, paged=True,
                page_size=16, prefill_chunk=8)
    tok = ByteTokenizer()
    bg = eng.submit(tok.encode(BG_PROMPT), max_new_tokens=40)
    eng.step()
    arr = eng.submit(tok.encode(ARRIVAL), max_new_tokens=4)
    syncs = eng.decode_syncs
    while not any(f.rid == arr for f in eng.finished):
        eng.step()
    done = {f.rid for f in eng.finished}
    assert arr in done and bg not in done
    assert eng.prefill_groups == 1          # only the background request's
    assert eng.decode_syncs > syncs


@pytest.mark.parametrize("how", ["evict", "drain"])
def test_mid_chunk_removal_releases_everything(models, how):
    """Evicting (or draining) the request that owns the active chunk task
    clears the task and releases its pages and admission reservation."""
    eng = _port(models, n_slots=2, max_len=64, decode_block=1, paged=True,
                page_size=16, prefill_chunk=8)
    tok = ByteTokenizer()
    bg = eng.submit(tok.encode(BG_PROMPT), max_new_tokens=30)
    eng.step()
    arr = eng.submit(tok.encode(ARRIVAL), max_new_tokens=10)
    eng.step()                      # admits the arrival as a chunk task
    assert eng._task is not None and eng._task.next < eng._task.plen
    if how == "evict":
        st = eng.evict(arr)
        assert st is not None and st.rid == arr and st.generated == []
        eng.run_to_completion()     # the background still completes cleanly
        assert [f.rid for f in eng.finished] == [bg]
    else:
        assert sorted(s.rid for s in eng.drain_slots()) == [bg, arr]
    assert eng._task is None
    assert eng.pages.pages_in_use() == 0 and eng._committed == 0


def test_dispatch_prefers_chunked_on_load_tie(models):
    """Equal load: the scheduler routes to the engine whose prefill
    interleaves (shorter time to first token there)."""
    plain = _port(models, n_slots=2, max_len=64, paged=True, page_size=16)
    chunked = _port(models, n_slots=2, max_len=64, paged=True, page_size=16,
                    prefill_chunk=8)
    assert chunked.chunked_admission and not plain.chunked_admission
    sched = CarbonAwareScheduler([plain, chunked])
    sched.submit(ServeRequest(0, "tie-break", max_new_tokens=4))
    sched._dispatch()
    assert chunked.load() == 1 and plain.load() == 0


# the first six prompts of chip_smoke.py's small phase
SMOKE_PROMPTS = [
    "Summarize today's carbon intensity forecast for the western grid.",
    "What is a generation directive?",
    "Explain paged attention to a new engineer.",
    "List three ways to make LLM inference greener.",
    "Why do brief answers cost less energy?",
    "Write a haiku about solar power at noon.",
]


def _smoke_streams(eng):
    tok = ByteTokenizer()
    for i, p in enumerate(SMOKE_PROMPTS):
        eng.submit(tok.encode(p, bos=True), max_new_tokens=12 + 4 * i)
    eng.run_to_completion()
    return {f.rid: list(f.token_ids) for f in eng.finished}


def _first_differences(got, want):
    """(rid, first differing token, length) for each request that differs."""
    return [(rid, next((i for i, (a, b) in enumerate(zip(got[rid], w)) if a != b),
                       min(len(got[rid]), len(w))), len(w))
            for rid, w in want.items() if got.get(rid) != w]


def test_int8_chunked_diverges_from_whole_prompt_as_reference():
    """chip_smoke.py's small phase with int8 KV (its weights from torch seed
    0, its six requests), through both frameworks' engines. A chunk attends
    over the prompt's K/V quantized and read back from its pages,
    whole-prompt prefill over the unquantized K/V
    (``test_int8_chunk_logits_part_from_whole_prompt_as_reference``), so a
    greedy token near a tie may flip between the two modes. The port
    matches the reference token for token in each mode, so it parts from
    whole-prompt wherever the reference does, on the same request from the
    same token."""
    cfg = reduced("granite_3_2b").replace(vocab_size=512)
    jcfg = jreduced("granite_3_2b").replace(vocab_size=512)
    params = MD.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    jp = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), params)
    kw = dict(n_slots=4, max_len=128, paged=True, page_size=16, decode_block=4,
              kv_int8=True)
    streams = {}
    for chunk in (0, 8):
        streams["ref", chunk] = _smoke_streams(JEngine(jcfg, jp, prefill_chunk=chunk, **kw))
        port = InferenceEngine(cfg, params, prefill_chunk=chunk, device="cpu", **kw)
        streams["port", chunk] = _smoke_streams(port)
        assert streams["port", chunk] == streams["ref", chunk]
        assert chunk == 0 or port.chunk_steps > 0
    assert (_first_differences(streams["port", 8], streams["port", 0])
            == _first_differences(streams["ref", 8], streams["ref", 0]))
