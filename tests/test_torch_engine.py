"""The port's paged engine against the JAX package's on the same weights
and traffic: identical greedy token streams and identical page ledgers
(peak pages, each request's block-table row at finish), at decode blocks
of 1 and 4 and fp32 and int8 KV; plus page-budget admission."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced as jreduced
from repro.models import model as JMD
from repro.serving import InferenceEngine as JEngine
from repro.serving.kv_cache import PageAllocator as JPageAllocator
from repro_torch.configs import reduced
from repro_torch.models import model as MD
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.kv_cache import PageAllocator
from repro_torch.serving.tokenizer import ByteTokenizer

# prompt lengths straddle the 16/32/64 prefill buckets; budgets differ per
# request as directive levels make them differ
TRAFFIC = [("hello world", 24), ("the quick brown fox jumps over it", 12),
           ("a", 30), ("carbon aware serving of llms " * 2, 20),
           ("xyz", 8), ("generation directives", 16)]


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced("granite_3_2b").replace(vocab_size=512)
    cfg = reduced("granite_3_2b").replace(vocab_size=512)
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    params = MD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, params


def _record_tables(eng):
    """rid -> the request's block-table row as it stood at finish."""
    seen = {}
    finish = eng._finish

    def wrapped(slot):
        seen[eng.slots[slot].rid] = eng.pages.block_table[slot].tolist()
        finish(slot)

    eng._finish = wrapped
    return seen


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("decode_block", [1, 4])
def test_engine_matches_reference(models, decode_block, kv_int8):
    jcfg, cfg, jp, params = models
    tok = ByteTokenizer()
    kw = dict(n_slots=4, max_len=96, paged=True, page_size=16, n_pages=12,
              decode_block=decode_block, kv_int8=kv_int8)
    ref = JEngine(jcfg, jp, **kw)
    port = InferenceEngine(cfg, params, device="cpu", **kw)
    tables = [_record_tables(e) for e in (ref, port)]
    for text, n in TRAFFIC:
        for e in (ref, port):
            e.submit(tok.encode(text, bos=True), max_new_tokens=n)
    ref.run_to_completion()
    port.run_to_completion()
    want = {f.rid: f.token_ids for f in ref.finished}
    got = {f.rid: f.token_ids for f in port.finished}
    assert len(want) == len(TRAFFIC) and got == want
    assert [f.rid for f in port.finished] == [f.rid for f in ref.finished]
    assert tables[1] == tables[0]
    assert port.peak_pages_in_use == ref.peak_pages_in_use
    assert port.peak_concurrent == ref.peak_concurrent
    assert port.steps == ref.steps and port.decode_syncs == ref.decode_syncs
    # the budget gated admission: not every request fit at once
    assert ref.peak_concurrent < len(TRAFFIC)
    assert port.pages.pages_in_use() == 0 and port._committed == 0


def test_page_budget_gates_admission_not_completion(models):
    """With pages for ~2 requests but 4 free slots, concurrency tracks the
    page budget; every request still completes, FIFO."""
    _, cfg, _, params = models
    tok = ByteTokenizer()
    eng = InferenceEngine(cfg, params, n_slots=4, max_len=64, paged=True,
                          page_size=16, n_pages=4, eos_id=-1, device="cpu")
    # prompt 3 + 20 new = 23 tokens -> 2-page reservation each; the 4-page
    # budget admits exactly two at a time
    rids = [eng.submit(tok.encode("pp"), max_new_tokens=20) for _ in range(4)]
    eng.run_to_completion()
    assert sorted(f.rid for f in eng.finished) == sorted(rids)
    assert all(f.gen_tokens == 20 for f in eng.finished)
    assert eng.peak_concurrent == 2
    assert eng.pages.pages_in_use() == 0
    small = InferenceEngine(cfg, params, n_slots=2, max_len=64, paged=True,
                            page_size=16, n_pages=2, device="cpu")
    with pytest.raises(ValueError, match="page budget"):
        small.submit(tok.encode("x" * 40), max_new_tokens=20)  # needs 4 pages


@pytest.mark.parametrize("kwargs", [dict(paged=True, tp_degree=2)])
def test_options_not_yet_ported_raise(models, kwargs):
    _, cfg, _, params = models
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        InferenceEngine(cfg, params, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(paged=True, prefill_chunk=8, prefix_cache=True),
    dict(paged=True, prefix_cache=True)])
def test_prefix_cache_is_served(models, kwargs):
    """The radix prefix cache, refused before it was ported, builds an
    engine whose allocator indexes prompt pages (salted by the KV dtype)
    and whose ``kv_stats`` report the prefill it skipped."""
    _, cfg, _, params = models
    eng = InferenceEngine(cfg, params, device="cpu", **kwargs)
    assert eng.prefix_cache and eng.pages.prefix_cache
    assert eng.kv_stats()["prefill_tokens_cached"] == 0


def test_allocator_copy_matches_reference_history():
    """The port's allocator (the reference's without the prefix cache)
    maps the same pages through an interleaved alloc/release history,
    raises the same exhaustion errors, and mirrors its tables to torch."""
    kw = dict(n_pages=8, page_size=16, n_slots=4, max_len=64)
    ref, port = JPageAllocator(**kw), PageAllocator(**kw)
    history = [("grow", 0, 17), ("grow", 1, 16), ("grow", 2, 40),
               ("release", 1), ("grow", 3, 33), ("release", 0),
               ("grow", 1, 64), ("grow", 2, 64), ("release", 3),
               ("grow", 0, 30)]
    for op, slot, *n in history:
        outs = []
        for al in (ref, port):
            try:
                outs.append(al.ensure_capacity(slot, n[0]) if op == "grow"
                            else al.release(slot))
            except MemoryError as err:
                outs.append(str(err).split(":")[0])
        assert outs[0] == outs[1], (op, slot, n)
        np.testing.assert_array_equal(port.block_table, ref.block_table)
        assert port.pages_in_use() == ref.pages_in_use()
    port.lengths[2] = 40
    bt, ln = port.device_tables("cpu")
    assert bt.dtype == torch.int32 and torch.equal(
        bt, torch.from_numpy(port.block_table))
    assert ln.tolist() == port.lengths.tolist()
    bt, ln = port.device_tables("cpu", np.array([2, 0]))
    assert torch.equal(bt, torch.from_numpy(port.block_table[[2, 0]]))
    assert ln.tolist() == [40, int(port.lengths[0])]
