"""The port's dense engine (``InferenceEngine()`` with no ``paged``, the
reference's default) against the reference's, on the same weights (one
``repro.models.model.init_model`` tree via ``params_from_jax``): reduced
llama2-13b and granite, fp32 and int8 KV, whole-prompt and chunked (8).

One pair of engines (reference, port) per (arch, KV dtype, chunk) serves
every test of this file that runs on it, so the reference compiles each of
its programs once, not once a test. Each test drives both engines of a
pair alike, so the two share their history (seed key, counters, store)
and every comparison holds whatever ran before.

* Lockstep: greedy and seeded sampled streams in one batch (top-k/top-p,
  temperature-only and greedy requests; greedy-only blocks once the
  sampled requests finish), blocks in buckets under the slot count, the
  dense store and ``kv_stats`` compared after every dispatch.
* Dead lanes of a block write their K/V at their position, as the
  reference's dense lanes do (its dense decode takes no live mask), in a
  full bucket and in a bucket under the slot count.
* ``evict`` and ``drain_slots``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import reduced as jreduced
from repro.models import model as JMD
from repro.serving import InferenceEngine as JEngine
from repro.serving.sampler import SamplingParams as JSamplingParams
from repro_torch.configs import reduced
from repro_torch.models import model as MD
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.tokenizer import ByteTokenizer
from test_torch_dense import TRAFFIC, VOCAB, _sync_rows, check_rows

# K/V the engines write after many blocks: a few fp32 ulp of the hidden
# states' drift between the frameworks (at most 2.6e-6 of O(1) values in
# these runs), held to 1e-5 of the leaf's largest magnitude
ENGINE_REL = 1e-5
# greedy, temperature only, top-k/top-p; the last requests greedy, so
# greedy blocks run once the sampled ones finish
MODES = [(0.9, 50, 0.95), (0.8, 0, 1.0), (0.0, 0, 1.0), (1.1, 5, 0.9),
         (0.0, 0, 1.0), (0.0, 0, 1.0)]
MAX_LEN = 96


@pytest.fixture(scope="module", params=["llama2_13b", "granite_3_2b"])
def models(request):
    arch = request.param
    jcfg = jreduced(arch).replace(vocab_size=VOCAB)
    cfg = reduced(arch).replace(vocab_size=VOCAB)
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    params = MD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, params


@pytest.fixture(scope="module")
def pairs(models):
    """``pairs(kv_int8, chunk)`` -> (reference engine, port engine), made
    on first use with one seed and 4 slots of ``MAX_LEN``, then shared."""
    jcfg, cfg, jp, params = models
    made = {}

    def pair(kv_int8, chunk):
        if (kv_int8, chunk) not in made:
            kw = dict(n_slots=4, max_len=MAX_LEN, decode_block=4, kv_int8=kv_int8,
                      prefill_chunk=chunk, seed=5)
            made[kv_int8, chunk] = (JEngine(jcfg, jp, **kw),
                                    InferenceEngine(cfg, params, device="cpu", **kw))
        return made[kv_int8, chunk]
    return pair


def _submit(eng, traffic, first=0):
    """Submit ``traffic``, request i with ``MODES[first + i]``."""
    tok = ByteTokenizer()
    cls = JSamplingParams if isinstance(eng, JEngine) else SamplingParams
    for i, (text, n) in enumerate(traffic):
        eng.submit(tok.encode(text, bos=True), max_new_tokens=n,
                   sampling=cls(*MODES[first + i]))


def _lockstep(ref, port, label):
    """Step both engines until both drain, holding the dense store and
    ``kv_stats`` (capacity without the sink row, live tokens) to the
    reference's after every dispatch. Returns the bucket size of every
    block the port ran."""
    buckets = []
    fused_for = port._fused_for

    def recorded(k, mode, bs, chunk_c):
        buckets.append(bs)
        return fused_for(k, mode, bs, chunk_c)

    port._fused_for = recorded
    try:
        while ref.queue or any(s is not None for s in ref.slots):
            ref.step()
            port.step()
            check_rows(port.cache, ref.cache,
                       f"{label} after block {ref.decode_syncs}", rel=ENGINE_REL)
            assert port.kv_stats() == ref.kv_stats(), label
    finally:
        del port._fused_for
    assert not any(s is not None for s in port.slots) and not port.queue
    return buckets


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole-prompt", "chunked"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_dense_engine_matches_reference_default(pairs, kv_int8, chunk):
    """Three requests, one block, then three more (admitted as chunk tasks
    while lanes decode when chunked), each with its ``MODES`` row, through
    the default (dense) engines with one seed. Greedy and sampled streams,
    finish order, counters, the entry table (``_full``, ``_temp`` and
    ``_greedy`` blocks) and ``kv_stats`` are the reference's, and so is
    the store after every block; blocks ran in buckets under the 4
    slots."""
    ref, port = pairs(kv_int8, chunk)
    assert not ref.paged and not port.paged
    assert port.kv_stats() == ref.kv_stats()
    n0 = len(ref.finished)
    assert len(port.finished) == n0
    for e in (ref, port):
        _submit(e, TRAFFIC[:3])
        e.step()
        _submit(e, TRAFFIC[3:], first=3)
    check_rows(port.cache, ref.cache, "first block", rel=ENGINE_REL)
    buckets = _lockstep(ref, port, f"kv_int8={kv_int8} chunk={chunk}")
    want = [(f.rid, f.token_ids) for f in ref.finished[n0:]]
    assert [(f.rid, f.token_ids) for f in port.finished[n0:]] == want
    assert len(want) == len(TRAFFIC)
    counters = ("steps", "decode_syncs", "peak_concurrent", "prefill_tokens_computed",
                "chunk_steps", "decode_tokens")
    assert ({c: getattr(port, c) for c in counters}
            == {c: getattr(ref, c) for c in counters})
    assert sorted(port.entry_points) == sorted(ref.entry_points)
    blocks = [n for n in port.entry_points if n.startswith(("decode_", "mixed_"))]
    assert {n.rsplit("_", 1)[1] for n in blocks} >= {"greedy", "full"}
    assert port.kv_stats() == ref.kv_stats()
    assert min(buckets) < 4
    assert (port.chunk_steps > 0) == (chunk > 0)


def _fused_state(pos, live, rows, bs, last):
    """The reference fused block's state for a greedy block over ``rows``."""
    return {"last": jnp.asarray(last, jnp.int32), "pos": jnp.asarray(pos, jnp.int32),
            "live": jnp.asarray(live, bool), "gc": jnp.zeros(bs, jnp.int32),
            "max_new": jnp.full(bs, 50, jnp.int32), "temp": jnp.zeros(bs, jnp.float32),
            "topk": jnp.zeros(bs, jnp.int32), "topp": jnp.ones(bs, jnp.float32),
            "key": jax.random.PRNGKey(0), "rows": jnp.asarray(rows, jnp.int32),
            "ok": jnp.ones(bs, bool)}


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("bs", [4, 2])
def test_dead_lanes_write_like_the_reference(models, pairs, kv_int8, bs):
    """A greedy 4-step block over a store that holds four prefilled rows,
    with dead lanes (at positions 7 and 12) beside live ones: the port's
    block emits the reference's tokens and leaves the reference's store,
    the dead lanes' writes at their position included; at bs 2 of 4 slots
    the block names slots 2 and 0 and leaves the others alone."""
    _, _, jp, _ = models
    ref, port = pairs(kv_int8, 0)
    k = 4
    toks = np.random.default_rng(4).integers(0, VOCAB, (4, 16))
    lengths = np.array([16, 7, 12, 5])
    _, ref.cache, _ = JMD.prefill(ref.cfg, jp, jnp.asarray(toks, jnp.int32),
                                  max_len=MAX_LEN, lengths=jnp.asarray(lengths, jnp.int32))
    _sync_rows(port.cache, ref.cache)
    rows = np.arange(4) if bs == 4 else np.array([2, 0])
    pos = np.array([30, 7, 12, 40])[:bs]
    live = np.array([1, 0, 0, 1])[:bs]
    last = np.array([65, 66, 67, 68])[:bs]
    fn, _ = ref._fused_for(k, "greedy", bs, 0)
    ref.cache, toks, valid, live_out, _ = fn(
        ref.params, ref.cache, None, _fused_state(pos, live, rows, bs, last), None)
    out = port._fused_for(k, "greedy", bs, 0)[0](
        last=last, pos=pos, gc=np.zeros(bs), max_new=np.full(bs, 50), live=live,
        rows=rows).numpy()
    np.testing.assert_array_equal(out[:k], np.asarray(toks))
    np.testing.assert_array_equal(out[k:2 * k], np.asarray(valid))
    np.testing.assert_array_equal(out[2 * k], np.asarray(live_out))
    check_rows(port.cache, ref.cache, "after the block", rel=ENGINE_REL)
    for b, r in enumerate(rows):
        if not live[b]:
            # the dead lane's own write, at its unchanged position
            assert (port.cache[0]["kpos"][:, r, pos[b]] == pos[b]).all()


def test_evict_and_drain_slots_match_reference(pairs):
    """One request evicted mid-decode, one still queued evicted, the rest
    drained; both engines hand back the same requests with the same state,
    free the same slots, and serve the requeued requests to the same
    tokens."""
    ref, port = pairs(False, 0)
    tok = ByteTokenizer()
    out = []
    for e in (ref, port):
        n0 = len(e.finished)
        rids = [e.submit(tok.encode(t, bos=True), max_new_tokens=min(n, 12))
                for t, n in TRAFFIC[:5]]
        e.step()
        got = [e.evict(rids[1]), e.evict(rids[4]), e.evict(12345)]
        e.step()
        drained = e.drain_slots()
        assert all(s is None for s in e.slots) and not e.live.any() and e._task is None
        back = [st for st in got if st is not None] + drained
        for st in back:
            e.submit(st.prompt_ids, max_new_tokens=st.max_new_tokens, rid=st.rid)
        e.run_to_completion()
        out.append(([(st.rid, st.slot, st.generated, st.prompt_len) for st in got if st],
                    [(st.rid, st.slot, st.reserved_pages) for st in drained],
                    {f.rid: f.token_ids for f in e.finished[n0:]}, got[2]))
    assert out[1] == out[0]
    assert out[1][3] is None and len(out[1][2]) == 5
