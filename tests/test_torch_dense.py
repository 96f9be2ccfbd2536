"""The dense KV layout of the port (``paged=False``, the reference's
default) against the JAX package, model level, on reduced llama2-13b (MHA,
untied embeddings) and granite (GQA groups of 4, tied), vocab 512, fp32
and int8 KV, with weights from one ``repro.models.model.init_model`` tree
via ``params_from_jax``: the empty store, prefill's store, one layer's
``gqa_decode``, teacher-forced decode (full batches and batches that name
their store rows), prompt chunks into a lane's row, and the sink row that
takes every dropped write. Then engines on a dense store: the default
engine, dense against paged tokens, and ``CarbonAwareScheduler`` over dense
engines serving the reference's streams (reduced granite). The engine
against the reference's in lockstep, its dead lanes, ``evict`` and
``drain_slots`` are in ``test_torch_dense_engine.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jreduced
from repro.models import attention as JA
from repro.models import model as JMD
from repro.serving import InferenceEngine as JEngine
from repro.serving.scheduler import CarbonAwareScheduler as JScheduler
from repro.serving.scheduler import ServeRequest as JServeRequest
from repro_torch.configs import reduced
from repro_torch.models import attention as A
from repro_torch.models import model as MD
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.scheduler import CarbonAwareScheduler, ServeRequest
from repro_torch.serving.tokenizer import ByteTokenizer

ARCHS = ["llama2_13b", "granite_3_2b"]
VOCAB = 512
# fp32 on both sides; the frameworks sum matmuls and softmaxes in another
# order (the logit tolerance of test_torch_model.py)
ATOL = 1e-4
# K/V and scales in the store: the projections of the same hidden states,
# summed in another order, held to 1e-6 of the leaf's largest magnitude
# (its values reach a few units, where one fp32 ulp is 2.4e-7 to 4.8e-7)
KV_REL = 1e-6
# int8 KV: a value on a rounding edge of x/scale may take the neighbouring
# code in one framework (the projections sum in another order); only a step
# that wrote such a code is held to this, and at most one step in twelve
# (test_torch_llama2.py's rule). The worst such step here (reduced granite,
# step 9) moves its O(1) logits by 5.6e-4, one scale step of one code
FLIP_ATOL = 1e-3
TRAFFIC = [("hello world", 24), ("the quick brown fox jumps over it", 12),
           ("a", 30), ("carbon aware serving of llms " * 2, 20),
           ("xyz", 8), ("generation directives", 16)]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg = jreduced(arch).replace(vocab_size=VOCAB)
    cfg = reduced(arch).replace(vocab_size=VOCAB)
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    params = MD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, params


def _with_kv(jcfg, cfg, kv_int8):
    if kv_int8:
        return (jcfg.replace(kv_cache_dtype="int8"),
                cfg.replace(kv_cache_dtype="int8"))
    return jcfg, cfg


def _sync_rows(cache, jcache):
    """Copy the reference's dense stores into the port's slot rows (the
    port keeps its sink row past them)."""
    for seg, jseg in zip(cache, jcache):
        for name, x in seg.items():
            w = np.array(jseg[name])
            x[:, :w.shape[1]] = torch.from_numpy(w)


def check_rows(cache, jcache, label, rel=KV_REL):
    """The port's slot rows hold the reference's store: ``kpos`` equal on
    every row, K/V and scales within ``rel`` of the leaf's largest
    magnitude wherever ``kpos`` is valid. At int8 a
    code may take its neighbour (within one, on under 1e-3 of the codes).
    Returns how many codes differ."""
    flips = 0
    for seg, jseg in zip(cache, jcache):
        kpos = np.asarray(jseg["kpos"])
        B = kpos.shape[1]
        np.testing.assert_array_equal(seg["kpos"][:, :B].numpy(), kpos,
                                      err_msg=f"kpos {label}")
        valid = kpos > JA.EMPTY_POS // 2
        for name, x in seg.items():
            if name == "kpos":
                continue
            g, w = x[:, :B].numpy()[valid], np.asarray(jseg[name])[valid]
            if x.dtype == torch.int8:
                assert np.abs(g.astype(np.int32) - w).max() <= 1, (name, label)
                assert (g != w).mean() < 1e-3, (name, label)
                flips += int((g != w).sum())
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max(),
                                           err_msg=f"{name} {label}")
    return flips


@pytest.mark.parametrize("kv_int8", [False, True])
def test_init_cache_is_the_reference_store_plus_a_sink_row(models, kv_int8):
    jcfg, cfg, _, _ = models
    jcfg, cfg = _with_kv(jcfg, cfg, kv_int8)
    B, S = 3, 40
    jcache = JMD.init_cache(jcfg, B, S)
    cache = MD.init_cache(cfg, B, S, device="cpu")
    assert len(cache) == len(jcache)
    for seg, jseg in zip(cache, jcache):
        assert set(seg) == set(jseg)
        for name, x in seg.items():
            w = np.asarray(jseg[name])
            assert tuple(x.shape) == (w.shape[0], B + 1) + w.shape[2:]
            assert str(x.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_array_equal(x[:, :B].numpy(), w)
            np.testing.assert_array_equal(x[:, B].numpy(), w[:, 0])
    assert A.EMPTY_POS == JA.EMPTY_POS


@pytest.mark.parametrize("kv_int8", [False, True])
def test_prefill_builds_the_reference_store(models, kv_int8):
    """Three prompts of one 16-token bucket, ragged (16, 9 and 3 valid):
    logits agree, ``kpos`` is the reference's on every row (pad positions
    and the row's tail empty), K/V and scales agree on valid rows (int8
    codes within one, as ``check_rows`` holds them)."""
    jcfg, cfg, jp, params = models
    jcfg, cfg = _with_kv(jcfg, cfg, kv_int8)
    B, T, S = 3, 16, 40
    toks = np.random.default_rng(0).integers(0, VOCAB, (B, T))
    lengths = np.array([16, 9, 3])
    want, jcache, _ = JMD.prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), max_len=S,
                                  lengths=jnp.asarray(lengths, jnp.int32))
    got, cache = MD.prefill(cfg, params, torch.from_numpy(toks), max_len=S,
                            lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    check_rows(cache, jcache, "prefill")
    kpos = cache[0]["kpos"][0].numpy()
    assert (kpos[1, 9:] == A.EMPTY_POS).all() and (kpos[2, :3] == [0, 1, 2]).all()
    # the sink row took nothing: a prefill of B rows names rows 0..B-1
    assert (cache[0]["kpos"][:, B] == A.EMPTY_POS).all()


@pytest.mark.parametrize("kv_int8", [False, True])
def test_gqa_decode_layer_matches_reference(models, kv_int8):
    """One layer's dense decode from a populated store: the output, and the
    store after its write-then-attend. Rows at positions 5, 17 and 39 (the
    row's last index)."""
    jcfg, cfg, jp, params = models
    jcfg, cfg = _with_kv(jcfg, cfg, kv_int8)
    B, T, S = 3, 16, 40
    rng = np.random.default_rng(2)
    toks = rng.integers(0, VOCAB, (B, T))
    _, jcache, _ = JMD.prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), max_len=S)
    cache = MD.init_cache(cfg, B, S, device="cpu")
    _sync_rows(cache, jcache)
    jc = jax.tree.map(lambda a: a[0], jcache[0])
    c = {k: v[0] for k, v in cache[0].items()}
    jl = jax.tree.map(lambda a: a[0], jp["segs"][0]["attn"])
    layer = {k: v[0] for k, v in params["segs"][0]["attn"].items()}
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([5, 17, 39])
    want, jc2 = JA.gqa_decode(jcfg, jl, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jc)
    got = A.gqa_decode(cfg, layer, torch.from_numpy(x), torch.from_numpy(pos), c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    check_rows([{k: v[None] for k, v in c.items()}],
               [jax.tree.map(lambda a: a[None], jc2)], "decode write")


@pytest.mark.parametrize("kv_int8", [False, True])
def test_teacher_forced_dense_decode_logits(models, kv_int8):
    """Three rows decode a fixed token sequence after a ragged prefill, one
    step at a time. Each step starts from the reference's store, so a code
    flipped on a rounding edge at int8 touches only the step that writes
    it. Logits agree within 1e-4 at every step whose written codes are the
    reference's; a step that wrote a flipped code within ``FLIP_ATOL``."""
    jcfg, cfg, jp, params = models
    jcfg, cfg = _with_kv(jcfg, cfg, kv_int8)
    B, T, S, steps = 3, 16, 48, 24
    rng = np.random.default_rng(1)
    toks = rng.integers(0, VOCAB, (B, T))
    lengths = np.array([16, 11, 4])
    _, jcache, _ = JMD.prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), max_len=S,
                               lengths=jnp.asarray(lengths, jnp.int32))
    cache = MD.init_cache(cfg, B, S, device="cpu")
    jstep = jax.jit(lambda tok, pos, c: JMD.forward(
        jcfg, jp, tok, mode="decode", positions=pos, cache=c))
    feed = rng.integers(0, VOCAB, (B, steps))
    flip_steps = 0
    for t in range(steps):
        _sync_rows(cache, jcache)
        pos = lengths + t
        want, jcache = jstep(jnp.asarray(feed[:, t:t + 1], jnp.int32),
                             jnp.asarray(pos, jnp.int32), jcache)
        got = MD.forward(cfg, params, torch.from_numpy(feed[:, t:t + 1]), mode="decode",
                         positions=torch.from_numpy(pos), cache=cache)
        flipped = check_rows(cache, jcache, f"step {t}") > 0
        flip_steps += flipped
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=FLIP_ATOL if flipped else ATOL, err_msg=f"step {t}")
    assert flip_steps <= steps // 12


def test_decode_of_named_rows_is_the_gathered_reference(models):
    """A bucket smaller than the store: batch rows name their store rows
    (slots 3 and 0 of four, and one pad row aimed at the sink). The logits
    are the reference's over the gathered rows (its bucketed program), the
    named rows are written in place, and every other slot row is untouched;
    the pad row's write lands in the sink row."""
    jcfg, cfg, jp, params = models
    B, T, S = 4, 16, 40
    rng = np.random.default_rng(3)
    toks = rng.integers(0, VOCAB, (B, T))
    _, jcache, _ = JMD.prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), max_len=S)
    cache = MD.init_cache(cfg, B, S, device="cpu")
    _sync_rows(cache, jcache)
    before = [{k: v.clone() for k, v in seg.items()} for seg in cache]
    rows = np.array([3, 0, B])               # B = the sink row
    feed = rng.integers(0, VOCAB, (3, 1))
    pos = np.array([16, 20, 0])
    part = jax.tree.map(lambda a: a[:, rows[:2]], jcache)
    want, part = JMD.forward(jcfg, jp, jnp.asarray(feed[:2], jnp.int32), mode="decode",
                             positions=jnp.asarray(pos[:2], jnp.int32), cache=part)
    got = MD.forward(cfg, params, torch.from_numpy(feed), mode="decode",
                     positions=torch.from_numpy(pos), cache=cache,
                     rows=torch.from_numpy(rows))
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(want), rtol=0, atol=ATOL)
    check_rows([{k: v[:, rows[:2]] for k, v in seg.items()} for seg in cache], part,
               "named rows")
    for seg, old in zip(cache, before):
        for name, x in seg.items():
            assert torch.equal(x[:, [1, 2]], old[name][:, [1, 2]]), name
        assert (seg["kpos"][:, B, 0] == 0).all()        # the pad row's write


def test_full_batch_of_permuted_rows_reads_its_rows(models):
    """A batch as large as the store naming its rows out of order (slots 2,
    0, 3 and 1 of four): the logits are the reference's over the rows in
    that order, and each named row is written in place. The read that takes
    rows 0..B-1 where they lie (the engine's full bucket) is asked for by
    name, and refuses a batch larger than the store."""
    jcfg, cfg, jp, params = models
    B, T, S = 4, 16, 40
    rng = np.random.default_rng(5)
    toks = rng.integers(0, VOCAB, (B, T))
    lengths = np.array([16, 9, 12, 5])
    _, jcache, _ = JMD.prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), max_len=S,
                               lengths=jnp.asarray(lengths, jnp.int32))
    cache = MD.init_cache(cfg, B, S, device="cpu")
    _sync_rows(cache, jcache)
    rows = np.array([2, 0, 3, 1])
    feed = rng.integers(0, VOCAB, (B, 1))
    pos = lengths[rows] + 3
    part = jax.tree.map(lambda a: a[:, rows], jcache)
    want, part = JMD.forward(jcfg, jp, jnp.asarray(feed, jnp.int32), mode="decode",
                             positions=jnp.asarray(pos, jnp.int32), cache=part)
    got = MD.forward(cfg, params, torch.from_numpy(feed), mode="decode",
                     positions=torch.from_numpy(pos), cache=cache,
                     rows=torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    check_rows([{k: v[:, rows] for k, v in seg.items()} for seg in cache], part,
               "permuted rows")
    layer = {k: v[0] for k, v in cache[0].items()}
    q = torch.zeros(B + 1, 1, cfg.n_heads, cfg.head_dim)
    with pytest.raises(ValueError, match="in-place read of 5 rows"):
        A.attend_rows(layer, q, torch.zeros(B + 1, dtype=torch.long),
                      torch.arange(B + 1), in_place=True)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_prefill_chunk_step_into_a_lane_row(models, kv_int8):
    """A 45-token prompt streamed in chunks of 12 (the last ragged) into
    lane 1's row, each chunk from the reference's store: the last logits
    and the written rows agree. A length-0 chunk changes no slot row; its
    pad rows land in the sink row."""
    jcfg, cfg, jp, params = models
    jcfg, cfg = _with_kv(jcfg, cfg, kv_int8)
    B, S, C = 2, 64, 12
    jcache = JMD.init_cache(jcfg, B, S)
    cache = MD.init_cache(cfg, B, S, device="cpu")
    prompt = np.random.default_rng(5).integers(0, VOCAB, 45)
    jstep = jax.jit(lambda toks, pos0, clen, c: JMD.prefill_chunk_step(
        jcfg, jp, toks, pos0, clen, jnp.int32(1), c))
    for pos0 in range(0, len(prompt), C):
        _sync_rows(cache, jcache)
        n = min(C, len(prompt) - pos0)
        toks = np.zeros(C, np.int64)
        toks[:n] = prompt[pos0:pos0 + n]
        want, jcache = jstep(jnp.asarray(toks, jnp.int32), jnp.int32(pos0), jnp.int32(n),
                             jcache)
        got = MD.prefill_chunk_step(cfg, params, torch.from_numpy(toks),
                                    *map(torch.tensor, (pos0, n, 1)), cache)
        assert tuple(got.shape) == (VOCAB,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL,
                                   err_msg=f"chunk at {pos0}")
        check_rows(cache, jcache, f"chunk at {pos0}")
    snap = [{k: v.clone() for k, v in seg.items()} for seg in cache]
    MD.prefill_chunk_step(cfg, params, torch.from_numpy(toks), torch.tensor(48),
                          torch.tensor(0), torch.tensor(1), cache)
    for seg, old in zip(cache, snap):
        for name, x in seg.items():
            assert torch.equal(x[:, :B], old[name][:, :B]), name
        assert (seg["kpos"][:, B, 48:48 + C] == torch.arange(48, 48 + C)).all()


# ----------------------------------------------------------------------
# the engine's bookkeeping on a dense store
# ----------------------------------------------------------------------

def test_default_engine_is_dense(models):
    """As in the reference, an engine built without ``paged`` keeps dense
    rows: no page allocator, a store of n_slots rows of max_len (and the
    sink row), and no prefix cache even when asked (the reference's engine
    drops it without pages)."""
    _, cfg, _, params = models
    eng = InferenceEngine(cfg, params, device="cpu", n_slots=3, max_len=40)
    assert not eng.paged and eng.pages is None and not eng.prefix_cache
    k = eng.cache[0]["k"]
    assert tuple(k.shape[1:3]) == (4, 40)
    assert eng.kv_stats()["layout"] == "dense"
    assert not InferenceEngine(cfg, params, device="cpu", prefix_cache=True).prefix_cache


def test_dense_and_paged_give_the_same_tokens(models):
    """fp32: both layouts compute the same attention over the same K/V, so
    the port's dense and paged engines emit the same greedy tokens, in the
    same order: three requests prefilled whole, three more admitted as
    chunk tasks (chunk 8) while lanes decode."""
    chunk = 8
    _, cfg, _, params = models
    tok = ByteTokenizer()
    runs = []
    for paged in (False, True):
        eng = InferenceEngine(cfg, params, device="cpu", n_slots=4, max_len=96,
                              decode_block=4, prefill_chunk=chunk, paged=paged,
                              page_size=16)
        for text, n in TRAFFIC[:3]:
            eng.submit(tok.encode(text, bos=True), max_new_tokens=n)
        eng.step()
        for text, n in TRAFFIC[3:]:
            eng.submit(tok.encode(text, bos=True), max_new_tokens=n)
        eng.run_to_completion()
        runs.append([(f.rid, f.token_ids) for f in eng.finished])
        assert eng.chunk_steps > 0 if chunk else eng.chunk_steps == 0
    assert runs[0] == runs[1] and len(runs[0]) == len(TRAFFIC)


@pytest.fixture(scope="module")
def granite():
    jcfg = jreduced("granite_3_2b").replace(vocab_size=VOCAB)
    cfg = reduced("granite_3_2b").replace(vocab_size=VOCAB)
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, MD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def test_scheduler_over_dense_engines_serves_reference_streams(granite):
    """``CarbonAwareScheduler`` over two dense engines of each package on
    reduced granite (chunk 8: requests that arrive while lanes decode
    stream in as chunk tasks), the same levels drawn: the same finished
    requests, levels and streams."""
    jcfg, cfg, jp, params = granite
    kw = dict(n_slots=2, max_len=96, decode_block=4, prefill_chunk=8)
    streams = []
    for sched_cls, req_cls, engines in (
            (JScheduler, JServeRequest, [JEngine(jcfg, jp, seed=i, **kw) for i in range(2)]),
            (CarbonAwareScheduler, ServeRequest,
             [InferenceEngine(cfg, params, device="cpu", seed=i, **kw) for i in range(2)])):
        rng = np.random.default_rng(0)
        sched = sched_cls(engines, level_fn=lambda rng=rng: int(rng.choice(3)))
        for text, n in TRAFFIC:
            sched.submit(req_cls(0, text, max_new_tokens=n,
                                 max_new_by_level=(n, max(n // 2, 1), 4)))
        sched.run()
        assert not sched.rejected and sum(e.chunk_steps for e in engines) > 0
        streams.append(sorted((f.rid, f.directive_level, f.token_ids)
                              for f in sched.finished))
    assert streams[1] == streams[0] and len(streams[0]) == len(TRAFFIC)
