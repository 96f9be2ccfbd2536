"""The port's table of entry points (``InferenceEngine.entry_points``, CUDA
graphs on the card, eager callables on the CPU) against the JAX package's
table of jitted programs, on the same weights and traffic: the same entry
names, tokens, page ledgers, step counts and warm flags; pad rows of a
bucket that write only the trash page; chunk arguments passed as device
tensors; the dead inputs that capture runs on; and entry bodies that read
no host value (a CUDA graph cannot capture a sync)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import reduced as jreduced
from repro.models import model as JMD
from repro.serving import InferenceEngine as JEngine
from repro.serving.sampler import SamplingParams as JSamplingParams
from repro_torch.configs import reduced
from repro_torch.models import model as MD
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.graphs import Entry, GraphPool
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.tokenizer import ByteTokenizer

# the traffic of test_torch_engine.py: prompt lengths straddle the 16/32/64
# prefill buckets, budgets differ per request
TRAFFIC = [("hello world", 24), ("the quick brown fox jumps over it", 12),
           ("a", 30), ("carbon aware serving of llms " * 2, 20),
           ("xyz", 8), ("generation directives", 16)]
# the same prompts and budgets with sampled requests among them: top-k/top-p,
# temperature only and greedy (the last two requests are greedy, so greedy
# blocks run once the sampled requests finish)
SAMPLING = [(0.9, 50, 0.95), (0.8, 0, 1.0), (0.0, 0, 1.0), (1.1, 5, 0.9),
            (0.0, 0, 1.0), (0.0, 0, 1.0)]
# fp32 on both sides; the frameworks sum in another order (test_torch_model.py)
ATOL = 1e-4
PAGE = 16
# ops that read a device value back to the host: each syncs the card, and
# a CUDA graph capture refuses them
SYNCING = frozenset({"_local_scalar_dense", "nonzero", "masked_select", "equal",
                     "is_nonzero", "allclose", "unique", "_unique2",
                     "repeat_interleave"})


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


def _drive(eng, traffic=TRAFFIC, sampling=None):
    """Serve ``traffic`` to completion, request i with ``sampling[i]``
    ((temperature, top_k, top_p); greedy when None). Returns, for each
    block dispatch, (last_decode_s == 0.0, the dispatch built a decode or
    mixed entry)."""
    tok = ByteTokenizer()
    cls = JSamplingParams if isinstance(eng, JEngine) else SamplingParams
    for i, (text, n) in enumerate(traffic):
        eng.submit(tok.encode(text, bos=True), max_new_tokens=n,
                   sampling=cls(*sampling[i]) if sampling else None)
    flags = []
    while eng.queue or any(s is not None for s in eng.slots):
        syncs, names = eng.decode_syncs, set(eng.entry_points)
        eng.step()
        if eng.decode_syncs > syncs:
            built = [n for n in set(eng.entry_points) - names
                     if n.startswith(("decode_", "mixed_"))]
            flags.append((eng.last_decode_s == 0.0, bool(built)))
    return flags


def _leaves(cache):
    return [x for seg in cache for x in seg.values()]


def _snapshot(cache):
    return [x.clone() for x in _leaves(cache)]


def _restore(cache, snap):
    for x, s in zip(_leaves(cache), snap):
        x.copy_(s)


def _unchanged_but_trash(cache, snap):
    """Every page except the trash page (the last) holds what ``snap`` held."""
    return all(torch.equal(x[:, :-1], s[:, :-1]) for x, s in zip(_leaves(cache), snap))


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("decode_block", [1, 4])
@pytest.mark.parametrize("chunk", [0, 8])
def test_entry_names_match_reference(models, chunk, decode_block, kv_int8):
    """The same traffic, greedy and sampled requests mixed, builds the same
    table, under the same names (the block's sampler in each decode and
    mixed name), in both engines; tokens, page ledgers and counts stay
    equal."""
    jcfg, cfg, jp, params = models
    kw = dict(n_slots=4, max_len=96, paged=True, page_size=PAGE, n_pages=12,
              decode_block=decode_block, kv_int8=kv_int8, prefill_chunk=chunk, seed=7)
    ref = JEngine(jcfg, jp, **kw)
    port = InferenceEngine(cfg, params, device="cpu", **kw)
    tables = [_record_tables(e) for e in (ref, port)]
    want_flags = _drive(ref, sampling=SAMPLING)
    got_flags = _drive(port, sampling=SAMPLING)
    assert set(port.entry_points) == set(ref.entry_points)
    table = sorted(port.entry_points)
    assert any(n.startswith("prefill_bs") for n in table)
    assert any(n.startswith("mixed_bs") for n in table) == (chunk > 0)
    blocks = [n for n in table if n.startswith(("decode_", "mixed_"))]
    assert any(n.endswith("_full") for n in blocks), blocks
    assert {f.rid: f.token_ids for f in port.finished} == {
        f.rid: f.token_ids for f in ref.finished}
    assert [f.rid for f in port.finished] == [f.rid for f in ref.finished]
    assert tables[1] == tables[0]
    assert (port.steps, port.chunk_steps, port.decode_syncs, port.peak_pages_in_use,
            port.prefill_tokens_computed) == (
        ref.steps, ref.chunk_steps, ref.decode_syncs, ref.peak_pages_in_use,
        ref.prefill_tokens_computed)
    assert got_flags == want_flags
    # every mixed block ran one chunk pass a step, real chunks or not
    assert port.chunk_passes >= port.chunk_steps
    assert (port.chunk_passes > 0) == (chunk > 0)


@pytest.mark.parametrize("decode_block", [1, 8])
def test_warm_flag_marks_exactly_the_dispatches_that_built(models, decode_block):
    """``last_decode_s`` is 0.0 on exactly the dispatches that built their
    entry, in both engines, and on the same dispatches; chunked traffic, so
    mixed entries are built too."""
    jcfg, cfg, jp, params = models
    kw = dict(n_slots=2, max_len=64, paged=True, page_size=PAGE,
              decode_block=decode_block, prefill_chunk=8)
    traffic = [("background request keeps its lane decoding", 30),
               ("newcomer arrives with a much longer prompt that spans chunks", 10),
               ("third", 6)]
    ref = JEngine(jcfg, jp, **kw)
    port = InferenceEngine(cfg, params, device="cpu", **kw)
    want, got = _drive(ref, traffic), _drive(port, traffic)
    assert port.chunk_steps > 0
    assert got == want
    assert all(zero == built for zero, built in got)
    assert sum(built for _, built in got) == sum(
        n.startswith(("decode_", "mixed_")) for n in port.entry_points)


def test_pad_row_writes_only_the_trash_page(models):
    """Three live lanes on eight slots: the bucket has four rows, one of them
    padding. Tokens match the reference; the padded block leaves every page
    but the trash page as the same block over the three rows alone leaves
    it, and the pad row emits nothing."""
    jcfg, cfg, jp, params = models
    kw = dict(n_slots=8, max_len=64, paged=True, page_size=PAGE, decode_block=4)
    # three prompts of the 16-token bucket: one prefill group of 3 rows,
    # padded to 4
    traffic = [("hello world", 24), ("a", 30), ("xyz", 8)]
    ref = JEngine(jcfg, jp, **kw)
    port = InferenceEngine(cfg, params, device="cpu", **kw)
    calls = []
    fused_for = port._fused_for

    def spy(k, mode, bs, chunk_c):
        entry, warm = fused_for(k, mode, bs, chunk_c)

        def call(**inputs):
            calls.append((k, bs, {n: np.array(v) for n, v in inputs.items()},
                          _snapshot(port.cache)))
            return entry(**inputs)

        return call, warm

    port._fused_for = spy
    _drive(ref, traffic)
    _drive(port, traffic)
    assert {f.rid: f.token_ids for f in port.finished} == {
        f.rid: f.token_ids for f in ref.finished}
    assert set(port.entry_points) == set(ref.entry_points)
    assert "prefill_bs4_p16" in port.entry_points
    k, bs, inputs, snap = calls[0]
    assert bs == 4 and list(inputs["live"]) == [1, 1, 1, 0]
    assert (inputs["bt"][3] == -1).all() and inputs["max_new"][3] == 1
    _restore(port.cache, snap)
    padded = fused_for(k, "greedy", 4, 0)[0](**inputs).numpy()
    after_padded = _snapshot(port.cache)
    _restore(port.cache, snap)
    bare = fused_for(k, "greedy", 3, 0)[0](
        **{n: v[:3] for n, v in inputs.items()}).numpy()
    np.testing.assert_array_equal(padded[:, :3], bare)
    assert not padded[k:2 * k + 1, 3].any()   # nothing emitted, dead after
    assert padded[2 * k + 1].all()            # and every verdict finite
    mapped = np.unique(inputs["bt"][:3][inputs["bt"][:3] >= 0])
    for x, want in zip(_leaves(port.cache), after_padded):
        # pages no lane maps: untouched by either run, bit for bit
        unmapped = [p for p in range(x.shape[1] - 1) if p not in mapped]
        assert torch.equal(want[:, unmapped], x[:, unmapped])
        np.testing.assert_allclose(want[:, mapped].float().numpy(),
                                   x[:, mapped].float().numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_chunk_step_takes_device_arguments(models, kv_int8):
    """``prefill_chunk_step`` with pos0, clen and lane as 0-dim tensors gives
    the reference's logits at every chunk of a prompt whose chunks straddle
    the 16-token pages; with clen 0 it writes only the trash page."""
    jcfg, cfg, jp, params = models
    if kv_int8:
        jcfg = jcfg.replace(kv_cache_dtype="int8")
        cfg = cfg.replace(kv_cache_dtype="int8")
    P = 10
    bt = np.full((2, 4), -1, np.int32)
    bt[0, :2] = [0, 1]
    bt[1, :3] = [7, 2, 5]
    jcache = JMD.init_paged_cache(jcfg, P, PAGE)
    cache = MD.init_paged_cache(cfg, P, PAGE, device="cpu")
    prompt = np.random.default_rng(6).integers(0, 512, 41)
    C = 12
    lane = torch.tensor(1)
    for pos0 in range(0, len(prompt), C):
        n = min(C, len(prompt) - pos0)
        toks = np.zeros(C, np.int64)
        toks[:n] = prompt[pos0:pos0 + n]
        want, jcache = JMD.prefill_chunk_step(
            jcfg, jp, jnp.asarray(toks, jnp.int32), jnp.int32(pos0), jnp.int32(n),
            jnp.int32(1), jcache, block_table=jnp.asarray(bt))
        got = MD.prefill_chunk_step(cfg, params, torch.from_numpy(toks),
                                    torch.tensor(pos0), torch.tensor(n), lane, cache,
                                    block_table=torch.from_numpy(bt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL,
                                   err_msg=f"chunk at {pos0}")
    snap = _snapshot(cache)
    out = MD.prefill_chunk_step(cfg, params, torch.from_numpy(toks), torch.tensor(16),
                                torch.tensor(0), lane, cache,
                                block_table=torch.from_numpy(bt))
    assert out.shape == (cfg.vocab_size,)
    assert _unchanged_but_trash(cache, snap)


def _populated(models, kv_int8):
    """A CPU engine whose page store holds the K/V of finished requests."""
    _, cfg, _, params = models
    eng = InferenceEngine(cfg, params, device="cpu", n_slots=4, max_len=96,
                          paged=True, page_size=PAGE, n_pages=12, decode_block=4,
                          kv_int8=kv_int8)
    _drive(eng, TRAFFIC[:4])
    assert any(x[:, :-1].any() for x in _leaves(eng.cache))
    return eng


# entry kinds: (block mode, chunk length) of a 4-step block over 4 rows, or
# a prefill group of 4 x 32
KINDS = {"decode": ("greedy", 0), "mixed": ("greedy", 8), "temp": ("temp", 0),
         "full": ("full", 0), "mixed_full": ("full", 8), "prefill": None}


def _entry(eng, kind, bs=4):
    if KINDS[kind] is None:
        return eng._prefill_for(4, 32)
    mode, chunk = KINDS[kind]
    return eng._fused_for(4, mode, bs, chunk)[0]


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
def test_capture_inputs_write_only_the_trash_page(models, kind, kv_int8):
    """The dead inputs that warm-up and capture run on (every lane dead,
    every table entry -1, chunk length 0, prompt pages at the trash page)
    leave every page but the trash page as it was."""
    eng = _populated(models, kv_int8)
    entry = _entry(eng, kind)
    snap = _snapshot(eng.cache)
    entry.stage_dead()
    out = entry.run()
    assert _unchanged_but_trash(eng.cache, snap)
    if kind != "prefill":
        assert not out[4:9].any()              # nothing emitted, nothing live
        assert out[9].all()                    # dead lanes leave the verdict


class _Ops(TorchDispatchMode):
    """Records every aten op run under it, with its arguments."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append((func.overloadpacket.__name__, args))
        return func(*args, **(kwargs or {}))


def _bool_indexed(name, args):
    """An index or index_put with a boolean mask (it syncs for the count)."""
    return (name in ("index", "index_put", "index_put_") and len(args) > 1
            and any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                    for t in args[1] if t is not None))


@pytest.mark.parametrize("kind", list(KINDS))
def test_entry_bodies_read_no_host_value(models, kind):
    """An entry's callable runs no op that reads a device value back to the
    host, and indexes by no boolean mask, so the card can capture it (the
    CPU runs the same callable; only the kernels differ). The sampled
    bodies (``temp``, ``full``, the prefill group's draw) run on live
    sampled rows and a real key, in a bucket smaller than the slots (rows
    fold by slot id)."""
    eng = _populated(models, False)
    sampled = kind != "prefill" and KINDS[kind][0] != "greedy"
    entry = _entry(eng, kind, bs=2 if sampled else 4)
    entry.stage_dead()
    values = dict(entry.dead)
    if kind in ("mixed", "mixed_full"):
        # one real chunk of the lane's prompt, so the chunk pass writes
        values.update(live=np.array([1, 1, 0, 0][:entry.host["live"].shape[0]]),
                      clen=np.array([8, 3, 0, 0]), lane=1, cfin=np.array([0, 1, 0, 0]))
    elif kind in ("temp", "full"):
        values["live"] = np.array([1, 1])
    if "key" in values:
        n = entry.host["temp"].shape[0]
        values.update(temp=np.linspace(0.5, 1.2, n, dtype=np.float32),
                      topk=np.arange(n) * 20, topp=np.full(n, 0.9, np.float32),
                      key=np.array([12345, 678]))
        if "rows" in values:
            values["rows"] = np.array([2, 0])
    entry.stage_inputs(**values)
    with _Ops() as ops:
        entry.run()
    names = {name for name, _ in ops.seen}
    assert names and not names & SYNCING, names & SYNCING
    assert not [name for name, args in ops.seen if _bool_indexed(name, args)]


def test_entry_stages_every_input_through_one_buffer():
    """Inputs are views of one static buffer, filled from one staging
    buffer; a dispatch must give every input. A float32 input (a sampler's
    temperature) is staged as its int32 bit pattern and reaches ``fn`` as
    the same float32 values; a key's two uint32 words as int64 values."""
    calls = []

    def fn(a, b, t, key):
        calls.append((a.clone(), b.clone(), t.clone(), key.clone()))
        return a.sum() + b.sum()

    entry = Entry("test", fn, {"a": ((2, 3), -1), "b": ((), 7),
                               "t": ((3,), 1.0, torch.float32), "key": ((2,), 0)},
                  GraphPool(torch.device("cpu")))
    assert entry.buf.numel() == 12 and entry.stage.numel() == 12
    assert entry.buf.dtype == entry.stage.dtype == torch.int64
    assert all(t.data_ptr() >= entry.buf.data_ptr() for t in entry.inputs.values())
    entry.stage_dead()
    one = int(np.float32(1.0).view(np.int32))
    assert entry.buf.tolist() == [-1] * 6 + [7] + [one] * 3 + [0, 0]
    temps = np.array([0.0, 0.9, -2.5e-7], np.float32)
    key = np.array([0xFFFFFFFF, 0x80000000])
    out = entry(a=np.arange(6).reshape(2, 3), b=4, t=temps, key=key)
    assert out.item() == 19 and calls[-1][1].item() == 4
    t = calls[-1][2]
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), temps)
    assert calls[-1][3].tolist() == key.tolist()
    assert entry.graph is None and entry.per_run == (0, 0, 0)
    with pytest.raises(ValueError, match="inputs"):
        entry(a=np.zeros((2, 3)))
    with pytest.raises(ValueError, match="dtype"):
        Entry("test", fn, {"a": ((2,), 0, torch.int32)}, GraphPool(torch.device("cpu")))


# ----------------------------------------------------------------------
# the dense layout's entries (``paged=False``, the reference's default)
# ----------------------------------------------------------------------

def _populated_dense(models, kv_int8):
    """A dense CPU engine whose store holds seeded K/V, scales and
    positions in every row (a state any traffic could leave), so that a
    stray write shows."""
    _, cfg, _, params = models
    eng = InferenceEngine(cfg, params, device="cpu", n_slots=4, max_len=96,
                          decode_block=4, kv_int8=kv_int8)
    gen = torch.Generator().manual_seed(3)
    for seg in eng.cache:
        for name, x in seg.items():
            if name == "kpos":
                x.copy_(torch.arange(x.shape[-1]).expand_as(x))
            elif x.dtype == torch.int8:
                x.copy_(torch.randint(-127, 128, x.shape, generator=gen))
            else:
                x.copy_(torch.rand(x.shape, generator=gen) + 0.5)
    return eng


@pytest.mark.parametrize("kind", list(KINDS))
def test_dense_entry_bodies_read_no_host_value(models, kind):
    """The dense entries' callables, on live lanes naming real slot rows
    (a chunk lane that writes, sampled rows in a bucket of 2 that fold by
    slot id), run no op that reads a device value back to the host and
    index by no boolean mask, so the card can capture them."""
    eng = _populated_dense(models, False)
    sampled = kind != "prefill" and KINDS[kind][0] != "greedy"
    entry = _entry(eng, kind, bs=2 if sampled else 4)
    values = dict(entry.dead)
    if kind == "prefill":
        values.update(slots=np.array([1, 3, 0, 4]), lengths=np.array([32, 20, 7, 1]))
    else:
        n = entry.host["live"].shape[0]
        values.update(rows=np.array([2, 0]) if n == 2 else np.arange(n),
                      live=np.ones(n, np.int64), pos=np.arange(n) + 30)
    if kind in ("mixed", "mixed_full"):
        values.update(clen=np.array([8, 3, 0, 0]), lane=1, cfin=np.array([0, 1, 0, 0]))
    if "key" in values:
        n = entry.host["temp"].shape[0]
        values.update(temp=np.linspace(0.5, 1.2, n, dtype=np.float32),
                      topk=np.arange(n) * 20, topp=np.full(n, 0.9, np.float32),
                      key=np.array([12345, 678]))
    entry.stage_inputs(**values)
    with _Ops() as ops:
        entry.run()
    names = {name for name, _ in ops.seen}
    assert names and not names & SYNCING, names & SYNCING
    assert not [name for name, args in ops.seen if _bool_indexed(name, args)]
