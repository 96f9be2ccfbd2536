"""Fault injection and recovery of the port's engine against the reference's
(DESIGN.md §12), on the same weights (one ``repro.models.model.init_model``
tree of reduced granite, vocab 512, via ``params_from_jax``).

* ``decode_sample_step`` on a store with a NaN row: the reference's
  tokens and finiteness verdict (its ``with_ok=True``), greedy and sampled.
* Lockstep: a port engine and a reference engine serve the same traffic
  and are poisoned (``poison_lane``) at the same slot before the same
  block, on the dense store (fp32 and int8, whole-prompt and chunked 8, a
  chunk-task lane poisoned mid-prefill, a sampled bucket under the slot
  count) and the page store (fp32, int8, the prefix cache with a poisoned
  lane that holds adopted pages, chunked 8 with the holder of page 0
  poisoned while a prompt is partly written, which takes the chunk lane
  down too). After every block both hold the same
  ``faulted`` requests (rid, tokens, reason), the same store (NaN where
  the reference's is NaN; the sink row and the trash page excepted), the
  same ``kv_stats``, counters and page ledger, and ``invalidate_slot``
  de-indexes as many pages. The quarantined requests, resubmitted, finish
  with the tokens of a clean run. Every fill of the port touches only its
  lane, and neither the fill nor a block's verdict reads a device value on
  the host.
* The reference's engine tests of ``test_faults.py`` that need a poisoned
  lane or a crash mid chunk prefill, on both layouts.

One engine pair per case, built in a module-scoped fixture, so each
reference program compiles once."""
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced as jreduced
from repro.models import attention as JA
from repro.models import model as JMD
from repro.serving import InferenceEngine as JEngine
from repro.serving import sampler as JS
from repro.serving.sampler import SamplingParams as JSamplingParams
from repro_torch.configs import reduced
from repro_torch.models import model as MD
from repro_torch.serving import prng
from repro_torch.serving import sampler as S
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.faults import FaultInjector, FaultPlan, FaultSpec
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import CarbonAwareScheduler, ServeRequest
from repro_torch.serving.tokenizer import ByteTokenizer
from test_torch_dense import TRAFFIC, VOCAB
from test_torch_entry_points import SYNCING, _bool_indexed, _Ops
from test_torch_prefix_cache import SHARED, _alloc_state

# K/V the engines write over many blocks: a few fp32 ulp of the hidden
# states' drift between the frameworks (test_torch_dense_engine.py)
ENGINE_REL = 1e-5
MAX_LEN = 96
# greedy, temperature only, top-k/top-p (test_torch_dense_engine.py)
SAMPLED = [(0.9, 50, 0.95), (0.8, 0, 1.0), (0.0, 0, 1.0), (1.1, 5, 0.9),
           (0.0, 0, 1.0), (0.0, 0, 1.0)]
GREEDY = [(0.0, 0, 1.0)] * len(TRAFFIC)
# three requests behind Sprout-like system prompts (two 16-token pages
# shared), then unrelated ones
PREFIX_TRAFFIC = [(SHARED + "q1", 12), (SHARED + "second?", 12),
                  ("unrelated prompt", 16), (SHARED + "x", 10),
                  (SHARED + "why not", 12), ("xyz", 8)]

# case -> (engine kwargs, traffic, sampling rows, poisons). A poison is
# (block, which): before that block (None: the first block where it
# applies) the engines poison the slot ``which`` names: ("live", i) the
# i-th live lane, "task" the chunk-task lane once its prompt is partly
# written, "adopted" a lane that maps pages it adopted from the index,
# "page0" the live lane that holds page 0 while another lane's prompt is
# partly written
PAGED = dict(paged=True, page_size=16)
CASES = {
    "dense-fp32": ({}, TRAFFIC, GREEDY, [(1, ("live", 1)), (4, ("live", 0))]),
    "dense-int8": (dict(kv_int8=True), TRAFFIC, GREEDY, [(2, ("live", 2))]),
    "dense-fp32-chunked": (dict(prefill_chunk=8), TRAFFIC, GREEDY,
                           [(None, "task"), (3, ("live", 0))]),
    "dense-int8-chunked": (dict(kv_int8=True, prefill_chunk=8), TRAFFIC, GREEDY,
                           [(1, ("live", 1)), (None, "task")]),
    "dense-sampled": ({}, TRAFFIC, SAMPLED, [(2, ("live", 0)), (3, ("live", 1))]),
    "paged-fp32": (PAGED, TRAFFIC, GREEDY, [(1, ("live", 1)), (4, ("live", 0))]),
    "paged-int8": (dict(PAGED, kv_int8=True), TRAFFIC, GREEDY, [(2, ("live", 2))]),
    "paged-fp32-chunked": (dict(PAGED, prefill_chunk=8), TRAFFIC, GREEDY, [(None, "page0")]),
    "paged-prefix": (dict(PAGED, prefix_cache=True, prefill_chunk=4), PREFIX_TRAFFIC, GREEDY,
                     [(None, "adopted"), (None, "task")]),
}


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced("granite_3_2b").replace(vocab_size=VOCAB)
    cfg = reduced("granite_3_2b").replace(vocab_size=VOCAB)
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    params = MD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, params


def _kw(case):
    return dict(n_slots=4, max_len=MAX_LEN, decode_block=4, seed=3, **CASES[case][0])


def _port(models, **kw):
    _, cfg, _, params = models
    return InferenceEngine(cfg, params, device="cpu", **kw)


# ======================================================================
# the model step's verdict
# ======================================================================

@pytest.mark.parametrize("mode", ["greedy", "full"])
def test_decode_sample_step_verdict_matches_reference(models, mode):
    """A dense store whose row 1 is NaN: the reference's tokens (argmax of a
    NaN row included) and verdict (row 1 False, the others True)."""
    jcfg, cfg, jp, params = models
    B, T = 4, 24
    toks = np.random.default_rng(1).integers(0, VOCAB, (B, T))
    lengths = np.array([24, 9, 17, 5])
    _, jcache, _ = JMD.prefill(jcfg, jp, jax.numpy.asarray(toks, jax.numpy.int32),
                               max_len=32, lengths=jax.numpy.asarray(lengths, jax.numpy.int32))
    jcache = jax.tree.map(lambda a: a.at[:, 1].set(np.nan) if a.dtype == np.float32 else a,
                          jcache)
    cache = MD.init_cache(cfg, B, 32, device="cpu")
    for seg, jseg in zip(cache, jcache):
        for name, x in seg.items():
            x[:, :B] = torch.from_numpy(np.array(jseg[name]))
    last = np.array([5, 6, 7, 8])
    temp, topk, topp = (np.array([0.9, 0.8, 0.0, 1.1], np.float32), np.array([50, 0, 0, 5]),
                        np.array([0.95, 1.0, 1.0, 0.9], np.float32))
    if mode == "greedy":
        jfn, fn, jsp, sp, jkey, key = JS.greedy_sample, S.greedy_sample, (), (), None, None
    else:
        jfn, fn = JS.sample_logits_batched, S.sample_logits_batched
        jsp = tuple(jax.numpy.asarray(a) for a in (temp, topk.astype(np.int32), topp))
        sp = tuple(torch.from_numpy(a) for a in (temp, topk, topp))
        jkey, key = jax.random.PRNGKey(7), prng.PRNGKey(7)
    jt, _, jok = JMD.decode_sample_step(
        jcfg, jp, jax.numpy.asarray(last[:, None], jax.numpy.int32),
        jax.numpy.asarray(lengths, jax.numpy.int32), jcache, jkey, jsp, jfn, with_ok=True)
    t, ok = MD.decode_sample_step(cfg, params, torch.from_numpy(last[:, None]),
                                  torch.from_numpy(lengths), cache, key, sp, fn)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ok.numpy(), [True, False, True, True])
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


# ======================================================================
# lockstep engines, poisoned alike
# ======================================================================

@pytest.fixture(scope="module")
def pairs(models):
    """``pairs(case)`` -> (reference engine, port engine), made once."""
    jcfg, _, jp, _ = models
    made = {}

    def pair(case):
        if case not in made:
            made[case] = (JEngine(jcfg, jp, **_kw(case)), _port(models, **_kw(case)))
        return made[case]
    return pair


def _submit(eng, traffic, modes, rids=None):
    tok = ByteTokenizer()
    cls = JSamplingParams if isinstance(eng, JEngine) else SamplingParams
    for i, (text, n) in enumerate(traffic):
        eng.submit(tok.encode(text, bos=True), max_new_tokens=n, sampling=cls(*modes[i]))


def _pick(eng, which):
    """The slot ``which`` names on ``eng`` now, or None."""
    t = eng._task
    in_flight = t is not None and 0 < t.next < t.plen
    if which == "task":
        return t.slot if in_flight else None
    if which == "page0":
        return next((i for i in range(eng.n_slots) if in_flight and i != t.slot
                     and eng.live[i] and 0 in eng.pages.block_table[i]), None)
    if which == "adopted":
        for i, st in enumerate(eng.slots):
            if st is None:
                continue
            pids = eng.pages.block_table[i][: int(eng.pages._slot_pages[i])]
            if any(eng.pages._owner[p] != i for p in pids) and eng.live[i]:
                return i
        return None
    live = np.nonzero(eng.live)[0]
    return int(live[which[1]]) if len(live) > which[1] else None


def _float_equal(g, w, rel, label):
    """Equal NaN pattern; finite values within ``rel`` of the leaf's largest
    finite magnitude."""
    nan = np.isnan(w)
    np.testing.assert_array_equal(np.isnan(g), nan, err_msg=f"NaN pattern {label}")
    if (~nan).any():
        scale = np.abs(w[~nan]).max()
        np.testing.assert_allclose(g[~nan], w[~nan], rtol=0, atol=rel * max(scale, 1e-30),
                                   err_msg=label)


def check_store(port, ref, label):
    """The port's store holds the reference's: the pages (not the trash
    page), or the dense slot rows (not the sink row) with ``kpos`` equal,
    where ``kpos`` is valid (the reference's insert also zeroes a row past
    its prompt), float leaves equal in their NaN pattern and within
    ``ENGINE_REL``, int8 codes at most one apart on under 1e-3 of them."""
    n = ref.pages.n_pages if ref.paged else ref.n_slots
    for seg, jseg in zip(port.cache, ref.cache):
        valid = None
        if not ref.paged:
            kpos = np.asarray(jseg["kpos"])
            np.testing.assert_array_equal(seg["kpos"][:, :n].numpy(), kpos,
                                          err_msg=f"kpos {label}")
            valid = kpos > JA.EMPTY_POS // 2
        for name, x in seg.items():
            g, w = x[:, :n].numpy(), np.asarray(jseg[name])
            if valid is not None:
                g, w = g[valid], w[valid]
            if name == "kpos":
                continue
            if x.dtype == torch.int8:
                assert np.abs(g.astype(np.int32) - w).max() <= 1, (name, label)
                assert (g != w).mean() < 1e-3, (name, label)
            else:
                _float_equal(g, w, ENGINE_REL, f"{name} {label}")


def _state(eng):
    out = {
        "faulted": [(st.rid, st.generated, st.last_fault, st.slot) for st in eng.faulted],
        "finished": [(f.rid, f.token_ids) for f in eng.finished],
        "slots": [None if s is None else s.rid for s in eng.slots],
        "live": eng.live.tolist(), "positions": eng.positions.tolist(),
        "task": None if eng._task is None else (eng._task.slot, eng._task.next),
        "counters": {c: getattr(eng, c) for c in (
            "steps", "decode_syncs", "decode_tokens", "chunk_steps",
            "prefill_tokens_computed", "peak_concurrent")},
        "kv_stats": eng.kv_stats(),
    }
    if eng.paged:
        out["pages"] = _alloc_state(eng.pages)
        out["committed"] = eng._committed
    return out


def _snapshot(eng):
    return [{n: x.clone() for n, x in seg.items()} for seg in eng.cache]


def _checked_fills(eng, fills):
    """Wrap the port engine's ``_fill_lane``: each fill writes ``value`` into
    every float leaf of the lane's row (dense) or of the pages it owns
    alone (paged), and leaves every other byte of the store as it was:
    other rows and pages, the sink row, the trash page, ``kpos`` and int8
    codes. Records (slot, value, the pages filled)."""
    fill = eng._fill_lane

    def checked(slot, value):
        before = _snapshot(eng)
        if eng.paged:
            al = eng.pages
            mapped = al.block_table[slot][al.block_table[slot] >= 0]
            mine = al.block_table[slot][al.exclusive_pages(slot)] if eng.prefix_cache \
                else mapped
            others = {int(p) for j in range(eng.n_slots) if j != slot
                      for p in al.block_table[j] if p >= 0}
            assert not others & {int(p) for p in mine}
            hit = torch.zeros(al.n_pages + 1, dtype=torch.bool)
            hit[torch.as_tensor(mine.astype(np.int64))] = True
        else:
            hit = torch.zeros(eng.n_slots + 1, dtype=torch.bool)
            hit[slot] = True
        fill(slot, value)
        for seg, old in zip(eng.cache, before):
            for name, x in seg.items():
                if x.is_floating_point():
                    got = x[:, hit]
                    assert (got.isnan().all() if value != value
                            else (got == value).all()), (name, slot, value)
                    assert torch.equal(x[:, ~hit].view(torch.uint8),
                                       old[name][:, ~hit].view(torch.uint8)), name
                else:
                    assert torch.equal(x, old[name]), name
        fills.append((slot, value, hit.nonzero().flatten().tolist()))

    eng._fill_lane = checked


def _invalidations(eng, record):
    inv = eng.pages.invalidate_slot

    def counted(slot):
        n = inv(slot)
        record.append((slot, n))
        return n

    eng.pages.invalidate_slot = counted


def _lockstep(ref, port, poisons, label, fired):
    """Step both engines until both drain, poisoning alike; compare after
    every block."""
    b = 0
    pending = list(poisons)
    while ref.queue or any(s is not None for s in ref.slots):
        for p in list(pending):
            at, which = p
            if at is not None and at != b:
                continue
            slot = _pick(ref, which)
            if slot is None:
                continue
            assert _pick(port, which) == slot
            # a "page0" poison also reaches the chunk lane (the caller holds it)
            task = ref.slots[ref._task.slot].rid if which == "page0" else None
            ref.poison_lane(slot)
            port.poison_lane(slot)
            fired.append((b, which, slot, ref.slots[slot].rid, task))
            pending.remove(p)
        syncs, steps = port.decode_syncs, port.steps
        ref.step()
        port.step()
        b += 1
        # the verdict rides the block's one copy: one sync a block run
        assert port.decode_syncs - syncs == int(port.steps > steps)
        assert _state(port) == _state(ref), f"{label} block {b}"
        check_store(port, ref, f"{label} block {b}")
        assert b < 200
    return pending


@pytest.mark.parametrize("case", list(CASES))
def test_poisoned_lanes_quarantine_like_the_reference(models, pairs, case):
    ref, port = pairs(case)
    _, traffic, modes, poisons = CASES[case]
    fills, inv_ref, inv_port, fired = [], [], [], []
    _checked_fills(port, fills)
    if port.prefix_cache:
        _invalidations(ref, inv_ref)
        _invalidations(port, inv_port)
    for e in (ref, port):
        _submit(e, traffic[:3], modes)
        e.step()
        _submit(e, traffic[3:], modes[3:])
    assert _state(port) == _state(ref)
    left = _lockstep(ref, port, poisons, case, fired)
    assert not left, f"poisons never fired: {left}"
    # every poisoned lane was caught by the block after its poison. On a
    # dense store no other lane was; on a page store the plain attention
    # (the reference's XLA path, which the CPU engines run) reads unmapped
    # table entries clamped to page 0 at masked positions, and a weight of
    # 0 times NaN is NaN: poisoning the lane that holds page 0 quarantines
    # every lane of that block with an unmapped entry (the kernels read
    # only a lane's pages below its length). The chunk pass gathers through
    # that clamp in both packages, on every device: a lane whose prompt is
    # partly written is quarantined beside the holder of page 0
    caught = [st.rid for st in port.faulted]
    if port.paged:
        assert {f[3] for f in fired} <= set(caught)
        assert {f[4] for f in fired if f[4] is not None} <= set(caught)
    else:
        assert caught == [f[3] for f in fired]
    assert all(st.last_fault == "decode.nonfinite" for st in port.faulted)
    # one NaN fill a poison, one zero fill a quarantine
    assert sum(v != v for _, v, _ in fills) == len(fired)
    assert sum(v == 0.0 for _, v, _ in fills) == len(caught) == len(fills) - len(fired)
    assert inv_port == inv_ref
    # the quarantined requests come back and finish like a clean run's
    retried = {st.rid: st for st in port.faulted}
    for e in (ref, port):
        for st in list(e.faulted):
            cls = JSamplingParams if e is ref else SamplingParams
            e.submit(st.prompt_ids, max_new_tokens=st.max_new_tokens, rid=st.rid,
                     sampling=cls(st.sampling.temperature, st.sampling.top_k,
                                  st.sampling.top_p))
        e.faulted = []
    _lockstep(ref, port, [], case + " retry", fired)
    got = {f.rid: f.token_ids for f in port.finished}
    assert sorted(got) == sorted({f.rid for f in ref.finished})
    assert len(got) == len(traffic)
    clean = _port(models, **_kw(case))
    _submit(clean, traffic[:3], modes)
    clean.step()
    _submit(clean, traffic[3:], modes[3:])
    want = {f.rid: f.token_ids for f in clean.run_to_completion()}
    for rid, st in retried.items():
        if st.sampling.temperature == 0.0:
            assert got[rid] == want[rid], (case, rid)
    if port.paged:
        assert port.pages.pages_in_use() == 0 or port.prefix_cache
        assert port._committed == 0
    # nothing non-finite is left, but in the sink row or the trash page,
    # where a poisoned lane's dead rows and length-0 chunk passes write
    n = port.pages.n_pages if port.paged else port.n_slots
    for seg in port.cache:
        for name, x in seg.items():
            if x.is_floating_point():
                assert torch.isfinite(x[:, :n]).all(), f"{case}: NaN left in {name}"


@pytest.mark.parametrize("case", ["dense-fp32", "paged-prefix"])
def test_fill_and_poison_read_no_host_value(models, case):
    """``poison_lane`` and the scrub run no op that reads a device value on
    the host (each would sync the card between blocks) and index by no
    boolean mask."""
    eng = _port(models, **_kw(case))
    _submit(eng, CASES[case][1][:3], GREEDY)
    eng.step()
    slot = int(np.nonzero(eng.live)[0][0])
    with _Ops() as ops:
        eng.poison_lane(slot)
        eng._scrub_lane(slot)
    names = [n for n, _ in ops.seen]
    assert "index_fill_" in names or "fill_" in names
    bad = [n for n, a in ops.seen if n in SYNCING or _bool_indexed(n, a)]
    assert not bad, bad


def _engine(models, paged, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 64)
    if paged:
        kw.update(paged=True, page_size=8)
    return _port(models, eos_id=-1, **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_retry_budget_exhaustion_rejects(models, paged):
    """A lane poisoned on every block exhausts its retry budget and parks
    in ``rejected`` with a reason, never a crash loop (``test_faults.py``)."""
    plan = FaultPlan([FaultSpec("decode.nonfinite", "*", occurrences=(), prob=1.0)])
    eng = _engine(models, paged, decode_block=4)
    sched = CarbonAwareScheduler([eng], fault_injector=FaultInjector(plan),
                                 retry_budget=1, backoff_base_steps=1,
                                 probation_steps=1, clean_window=4)
    sched.submit(ServeRequest(0, "doomed request", max_new_tokens=16))
    for _ in range(60):
        sched.step()
        if sched.rejected:
            break
    assert len(sched.rejected) == 1
    req, reason = sched.rejected[0]
    assert "retry budget exhausted (1)" in reason
    assert "decode.nonfinite" in reason
    assert req.retries == 2 and not sched.finished and not sched.pending
    # every quarantine scrubbed its lane: nothing non-finite is left where
    # a request can read
    n = eng.pages.n_pages if paged else eng.n_slots
    assert all(torch.isfinite(x[:, :n]).all() for seg in eng.cache
               for x in seg.values() if x.is_floating_point())


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_replica_failure_mid_chunk_prefill(models, paged):
    """A replica dying while a chunk task is mid-prefill releases the lane
    (on a page store its pages and admission reservation too) and requeues
    the request with its identity (deadline_at, t_submit, verbatim ids)
    intact; the retry finishes with an undisturbed run's tokens
    (``test_faults.py``)."""

    def fresh():
        return _engine(models, paged, decode_block=4, prefill_chunk=8)

    eng = fresh()
    sched = CarbonAwareScheduler([eng], probation_steps=2, backoff_base_steps=1)
    sched.submit(ServeRequest(0, "background lane", max_new_tokens=24))
    sched.step()                       # background live -> chunked admission
    long_prompt = "a long arrival prompt that spans several prefill chunks"
    deadline = time.monotonic() + 3600.0
    rid_b = sched.submit(ServeRequest(0, long_prompt, max_new_tokens=6,
                                      deadline_at=deadline))
    t_submit = next(r.t_submit for r in sched.pending if r.rid == rid_b)
    sched.step()
    task = eng._task
    assert task is not None and task.next < task.plen   # genuinely mid-chunk
    if paged:
        assert eng.pages.pages_in_use() > 0 and eng._committed > 0
    orig_ids = list(next(s for s in eng.slots
                         if s is not None and s.rid == rid_b).prompt_ids)

    sched._bench(0, fault_reason="replica.crash")       # replica dies

    if paged:
        assert eng.pages.pages_in_use() == 0 and eng._committed == 0
    assert eng._task is None
    assert all(s is None for s in eng.slots)
    req = next(r for r in sched.pending if r.rid == rid_b)
    assert req.retries == 1 and req.last_fault == "replica.crash"
    assert req.deadline_at == deadline and req.t_submit == t_submit
    assert req.prompt_token_ids == orig_ids
    assert len(sched.fault_events) == 2        # both in-flight lanes charged

    fins = {f.rid: f for f in sched.run(max_steps=200)}
    assert set(fins) == {1, rid_b} and fins[rid_b].retries == 1
    ref = fresh()
    ref.submit(orig_ids, max_new_tokens=6)
    ref.run_to_completion()
    assert fins[rid_b].token_ids == ref.finished[0].token_ids
