"""The radix prefix cache in the port (``PageAllocator(prefix_cache=True)``
and the engine's prefix-aware admission), held against the JAX package on
the same weights (the reference's ``init_model`` tree, converted with
``params_from_jax``) and the same traffic:

- the allocator after every op of seeded op sequences: block table,
  lengths, refcounts, owners, pinned count, the cached LRU, the free heap,
  the index and ``report()``;
- the engine and gateway scenarios of ``tests/test_prefix_cache.py``, on a
  port engine and a reference engine, fp32 and int8 KV: tokens,
  ``cached_tokens``, block tables, counters and the allocator at the end;
  in fp32 every chunk pass the port ran is replayed through the
  reference's ``prefill_chunk_step`` from the port's page store, logits
  within 1e-4; every copy-on-write copies its page bit for bit;
- ``SproutGateway`` over prefix-cache engines on the Sprout workload, whose
  directive system prompts are shared page for page: per-request
  ``cached_tokens``, decisions, carbon and the ledger.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.policies as jpolicies
import repro.serving as jserving
from repro.configs import reduced as jreduced
from repro.models import model as JMD
from repro.serving.engine import FinishedRequest as JFinished
from repro.serving.kv_cache import PageAllocator as JAllocator
import repro_torch.core as tcore
import repro_torch.core.policies as tpolicies
import repro_torch.serving as tserving
from repro_torch.configs import reduced
from repro_torch.models import model as MD
from repro_torch.serving.engine import FinishedRequest
from repro_torch.serving.kv_cache import PageAllocator

ATOL = 1e-4            # fp32 logits, as in test_torch_model.py
REL = 1e-12            # the gateway's carbon ledger, as in test_torch_gateway.py


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced("granite_3_2b").replace(vocab_size=512)
    cfg = reduced("granite_3_2b").replace(vocab_size=512)
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    params = MD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, params


# ======================================================================
# (a) the allocator, op by op
# ======================================================================

def _alloc_state(al):
    return {
        "block_table": al.block_table.tolist(), "lengths": al.lengths.tolist(),
        "slot_pages": al._slot_pages.tolist(), "refcount": al.refcount.tolist(),
        "owner": al._owner.tolist(), "pinned": al.pinned,
        "cached": list(al._cached), "free": list(al._free),
        "index": [(h.hex(), pid) for h, pid in al._index.items()],
        "page_hash": sorted((pid, h.hex()) for pid, h in al._page_hash.items()),
        "report": al.report(),
    }


def _call(fn, *a):
    """(outcome, value): an op's return value or the error it raised."""
    try:
        out = fn(*a)
    except MemoryError as e:
        return "raised", str(e)
    return "ok", out.tolist() if isinstance(out, np.ndarray) else out


# three system prompts of 20-28 tokens, so requests share one to three
# 8-token pages, and some prompts are page-aligned
SYSTEMS = [list(range(1, 25)), list(range(100, 120)), list(range(1, 17)) + [9] * 12]


@pytest.mark.parametrize("seed, prefix_cache, salt", [
    (0, True, ""), (1, True, ""), (2, True, "int8"), (3, True, ""),
    (4, True, "int8"), (5, True, ""), (6, False, ""), (7, False, "int8")])
def test_allocator_matches_reference_after_every_op(seed, prefix_cache, salt):
    """Seeded sequences of ``ensure_capacity``, ``match_prefix``, ``adopt``,
    ``register_prefix``, ``prepare_append``, ``release``,
    ``invalidate_slot`` and ``exclusive_pages`` on both allocators, under
    page pressure (12 pages for 4 slots), so cached pages are evicted. Each
    op returns (or raises) the same, and the state is identical after it."""
    rng = np.random.default_rng(seed)
    kw = dict(n_pages=12, page_size=8, n_slots=4, max_len=64,
              prefix_cache=prefix_cache, kv_salt=salt)
    ref, port = JAllocator(**kw), PageAllocator(**kw)
    prompts = {}
    ops = {"admit": 0, "adopt": 0, "cow": 0, "raised": 0}

    def both(name, *a):
        """The op on both allocators: (outcome, value), equal on both."""
        want, got = _call(getattr(ref, name), *a), _call(getattr(port, name), *a)
        assert got == want, (name, a)
        assert _alloc_state(port) == _alloc_state(ref), (name, a)
        ops["raised"] += want[0] == "raised"
        return want

    for _ in range(300):
        slot = int(rng.integers(4))
        mapped = int(ref._slot_pages[slot]) > 0
        op = rng.choice(["admit", "grow", "register", "release", "invalidate",
                         "exclusive", "match"],
                        p=[0.3, 0.2, 0.05, 0.2, 0.08, 0.07, 0.1])
        if op == "admit" and not mapped:
            ids = SYSTEMS[rng.integers(3)] + list(
                rng.integers(200, 260, rng.integers(0, 12)))
            m, pids, _ = both("match_prefix", ids)[1]
            if m and rng.random() < 0.8:
                both("adopt", slot, pids)
                cached = min(m * 8, len(ids) - 1)
                ref.lengths[slot] = port.lengths[slot] = cached
                ops["adopt"] += 1
                # the engine's copy-on-write gate for the first computed token
                ops["cow"] += both("prepare_append", slot, cached)[1] is not None
            if both("ensure_capacity", slot, len(ids))[0] == "raised":
                both("release", slot)
                continue
            ref.lengths[slot] = port.lengths[slot] = len(ids)
            both("register_prefix", slot, ids)
            prompts[slot] = ids
            ops["admit"] += 1
        elif op == "grow" and mapped:
            pos = int(ref.lengths[slot])
            # mostly the append position; sometimes a write into an earlier
            # (maybe shared) page, which copies it or drops its key
            at = pos if rng.random() < 0.7 else int(rng.integers(0, pos + 1))
            ops["cow"] += both("prepare_append", slot, at)[1] is not None
            n = int(rng.integers(1, 12))
            if both("ensure_capacity", slot, min(pos + n, 63))[0] == "ok":
                ref.lengths[slot] = port.lengths[slot] = min(pos + n, 63)
        elif op == "register" and mapped:
            both("register_prefix", slot, prompts[slot])
        elif op == "release":
            both("release", slot)
        elif op == "invalidate":
            both("invalidate_slot", slot)
        elif op == "exclusive":
            both("exclusive_pages", slot)
        elif op == "match":
            both("match_prefix", SYSTEMS[rng.integers(3)])
    assert ops["admit"] > 10 and ops["raised"] > 0
    if prefix_cache:
        assert ops["adopt"] > 0 and ops["cow"] > 0 and ref.cache_evictions > 0
        assert ref.pages_adopted == port.pages_adopted > 0
    else:
        assert ops["adopt"] == 0 and port.report() == ref.report()


# ======================================================================
# (b, c) the engine scenarios of tests/test_prefix_cache.py
# ======================================================================

SHARED = "system: answer briefly and cite sources. "   # 41 tokens, 2 pages
DUP_REQS = [(SHARED + "q1", 12), (SHARED + "second?", 12),
            (SHARED + "x", 8), ("unrelated prompt", 8), (SHARED + "y", 8)]


class Side:
    """One package's engine, tokenizer and gateway, at one KV dtype. Every
    engine built is recorded with the block table of each request at its
    finish."""

    def __init__(self, make_engine, serving, core, policies, finished_cls, kv_int8):
        self._make, self.serving, self.core = make_engine, serving, core
        self.policies = policies
        self.Finished, self.kv_int8 = finished_cls, kv_int8
        self.tok = serving.ByteTokenizer()
        self.engines = []

    def engine(self, **kw):
        kw = {"n_slots": 2, "max_len": 64, "paged": True, "page_size": 16,
              "eos_id": -1, "kv_int8": self.kv_int8, **kw}
        eng = self._make(**kw)
        eng.tables = {}
        finish = eng._finish

        def wrapped(slot):
            eng.tables[eng.slots[slot].rid] = eng.pages.block_table[slot].tolist()
            finish(slot)

        eng._finish = wrapped
        self.engines.append(eng)
        return eng

    def run(self, reqs, **kw):
        eng = self.engine(**kw)
        for prompt, mnt in reqs:
            eng.submit(self.tok.encode(prompt), max_new_tokens=mnt)
        return eng, eng.run_to_completion()


COUNTERS = ("steps", "decode_syncs", "peak_concurrent", "peak_pages_in_use",
            "prefill_tokens_computed", "prefill_tokens_cached", "chunk_steps",
            "pages_grown_chunked", "_committed")


def _engine_state(eng):
    return {
        "finished": [(f.rid, f.token_ids, f.cached_tokens, f.prompt_tokens,
                      f.gen_tokens) for f in eng.finished],
        "tables": eng.tables,
        "counters": {c: getattr(eng, c) for c in COUNTERS},
        "allocator": _alloc_state(eng.pages), "kv_stats": eng.kv_stats(),
    }


def on_vs_off(S):
    """Prefix on and off emit the same tokens on duplicate traffic; the
    on engine skips the shared span of the duplicates admitted after it
    was registered."""
    e0, f0 = S.run(DUP_REQS)
    e1, f1 = S.run(DUP_REQS, prefix_cache=True)
    assert [f.token_ids for f in f0] == [f.token_ids for f in f1]
    assert e1.prefill_tokens_cached >= 2 * 32
    assert e1.prefill_tokens_computed < e0.prefill_tokens_computed
    assert sum(f.cached_tokens for f in f1) == e1.prefill_tokens_cached
    assert all(f.cached_tokens == 0 for f in f0)
    assert e1._committed == 0 and e1.pages.pinned == 0
    assert e1.pages.pages_in_use() == e1.pages.cached_pages() > 0
    return {}


def full_hit_adopts(S):
    """A hit maps the registered pages into the new slot's table; its
    prefill starts past them."""
    eng = S.engine(prefix_cache=True)
    ids = S.tok.encode(SHARED)
    eng.submit(ids, max_new_tokens=4)
    eng.run_to_completion()
    shared = sorted(eng.pages._cached)
    assert len(shared) == 2
    eng.submit(ids + S.tok.encode("tail"), max_new_tokens=4)
    eng._try_prefill()                         # hit admission, no dispatch
    slot = eng._task.slot
    seen = {"table": eng.pages.block_table[slot].tolist(), "next": eng._task.next,
            "cached": eng.slots[slot].cached_tokens, "chunk": eng._task.chunk}
    assert seen["table"][:2] == shared and seen["next"] == 32 == seen["cached"]
    eng.run_to_completion()
    assert eng.pages.pages_adopted == 2 and eng._committed == 0
    return seen


def page_aligned_cow(S):
    """A fully cached page-aligned prompt recomputes its last token into
    the last shared page: the one copy-on-write, 31 tokens cached, and the
    cold run's tokens."""
    _, f0 = S.run([("p" * 32, 8)])
    eng = S.engine(prefix_cache=True)
    for _ in range(2):                         # the second sees the first's pages
        eng.submit(S.tok.encode("p" * 32), max_new_tokens=8)
        eng.run_to_completion()
    f1 = eng.finished
    assert [f.token_ids for f in f1] == [f0[0].token_ids] * 2
    assert eng.pages.cow_copies == 1 and f1[1].cached_tokens == 31
    return {}


def budget_admits_duplicates(S):
    """With 5 pages, two requests sharing a 2-page prefix run at once only
    with the cache (3 + 2 pages against 3 + 4)."""
    a = S.tok.encode(SHARED[:32])
    b = a + S.tok.encode("extra suffix")
    peaks = []
    for on in (False, True):
        eng = S.engine(n_pages=5, prefix_cache=on)
        eng.submit(a, max_new_tokens=16)
        eng.submit(b, max_new_tokens=12)
        fins = eng.run_to_completion()
        assert sorted(f.gen_tokens for f in fins) == [12, 16]
        assert eng._committed == 0
        peaks.append(eng.peak_concurrent)
    assert peaks == [1, 2]
    return {}


def evict_and_drain(S):
    """Evicting a hit-admitted request repays its charge and its holds; the
    engine still serves the cache after."""
    eng = S.engine(prefix_cache=True)
    eng.submit(S.tok.encode(SHARED), max_new_tokens=4)
    eng.run_to_completion()
    cached0 = eng.pages.cached_pages()
    rid = eng.submit(S.tok.encode(SHARED + "zz"), max_new_tokens=8)
    eng._try_prefill()
    assert eng._task is not None and eng._committed > 0
    st = eng.evict(rid)
    assert st.reserved_pages == 0 and st.cached_tokens == 0
    assert eng._committed == 0 and eng.pages.pinned == 0
    assert eng.pages.cached_pages() == cached0
    assert np.all(eng.pages.refcount <= 1)
    eng.submit(S.tok.encode(SHARED + "zz"), max_new_tokens=8)
    eng.run_to_completion()
    held = eng.submit(S.tok.encode(SHARED + "zz"), max_new_tokens=8)
    eng._try_prefill()
    drained = [(s.rid, s.cached_tokens, s.reserved_pages) for s in eng.drain_slots()]
    assert drained == [(held, 0, 0)]
    assert eng._committed == 0 and eng.pages.pinned == 0
    assert eng.prefill_tokens_cached >= 3 * 32
    return {"drained": drained}


def gateway_eq1_credit(S):
    """Eq. 1 charges only the computed prompt span: a finish with cached
    tokens costs less; through a gateway over a prefix-cache engine the
    duplicates carry their cached span into the telemetry."""
    prov = S.core.CarbonIntensityProvider("CA", "jun")
    eng = S.engine(prefix_cache=True)
    gw = S.serving.SproutGateway(
        [(prov, S.serving.CarbonAwareScheduler([eng]))],
        energy=S.core.EnergyModel(S.core.A100_40GB))
    pool = gw.pools[0]
    fin = dict(rid=1, token_ids=[1] * 8, text="", prompt_tokens=64,
               gen_tokens=8, ttft_s=0.1, latency_s=0.2, directive_level=0,
               decode_s=0.05)
    gw._account(pool, S.Finished(**fin))
    gw._account(pool, S.Finished(**fin, cached_tokens=48))
    t0, t1 = gw.stats.telemetry[-2:]
    assert t0.cached_tokens == 0 and t1.cached_tokens == 48
    assert t1.energy_kwh < t0.energy_kwh and t1.carbon_g < t0.carbon_g
    gw.tick(0.0)
    for i in range(3):
        gw.submit(S.serving.ServeRequest(0, SHARED + f"q{i}", max_new_tokens=6,
                                         directive_level=0, pre_rendered=True))
        gw.drain()
    tel = gw.stats.telemetry
    assert [r.cached_tokens for r in tel[2:]] == [0, 32, 32]
    return {"telemetry": [(r.rid, r.prompt_tokens, r.gen_tokens, r.cached_tokens)
                          for r in tel],
            "ledger": [(r.energy_kwh, r.carbon_g) for r in tel]
            + [(gw.stats.energy_kwh, gw.stats.carbon_g)]}


SCENARIOS = [on_vs_off, full_hit_adopts, page_aligned_cow,
             budget_admits_duplicates, evict_and_drain, gateway_eq1_credit]


def _sides(models, kv_int8):
    jcfg, cfg, jp, params = models
    return (Side(lambda **kw: jserving.InferenceEngine(jcfg, jp, **kw),
                 jserving, jcore, jpolicies, JFinished, kv_int8),
            Side(lambda **kw: tserving.InferenceEngine(cfg, params, device="cpu", **kw),
                 tserving, tcore, tpolicies, FinishedRequest, kv_int8))


class ChunkRecorder:
    """Records every chunk pass the port's engine runs with a prompt chunk
    in it: its inputs, the page store before it, and its logits."""

    def __init__(self, monkeypatch):
        self.calls = []
        step = MD.prefill_chunk_step

        def recorded(cfg, params, toks, pos0, clen, lane, cache, *, block_table):
            before = [{k: v.clone() for k, v in seg.items()} for seg in cache]
            out = step(cfg, params, toks, pos0, clen, lane, cache,
                       block_table=block_table)
            if int(clen) > 0:
                self.calls.append((toks.clone(), int(pos0), int(clen), int(lane),
                                   block_table.clone(), before, out.clone()))
            return out

        monkeypatch.setattr(MD, "prefill_chunk_step", recorded)

    def check_against_reference(self, jcfg, jp):
        """Each recorded pass, from the same page store (the trash page
        dropped), through the reference's ``prefill_chunk_step``: logits
        within ``ATOL``."""
        jstep = jax.jit(lambda toks, pos0, clen, lane, c, bt: JMD.prefill_chunk_step(
            jcfg, jp, toks, pos0, clen, lane, c, block_table=bt))
        for toks, pos0, clen, lane, bt, store, got in self.calls:
            jcache = [{k: jnp.asarray(v[:, :-1].numpy()) for k, v in seg.items()}
                      for seg in store]
            want, _ = jstep(jnp.asarray(toks.numpy(), jnp.int32), jnp.int32(pos0),
                            jnp.int32(clen), jnp.int32(lane), jcache,
                            jnp.asarray(bt.numpy(), jnp.int32))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=ATOL, err_msg=f"chunk at {pos0}")
        return len(self.calls)


def _check_copies_bitwise(eng, copies):
    """Wrap the port engine's ``_copy_page``: after each copy the page holds
    the source page's bytes, in every leaf (int8 codes and scales too)."""
    copy = eng._copy_page

    def checked(src, dst):
        copy(src, dst)
        for seg in eng.cache:
            for name, leaf in seg.items():
                assert torch.equal(leaf[:, dst].view(torch.uint8),
                                   leaf[:, src].view(torch.uint8)), name
        copies.append((src, dst))

    eng._copy_page = checked


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_engine_scenario_matches_reference(models, scenario, kv_int8, monkeypatch):
    ref, port = _sides(models, kv_int8)
    want = scenario(ref)
    recorder = ChunkRecorder(monkeypatch)
    copies = []
    make = port._make

    def make_checked(**kw):
        eng = make(**kw)
        _check_copies_bitwise(eng, copies)
        return eng

    port._make = make_checked
    got = scenario(port)
    assert got == want
    assert len(port.engines) == len(ref.engines)
    for e_ref, e_port in zip(ref.engines, port.engines):
        assert _engine_state(e_port) == _engine_state(e_ref)
    assert len(copies) == sum(e.pages.cow_copies for e in port.engines)
    assert sum(e.pages.pages_adopted for e in port.engines) > 0
    if not kv_int8:
        jcfg, _, jp, _ = models
        assert recorder.check_against_reference(jcfg, jp) > 0


def test_cow_page_matches_reference_store_bitwise(models):
    """int8 KV, the page-aligned full hit: the page the copy-on-write made
    holds, bit for bit, what the source page held when it was copied, and
    the reference's copy holds the same codes and scales as its source."""
    ref, port = _sides(models, True)
    seen = []
    for S in (ref, port):
        eng = S.engine(prefix_cache=True)
        for _ in range(2):
            eng.submit(S.tok.encode("p" * 32), max_new_tokens=8)
            eng.run_to_completion()
        assert eng.pages.cow_copies == 1
        # the copy and its source differ now only past the recomputed token
        src, dst = eng.tables[eng.finished[0].rid][1], eng.tables[eng.finished[1].rid][1]
        leaves = [(name, np.asarray(leaf)) for seg in eng.cache
                  for name, leaf in seg.items()]
        for name, x in leaves:
            np.testing.assert_array_equal(x[:, dst, :15], x[:, src, :15], err_msg=name)
        seen.append((src, dst))
    assert seen[0] == seen[1]


# ======================================================================
# (d) SproutGateway on the Sprout workload
# ======================================================================

def _plain(x):
    """``x`` with every array a list, so outcomes compare with ``==``."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x.tolist() if isinstance(x, np.ndarray) else x


def _sprout_gateway(S, hours=3, n=8):
    """The launcher's loop over two pools of prefix-cache engines: the LP
    draws directive levels, the scheduler renders each as the system
    prompt at the head of the request, so every L1 and L2 request of a
    pool starts with the same full pages."""
    carbon = S.core
    provs = [carbon.WatchdogProvider(carbon.CarbonIntensityProvider(r, "jun"))
             for r in ("CA", "TX")]
    pol = S.policies.SproutPolicy(
        k0_min=min(p.k_min for p in provs), k0_max=max(p.k_max for p in provs),
        xi=0.1, k1=carbon.A100_40GB.embodied_gco2 / carbon.A100_40GB.lifetime_s)
    engines = [S.engine(n_slots=2, max_len=160, prefix_cache=True) for _ in range(2)]
    gw = S.serving.SproutGateway(
        [(p, S.serving.CarbonAwareScheduler([e])) for p, e in zip(provs, engines)],
        policy=pol, energy=carbon.EnergyModel(carbon.A100_40GB), load_cap=3)
    wl, ev = carbon.Workload(seed=0), carbon.QualityEvaluator(sample_size=200)
    out = []
    for hour in range(hours):
        gw.set_quality(ev.evaluate([wl.sample_request(hour + i * 0.01)
                                    for i in range(300)]).q)
        reqs = [S.serving.serve_request_from(wl.sample_request(hour + i * 0.01),
                                             token_scale=320.0 / 24, max_new=24)
                for i in range(n)]
        s = gw.run_hour(float(hour), reqs)
        out.append({k: s[k] for k in ("t", "k0", "x", "routes", "served", "level_mix")})
    st = gw.stats
    assert st.requests == hours * n and st.rejected == 0
    exact = _plain({
        "hours": out,
        "telemetry": [(r.pool, r.rid, r.level, r.prompt_tokens, r.gen_tokens,
                       r.cached_tokens, r.k0) for r in st.telemetry],
        "plans": [(p.t, p.pool, p.x, p.solver) for p in st.plans],
        "engines": [_engine_state(e) for e in engines],
    })
    ledger = [x for r in st.telemetry for x in (r.energy_kwh, r.carbon_g)] + [
        st.energy_kwh, st.carbon_g, sum(st.carbon_by_pool.values())]
    return exact, ledger


def test_sprout_gateway_matches_reference(models):
    """Per-request cached spans (the directive prompts' shared pages),
    routes, mixes, plans, engine ledgers: identical; carbon within 1e-12
    relative; L1 and L2 requests hit their directive's pages."""
    sides = _sides(models, False)
    (want, want_ledger), (got, got_ledger) = (_sprout_gateway(S) for S in sides)
    assert got == want
    np.testing.assert_allclose(np.array(got_ledger), np.array(want_ledger),
                               rtol=REL, atol=0)
    # with the byte tokenizer the L2 head (BOS, its system prompt, the user
    # tag) is 80 tokens, 5 pages of 16; L1's 46 tokens fill 2
    hits = [(lvl, cached) for _, _, lvl, _, _, cached, _ in got["telemetry"]]
    assert any(c >= 80 for lvl, c in hits if lvl == 2)
    assert any(c >= 32 for lvl, c in hits if lvl == 1)
    assert sum(c for _, c in hits) == sum(
        e["counters"]["prefill_tokens_cached"] for e in got["engines"])
