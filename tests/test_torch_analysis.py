"""The port's static checks (``repro_torch.analysis``) against the
reference's (``repro.analysis``, ``tests/test_analysis.py``).

Layer 1 fixtures are inline source snippets: for each rule a positive (the
finding fires in a hot scope), a cold, a ``# noqa`` and an allowlisted
variant, then the lint of the tree itself, clean against its committed
baseline, and failing once a second device-to-host copy is planted in
``InferenceEngine.step``. Layer 2 runs the graph audit on CPU engines: each
check fires on an entry body with a planted fault and only there, the
audit of the four variants finds nothing, and its entry names are held
against the reference's committed inventory.
"""
from __future__ import annotations

import json
import shutil
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import config, frozen_entry_points, run_lint
from repro_torch.analysis import graph_audit as GA
from repro_torch.analysis.findings import (Finding, apply_baseline, load_baseline,
                                           save_baseline)
from repro_torch.analysis.sproutlint import lint_module

ROOT = Path(__file__).resolve().parents[1]
REF_INVENTORY = ROOT / "src" / "repro" / "analysis" / "entry_point_inventory.json"
HOT = {"*"}
# the reference's single-chip entry names the port does not build, and why
REF_ONLY = {
    "insert": "the port's prefill entry writes the slots' dense rows itself; "
              "the reference jits that write as a program of its own",
    "paged_insert": "the port's prefill entry writes the pages itself; the "
                    "reference jits that write as a program of its own",
}


def _lint(src, hot=frozenset(), deterministic=True, allowlist=None):
    return lint_module("fix.py", textwrap.dedent(src), set(hot), deterministic,
                       allowlist)


def _rules(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------- SPL001
SYNCS = [
    "a = x.item()",
    "a = x.tolist()",
    "a = x.cpu()",
    "a = x.numpy()",
    'a = x.to("cpu")',
    'a = x.to(torch.device("cpu"))',
    'a = x.to(device="cpu")',
    "torch.cuda.synchronize()",
    "ev.synchronize()",
    "a = float(torch.isfinite(x).all())",
    "a = bool(t.any())",
    "a = int(t[0] + 1)",
    "a = bool(t > 0)",
    "a = np.asarray(t * 2)",
    "a = np.array(torch.zeros(3))",
]


@pytest.mark.parametrize("line", SYNCS)
def test_spl001_fires_in_a_hot_scope_only(line):
    src = f"""
        import numpy as np
        import torch
        def hot_fn(x, ev):
            t = torch.zeros(4)
            {line}
    """
    kept, _ = _lint(src, hot=HOT)
    assert _rules(kept) == ["SPL001"] and kept[0].scope == "hot_fn", kept
    assert _lint(src) == ([], [])                 # not reachable from a root


@pytest.mark.parametrize("line", [
    "a = float(share.sum())",            # a parameter: type unknown
    "a = int(lengths[:2].sum())",
    "a = int(t.shape[0]) + t.numel() + int(t.size(0))",   # metadata
    "a = int(np.searchsorted(share, 3))",
    "a = bool(t is None)",
])
def test_spl001_host_values_stay_clean(line):
    src = f"""
        import numpy as np
        import torch
        def hot_fn(share, lengths):
            t = torch.zeros(4)
            {line}
    """
    assert _lint(src, hot=HOT) == ([], [])


def test_spl001_a_wrapped_sync_counts_once():
    src = """
        import numpy as np
        def hot_fn(x):
            a = x.cpu().numpy()
            b = int(x.item())
            c = np.asarray(x.cpu())
            return a, b, c
    """
    kept, _ = _lint(src, hot=HOT)
    assert [f.line for f in kept] == [4, 5, 6]


def test_spl001_noqa_suppresses():
    src = """
        def hot_fn(key):
            a = key.numpy()  # noqa: SPL001 — a host key
            b = key.numpy()  # noqa: SPL003 — another rule's code
            return a, b
    """
    kept, _ = _lint(src, hot=HOT)
    assert [f.line for f in kept] == [4]


def test_spl001_allowlist_budget_is_a_count():
    two = """
        class InferenceEngine:
            def step(self, out):
                block = out.cpu().numpy()
                again = out.cpu()
                return block, again
    """
    allow = {("fix.py", "InferenceEngine.step", "SPL001"): 1}
    kept, allowed = _lint(two, hot={"InferenceEngine.step"}, allowlist=allow)
    # budget of one: the first copy is sanctioned, the second still fires
    assert [f.line for f in allowed] == [4] and _rules(kept) == ["SPL001"]
    assert "exceeds allowlist budget" in kept[0].message


# ---------------------------------------------------------------- SPL003
def test_spl003_bare_hash():
    kept, _ = _lint("seed = hash(('a', 1))\n")
    assert _rules(kept) == ["SPL003"]


def test_spl003_set_iteration_and_sorted_exemption():
    src = """
        def f(xs):
            lanes = set(xs)
            for i in lanes:
                print(i)
            return sorted(lanes)
    """
    kept, _ = _lint(src)
    assert _rules(kept) == ["SPL003"]
    src_ok = """
        import numpy as np
        def f(xs):
            lanes = set(xs)
            rows = np.sort(np.fromiter(lanes, np.int64))
            return [i for i in sorted(lanes)], rows
    """
    assert _lint(src_ok) == ([], [])


def test_spl003_wall_clock_and_random_only_in_deterministic_paths():
    src = """
        import random
        import time
        def f():
            return time.time(), random.random()
    """
    kept, _ = _lint(src, deterministic=True)
    assert _rules(kept) == ["SPL003", "SPL003"]
    assert _lint(src, deterministic=False) == ([], [])


# ---------------------------------------------------------------- SPL004
@pytest.mark.parametrize("src", [
    """
    import torch
    def f(fn, x):
        return torch.compile(fn)(x)
    """,
    """
    import torch
    def f(fns):
        out = []
        for g in fns:
            out.append(torch.compile(g))
        return out
    """,
    """
    import torch
    def f(graphs, fn):
        for g in graphs:
            with torch.cuda.graph(g):
                fn()
    """,
    """
    def f(self, rows, fn):
        self.entry_points[f"decode_bs{len(rows)}"] = fn
    """,
])
def test_spl004_fires(src):
    kept, _ = _lint(src)
    assert kept and set(_rules(kept)) == {"SPL004"}


def test_spl004_bound_once_and_bucketed_key_are_clean():
    src = """
        import torch
        def f(self, bs, fn, graph):
            cf = torch.compile(fn)
            with torch.cuda.graph(graph):
                cf()
            self.entry_points[f"decode_bs{bs}"] = cf
            return self.entry_points.setdefault(f"decode_bs{bs}", cf)
    """
    assert _lint(src) == ([], [])


# ------------------------------------------------------- baseline format
def test_baseline_round_trip_and_staleness(tmp_path):
    f1 = Finding("SPL003", "a.py", "f", 3, "seed = hash(x)", "m")
    f2 = Finding("SPL001", "b.py", "g", 9, "out.cpu()", "m")
    p = tmp_path / "baseline.json"
    save_baseline(p, [f1, f2])
    keys = load_baseline(p)
    assert len(keys) == 2
    new, baselined, stale = apply_baseline([f1, f2], keys)
    assert new == [] and len(baselined) == 2 and stale == []
    # f2 got fixed but its entry remains: stale, which fails the lint
    new, baselined, stale = apply_baseline([f1], keys)
    assert new == [] and stale == [f2.key]
    # line-number churn does not invalidate an entry (keyed on snippet)
    moved = Finding("SPL003", "a.py", "f", 31, "seed = hash(x)", "m")
    assert apply_baseline([moved, f2], keys)[0::2] == ([], [])


# ---------------------------------------------------------- the tree
def test_lint_of_the_tree_is_clean():
    """Against the committed (empty) baseline: no new finding, no stale
    entry, exactly the two budgeted copies allowed."""
    res = run_lint(ROOT)
    assert res.rc == 0 and res.new == [] and res.stale == [], res.render()
    assert sorted(f.scope for f in res.allowed) == [
        "InferenceEngine._prefill_group", "InferenceEngine.step"]
    assert json.loads((ROOT / "src/repro_torch/analysis/baseline.json").read_text()) \
        == {"findings": []}
    assert {scope for _, scope, _ in config.ALLOWLIST} == {
        "InferenceEngine.step", "InferenceEngine._prefill_group"}
    assert set(config.ALLOWLIST.values()) == {1}


def test_a_second_copy_in_step_fails_the_lint(tmp_path):
    port = tmp_path / "src" / "repro_torch"
    shutil.copytree(ROOT / "src" / "repro_torch", port,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    engine = port / "serving" / "engine.py"
    src = engine.read_text()
    anchor = "        block = out.cpu().numpy()\n"
    assert src.count(anchor) == 1
    engine.write_text(src.replace(anchor, anchor + "        again = out.cpu()\n"))
    res = run_lint(tmp_path)
    assert res.rc == 1
    assert [(f.scope, "exceeds allowlist budget" in f.message) for f in res.new] == [
        ("InferenceEngine.step", True)]


# ------------------------------------------------------------- audit
@pytest.fixture(scope="module")
def report():
    return GA.run_audit(device="cpu")


@pytest.fixture(scope="module")
def engine():
    """One driven paged fp32 engine, its entries built."""
    eng = GA._build_engine(True, False, "cpu")
    GA._drive(eng)
    return eng


def test_run_audit_on_the_cpu_finds_nothing(report):
    assert report.rc == 0, report.render()
    assert sorted(report.audited) == [v for v, *_ in sorted(GA.VARIANTS)]
    assert all(len(names) == 9 for names in report.audited.values())


def test_port_entries_match_the_reference_inventory(report):
    """The port builds the reference's entries under the reference's names
    (the reference's own committed inventory, not a run of its audit),
    but for the reference's separate store-write programs."""
    ref = json.loads(REF_INVENTORY.read_text())
    for variant in report.audited:
        want = set(ref[variant]) - set(REF_ONLY)
        assert set(report.audited[variant]) == want, variant
        assert set(ref[variant]) - want <= set(REF_ONLY)


def _store_write(eng, index):
    """Write 0 into layer 0's K at page ``index`` (an index_put on the store)."""
    eng.cache[0]["k"][0][torch.tensor([index])] = 0.0


PLANTS = {
    "f64": lambda eng, out: out.double(),
    "host_read": lambda eng, out: (out.sum().item(), out)[1],
    "bounds": lambda eng, out: (_store_write(eng, -1), out)[1],
    "in_place": lambda eng, out: (eng.cache[0]["k"].clone(), out)[1],
}


@pytest.mark.parametrize("name", ["decode_bs4_k8_full", "mixed_bs4_k4_c4_temp",
                                  "prefill_bs4_p16"])
@pytest.mark.parametrize("check", list(PLANTS))
def test_each_check_fires_on_its_planted_fault_only(engine, monkeypatch, check, name):
    entry = engine.entry_points[name]
    before = [x.clone() for x in GA.store_leaves(engine)]
    staged = entry.stage.clone()
    assert GA.audit_entry(engine, entry) == []
    orig = entry.fn
    monkeypatch.setattr(entry, "fn", lambda **kw: PLANTS[check](engine, orig(**kw)))
    issues = GA.audit_entry(engine, entry)
    # on the dead inputs and on the live staging, and nothing else fires
    assert {i.check for i in issues} == {check}, [i.render() for i in issues]
    assert {i.detail.split(":")[0] for i in issues} == {"dead", "live"}
    # the audit leaves the store and the staging as it found them
    assert all(torch.equal(x, b) for x, b in zip(GA.store_leaves(engine), before))
    assert torch.equal(entry.stage, staged)


def test_an_in_bounds_store_write_is_clean(engine, monkeypatch):
    """The trash page (index n_pages) is in bounds: only a wrapped index is
    a fault."""
    entry = engine.entry_points["decode_bs4_k8_full"]
    orig = entry.fn
    trash = engine.pages.n_pages
    monkeypatch.setattr(entry, "fn",
                        lambda **kw: (_store_write(engine, trash), orig(**kw))[1])
    assert GA.audit_entry(engine, entry) == []


def test_inventory_drift_detection(tmp_path):
    audited = {"dense_fp32": ["decode_bs4_k8_full", "prefill_bs4_p16"]}
    assert GA.check_inventory(audited, audited) == []
    assert GA.check_inventory(audited, None)      # no committed file: fails
    drifted = {"dense_fp32": ["decode_bs4_k8_full", "decode_bs2_k8_temp"]}
    issues = GA.check_inventory(drifted, audited)
    assert sorted((i.entry, i.check) for i in issues) == [
        ("decode_bs2_k8_temp", "inventory"), ("prefill_bs4_p16", "inventory")]
    p = tmp_path / "inv.json"
    GA.save_inventory(p, audited)
    assert GA.load_inventory(p) == audited


def test_frozen_entry_points_guard():
    eng = GA._build_engine(True, False, "cpu")
    with frozen_entry_points(eng) as names:
        eng.step()                                 # idle: builds nothing
    assert names == () and eng.entry_points == {}
    with pytest.raises(AssertionError, match=r"measured window: added=\['decode_bs2_k1"):
        with frozen_entry_points(eng, "measured window"):
            eng.submit(eng.tok.encode("india"), max_new_tokens=2)
            eng.submit(eng.tok.encode("juliet"), max_new_tokens=2)
            eng.run_to_completion()
    assert len(eng.finished) == 2
