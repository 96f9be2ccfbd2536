"""Sprout's paired chaos scenario on the port (``repro_torch.serving.chaos``)
against the reference's (``repro.serving.chaos``), on the same weights (the
reference's ``build_model`` tree and its ``params_from_jax`` copy): the
fault-free control and the armed run give the same report, key for key
(served tokens, retries, carbon, shed, plan holds, watchdog counters, the
injected events), the same ``digest``, and all twelve ``check_pair``
invariants hold. The scenario serves dense engines, the reference's
default, and its ``decode.nonfinite`` faults go through the port's lane
poison, in-block verdict and quarantine."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.serving import chaos as JC
from repro_torch.configs import reduced
from repro_torch.models import model as MD
from repro_torch.serving import chaos as C


@pytest.fixture(scope="module")
def reference():
    jcfg, jp = JC.build_model()
    return jp, JC.run_chaos(jcfg, jp)


def test_run_chaos_matches_reference(reference):
    jp, want = reference
    cfg = reduced("granite_3_2b").replace(vocab_size=512)
    params = MD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    got = C.run_chaos(cfg, params)
    for side in ("control", "chaos"):
        for key in want[side]:
            assert got[side][key] == want[side][key], (side, key)
    assert got == want
    assert len(got["checks"]) == 12 and all(got["checks"].values()), got["checks"]
    assert got["ok"] and len(got["digest"]) == 64
    chaos = got["chaos"]
    assert {e[0] for e in chaos["injected"]} == set(C.POINTS)
    assert sum(e[0] == "decode.nonfinite" for e in chaos["injected"]) == 2
    assert chaos["faults"] >= 3 and chaos["shed"] >= 1


def test_chaos_main_runs_on_the_cpu(monkeypatch, capsys):
    """``python -m repro_torch.serving.chaos --device cpu``: the port's own
    seed-0 weights, every invariant holds, exit code 0."""
    monkeypatch.setattr("sys.argv", ["chaos", "--device", "cpu"])
    assert C.main() == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and all(out["checks"].values())
    assert set(out["chaos"]) == {"served", "faults", "shed", "plan_holds"}


def test_chaos_asks_for_the_card(monkeypatch):
    """The scenario's device defaults to the card, and without one it
    raises instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        C.run_chaos()
