"""The port's serving CLI (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``): ``run_gateway`` of both, given the same
arguments and the same weights (the reference's params and their
``params_from_jax`` copy), prints the same lines. Flags the port cannot
serve yet raise ``NotImplementedError`` naming their ROADMAP.md item, and
nothing falls back from the card to the CPU."""
import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import reduced as jreduced
from repro.models import model as JMD
from repro_torch.configs import reduced
from repro_torch.launch import serve
from repro_torch.models import model as MD
from repro_torch.serving import SproutGateway

BASE = ["--device", "cpu", "--gateway", "--paged", "--hours", "2",
        "--requests", "4", "--replicas", "2"]


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced("granite_3_2b").replace(vocab_size=512)
    cfg = reduced("granite_3_2b").replace(vocab_size=512)
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    params = MD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, params


@pytest.mark.parametrize("extra", [[], ["--tenants", "--migrate",
                                        "--drain-at", "1"]],
                         ids=["plain", "tenants-migrate-drain"])
def test_run_gateway_prints_the_reference_lines(weights, extra, capsys):
    jcfg, jp, cfg, params = weights
    args = serve.parse_args(BASE + extra)
    jserve.run_gateway(args, jcfg, jp)
    want = capsys.readouterr().out.splitlines()
    gw = serve.run_gateway(args, cfg, params)
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert isinstance(gw, SproutGateway)
    assert [ln.split(":")[0] for ln in got if ln.startswith("hour ")] == \
        ["hour 0", "hour 1"]
    assert ", 0 rejected," in next(ln for ln in got if ln.startswith("total"))
    assert gw.stats.requests == 8 and gw.stats.rejected == 0
    for pool in gw.pools:
        # two replicas a pool: the straggler detector, which reads wall
        # time, never had 20 samples on both
        assert sum(len(t) >= 20
                   for t in pool.scheduler._step_times.values()) < 2
    if extra:
        assert any("draining" in ln for ln in got)
        assert gw.stats.migrated > 0


@pytest.mark.parametrize("argv, item", [
    (["--gateway", "--paged", "--chaos"], "item 8"),
    (["--gateway", "--paged", "--tp-degree", "2"], "item 10"),
    (["--paged", "--prefix-cache"], "item 5"),
    (["--gateway"], "item 9"),
    (["--paged", "--arch", "llama2_13b"], "item 3"),
    (["--paged", "--arch", "deepseek_v2_lite"], "item 11"),
], ids=["chaos", "tp-degree", "prefix-cache", "dense", "llama2", "other"])
def test_unported_flags_raise_naming_their_item(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        serve.parse_args(["--device", "cpu"] + argv)


def test_card_is_asked_for_and_never_replaced(monkeypatch):
    """The default device is the card; without one the launcher raises
    before it builds anything, instead of serving on the CPU."""
    assert serve.parse_args(["--paged"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--gateway", "--paged"])


@pytest.mark.parametrize("argv", [
    ["--gateway", "--regions", "CA", "--hours", "1", "--requests", "3",
     "--replicas", "1", "--kv-int8", "--prefill-chunk", "8"],
    ["--hours", "2", "--requests", "3", "--replicas", "1"],
], ids=["gateway-int8-chunked", "scheduler"])
def test_main_serves_on_the_cpu(argv, capsys):
    serve.main(["--device", "cpu", "--paged"] + argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("hour 0:")
    assert not any(ln.startswith("rejected") for ln in out)
    if "--gateway" in argv:
        assert ", 0 rejected," in next(ln for ln in out
                                       if ln.startswith("total"))
    else:
        assert out[-1].endswith("across 6 requests")
