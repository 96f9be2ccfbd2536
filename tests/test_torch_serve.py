"""The port's serving CLI (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``): ``run_gateway`` of both, given the same
arguments and the same weights (the reference's params and their
``params_from_jax`` copy), prints the same lines. Flags the port cannot
serve yet raise ``NotImplementedError`` naming their ROADMAP.md item, and
nothing falls back from the card to the CPU. ``--prefix-cache`` serves,
and without ``--paged`` raises; without ``--paged`` the CLI serves dense
engines, as the reference's does; ``--chaos`` prints the reference's
recovery line on both layouts."""
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
                                        "--drain-at", "1"], ["--prefix-cache"]],
                         ids=["plain", "tenants-migrate-drain", "prefix-cache"])
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
    if "--drain-at" in extra:
        assert any("draining" in ln for ln in got)
        assert gw.stats.migrated > 0
    engines = [e for pool in gw.pools for e in pool.scheduler.engines]
    assert all(e.prefix_cache == ("--prefix-cache" in extra) for e in engines)
    if "--prefix-cache" in extra:
        # the directive system prompts are served from shared pages
        assert sum(r.cached_tokens for r in gw.stats.telemetry) == sum(
            e.prefill_tokens_cached for e in engines) > 0


@pytest.mark.parametrize("argv, item", [
    (["--gateway", "--paged", "--tp-degree", "2"], "item 7"),
    (["--paged", "--arch", "command_r_plus_104b"], "item 10"),
    (["--paged", "--arch", "deepseek_v2_lite"], "item 10"),
    (["--paged", "--arch", "starcoder2_15b"], "item 10.*sliding window"),
], ids=["tp-degree", "layernorm", "other", "windowed-dense"])
def test_unported_flags_raise_naming_their_item(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        serve.parse_args(["--device", "cpu"] + argv)


@pytest.mark.parametrize("extra", [["--prefill-chunk", "8"]], ids=["dense-chunked"])
def test_run_gateway_without_paged_prints_the_reference_lines(weights, extra, capsys):
    """Without ``--paged`` both CLIs serve the dense layout (the reference's
    default), and print the same lines: the kv telemetry reports each
    pool's fixed dense footprint."""
    jcfg, jp, cfg, params = weights
    # one replica a pool: the dense engines' lines, at half the engines
    argv = [a for a in BASE if a != "--paged"]
    argv[argv.index("--replicas") + 1] = "1"
    args = serve.parse_args(argv + extra)
    assert not args.paged
    jserve.run_gateway(args, jcfg, jp)
    want = capsys.readouterr().out.splitlines()
    gw = serve.run_gateway(args, cfg, params)
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert gw.stats.requests == 8 and gw.stats.rejected == 0
    engines = [e for pool in gw.pools for e in pool.scheduler.engines]
    assert len(engines) == 2 and not any(e.paged for e in engines)
    assert all(e.kv_stats()["layout"] == "dense" for e in engines)
    assert all(e.chunked_admission == ("--prefill-chunk" in extra) for e in engines)


@pytest.mark.parametrize("layout", [["--paged"], []], ids=["paged", "dense"])
def test_chaos_prints_the_reference_lines(weights, layout, capsys):
    """``--chaos`` arms the reference's default fault script (with
    ``--migrate``, so every point can fire): both CLIs print the same
    lines, the ``chaos:`` line included, and every request is served."""
    jcfg, jp, cfg, params = weights
    argv = [a for a in BASE if a != "--paged"] + layout
    argv[argv.index("--hours") + 1] = "3"
    args = serve.parse_args(argv + ["--chaos", "--migrate"])
    jserve.run_gateway(args, jcfg, jp)
    want = capsys.readouterr().out.splitlines()
    gw = serve.run_gateway(args, cfg, params)
    got = capsys.readouterr().out.splitlines()
    assert got == want
    chaos = next(ln for ln in got if ln.startswith("chaos: injected["))
    assert "decode.nonfinite@" in chaos and "replica.crash@CA/0" in chaos
    assert gw.stats.faults >= 1 and gw.stats.requests == 12
    assert gw.stats.rejected == 0
    engines = [e for pool in gw.pools for e in pool.scheduler.engines if e is not None]
    assert all(e.paged == bool(layout) for e in engines)
    assert sum(p.load() for p in gw.pools) == 0


def test_prefix_cache_without_paged_raises():
    """The reference's ``--prefix-cache`` requires ``--paged`` (its engine
    drops the cache on a dense store); the port refuses the pair instead
    of dropping a flag."""
    with pytest.raises(ValueError, match=r"requires --paged"):
        serve.parse_args(["--device", "cpu", "--gateway", "--prefix-cache"])


def test_default_arch_is_the_papers_model():
    """As in the reference's launcher, ``--arch`` defaults to llama2_13b."""
    assert serve.parse_args(["--device", "cpu", "--paged"]).arch == "llama2_13b"


def test_run_gateway_serves_the_default_arch_like_the_reference(capsys):
    """With no ``--arch`` both packages serve reduced llama2-13b (vocab 512,
    untied embeddings) on the same weights, and print the same lines."""
    args = serve.parse_args(BASE)
    jcfg = jreduced(args.arch).replace(vocab_size=512)
    cfg = reduced(args.arch).replace(vocab_size=512)
    assert cfg.name == "llama2-13b" and not cfg.tie_embeddings
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    params = MD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert "unembed" in params["embed"]
    jserve.run_gateway(args, jcfg, jp)
    want = capsys.readouterr().out.splitlines()
    gw = serve.run_gateway(args, cfg, params)
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert gw.stats.requests == 8 and gw.stats.rejected == 0


@pytest.mark.parametrize("change", [
    dict(logit_softcap=30.0), dict(norm="layernorm"), dict(use_bias=True),
    dict(sliding_window=16)], ids=["softcap", "layernorm", "bias", "window"])
def test_model_still_refuses_what_the_port_does_not_compute(change):
    """Untied embeddings are served now; softcap, layernorm, biases and
    sliding windows still raise, naming the ROADMAP item."""
    cfg = reduced("llama2_13b").replace(vocab_size=512, **change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        MD.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")


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
    ["--gateway", "--hours", "2", "--requests", "4", "--replicas", "2",
     "--prefix-cache"],
], ids=["gateway-int8-chunked", "scheduler", "gateway-prefix-cache"])
def test_main_serves_on_the_cpu(argv, capsys):
    serve.main(["--device", "cpu", "--paged"] + argv)
    _check_main_lines(argv, capsys)


@pytest.mark.parametrize("argv", [
    ["--gateway", "--regions", "CA", "--hours", "1", "--requests", "3",
     "--replicas", "1", "--kv-int8", "--prefill-chunk", "8"],
    ["--hours", "2", "--requests", "3", "--replicas", "1"],
], ids=["gateway-int8-chunked", "scheduler"])
def test_main_serves_dense_on_the_cpu(argv, capsys):
    """``main`` without ``--paged``: dense engines, every request served."""
    serve.main(["--device", "cpu"] + argv)
    _check_main_lines(argv, capsys)


def _check_main_lines(argv, capsys):
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("hour 0:")
    assert not any(ln.startswith("rejected") for ln in out)
    if "--gateway" in argv:
        total = next(ln for ln in out if ln.startswith("total"))
        assert ", 0 rejected," in total
        assert "--prefix-cache" not in argv or " across 8 requests " in total
    else:
        assert out[-1].endswith("across 6 requests")
