"""The dense layout's entry points (``paged=False``, the reference's
default engine) on the CPU: the dead inputs that warm-up and capture run
on write only the sink row, and a bucket's pad row writes only there too,
while the tokens stay the reference's (the paged cases are in
``test_torch_entry_points.py``, as is the dense entries' no-host-sync
check)."""
import numpy as np
import pytest
import torch

from repro.serving import InferenceEngine as JEngine
from repro_torch.serving.engine import InferenceEngine
from test_torch_entry_points import (KINDS, _drive, _entry, _leaves,
                                     _populated_dense, _restore, _snapshot,
                                     _unchanged_but_trash, models)  # noqa: F401


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
def test_dense_capture_inputs_write_only_the_sink_row(models, kind, kv_int8):  # noqa: F811
    """On a dense engine the dead inputs (every lane dead with slot id
    n_slots, chunk length 0, prefill rows aimed at slot n_slots) write only
    the sink row, which no slot owns: every slot row, ``kpos`` included,
    is as it was."""
    eng = _populated_dense(models, kv_int8)
    entry = _entry(eng, kind)
    assert ("slots" if kind == "prefill" else "rows") in entry.dead
    assert "bt" not in entry.dead and "page_ids" not in entry.dead
    snap = _snapshot(eng.cache)
    entry.stage_dead()
    out = entry.run()
    assert _unchanged_but_trash(eng.cache, snap)
    if kind != "prefill":
        assert not out[4:9].any()              # nothing emitted, nothing live
        assert out[9].all()                    # dead lanes leave the verdict


def test_dense_pad_row_writes_only_the_sink_row(models):  # noqa: F811
    """Three live lanes on eight dense slots: the bucket has four rows, one
    of them padding (slot id 8, the sink row). Tokens match the reference;
    the padded block leaves every slot row as the same block over the three
    rows alone leaves it, and the pad row emits nothing."""
    jcfg, cfg, jp, params = models
    kw = dict(n_slots=8, max_len=64, decode_block=4)
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
    assert list(inputs["rows"]) == [0, 1, 2, 8] and inputs["max_new"][3] == 1
    _restore(port.cache, snap)
    padded = fused_for(k, "greedy", 4, 0)[0](**inputs).numpy()
    after_padded = _snapshot(port.cache)
    _restore(port.cache, snap)
    bare = fused_for(k, "greedy", 3, 0)[0](
        **{n: v[:3] for n, v in inputs.items()}).numpy()
    np.testing.assert_array_equal(padded[:, :3], bare)
    assert not padded[k:2 * k + 1, 3].any()   # nothing emitted, dead after
    assert padded[2 * k + 1].all()            # and every verdict finite
    for x, want in zip(_leaves(port.cache), after_padded):
        assert torch.equal(want[:, :-1], x[:, :-1])
