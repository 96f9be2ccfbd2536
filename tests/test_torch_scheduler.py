"""The port's CarbonAwareScheduler over a port engine against the JAX
package's scheduler over a reference engine: the same seeded directive
draws render the same prompts, cap the same budgets and finish with the
same greedy tokens."""
import jax
import numpy as np
import pytest

from repro.configs import reduced as jreduced
from repro.models import model as JMD
from repro.serving import CarbonAwareScheduler as JScheduler
from repro.serving import InferenceEngine as JEngine
from repro.serving import ServeRequest as JServeRequest
from repro_torch.configs import reduced
from repro_torch.models import model as MD
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.scheduler import CarbonAwareScheduler, ServeRequest

PROMPTS = ["Summarize the grid's carbon intensity today.", "What is a TPU?",
           "Explain paged attention", "hi", "List three renewable sources.",
           "Why do brief answers save energy?", "Name a prime", "ok"]
BUDGETS = (24, 16, 8)      # max_new_tokens per directive level L0, L1, L2


def _serve(sched_cls, req_cls, engine):
    rng = np.random.default_rng(7)
    sched = sched_cls([engine], level_fn=lambda: int(rng.choice(3)))
    for p in PROMPTS:
        sched.submit(req_cls(0, p, max_new_by_level=BUDGETS))
    sched.run()
    assert not sched.rejected
    return ({f.rid: f.token_ids for f in sched.finished},
            {f.rid: f.directive_level for f in sched.finished})


@pytest.mark.parametrize("kv_int8", [False, True])
def test_scheduler_matches_reference(kv_int8):
    jcfg = jreduced("granite_3_2b").replace(vocab_size=512)
    cfg = reduced("granite_3_2b").replace(vocab_size=512)
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    params = MD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(n_slots=4, max_len=128, paged=True, page_size=16, n_pages=20,
              decode_block=4, kv_int8=kv_int8)
    want_toks, want_levels = _serve(JScheduler, JServeRequest,
                                    JEngine(jcfg, jp, **kw))
    got_toks, got_levels = _serve(CarbonAwareScheduler, ServeRequest,
                                  InferenceEngine(cfg, params, device="cpu", **kw))
    assert len(want_toks) == len(PROMPTS)
    assert set(want_levels.values()) == {0, 1, 2}
    assert got_levels == want_levels
    assert got_toks == want_toks
