"""The port's dense model against the JAX package's on the same weights:
weight conversion, prefill logits, teacher-forced paged decode logits at
fp32 and int8 KV, and the dead-lane write hazard."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jreduced
from repro.models import model as JMD
from repro_torch.configs import reduced
from repro_torch.models import model as MD

# fp32 on both sides; the frameworks sum matmuls and softmaxes in another
# order, which moves the O(1)-scale logits by a few 1e-6 (int8 KV too: the
# port quantizes to the reference's codes)
ATOL = 1e-4
PAGE = 16


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced("granite_3_2b").replace(vocab_size=512)
    cfg = reduced("granite_3_2b").replace(vocab_size=512)
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    return jcfg, cfg, jp, tree, MD.params_from_jax(tree, device="cpu")


def test_params_from_jax_round_trips_every_leaf(models):
    _, _, _, tree, params = models
    jl, jdef = jax.tree_util.tree_flatten(tree)
    tl, tdef = jax.tree_util.tree_flatten(params)
    assert jdef == tdef
    assert len(jl) == len(tl) > 0
    for a, b in zip(jl, tl):
        assert b.device.type == "cpu" and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.numpy(), a)


def test_prefill_logits_match(models):
    jcfg, cfg, jp, _, params = models
    toks = np.random.default_rng(0).integers(0, 512, (2, 21), dtype=np.int64)
    want, _, _ = JMD.forward(jcfg, jp, jnp.asarray(toks, jnp.int32),
                             mode="prefill", max_len=32)
    got = MD.forward(cfg, params, torch.from_numpy(toks), mode="prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_teacher_forced_paged_decode_logits(models, kv_int8):
    """Three rows decode a fixed token sequence one step at a time through
    their own block tables; logits agree at every step."""
    jcfg, cfg, jp, _, params = models
    if kv_int8:
        jcfg = jcfg.replace(kv_cache_dtype="int8")
        cfg = cfg.replace(kv_cache_dtype="int8")
    B, T, P = 3, 40, 12
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, (B, T), dtype=np.int64)
    bt = np.full((B, 4), -1, np.int32)
    bt[:, :3] = rng.permutation(P)[:9].reshape(B, 3)
    jcache = JMD.init_paged_cache(jcfg, P, PAGE)
    cache = MD.init_paged_cache(cfg, P, PAGE, device="cpu")
    jstep = jax.jit(lambda tok, pos, c: JMD.forward(
        jcfg, jp, tok, mode="decode", positions=pos, cache=c,
        block_table=jnp.asarray(bt), paged_impl="xla"))
    for t in range(T):
        pos = np.full(B, t, np.int64)
        want, jcache = jstep(jnp.asarray(toks[:, t:t + 1], jnp.int32),
                             jnp.asarray(pos, jnp.int32), jcache)
        got = MD.forward(cfg, params, torch.from_numpy(toks[:, t:t + 1]),
                         mode="decode", positions=torch.from_numpy(pos),
                         cache=cache, block_table=torch.from_numpy(bt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=f"step {t}")


@pytest.mark.parametrize("kv_int8", [False, True])
def test_dead_lane_write_leaves_live_pages_unchanged(models, kv_int8):
    """A dead lane whose block-table row maps pages another lane owns (a
    slot freed and re-allocated mid-block) writes to the trash page: every
    real page is bit-unchanged except the live lanes' own appends."""
    _, cfg, _, _, params = models
    if kv_int8:
        cfg = cfg.replace(kv_cache_dtype="int8")
    P = 6
    cache = MD.init_paged_cache(cfg, P, PAGE, device="cpu")
    g = torch.Generator().manual_seed(0)
    for seg in cache:
        for name, x in seg.items():
            x.copy_((torch.randn(x.shape, generator=g) * 50).to(x.dtype))
    before = [{k: v.clone() for k, v in seg.items()} for seg in cache]
    # lane 1 is dead, and its row maps page 0, which lane 0 owns
    bt = torch.tensor([[0, 1, -1], [0, 2, -1], [3, 4, -1]], dtype=torch.int32)
    pos = torch.tensor([20, 5, 3])
    live = torch.tensor([True, False, True])
    MD.forward(cfg, params, torch.tensor([[7], [8], [9]]), mode="decode",
               positions=pos, cache=cache, block_table=bt, live=live)
    written = {(1, 20 % PAGE), (3, 3)}          # (page, offset) of live lanes
    for seg, old in zip(cache, before):
        for name, x in seg.items():
            for pg in range(P):
                for off in range(PAGE):
                    same = torch.equal(x[:, pg, off], old[name][:, pg, off])
                    assert same != ((pg, off) in written), (name, pg, off)
