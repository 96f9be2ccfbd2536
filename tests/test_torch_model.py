"""The port's dense model against the JAX package's on the same weights:
weight conversion, prefill logits, bf16 prefill attention against the
reference's full-config (blocked, fp32) arithmetic, teacher-forced paged
decode logits and chunked-prefill steps at fp32 and int8 KV, and the
dead-lane write hazard."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jreduced
from repro.models import attention as JA
from repro.models import model as JMD
from repro_torch.configs import reduced
from repro_torch.models import attention as A
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


def test_bf16_prefill_attention_matches_blocked_reference():
    """At bf16 the port's prefill attention computes what the reference's
    full config computes (``attn_impl="blocked"``: fp32 scores and fp32
    P·V, rounded once), not the xla path's bf16-rounded scores and
    probabilities. The two frameworks round the bf16 projections and sum
    in another order, so a few outputs may sit one bf16 ulp apart: at
    most one ulp of the output scale, on under 1 % of the outputs."""
    jcfg = jreduced("granite_3_2b").replace(dtype="bfloat16", attn_impl="blocked")
    cfg = reduced("granite_3_2b").replace(dtype="bfloat16", attn_impl="blocked")
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(3))
    jattn = jax.tree.map(lambda a: a[0], jp["segs"][0]["attn"])
    attn = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16)
            for k, v in jattn.items()}
    B, T = 2, 128
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, T, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    pos = np.broadcast_to(np.arange(T), (B, T))
    want, _ = JA.gqa_full(jcfg, jattn, jnp.asarray(x.float().numpy(), jnp.bfloat16),
                          jnp.asarray(pos, jnp.int32))
    got, _ = A.gqa_full(cfg, attn, x, torch.from_numpy(pos.copy()))
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    ulp = 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got - want).max() <= ulp
    assert (got != want).mean() < 0.01


@pytest.mark.parametrize("dtype,attn_impl,raises", [
    ("bfloat16", "xla", True), ("bfloat16", "blocked", False),
    ("float32", "xla", False)])
def test_bf16_xla_attention_is_refused(dtype, attn_impl, raises):
    """The port's prefill attention always computes the blocked fp32
    arithmetic. At fp32 that is what ``attn_impl="xla"`` computes too; at
    bf16 the xla path rounds scores and probabilities, so the port refuses
    that config rather than compute something else."""
    cfg = reduced("granite_3_2b").replace(dtype=dtype, attn_impl=attn_impl)
    gen = torch.Generator().manual_seed(0)
    if raises:
        with pytest.raises(NotImplementedError, match="attn_impl='xla'"):
            MD.init_model(cfg, gen, device="cpu")
    else:
        assert MD.param_count(MD.init_model(cfg, gen, device="cpu")) > 0


def _chunk_setup(cfg, jcfg, P=10):
    """A two-row block table: row 1 (the chunk's lane) maps pages 7, 2, 5
    and leaves the rest unmapped; row 0 maps pages the lane must not touch."""
    bt = np.full((2, 4), -1, np.int32)
    bt[0, :2] = [0, 1]
    bt[1, :3] = [7, 2, 5]
    return (JMD.init_paged_cache(jcfg, P, PAGE),
            MD.init_paged_cache(cfg, P, PAGE, device="cpu"), bt)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_prefill_chunk_step_matches_reference(models, kv_int8):
    """A 45-token prompt streamed in chunks of 12 (straddling the 16-token
    pages, the last chunk ragged): each step's last logits agree, and the
    page stores hold the same K/V (the port's trash page aside)."""
    jcfg, cfg, jp, _, params = models
    if kv_int8:
        jcfg = jcfg.replace(kv_cache_dtype="int8")
        cfg = cfg.replace(kv_cache_dtype="int8")
    P = 10
    jcache, cache, bt = _chunk_setup(cfg, jcfg, P)
    prompt = np.random.default_rng(5).integers(0, 512, 45)
    C = 12
    jstep = jax.jit(lambda toks, pos0, clen, c: JMD.prefill_chunk_step(
        jcfg, jp, toks, pos0, clen, jnp.int32(1), c, block_table=jnp.asarray(bt)))
    for pos0 in range(0, len(prompt), C):
        n = min(C, len(prompt) - pos0)
        toks = np.zeros(C, np.int64)
        toks[:n] = prompt[pos0:pos0 + n]
        want, jcache = jstep(jnp.asarray(toks, jnp.int32), jnp.int32(pos0),
                             jnp.int32(n), jcache)
        got = MD.prefill_chunk_step(cfg, params, torch.from_numpy(toks),
                                    *map(torch.tensor, (pos0, n, 1)), cache,
                                    block_table=torch.from_numpy(bt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL,
                                   err_msg=f"chunk at {pos0}")
    for seg, jseg in zip(cache, jcache):
        for name, x in seg.items():
            w = np.asarray(jseg[name])
            g = x[:, :P].numpy()
            if name in ("k", "v") and kv_int8:
                # codes of values that sit on a rounding edge of x/scale may
                # step by one between the frameworks
                assert np.abs(g.astype(np.int32) - w).max() <= 1, name
                assert (g != w).mean() < 1e-3, name
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
    # pages the lane does not map stay empty
    untouched = [p for p in range(P) if p not in (7, 2, 5)]
    assert all(not x[:, untouched].any() for seg in cache for x in seg.values())


@pytest.mark.parametrize("kv_int8", [False, True])
def test_int8_chunk_logits_part_from_whole_prompt_as_reference(models, kv_int8):
    """Why int8-KV chunked and whole-prompt greedy tokens may part: a chunk
    attends over the earlier chunks' K/V quantized and read back from its
    pages, whole-prompt prefill over the unquantized K/V. The reference's
    last chunk logits part from its whole-prompt logits by the same amount
    as the port's (at most ATOL apart); with fp32 KV neither parts beyond
    ATOL."""
    jcfg, cfg, jp, _, params = models
    if kv_int8:
        jcfg = jcfg.replace(kv_cache_dtype="int8")
        cfg = cfg.replace(kv_cache_dtype="int8")
    jcache, cache, bt = _chunk_setup(cfg, jcfg)
    prompt = np.random.default_rng(5).integers(0, 512, 45)
    C = 12
    for pos0 in range(0, len(prompt), C):
        n = min(C, len(prompt) - pos0)
        toks = np.zeros(C, np.int64)
        toks[:n] = prompt[pos0:pos0 + n]
        jchunk, jcache = JMD.prefill_chunk_step(
            jcfg, jp, jnp.asarray(toks, jnp.int32), jnp.int32(pos0), jnp.int32(n),
            jnp.int32(1), jcache, block_table=jnp.asarray(bt))
        chunk = MD.prefill_chunk_step(cfg, params, torch.from_numpy(toks),
                                      *map(torch.tensor, (pos0, n, 1)), cache,
                                      block_table=torch.from_numpy(bt))
    jwhole, _, _ = JMD.forward(jcfg, jp, jnp.asarray(prompt[None], jnp.int32),
                               mode="prefill", max_len=64)
    whole = MD.forward(cfg, params, torch.from_numpy(prompt[None]), mode="prefill")
    ref_gap = np.asarray(jchunk) - np.asarray(jwhole)[0, -1]
    port_gap = chunk.numpy() - whole[0, -1].numpy()
    np.testing.assert_allclose(port_gap, ref_gap, rtol=0, atol=ATOL)
    if kv_int8:
        assert np.abs(ref_gap).max() > 10 * ATOL
    else:
        assert np.abs(ref_gap).max() <= ATOL
