"""The paged decode-attention kernel's split over pages, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against the plain version there). Here: the split plan the wrapper picks
from static shapes, a torch mirror of the kernels' arithmetic (splits of
``pages_per_split`` pages, four warps each with its own online softmax in
the log2 domain over tiles of 32, 16 or 8 tokens, a guarded merge of
the warps and a guarded combine of the splits) against the JAX package's
oracle and its Pallas kernel in interpret mode, and the wrapper's shape
checks."""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("jax.experimental.pallas",
                    reason="Pallas unavailable in this jax build")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import paged_attention as pallas_paged  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.checks import check_cp_async_rows  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    HEAD_DIMS, MAX_GROUP, MAX_PAGE, MIN_SPLIT_TOKENS, check_shapes, split_plan)
from repro_torch.models.attention import quantize_kv  # noqa: E402

# as in test_torch_kernels.py: fp32 against fp32, the sums taken in another
# order (einsum vs tiles, warps and splits), a few ulp of the O(1) output
FP32_ATOL = 2e-5
LOG2E = 1.4426950408889634
WARPS = 4
H100_SMS = 132  # the card the plan is checked for

# (B, KVH, max_pages, page): chip_smoke.py's paged rows, the serve's
# engine (8 slots, max_len 1024, page 32) and the reduced engine
PLAN_SHAPES = [
    (8, 8, 32, 32), (1, 8, 64, 32), (8, 8, 64, 32), (8, 2, 13, 16),
    (8, 32, 32, 32), (8, 4, 32, 32), (8, 8, 8, 128),
    (8, 8, 1024 // 32, 32), (4, 2, 128 // 16, 16),
    (1, 1, 1, 256), (64, 8, 2, 32), (3, 5, 97, 24), (1, 1, 4096, 16),
]


@pytest.mark.parametrize("B,KVH,max_pages,page", PLAN_SHAPES)
def test_split_plan_covers_every_page_once(B, KVH, max_pages, page):
    pps, n_splits = split_plan(B, KVH, max_pages, page, H100_SMS)
    assert isinstance(pps, int) and isinstance(n_splits, int)
    assert n_splits >= 1 and 1 <= pps <= max_pages
    covered = [j for s in range(n_splits)
               for j in range(s * pps, min((s + 1) * pps, max_pages))]
    assert covered == list(range(max_pages))
    assert (n_splits - 1) * pps < max_pages          # no split is empty
    # no split under the floor unless the table is shorter than it
    assert pps * page >= min(MIN_SPLIT_TOKENS, max_pages * page)


def test_split_plan_reads_static_shapes_only():
    """The plan takes ints, never a tensor, so a call adds no host sync."""
    params = inspect.signature(split_plan).parameters
    assert list(params) == ["B", "KVH", "max_pages", "page", "n_sm"]
    assert all(p.annotation in (int, "int") for p in params.values())
    # the serve's engine on the H100: at least two blocks an SM when full
    pps, n_splits = split_plan(8, 8, 32, 32, H100_SMS)
    assert (pps, n_splits) == (4, 8) and 8 * 8 * n_splits >= 2 * H100_SMS
    # the small phase's engine (4 slots, max_len 128, page 16): one split
    assert split_plan(4, 2, 128 // 16, 16, H100_SMS) == (8, 1)


# ----------------------------------------------------------------------
# torch mirror of the split kernel and the combine kernel
# ----------------------------------------------------------------------

def tile_tokens(D, itemsize):
    """Tokens a warp copies and scores at once (``Geo::kTokens`` in
    ``csrc/paged_attention.cu``): 32, or 16 and 8 for rows of 256 and 512
    bytes."""
    row = D * itemsize
    return 32 if row <= 128 else 16 if row <= 256 else 8


def _merge(parts):
    """(m, l, acc) rows merged with the Pallas guard: a part with m = -inf
    (a warp that took no tile, an empty split) weighs exactly 0."""
    m = torch.stack([p[0] for p in parts])                 # (n, G)
    mx = m.max(dim=0).values
    wt = torch.where(m > -math.inf, torch.exp2(m - mx), torch.zeros_like(m))
    l = (wt * torch.stack([p[1] for p in parts])).sum(0)
    acc = (wt[..., None] * torch.stack([p[2] for p in parts])).sum(0)
    return mx, l, acc


def _warp(qs, kp, vp, ks, vs, row_page, sb, se, tiles, T, kvh):
    """One warp's online softmax over its tiles (log2 domain, fp32)."""
    G, D = qs.shape
    page = kp.shape[1]
    m = torch.full((G,), -math.inf)
    l = torch.zeros(G)
    acc = torch.zeros(G, D)
    for tile in tiles:
        pos = sb + tile * T + torch.arange(T)
        valid = pos < se
        k = torch.zeros(T, D)
        v = torch.zeros(T, D)
        k_sc = torch.zeros(T)
        v_sc = torch.zeros(T)
        pv = pos[valid]
        pid, off = row_page(pv // page), pv % page
        k[valid] = kp[pid, off, kvh].float()
        v[valid] = vp[pid, off, kvh].float()
        if ks is not None:
            k_sc[valid], v_sc[valid] = ks[pid, off, kvh], vs[pid, off, kvh]
        else:
            k_sc[valid], v_sc[valid] = 1.0, 1.0
        s = (qs @ k.T) * k_sc
        s = torch.where(valid, s, torch.tensor(-math.inf))
        m_new = torch.maximum(m, s.max(dim=1).values)      # finite: token 0 valid
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[:, None])
        l = l * corr + p.sum(1)
        acc = acc * corr[:, None] + (p * v_sc) @ v
        m = m_new
    return m, l, acc


def split_mirror(q, kp, vp, bt, lengths, ks=None, vs=None, n_sm=H100_SMS):
    """What the split and combine kernels compute, step for step."""
    B, H, D = q.shape
    P, page, KVH, _ = kp.shape
    max_pages = bt.shape[1]
    G = H // KVH
    pps, n_splits = split_plan(B, KVH, max_pages, page, n_sm)
    T = tile_tokens(D, kp.element_size())
    split_tokens = pps * page
    qs = q.float() * (LOG2E / math.sqrt(D))
    out = torch.zeros(B, H, D)
    for b in range(B):
        length = min(int(lengths[b]), max_pages * page)

        def row_page(j, b=b):
            return bt[b, j].long().clamp(0, P - 1)

        n_live = min(max(-(-length // split_tokens), 0), n_splits)
        for kvh in range(KVH):
            qg = qs[b, kvh * G:(kvh + 1) * G]
            parts = []
            for s in range(max(n_live, 1)):
                sb = s * split_tokens
                se = min(sb + split_tokens, length)
                n_tiles = -(-(se - sb) // T) if se > sb else 0
                parts.append(_merge([
                    _warp(qg, kp, vp, ks, vs, row_page, sb, se,
                          range(w, n_tiles, WARPS), T, kvh)
                    for w in range(WARPS)]))
            m, l, acc = _merge(parts[:n_live]) if n_live else parts[0]
            out[b, kvh * G:(kvh + 1) * G] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out.to(q.dtype), n_splits


def _inputs(seed, B, H, KVH, D, P, page, maxp, lengths):
    """Random q/pages; each row maps distinct pages up to the table's reach
    and holds -1 past ceil(len/page) (never read)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    kp = rng.standard_normal((P, page, KVH, D), dtype=np.float32)
    vp = rng.standard_normal((P, page, KVH, D), dtype=np.float32)
    bt = np.full((B, maxp), -1, np.int32)
    for b, L in enumerate(lengths):
        n = min(-(-L // page), maxp)
        bt[b, :n] = rng.choice(P, size=n, replace=False)
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


MIRROR_CASES = [
    # B, H, KVH, D, P, page, maxp, lengths; splits of 128 tokens (144 at
    # page 24): a single token, a split boundary -1/0/+1, past the table's
    # reach (640, 384, 512), slots whose later splits are empty
    (6, 4, 2, 16, 48, 16, 40, [1, 127, 128, 129, 700, 300]),
    (3, 8, 2, 64, 16, 32, 12, [1, 129, 434]),
    (2, 12, 1, 128, 8, 128, 4, [255, 600]),
    (3, 4, 4, 128, 12, 24, 16, [23, 144, 97]),
]


@pytest.mark.parametrize("case", MIRROR_CASES)
@pytest.mark.parametrize("quantized", [False, True])
def test_split_mirror_matches_oracle_and_pallas(case, quantized):
    B, H, KVH, D, P, page, maxp, lengths = case
    q, kp, vp, bt, ln = _inputs(4, B, H, KVH, D, P, page, maxp, lengths)
    ks = vs = None
    kt, vt = _t(kp), _t(vp)
    if quantized:
        (kt, ks), (vt, vs) = quantize_kv(kt), quantize_kv(vt)
    got, n_splits = split_mirror(_t(q), kt, vt, _t(bt), _t(ln), ks, vs)
    assert n_splits > 1
    assert torch.isfinite(got).all()
    want = ref.paged_attention_ref(_t(q), kt, vt, _t(bt), _t(ln), ks, vs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=FP32_ATOL)
    args = [jnp.asarray(q), jnp.asarray(kt.numpy()), jnp.asarray(vt.numpy()),
            jnp.asarray(bt), jnp.asarray(ln)]
    if quantized:
        args += [jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy())]
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.paged_attention_ref(*args)),
                               rtol=0, atol=FP32_ATOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(pallas_paged(*args, interpret=True)),
                               rtol=0, atol=FP32_ATOL)


def test_one_split_writes_the_output_itself():
    """A plan of one split (small B * KVH is not needed: a short table)
    gives the same result without any combine."""
    B, H, KVH, D, P, page, maxp, lengths = 2, 8, 2, 64, 8, 32, 4, [1, 128]
    q, kp, vp, bt, ln = _inputs(5, B, H, KVH, D, P, page, maxp, lengths)
    got, n_splits = split_mirror(_t(q), _t(kp), _t(vp), _t(bt), _t(ln))
    assert n_splits == 1
    want = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(bt), _t(ln))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=FP32_ATOL)


def test_merge_guard_weighs_empty_parts_zero():
    """An empty split or a warp that took no tile (m = -inf, l = 0) adds
    exactly 0; unguarded, exp2(-inf - (-inf)) would be NaN."""
    rng = np.random.default_rng(6)
    live = (_t(rng.standard_normal(4, dtype=np.float32)),
            _t(rng.random(4, dtype=np.float32) + 1),
            _t(rng.standard_normal((4, 16), dtype=np.float32)))
    empty = (torch.full((4,), -math.inf), torch.zeros(4), torch.zeros(4, 16))
    for parts in ([live, empty], [empty, live, empty]):
        m, l, acc = _merge(parts)
        assert torch.equal(m, live[0]) and torch.equal(l, live[1])
        assert torch.equal(acc, live[2])
    m, l, acc = _merge([empty, empty])
    assert torch.isfinite(l).all() and torch.isfinite(acc).all()
    assert torch.equal(acc / torch.clamp(l, min=1e-30)[:, None], torch.zeros(4, 16))
    unguarded = torch.exp2(empty[0] - m)
    assert torch.isnan(unguarded).all()


# ----------------------------------------------------------------------
# the wrapper's shape checks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KVH,D,page,max_pages", [
    (8, 32, 8, 64, 32, 32),       # granite
    (8, 4, 2, 16, 16, 13),        # reduced
    (8, 32, 32, 128, 32, 32),     # Llama 2: D 128, G 1
    (8, 48, 4, 128, 32, 32),      # G 12
    (8, 64, 4, 64, 256, 4),       # G 16, page 256
    (1, 8, 8, 16, 1, 1),          # page 1
    (3, 9, 3, 64, 24, 7),         # G 3, page 24
])
def test_check_shapes_accepts_what_the_kernel_takes(B, H, KVH, D, page, max_pages):
    assert D in HEAD_DIMS and page <= MAX_PAGE and H // KVH <= MAX_GROUP
    check_shapes(B, H, KVH, D, page, max_pages)


@pytest.mark.parametrize("B,H,KVH,D,page,max_pages", [
    (8, 32, 8, 96, 32, 32),       # D 96
    (8, 32, 8, 256, 32, 32),      # D 256
    (8, 64, 2, 64, 32, 32),       # G 32
    (8, 32, 6, 64, 32, 32),       # H not a multiple of KVH
    (8, 32, 8, 64, 257, 4),       # page past MAX_PAGE
    (8, 32, 8, 64, 0, 4),         # page 0
    (0, 32, 8, 64, 32, 4),        # no slot
    (8, 32, 8, 64, 32, 0),        # no table entry
])
def test_check_shapes_refuses_what_the_kernel_does_not_take(B, H, KVH, D, page, max_pages):
    with pytest.raises(ValueError, match="paged_attention: kernel takes"):
        check_shapes(B, H, KVH, D, page, max_pages)


@pytest.mark.parametrize("offset,ok", [(0, True), (16, True), (2, False), (8, False)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_pages_must_start_16_byte_aligned(offset, ok, dtype):
    """K/V rows (D 16: 16 bytes in int8, 32 in bf16) arrive by 16-byte
    cp.async copies, so a page store that starts off a 16-byte boundary is
    refused; the helper reads only addresses and strides, so it runs on
    the CPU as on the card."""
    flat = torch.zeros(4096, dtype=torch.int8)
    base = (-flat.data_ptr()) % 16 + offset
    n = 6 * 8 * 2 * 16 * torch.tensor([], dtype=dtype).element_size()
    pages = flat[base:base + n].view(dtype).view(6, 8, 2, 16)
    if ok:
        check_cp_async_rows("paged_attention", "k_pages", pages)
    else:
        with pytest.raises(ValueError, match="paged_attention: k_pages rows must "
                           "be 16-byte aligned"):
            check_cp_async_rows("paged_attention", "k_pages", pages)

