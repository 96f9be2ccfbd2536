"""The port's plain kernel versions (paged attention, fused RMSNorm, flash
attention) against the JAX package's oracles and its Pallas kernels
(interpret mode), and the CPU dispatch.

The hand-written CUDA kernels themselves run only on the card;
``chip_smoke.py`` holds each against its plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("jax.experimental.pallas",
                    reason="Pallas unavailable in this jax build")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.paged_attention import paged_attention as pallas_paged  # noqa: E402
from repro.kernels.rmsnorm import fused_rmsnorm as pallas_rmsnorm  # noqa: E402
from repro.models.attention import dequantize_kv as jdequantize_kv  # noqa: E402
from repro.models.attention import quantize_kv as jquantize_kv  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.checks import check_cp_async_rows  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as cuda_flash  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as cuda_paged  # noqa: E402
from repro_torch.kernels.rmsnorm import fused_rmsnorm as cuda_rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm import MAX_D as RMSNORM_MAX_D  # noqa: E402
from repro_torch.kernels.rmsnorm import launch_shape as rmsnorm_launch_shape  # noqa: E402
from repro_torch.models.attention import dequantize_kv, quantize_kv  # noqa: E402

# fp32 against fp32: the two frameworks sum in another order (einsum vs
# the kernel's page-by-page online softmax), a few ulp of the O(1) output
FP32_ATOL = 2e-5
# RMSNorm at fp32: one reduction of d terms in another order moves the
# outputs by a few ulp: 1e-6 relative (atol 1e-6 for outputs near zero)
RMS_FP32_TOL = 1e-6
BF16_ULP = 2.0 ** -7      # one bf16 ulp, relative to the top of a binade


def _inputs(seed, B, H, KVH, D, P, page, maxp, lengths):
    """Random q/pages and a block table whose rows map distinct pages up
    to ceil(len/page) and hold -1 past that (never read)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    kp = rng.standard_normal((P, page, KVH, D), dtype=np.float32)
    vp = rng.standard_normal((P, page, KVH, D), dtype=np.float32)
    bt = np.full((B, maxp), -1, np.int32)
    for b, L in enumerate(lengths):
        n = -(-L // page)
        bt[b, :n] = rng.choice(P, size=n, replace=False)
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


CASES = [
    # B, H, KVH, D, P, page, maxp, lengths (straddling page edges)
    (3, 8, 2, 64, 16, 32, 4, [1, 33, 128]),
    (4, 4, 2, 16, 24, 16, 6, [16, 17, 31, 96]),
    (2, 32, 8, 64, 12, 32, 5, [32, 150]),
    # the widths the redesigned kernel covers: D 128 with groups of 12 and
    # of 1 (Llama 2), 128-token pages
    (2, 12, 1, 128, 8, 32, 4, [1, 100]),
    (2, 4, 4, 128, 6, 32, 3, [33, 96]),
    (3, 8, 2, 64, 8, 128, 2, [1, 129, 256]),
]


@pytest.mark.parametrize("case", CASES)
def test_paged_ref_matches_jax_oracle_and_pallas(case):
    B, H, KVH, D, P, page, maxp, lengths = case
    q, kp, vp, bt, ln = _inputs(0, B, H, KVH, D, P, page, maxp, lengths)
    got = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(bt), _t(ln)).numpy()
    want = np.asarray(jref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ln)))
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)
    kern = np.asarray(pallas_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ln), interpret=True))
    np.testing.assert_allclose(got, kern, rtol=0, atol=FP32_ATOL)


def test_paged_ref_int8_matches_jax():
    """int8 pages + f32 scales: the port's quantizer gives the reference's
    codes and scales, and attention over them matches oracle and kernel."""
    B, H, KVH, D, P, page, maxp, lengths = CASES[1]
    q, kp, vp, bt, ln = _inputs(1, B, H, KVH, D, P, page, maxp, lengths)
    kq, ks = quantize_kv(_t(kp))
    vq, vs = quantize_kv(_t(vp))
    jkq, jks = jquantize_kv(jnp.asarray(kp))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    np.testing.assert_array_equal(
        dequantize_kv(kq, ks, torch.float32).numpy(),
        np.asarray(jdequantize_kv(jkq, jks, jnp.float32)))
    got = ref.paged_attention_ref(_t(q), kq, vq, _t(bt), _t(ln), ks, vs).numpy()
    args = (jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
            jnp.asarray(bt), jnp.asarray(ln), jnp.asarray(ks.numpy()),
            jnp.asarray(vs.numpy()))
    np.testing.assert_allclose(got, np.asarray(jref.paged_attention_ref(*args)),
                               rtol=0, atol=FP32_ATOL)
    np.testing.assert_allclose(got, np.asarray(pallas_paged(*args, interpret=True)),
                               rtol=0, atol=FP32_ATOL)


def test_cpu_dispatch_takes_plain_version():
    B, H, KVH, D, P, page, maxp, lengths = CASES[0]
    q, kp, vp, bt, ln = _inputs(2, B, H, KVH, D, P, page, maxp, lengths)
    before = cuda_paged.launches
    got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(ln))
    want = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(bt), _t(ln))
    assert torch.equal(got, want)
    assert cuda_paged.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs a CPU tensor through the plain version."""
    B, H, KVH, D, P, page, maxp, lengths = CASES[0]
    q, kp, vp, bt, ln = _inputs(3, B, H, KVH, D, P, page, maxp, lengths)
    before = cuda_paged.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_paged(_t(q), _t(kp), _t(vp), _t(bt), _t(ln))
    assert cuda_paged.launches == before


# ----------------------------------------------------------------------
# fused RMSNorm
# ----------------------------------------------------------------------

def _rms_inputs(seed, N, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, d), dtype=np.float32)
    res = rng.standard_normal((N, d), dtype=np.float32)
    scale = (rng.random(d, dtype=np.float32) + 0.5).astype(np.float32)
    return x, res, scale


def _bf16(a):
    """numpy f32 -> (torch bf16, jnp bf16) holding the same values."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("N,d", [(8, 64), (256, 64), (512, 2048),
                                 # minicpm-2b, llama2-7b, llama2-13b
                                 (8, 2304), (8, 4096), (64, 5120)])
@pytest.mark.parametrize("with_residual", [True, False])
def test_rmsnorm_ref_matches_jax_oracle_and_pallas_f32(N, d, with_residual):
    """f32: the plain version equals the JAX oracle and the Pallas kernel
    (interpret mode) up to a few ulp of the reduction (1e-6 relative)."""
    x, res, scale = _rms_inputs(0, N, d)
    r = res if with_residual else None
    y, s = ref.fused_rmsnorm_ref(_t(x), _t(scale), None if r is None else _t(r))
    jargs = (jnp.asarray(x), jnp.asarray(scale),
             None if r is None else jnp.asarray(r))
    wy, ws = jref.fused_rmsnorm_ref(*jargs)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=RMS_FP32_TOL,
                               atol=RMS_FP32_TOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    ky, ks = pallas_rmsnorm(*jargs, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ky), rtol=RMS_FP32_TOL,
                               atol=RMS_FP32_TOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ks))


@pytest.mark.parametrize("N,d", [(8, 64), (256, 2048), (8, 2304), (64, 4096),
                                 (64, 5120)])
def test_rmsnorm_ref_bf16_rounds_like_the_reference_block(N, d):
    """bf16 with a residual: the plain version normalizes the ROUNDED sum,
    as the JAX oracle and the reference block do, so it equals the oracle
    except where the two means differ in their last fp32 bit (the sums
    run in another order) and a bf16 output sits on a rounding edge: at
    most 1e-4 of the outputs, each one bf16 ulp off. The Pallas body
    normalizes the unrounded fp32 sum, so the port is within one bf16 ulp
    of it. The sums r agree exactly with both."""
    x, res, scale = _rms_inputs(1, N, d)
    (tx, jx), (tr, jr) = _bf16(x), _bf16(res)
    y, s = ref.fused_rmsnorm_ref(tx, _t(scale), tr)
    wy, ws = jref.fused_rmsnorm_ref(jx, jnp.asarray(scale), jr)
    yf, wyf = y.float().numpy(), np.asarray(wy, np.float32)
    assert (yf != wyf).mean() <= 1e-4
    np.testing.assert_allclose(yf, wyf, rtol=BF16_ULP, atol=0)
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(ws, np.float32))
    ky, ks = pallas_rmsnorm(jx, jnp.asarray(scale), jr, interpret=True)
    ky = np.asarray(ky, np.float32)
    np.testing.assert_allclose(y.float().numpy(), ky, rtol=BF16_ULP, atol=0)
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(ks, np.float32))


def test_rmsnorm_ref_ragged_rows_match_jax_oracle():
    """A row count no Pallas block divides (the reference's ops fall back
    there; the port's kernel masks the tail): the oracle is the yardstick."""
    x, res, scale = _rms_inputs(2, 1000, 64)
    y, s = ref.fused_rmsnorm_ref(_t(x), _t(scale), _t(res))
    wy, ws = jref.fused_rmsnorm_ref(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(res))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=RMS_FP32_TOL,
                               atol=RMS_FP32_TOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))


# ----------------------------------------------------------------------
# flash attention
# ----------------------------------------------------------------------

def _flash_inputs(seed, B, H, KVH, Tq, Tk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Tq, D), dtype=np.float32),
            rng.standard_normal((B, KVH, Tk, D), dtype=np.float32),
            rng.standard_normal((B, KVH, Tk, D), dtype=np.float32))


FLASH_BLOCK_CASES = [
    # B, H, KVH, T, D, causal, window, block
    (1, 4, 4, 128, 16, True, 0, 64),        # MHA, causal
    (2, 8, 2, 128, 16, True, 0, 64),        # GQA, causal
    (1, 4, 2, 128, 64, True, 48, 32),       # sliding window
    (1, 4, 2, 64, 16, False, 0, 32),        # non-causal
    # head_dim 128 (Llama 2)
    (1, 4, 4, 128, 128, True, 0, 64),       # MHA, causal
    (2, 8, 2, 128, 128, True, 0, 64),       # GQA, causal
    (1, 4, 4, 128, 128, True, 48, 32),      # MHA, sliding window
    (1, 8, 2, 128, 128, True, 40, 32),      # GQA, sliding window
]


@pytest.mark.parametrize("case", FLASH_BLOCK_CASES)
def test_flash_ref_matches_pallas_and_oracle(case):
    B, H, KVH, T, D, causal, window, block = case
    q, k, v = _flash_inputs(3, B, H, KVH, T, T, D)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                  window=window).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kern = np.asarray(pallas_flash(*jargs, causal=causal, window=window,
                                   block_q=block, block_k=block, interpret=True))
    np.testing.assert_allclose(got, kern, rtol=0, atol=FP32_ATOL)
    want = np.asarray(jref.flash_attention_ref(*jargs, causal=causal, window=window))
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("Tq,Tk,causal,window", [
    (77, 77, True, 0), (200, 200, True, 64), (50, 77, False, 0),
    (77, 50, True, 0), (128, 128, False, 40)])
def test_flash_ref_ragged_matches_oracle(Tq, Tk, causal, window):
    """Lengths no block divides (the Pallas kernel asserts on them; the
    port's kernel masks the tail), Tq != Tk included: top-left masks.
    A window without causality is held against the oracle only: the
    Pallas kernel skips key blocks past the diagonal there too
    (``flash_attention.py:71-73``), so it drops keys the mask keeps."""
    q, k, v = _flash_inputs(4, 2, 8, 2, Tq, Tk, 16)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                  window=window).numpy()
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)


def test_flash_ref_bf16_computes_in_fp32():
    """bf16 inputs: scores and P·V in fp32, one rounding at the output, as
    the oracle: within one bf16 ulp of the output scale."""
    q, k, v = _flash_inputs(5, 1, 8, 2, 96, 96, 64)
    tq, jq = _bf16(q)
    tk, jk = _bf16(k)
    tv, jv = _bf16(v)
    got = ref.flash_attention_ref(tq, tk, tv).float().numpy()
    want = np.asarray(jref.flash_attention_ref(jq, jk, jv), np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_ULP * np.abs(want).max())


def test_flash_ref_takes_strided_views():
    """gqa_full hands over (B, T, H, D) projections as (B, H, T, D) views."""
    q, k, v = _flash_inputs(6, 2, 4, 2, 40, 40, 16)
    views = [_t(a).transpose(1, 2).contiguous().transpose(1, 2) for a in (q, k, v)]
    assert not views[0].is_contiguous()
    got = ref.flash_attention_ref(*views)
    assert torch.equal(got, ref.flash_attention_ref(_t(q), _t(k), _t(v)))


# ----------------------------------------------------------------------
# dispatch and wrappers
# ----------------------------------------------------------------------

def test_cpu_dispatch_takes_plain_rmsnorm_and_flash():
    x, res, scale = _rms_inputs(7, 10, 64)
    b0, f0 = cuda_rmsnorm.launches, cuda_flash.launches
    for r in (None, _t(res)):
        got = ops.fused_rmsnorm(_t(x), _t(scale), r)
        want = ref.fused_rmsnorm_ref(_t(x), _t(scale), r)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    q, k, v = _flash_inputs(8, 1, 4, 2, 33, 33, 16)
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=8)
    assert torch.equal(got, ref.flash_attention_ref(_t(q), _t(k), _t(v), window=8))
    assert (cuda_rmsnorm.launches, cuda_flash.launches) == (b0, f0)


def test_rmsnorm_and_flash_wrappers_refuse_cpu_tensors():
    x, res, scale = _rms_inputs(9, 8, 64)
    q, k, v = _flash_inputs(10, 1, 4, 2, 16, 16, 16)
    b0, f0 = cuda_rmsnorm.launches, cuda_flash.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_rmsnorm(_t(x), _t(scale), _t(res))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_flash(_t(q), _t(k), _t(v))
    assert (cuda_rmsnorm.launches, cuda_flash.launches) == (b0, f0)


def _bf16_views(kind):
    """(B, H, T, D) bf16 views of (B, T, H, D) storage, as gqa_full passes
    them: aligned, with a token stride of 130 bytes, or with the base one
    element past a 16-byte boundary."""
    B, T, H, D = 2, 40, 4, 64
    if kind == "aligned":
        return torch.zeros(B, T, H, D, dtype=torch.bfloat16).transpose(1, 2)
    if kind == "odd token stride":
        return torch.zeros(B, T, H, D + 1, dtype=torch.bfloat16)[..., :D].transpose(1, 2)
    flat = torch.zeros(B * T * H * D + 8, dtype=torch.bfloat16)
    return flat[1:1 + B * T * H * D].view(B, T, H, D).transpose(1, 2)


@pytest.mark.parametrize("kind", ["aligned", "odd token stride", "misaligned base"])
def test_flash_wrapper_checks_rows_for_16_byte_copies(kind):
    """The bf16 kernel copies rows with 16-byte cp.async: an aligned strided
    view passes; a view whose token stride or base breaks the 16-byte
    alignment raises, naming the constraint."""
    t = _bf16_views(kind)
    if kind == "aligned":
        check_cp_async_rows("flash_attention", "q", t)
    else:
        with pytest.raises(ValueError, match="16-byte aligned.*cp.async"):
            check_cp_async_rows("flash_attention", "q", t)


@pytest.mark.parametrize("N,d,itemsize,shape", [
    # one block per row, one 16-byte vector a thread, whole warps
    (1, 2048, 2, (1, 256)),
    (8, 2048, 2, (8, 256)),
    (48, 2048, 2, (48, 256)),
    (8, 2048, 4, (8, 512)),
    (8, 64, 2, (8, 32)),
    (2048, 2048, 2, (2048, 256)),
    (2048, 2048, 4, (2048, 512)),
    (1000, 2048, 2, (1000, 256)),
    # minicpm-2b, llama2-7b and llama2-13b: f32 at d 5120 is 1280 vectors,
    # two a thread
    (8, 2304, 2, (8, 288)),
    (8, 4096, 2, (8, 512)),
    (8, 4096, 4, (8, 1024)),
    (8, 5120, 2, (8, 640)),
    (8, 5120, 4, (8, 640)),
    (2048, 5120, 4, (2048, 640)),
    (8, 8192, 4, (8, 1024)),
])
def test_rmsnorm_launch_shape_follows_the_row_count(N, d, itemsize, shape):
    """(blocks, threads per block) the RMSNorm wrapper launches with."""
    assert rmsnorm_launch_shape(N, d, itemsize) == shape


@pytest.mark.parametrize("itemsize", [2, 4])
def test_rmsnorm_launch_shape_is_one_the_kernel_takes(itemsize):
    """Every launch shape the wrapper picks, for any row count and any d up
    to ``MAX_D`` that is a multiple of 16 bytes, is one ``csrc/rmsnorm.cu``
    accepts: one block per row, whole warps of at most 1024 threads that
    cover the row with one 16-byte vector a thread, or two past 1024
    vectors (f32 above d 4096), as the kernel derives them
    (ceil(vectors / threads)), and no idle warp."""
    vec = 16 // itemsize
    for N in (1, 2, 8, 48, 64, 255, 256, 257, 512, 1000, 2048, 8191):
        for d in range(vec, RMSNORM_MAX_D + 1, vec):
            blocks, threads = rmsnorm_launch_shape(N, d, itemsize)
            nvec = d // vec
            per = -(-nvec // threads)
            assert blocks == N and threads % 32 == 0 and threads <= 1024
            assert per == (1 if nvec <= 1024 else 2), (N, d, threads)
            assert threads * per >= nvec > (threads - 32) * per, (N, d, threads)
