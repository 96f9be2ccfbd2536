"""The port's paged-attention plain version against the JAX package's
oracle and its Pallas kernel (interpret mode), and the CPU dispatch.

The hand-written CUDA kernel itself runs only on the card; ``chip_smoke.py``
holds it against ``paged_attention_ref`` there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("jax.experimental.pallas",
                    reason="Pallas unavailable in this jax build")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import paged_attention as pallas_paged  # noqa: E402
from repro.models.attention import dequantize_kv as jdequantize_kv  # noqa: E402
from repro.models.attention import quantize_kv as jquantize_kv  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as cuda_paged  # noqa: E402
from repro_torch.models.attention import dequantize_kv, quantize_kv  # noqa: E402

# fp32 against fp32: the two frameworks sum in another order (einsum vs
# the kernel's page-by-page online softmax), a few ulp of the O(1) output
FP32_ATOL = 2e-5


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
