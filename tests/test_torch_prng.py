"""The port's threefry key stream (``repro_torch.serving.prng``) against
``jax.random`` on the same keys: keys, random bits and uniforms bit for
bit; Gumbel draws to 2 ulp of max(|x|, 1) (two ``log``s, whose last ulp
differs between XLA's and torch's CPU code; near 0 the error scale is the
ulp of the inner log's output, about 1); categorical draws equal. Also the
Random123 known-answer vector, the variant jax runs (the test fails
loudly if an upgrade changes it) and the constants ``chip_smoke.py`` holds
the card to."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.serving import prng

SHAPES = [(), (5,), (8, 512), (3, 4, 7)]
GUMBEL_ULPS = 2


def _j(x):
    return np.asarray(x).astype(np.int64).tolist()


def _keys(seed=11):
    """A jax key and the port's, equal."""
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def test_jax_runs_the_partitionable_threefry():
    """The variant this module reproduces: jax's default threefry2x32 with
    the partitionable split and bits, and 32-bit seeds (64-bit mode off)."""
    assert jax.__version__ == "0.9.0"
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_enable_x64 is False


def test_random123_known_answer():
    """Threefry-2x32, 20 rounds, key 0 and counter 0 (Random123's vector),
    on ints, on tensors and through jax's own hash."""
    want = (0x6B200159, 0x99BA4EFE)
    assert prng.threefry_2x32(0, 0, 0, 0) == want
    z = torch.zeros((), dtype=torch.int64)
    assert tuple(int(x) for x in prng.threefry_2x32(z, z, z, z)) == want
    from jax._src import prng as jprng
    got = jprng.threefry_2x32(jnp.zeros(2, jnp.uint32), jnp.zeros(2, jnp.uint32))
    assert tuple(_j(got)) == want


def test_known_answers():
    """The constants chip_smoke.py holds the card to."""
    assert prng.split(prng.PRNGKey(0), 3).tolist() == [
        [1797259609, 2579123966], [928981903, 3453687069], [4146024105, 2718843009]]
    assert prng.fold_in(prng.PRNGKey(42), 7).tolist() == [2547012911, 1371500959]
    assert prng.bits(prng.PRNGKey(0), (4,)).tolist() == [
        4070199207, 4202968722, 1427181096, 2012915765]
    assert prng.uniform(prng.PRNGKey(1), (3,)).tolist() == [
        0.4386324882507324, 0.5337529182434082, 0.44591832160949707]
    assert _j(jax.random.split(jax.random.PRNGKey(0), 3)) == prng.split(
        prng.PRNGKey(0), 3).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2**32 + 5, 2**62])
def test_prng_key(seed):
    assert _j(jax.random.PRNGKey(seed)) == prng.PRNGKey(seed).tolist()


@pytest.mark.parametrize("num", [1, 2, 3, 8])
def test_split_nested(num):
    """split of one key and of a batch of one key, three levels deep."""
    jk, k = _keys()
    for level in range(3):
        want = _j(jax.random.split(jk, num))
        assert prng.split(k, num).tolist() == want, level
        assert prng.split(k[None], num)[0].tolist() == want, level
        jk, k = jax.random.split(jk, num)[-1], prng.split(k, num)[-1]


def test_split_shape_and_batch():
    jk, k = _keys(5)
    assert prng.split(k, (2, 3)).tolist() == _j(jax.random.split(jk, (2, 3)))
    jks = jax.random.split(jk, 4)
    ks = torch.tensor(_j(jks))
    want = _j(jax.vmap(lambda x: jax.random.split(x, 3))(jks))
    assert prng.split(ks, 3).tolist() == want


def test_split_prefix_is_fold_in():
    """The partitionable split's property: the first keys of a 3-way split
    are the 2-way split's (a mixed block's carry and draw keys equal a
    decode block's), and key i is fold_in(key, i)."""
    _, k = _keys(9)
    assert torch.equal(prng.split(k, 3)[:2], prng.split(k, 2))
    assert torch.equal(prng.split(k[None], 3)[0, :2], prng.split(k[None], 2)[0])
    assert torch.equal(prng.split(k, 8), prng.fold_in(k, torch.arange(8)))


@pytest.mark.parametrize("data", [0, 7, 2**31])
def test_fold_in(data):
    jk, k = _keys(3)
    want = _j(jax.random.fold_in(jk, data))
    assert prng.fold_in(k, data).tolist() == want
    # a tensor of fold ids folds element by element (vmap over the ids)
    ids = torch.tensor([data, 1, data])
    assert prng.fold_in(k, ids).tolist() == [want, _j(jax.random.fold_in(jk, 1)), want]


@pytest.mark.parametrize("shape", SHAPES)
def test_bits(shape):
    jk, k = _keys(17)
    got = prng.bits(k, shape)
    assert tuple(got.shape) == shape
    assert got.tolist() == _j(jax.random.bits(jk, shape))


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform(shape):
    jk, k = _keys(23)
    got = prng.uniform(k, shape)
    want = np.asarray(jax.random.uniform(jk, shape))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_array_equal(
        prng.uniform(k, shape, minval=tiny).numpy(),
        np.asarray(jax.random.uniform(jk, shape, minval=tiny)))


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel(shape):
    jk, k = _keys(29)
    got = prng.gumbel(k, shape).numpy()
    want = np.asarray(jax.random.gumbel(jk, shape, mode="low"))
    assert got.shape == want.shape
    scale = np.spacing(np.maximum(np.abs(want), np.float32(1)))
    assert (np.abs(got - want) <= GUMBEL_ULPS * scale).all()


def test_batched_keys_equal_vmap():
    """A batch of keys draws what jax.vmap over the keys draws."""
    jks = jax.random.split(jax.random.PRNGKey(31), 5)
    ks = torch.tensor(_j(jks))
    assert prng.bits(ks, (6,)).tolist() == _j(
        jax.vmap(lambda x: jax.random.bits(x, (6,)))(jks))
    np.testing.assert_array_equal(
        prng.uniform(ks, (6,)).numpy(),
        np.asarray(jax.vmap(lambda x: jax.random.uniform(x, (6,)))(jks)))


def test_categorical():
    """Draws over seeded logits, one key for the batch and one key a row
    (vmap), at the sampler's width and over many keys."""
    logits = np.random.default_rng(0).standard_normal((8, 512)).astype(np.float32)
    x = torch.from_numpy(logits)
    for seed in range(20):
        jk, k = _keys(seed)
        assert prng.categorical(k, x).tolist() == _j(
            jax.random.categorical(jk, jnp.asarray(logits), axis=-1))
        jks = jax.random.split(jk, 8)
        ks = torch.tensor(_j(jks))
        assert prng.categorical(ks, x).tolist() == _j(jax.vmap(
            lambda kk, ll: jax.random.categorical(kk, ll))(jks, jnp.asarray(logits)))
