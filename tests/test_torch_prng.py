"""raft_tpu_torch.ops.prng against jax.random as raft_tpu runs it (x64 on,
threefry2x32 partitionable): the keys, splits, float64 uniforms and int64
randints that simulate mode draws, bit for bit."""

import jax
import numpy as np
import pytest
import torch

import raft_tpu  # noqa: F401  (turns jax_enable_x64 on, as the reference runs)
from raft_tpu_torch.ops import prng

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

SEEDS = (0, 7, 123_456_789, (1 << 40) + 5)


def _key(k) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(k).tolist())


def test_reference_runs_x64_and_partitionable_threefry():
    # the port copies these two choices of jax; a change of JAX's default
    # shows here first
    assert jax.config.jax_enable_x64
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split(seed):
    k = jax.random.PRNGKey(seed)
    assert _key(k) == prng.PRNGKey(seed)
    for num in (2, 3):
        want = [_key(x) for x in jax.random.split(k, num)]
        assert want == prng.split(prng.PRNGKey(seed), num)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 16, 1000])
def test_uniform_float64(seed, n):
    key = jax.random.split(jax.random.PRNGKey(seed))[0]
    want = np.asarray(jax.random.uniform(key, (n,)))
    assert want.dtype == np.float64
    got = prng.uniform(_key(key), n).numpy()
    assert np.array_equal(want.view(np.int64), got.view(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 16, 1000])
@pytest.mark.parametrize("span", [1, 3, 1 << 20])
def test_randint_int64(seed, n, span):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    want = np.asarray(jax.random.randint(key, (n,), 0, span))
    assert want.dtype == np.int64
    assert np.array_equal(want, prng.randint(_key(key), n, span).numpy())


def test_randint_widest_span_and_refusal():
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.randint(key, (64,), 0, 1 << 31))
    assert np.array_equal(want, prng.randint(_key(key), 64, 1 << 31).numpy())
    with pytest.raises(ValueError, match="span"):
        prng.randint(_key(key), 4, (1 << 31) + 1)


def test_random_bits_counter_layout():
    # element i is the threefry block of the 64-bit counter (0, i)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.bits(key, (5,), dtype=np.uint64))
    hi, lo = prng.random_bits64(_key(key), 5)
    got = (hi.numpy().astype(np.uint64) << np.uint64(32)) | lo.numpy().astype(np.uint64)
    assert np.array_equal(want, got)
