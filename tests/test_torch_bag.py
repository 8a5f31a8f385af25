"""The port's batched message-bag ops (raft_tpu_torch/ops/bag.py) against
the JAX reference's per-bag ops (raft_tpu/ops/bag.py) under ``jax.vmap``,
bit for bit, on sorted bags made with numpy: present and absent keys,
full bags (overflow) and empty ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import bag as jbag
from raft_tpu_torch.ops import bag as tbag
from raft_tpu_torch.ops.packing import EMPTY

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)


def _bags(seed, B=300, M=12):
    """Sorted (hi, lo) bags with distinct keys, empties last, and one key
    per bag: half of them already in the bag."""
    rng = np.random.default_rng(seed)
    hi = np.full((B, M), EMPTY, np.int32)
    lo = np.full((B, M), EMPTY, np.int32)
    cnt = np.zeros((B, M), np.int32)
    khi = rng.integers(0, 8, B).astype(np.int32)
    klo = rng.integers(0, 8, B).astype(np.int32)
    for b in range(B):
        n = M if b % 7 == 0 else int(rng.integers(0, M + 1))
        keys = sorted({(int(rng.integers(0, 8)), int(rng.integers(0, 8))) for _ in range(3 * M)})
        keys = keys[:n]
        for k, (h, l) in enumerate(keys):
            hi[b, k], lo[b, k], cnt[b, k] = h, l, rng.integers(0, 3)
        if keys and b % 2:
            khi[b], klo[b] = keys[int(rng.integers(0, len(keys)))]
    return hi, lo, cnt, khi, klo


@pytest.mark.parametrize("seed", [0, 1])
def test_bag_put_and_count(seed):
    hi, lo, cnt, khi, klo = _bags(seed)
    want = [np.asarray(x) for x in jax.vmap(jbag.bag_put)(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(cnt), jnp.asarray(khi),
        jnp.asarray(klo))]
    t = [torch.from_numpy(x) for x in (hi, lo, cnt, khi, klo)]
    got = [x.numpy() for x in tbag.bag_put(*t)]
    for label, w, g in zip(("hi", "lo", "cnt", "existed", "overflow"), want, got):
        assert np.array_equal(w, g), label
    assert want[3].any() and (~want[3]).any() and want[4].any()
    want_n = np.asarray(jax.vmap(jbag.bag_count)(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(cnt), jnp.asarray(khi),
        jnp.asarray(klo)))
    assert np.array_equal(tbag.bag_count(*t).numpy(), want_n)


def test_bag_discard_at():
    hi, lo, cnt, khi, klo = _bags(2)
    slot = np.random.default_rng(3).integers(0, cnt.shape[1], cnt.shape[0]).astype(np.int32)
    want = np.asarray(jax.vmap(jbag.bag_discard_at)(jnp.asarray(cnt), jnp.asarray(slot)))
    got = tbag.bag_discard_at(torch.from_numpy(cnt), torch.from_numpy(slot).long())
    assert np.array_equal(got.numpy(), want)
