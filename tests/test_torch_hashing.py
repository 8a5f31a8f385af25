"""Parity of the port's fingerprint arithmetic (raft_tpu_torch/ops/hashing.py)
with the JAX reference (raft_tpu/ops/hashing.py), bit for bit, on random
inputs made with numpy; plus the sign-flipped fingerprint encoding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import hashing as jh
from raft_tpu_torch.convert import fps_from_u64, fps_to_u64
from raft_tpu_torch.ops import hashing as th

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _u32(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def test_mix32_and_combine_pair():
    rng = np.random.default_rng(0)
    a, b = _u32(rng, 4096), _u32(rng, 4096)
    a[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    ta = torch.from_numpy(a.astype(np.int64))
    tb = torch.from_numpy(b.astype(np.int64))
    want_mix = np.asarray(jh.mix32(jnp.asarray(a)))
    assert np.array_equal(th.mix32(ta).numpy(), want_mix.astype(np.int64))
    want = np.asarray(jh.combine_pair(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(fps_to_u64(th.combine_pair(ta, tb)), want)


@pytest.mark.parametrize("seed", [0, 7])
def test_hash_lanes(seed):
    rng = np.random.default_rng(seed + 1)
    vec = rng.integers(-(1 << 31), 1 << 31, (257, 37), dtype=np.int64).astype(np.int32)
    vec[0] = 0
    want_a, want_b = (np.asarray(x) for x in jh.hash_lanes_pair(jnp.asarray(vec), seed))
    got_a, got_b = th.hash_lanes_pair(torch.from_numpy(vec), seed)
    assert np.array_equal(got_a.numpy(), want_a.astype(np.int64))
    assert np.array_equal(got_b.numpy(), want_b.astype(np.int64))
    want = np.asarray(jh.hash_lanes(jnp.asarray(vec), seed))
    assert np.array_equal(fps_to_u64(th.hash_lanes(torch.from_numpy(vec), seed)), want)
    assert th.seed_salts(seed) == tuple(int(x) for x in jh.seed_salts(seed))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("mcap", [1 << 10, 1 << 21])
def test_memo_slot(seed, mcap):
    rng = np.random.default_rng(seed)
    fps = rng.integers(0, np.iinfo(np.uint64).max, 4096, dtype=np.uint64, endpoint=True)
    fps[:3] = [0, U64_MAX, np.uint64(1 << 63)]
    want = np.asarray(jh.memo_slot(jnp.asarray(fps), mcap))
    got = th.memo_slot(fps_from_u64(fps), mcap).numpy()
    assert np.array_equal(got, want.astype(np.int64))


def test_sign_flip_preserves_u64_order():
    rng = np.random.default_rng(3)
    fps = rng.integers(0, np.iinfo(np.uint64).max, 5000, dtype=np.uint64, endpoint=True)
    fps[:6] = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, U64_MAX]
    enc = fps_from_u64(fps)
    assert int(fps_from_u64(np.array([U64_MAX]))[0]) == th.INT64_MAX
    assert np.array_equal(fps_to_u64(th.sort_fps(enc)), np.sort(fps))
    s, idx = th.sort_fps_with_idx(torch.cat([enc, enc]))
    assert np.array_equal(fps_to_u64(s), np.sort(np.concatenate([fps, fps])))
    assert np.array_equal(idx.numpy(), np.argsort(np.concatenate([fps, fps]), kind="stable"))
    assert np.array_equal(fps_to_u64(enc), fps)


def test_join_split_roundtrip():
    rng = np.random.default_rng(5)
    hi, lo = _u32(rng, 1000).astype(np.int64), _u32(rng, 1000).astype(np.int64)
    enc = th.join_enc(torch.from_numpy(hi), torch.from_numpy(lo))
    want = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    assert np.array_equal(fps_to_u64(enc), want)
    h2, l2 = th.split_enc(enc)
    assert np.array_equal(h2.numpy(), hi) and np.array_equal(l2.numpy(), lo)
