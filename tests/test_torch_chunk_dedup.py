"""The port's dedup stage (raft_tpu_torch/checker/util.py chunk_dedup and
chunk_dedup_plain) against the JAX reference's own formulas, bit for bit:
the probe of every run through raft_tpu/checker/util.py:21 probe_sorted,
_st_dedup's first occurrence (raft_tpu/checker/device_bfs.py:413-420,
``sort_u64_with_idx``) and _st_finish's run (:495, ``sort_u64``). A numpy
replay of csrc/chunk_dedup.cu's design (buckets as runs of fine bins of the
top key bits, equi-depth over a sample of the lanes; one sort of (key,
lane) pairs a bucket, only first occurrences probing the
runs, each in the slice of the runs that its bucket's key range maps to,
found by the kernel's 32-ary warp search, then staged whole in groups of
runs or sampled every step-th entry) must give the same answer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.checker.util import probe_sorted as jax_probe_sorted
from raft_tpu.ops.hashing import U64_MAX, ne_u64, sort_u64, sort_u64_with_idx
from raft_tpu_torch.checker.util import MAX_RUNS, chunk_dedup, chunk_dedup_plain
from raft_tpu_torch.convert import fps_from_u64

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

# csrc/chunk_dedup.cu's geometry: a tile of sorted positions, the run
# entries a block stages, the entries a key reads at once between two
# samples, the most buckets
CD_T, CD_CAP, CD_POOL, CD_SCAN, CD_SPK, CD_MIN_SAMPLES, CD_MAX_LOG_B = (
    256, 2048, 2048, 16, 2, 64, 12)
CD_FINE_BITS, CD_SAMPLES = 12, 4096


def _reference(fps, runs, run_len):
    """(new, run, order) by the reference's formulas (numpy u64)."""
    n = len(fps)
    if n == 0:
        return np.zeros(0, bool), np.full(run_len, U64_MAX, np.uint64), np.zeros(0, np.int32)
    f = jnp.asarray(fps)
    fresh = ne_u64(f, U64_MAX)
    for r in runs:
        fresh = fresh & ~jax_probe_sorted(jnp.asarray(r), f)
    rf, order = sort_u64_with_idx(f)
    first_s = jnp.concatenate([jnp.ones((1,), bool), ne_u64(rf[1:], rf[:-1])])
    first = jnp.zeros((n,), bool).at[order].set(first_s)
    new = fresh & first
    run = np.asarray(sort_u64(jnp.where(new, f, U64_MAX)))
    run = np.concatenate([run, np.full(run_len - n, U64_MAX, np.uint64)])
    return np.asarray(new), run, np.asarray(order).astype(np.int32)


def _warp_search(a, x) -> int:
    """cd_warp_search: the first i with a[i] >= x, len(a) when none, by 32
    samples a level."""
    lo, hi = 0, len(a)
    while lo < hi:
        step = (hi - lo + 31) // 32
        pos = lo + np.arange(32) * step
        ok = pos < hi
        v = a[np.minimum(pos, hi - 1)]
        below = ok & (v < x)
        c = int(below.sum())
        assert below[:c].all()  # the samples below x come first
        if c == 0:
            hi = lo
        else:
            lo = lo + (c - 1) * step + 1
            hi = min(lo - 1 + step, hi)
    return lo


def _probe_tile(keys, cand, runs, bounds):
    """cd_probe over one tile: keys ascending (u64), cand the first
    occurrences (position p on thread p % CD_T), bounds each run's slice
    of the bucket; returns fresh."""
    fresh = cand.copy()
    r = 0
    while r < len(runs) and fresh.any():
        # a group: one sampled run, or the runs whose slices fit the pool together
        total, r1, step = bounds[r][1] - bounds[r][0], r + 1, 1
        if total > CD_POOL:  # CD_SPK samples a thread with a fresh key
            nf = len({p % CD_T for p in np.nonzero(fresh)[0]})
            step = -(-total // min(CD_POOL, max(CD_MIN_SAMPLES, CD_SPK * nf)))
        else:
            while r1 < len(runs) and total + bounds[r1][1] - bounds[r1][0] <= CD_POOL:
                total += bounds[r1][1] - bounds[r1][0]
                r1 += 1
        pools = [runs[u][bounds[u][0]:bounds[u][1]:step] for u in range(r, r1)]
        assert sum(map(len, pools)) <= CD_POOL
        for p in np.nonzero(fresh)[0]:
            q = keys[p]
            for u, pool in zip(range(r, r1), pools):
                a, (lo, hi) = runs[u], bounds[u]
                plo = int(np.searchsorted(pool, q, "left"))
                hit = plo < len(pool) and pool[plo] == q
                if not hit and step > 1 and plo > 0:
                    glo, ghi = lo + (plo - 1) * step + 1, min(lo + plo * step, hi)
                    while ghi - glo > CD_SCAN:
                        mid = (glo + ghi) // 2
                        glo, ghi = (mid + 1, ghi) if a[mid] < q else (glo, mid + 1)
                    hit = bool((a[glo:ghi] == q).any())
                if hit:
                    fresh[p] = False
                    break
        r = r1
    return fresh


def _replay(fps, runs, run_len):
    """The kernel's design in numpy: (new, run, order)."""
    n = len(fps)
    log_b = min(max((max(n, 1) - 1).bit_length() - 8, 0), CD_MAX_LOG_B)
    B = 1 << log_b
    real = fps != U64_MAX
    shift = np.uint64(64 - CD_FINE_BITS)
    # fine bin f (the top bits) goes to bucket floor(samples below f * B /
    # real samples), the samples CD_SAMPLES evenly spaced lanes' real keys
    sample = fps[np.arange(CD_SAMPLES) * n // CD_SAMPLES] if n else np.zeros(0, np.uint64)
    sample = sample[sample != U64_MAX]
    counts = np.bincount((sample >> shift).astype(np.int64), minlength=1 << CD_FINE_BITS)
    below = np.cumsum(counts) - counts
    fine = np.minimum(B - 1, below * B // len(sample)) if len(sample) else 0 * below
    bucket = fine[(fps >> shift).astype(np.int64)]
    new = np.zeros(n, bool)
    order, emitted = [], []

    def first_key(j):  # bucket j's first key: that of its first fine bin
        f = int(np.searchsorted(fine, j, "left")) if j < B else 1 << CD_FINE_BITS
        return U64_MAX if f == 1 << CD_FINE_BITS else np.uint64(f) << shift

    for b in range(B):
        # the bucket's slice of each run: from its first key to the next
        # bucket's, the last bucket's to the run's first U64_MAX
        lo_key = first_key(b) if b else np.uint64(0)
        bounds = [(_warp_search(a, lo_key), _warp_search(a, first_key(b + 1))) for a in runs]
        lanes = np.nonzero(real & (bucket == b))[0]
        lanes = lanes[np.lexsort((lanes, fps[lanes]))]
        keys = fps[lanes]
        first = np.ones(len(keys), bool)
        first[1:] = keys[1:] != keys[:-1]
        for s0 in range(0, len(keys), CD_CAP):
            tile = slice(s0, s0 + CD_CAP)
            fresh = _probe_tile(keys[tile], first[tile], runs, bounds)
            new[lanes[tile]] = fresh
            emitted.append(keys[tile][fresh])
        order.append(lanes)
    order.append(np.nonzero(~real)[0])  # the sentinel bucket in lane order
    run = np.concatenate(emitted + [np.zeros(0, np.uint64)])
    run = np.concatenate([run, np.full(run_len - len(run), U64_MAX, np.uint64)])
    return new, run, np.concatenate(order).astype(np.int32)


def _sorted_run(vals, pad):
    v = np.unique(vals)
    v = v[v != U64_MAX]
    return np.concatenate([v, np.full(pad, U64_MAX, np.uint64)])


def _case(kind: str, n: int, n_runs: int, seed: int):
    """(fps, runs) of one case: fingerprints from a pool (duplicates,
    values across the whole u64 range), about 10% sentinel lanes, runs
    holding parts of the pool and keys of their own (a 2^17-entry first
    run, so a tile's slice of it is sampled, not staged whole)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64 - 1, max(1, n // 3), dtype=np.uint64)
    fps = pool[rng.integers(0, len(pool), n)]
    fps[rng.random(n) < 0.1] = U64_MAX
    runs = []
    for r in range(n_runs):
        own = rng.integers(0, 2**64 - 1, (1 << 17) if r == 0 else 50 + 97 * r, dtype=np.uint64)
        part = pool[rng.random(len(pool)) < 0.4 / (r + 1)]
        runs.append(_sorted_run(np.concatenate([own, part]), pad=r + 3))
    if kind == "every":  # a run holding every key
        runs.append(_sorted_run(fps, pad=5))
    elif kind == "ends":  # keys equal to a run's first and last real entry
        r = runs[0]  # padded with 3 sentinels
        fps[: n // 2] = r[0]
        fps[n // 2:] = r[len(r) - 4]
    elif kind == "equal":
        fps[:] = pool[0]
    elif kind == "sentinel":
        fps[:] = U64_MAX
    elif kind == "narrow":  # one bucket holds every real key (the kernel's wide-bucket path)
        fps = np.uint64(1 << 63) + rng.integers(0, 5000, n).astype(np.uint64)
        runs.append(_sorted_run(fps[::3], pad=1))
    return fps, runs


CASES = [
    ("random", 0, 4), ("random", 1, 4), ("random", 255, 4), ("random", 256, 4),
    ("random", 257, 4), ("random", 2047, 4), ("random", 2048, 4), ("random", 2049, 4),
    ("random", 3000, 0), ("random", 3000, 1), ("random", 3000, 32), ("every", 3000, 4),
    ("ends", 600, 4), ("equal", 3000, 4), ("sentinel", 3000, 4), ("narrow", 3000, 2),
]


@pytest.mark.parametrize("kind,n,n_runs", CASES)
def test_chunk_dedup_matches_reference(kind, n, n_runs):
    fps, runs = _case(kind, n, n_runs, seed=n + n_runs)
    run_len = n + 7
    want_new, want_run, want_order = _reference(fps, runs, run_len)
    t_fps, t_runs = fps_from_u64(fps), [fps_from_u64(r) for r in runs]
    new, run = chunk_dedup(t_fps, t_runs, run_len)
    assert np.array_equal(new.numpy(), want_new)
    assert torch.equal(run, fps_from_u64(want_run))
    new_o, run_o, order = chunk_dedup_plain(t_fps, t_runs, run_len, with_order=True)
    assert torch.equal(new_o, new) and torch.equal(run_o, run)
    assert order.dtype == torch.int32 and np.array_equal(order.numpy(), want_order)
    r_new, r_run, r_order = _replay(fps, runs, run_len)
    assert np.array_equal(r_new, want_new) and np.array_equal(r_run, want_run)
    assert np.array_equal(r_order, want_order)
    if kind == "every":
        assert not want_new.any()
    if kind == "random" and n >= 2047 and n_runs:
        assert 0 < want_new.sum() < len(np.unique(fps))  # hits and misses both


def test_warp_search_matches_searchsorted():
    rng = np.random.default_rng(7)
    for size in (0, 1, 31, 32, 33, 1000, 1 << 16):
        a = np.sort(rng.integers(0, 50, size).astype(np.uint64))
        for x in np.concatenate([a[:40], np.arange(-1, 52, 5).clip(0).astype(np.uint64)]):
            assert _warp_search(a, x) == np.searchsorted(a, x, "left")


def test_chunk_dedup_refuses_bad_arguments():
    fps = fps_from_u64(np.arange(10, dtype=np.uint64))
    with pytest.raises(ValueError, match="run_len"):
        chunk_dedup(fps, [], 9)
    # an empty run answers "absent", as no run does
    new, run = chunk_dedup(fps, [fps[:0]], 10)
    assert bool(new.all()) and torch.equal(run, fps)
    assert MAX_RUNS == 32
