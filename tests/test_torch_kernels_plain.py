"""The plain PyTorch versions of the port's kernels (probe_runs,
compact_append, merge_runs) against the JAX reference's probe_sorted,
dense_prefix_sel + emit_append and sort-concat, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.checker.util import dense_prefix_sel as jax_dense_prefix_sel
from raft_tpu.checker.util import emit_append as jax_emit_append
from raft_tpu.checker.util import probe_sorted as jax_probe_sorted
from raft_tpu_torch import kernels
from raft_tpu_torch.checker.lsm import merge_many, merge_runs, merge_runs_plain
from raft_tpu_torch.checker.util import (
    append_rows, compact_indices, dense_prefix_sel, emit_append, probe_runs,
)
from raft_tpu_torch.convert import fps_from_u64

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _run(rng, n_real, size):
    v = np.sort(rng.integers(0, U64_MAX, n_real, dtype=np.uint64))
    return np.concatenate([v, np.full(size - n_real, U64_MAX)])


def test_probe_runs_matches_probe_sorted():
    rng = np.random.default_rng(0)
    runs = [_run(rng, 3000, 4096), _run(rng, 100, 256), _run(rng, 0, 64)]
    present = np.concatenate([runs[0][:3000], runs[1][:100]])
    q = rng.integers(0, U64_MAX, 2048, dtype=np.uint64)
    q[:1000] = rng.choice(present, 1000)
    q[-5:] = U64_MAX
    want = q != U64_MAX
    for r in runs:
        want &= ~np.asarray(jax_probe_sorted(jnp.asarray(r), jnp.asarray(q)))
    got = probe_runs(fps_from_u64(q), [fps_from_u64(r) for r in runs])
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(probe_runs(fps_from_u64(q), []).numpy(), q != U64_MAX)


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
def test_compact_indices_matches_dense_prefix_sel(density):
    rng = np.random.default_rng(1)
    n = 3000
    mask = rng.random(n) < density
    npos = (np.cumsum(mask) - 1).astype(np.int32)
    want = np.asarray(jax_dense_prefix_sel(jnp.asarray(mask), jnp.asarray(npos), n))
    sel, count = compact_indices(torch.from_numpy(mask), n, n)
    assert np.array_equal(sel.numpy(), want) and int(count) == mask.sum()
    # a worklist shorter than the set lanes drops the surplus, keeping order
    sel, count = compact_indices(torch.from_numpy(mask), 100, n)
    want_short = np.full(100, n, np.int32)
    idx = np.nonzero(mask)[0][:100]
    want_short[: len(idx)] = idx
    assert np.array_equal(sel.numpy(), want_short) and int(count) == mask.sum()
    assert np.array_equal(dense_prefix_sel(torch.from_numpy(mask), 100, n)[0].numpy(),
                          want_short)


@pytest.mark.parametrize("where", ["below", "exactly_full", "one_past_full", "past_cap"])
@pytest.mark.parametrize("width", [1, 7])
def test_append_rows_matches_emit_append(where, width):
    rng = np.random.default_rng(2)
    cap, B = 64, 16
    new = rng.random(B) < 0.6
    n_new = int(new.sum())
    count = {"below": 10, "exactly_full": cap - n_new,
             "one_past_full": cap - n_new + 1, "past_cap": cap + 3}[where]
    src = rng.integers(0, 1 << 30, (B, width)).astype(np.int32)
    shape = (cap + B, width) if width > 1 else (cap + B,)
    buf0 = rng.integers(0, 1 << 30, shape).astype(np.int32)
    npos = (np.cumsum(new) - 1).astype(np.int32)
    esel = np.asarray(jax_dense_prefix_sel(jnp.asarray(new), jnp.asarray(npos), B))
    srcp = src if width > 1 else src[:, 0]
    block = np.concatenate([srcp, np.zeros_like(srcp[:1])])[esel]
    want, want_ovf = jax_emit_append(jnp.asarray(buf0), jnp.asarray(block),
                                     jnp.int32(count), jnp.int32(n_new), cap)
    buf = torch.from_numpy(buf0.copy())
    append_rows(buf, torch.from_numpy(srcp.copy()), torch.from_numpy(esel.copy()),
                torch.tensor([count], dtype=torch.int64), cap)
    assert np.array_equal(buf.numpy(), np.asarray(want))
    buf2 = torch.from_numpy(buf0.copy())
    ovf = emit_append(buf2, torch.from_numpy(block), count, n_new, cap)
    assert np.array_equal(buf2.numpy(), np.asarray(want))
    assert bool(ovf) == bool(want_ovf) == (count + n_new > cap)


@pytest.mark.parametrize("target", [100, 700, 1100, 1500])
def test_merge_runs_is_sort_concat(target):
    rng = np.random.default_rng(3)
    a, b = _run(rng, 500, 512), _run(rng, 400, 512)
    b[:50] = a[:50]  # shared values merge as a multiset
    b[:400] = np.sort(b[:400])
    want = np.sort(np.concatenate([a, b]))[:target]
    want = np.concatenate([want, np.full(target - len(want), U64_MAX)])
    got = merge_runs(fps_from_u64(a), fps_from_u64(b), target)
    assert torch.equal(got, fps_from_u64(want))
    assert torch.equal(merge_runs_plain(fps_from_u64(a), fps_from_u64(b), target), got)
    c = _run(rng, 10, 64)
    want3 = np.sort(np.concatenate([a, b, c]))[:target]
    want3 = np.concatenate([want3, np.full(target - len(want3), U64_MAX)])
    got3 = merge_many([fps_from_u64(x) for x in (a, b, c)], target)
    assert torch.equal(got3, fps_from_u64(want3))


def test_wrappers_route_by_device():
    meta = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.route(meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.require(torch.zeros(3), torch.float32, "x")
    assert set(kernels.launch_counts()) == {
        "canon_memo", "probe_runs", "compact_append", "merge_runs", "raft_guard",
        "raft_apply", "raft_fold", "chunk_sort", "canon_tiered", "canon_signatures",
        "sim_pick", "raft_predicates", "raft_sim_check", "hash_rows", "pull_guard",
        "pull_apply", "pull_fold", "pull_predicates", "pull_sim_check", "kraft_guard",
        "kraft_apply", "kraft_fold", "kraft_predicates", "kraft_sim_check", "reconfig_guard",
        "reconfig_apply", "reconfig_fold", "reconfig_predicates", "reconfig_sim_check",
        "joint_guard", "joint_apply", "joint_fold", "joint_predicates", "joint_sim_check",
        "slot_canon", "kreconfig_guard", "kreconfig_apply", "kreconfig_fold",
        "kreconfig_predicates", "kreconfig_sim_check"}
