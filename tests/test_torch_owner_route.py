"""The sharded engine's owner route on the CPU against the reference's
formula: ``owner_route_plain`` (the CPU path of the ``owner_route`` kernel)
against ``raft_tpu/parallel/sharded.py:_cs_pre``'s routing (:576-606, with
the route-overflow bit and the routed-lane count of its pre_stats), which
cannot be called alone and is copied here as jnp. Seeded fingerprints with
the high bits set and U64_MAX lanes, D in {1, 2, 3, 4, 8}, route caps with
and without overflow; send_pay, send_fps, the overflow bit and n_routed
compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops.hashing import U64_MAX, eq_u64, split_u64
from raft_tpu_torch.convert import fps_from_u64, fps_to_u64
from raft_tpu_torch.parallel.route import MAX_OWNERS, owner_route, owner_route_plain

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

C, A, W, K = 32, 12, 9, 7
VC = 160


def reference_route(fps, flatc, sel, rank, base_lgid, cursor, D, RC):
    """raft_tpu/parallel/sharded.py:576-606 and the route lanes of
    :608-615, verbatim but for the arguments."""
    parent_lgid = base_lgid + cursor + sel // A
    cand = sel % A
    lane_rank = jnp.concatenate(
        [rank.reshape(-1), jnp.full((1,), -1, rank.dtype)]
    )[sel]  # [VC] rank per compacted lane (drop row -> -1)
    payload = jnp.concatenate(
        [flatc, parent_lgid[:, None], cand[:, None],
         lane_rank[:, None].astype(jnp.int32)], axis=1
    )  # [VC, W+3] i32
    fhi, flo = split_u64(fps)
    t32 = np.uint32((1 << 32) % D)
    owner = (((fhi % np.uint32(D)) * t32 + flo % np.uint32(D))
             % np.uint32(D)).astype(jnp.int32)
    owner = jnp.where(eq_u64(fps, U64_MAX), D, owner)  # invalid -> drop
    order = jnp.argsort(owner, stable=True)
    owner_s = owner[order]
    fps_s = fps[order]
    start = jnp.searchsorted(owner_s, jnp.arange(D + 1), side="left")
    pos_in_owner = jnp.arange(VC) - start[owner_s]
    ok = (owner_s < D) & (pos_in_owner < RC)
    route_ovf = jnp.any((owner_s < D) & (pos_in_owner >= RC))
    n_routed = jnp.sum(ok)
    slot = jnp.where(ok, owner_s * RC + pos_in_owner, D * RC)
    send_pay = jnp.zeros((D * RC + 1, W + 3), jnp.int32).at[slot].set(payload[order])[:-1]
    send_fps = jnp.full((D * RC + 1,), U64_MAX, jnp.uint64).at[slot].set(
        jnp.where(ok, fps_s, U64_MAX))[:-1]
    return (np.asarray(send_pay), np.asarray(send_fps), bool(route_ovf), int(n_routed))


def _inputs(seed: int, n_valid: int):
    """A chunk's compacted lanes: ``n_valid`` valid lanes (ascending flat
    candidates of the [C, A] grid, fingerprints with the high bits set and
    a few equal ones), then invalid lanes (sel = C * A, U64_MAX)."""
    rng = np.random.default_rng(seed)
    fps = rng.integers(0, np.iinfo(np.uint64).max, VC, dtype=np.uint64, endpoint=True)
    fps[: n_valid // 2] |= np.uint64(1 << 63)
    fps[5:9] = fps[1]  # duplicates route to one owner, in lane order
    fps[n_valid:] = U64_MAX
    sel = np.full(VC, C * A, np.int32)
    sel[:n_valid] = np.sort(rng.choice(C * A, n_valid, replace=False)).astype(np.int32)
    flatc = rng.integers(-(1 << 31), 1 << 31, (VC, W), dtype=np.int64).astype(np.int32)
    rank = rng.integers(0, K, (C, A), dtype=np.int64).astype(np.int32)
    return fps, flatc, sel, rank


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("overflow", [False, True])
def test_owner_route_plain_matches_reference(D, overflow):
    n_valid = 137
    fps, flatc, sel, rank = _inputs(D * 10 + overflow, n_valid)
    # RC = VC can never overflow (the default); a cap below the busiest
    # owner's count overflows at every D (at D = 1 every lane has owner 0)
    RC = max(1, n_valid // (2 * D)) if overflow else VC
    base_lgid, cursor = 1000, 64
    want_pay, want_fps, want_ovf, want_n = reference_route(
        jnp.asarray(fps), jnp.asarray(flatc), jnp.asarray(sel), jnp.asarray(rank),
        base_lgid, cursor, D, RC)
    pay, sfps, route = owner_route_plain(
        fps_from_u64(fps), torch.from_numpy(flatc), torch.from_numpy(sel),
        torch.from_numpy(rank), base_lgid + cursor, A, D, RC)
    assert want_ovf == overflow
    assert np.array_equal(pay.numpy(), want_pay)
    assert np.array_equal(fps_to_u64(sfps), want_fps)
    assert int(route[0]) == (4 if want_ovf else 0) and int(route[1]) == want_n
    # the wrapper takes the plain version for CPU tensors
    pay2, sfps2, route2 = owner_route(
        fps_from_u64(fps), torch.from_numpy(flatc), torch.from_numpy(sel),
        torch.from_numpy(rank), base_lgid + cursor, A, D, RC)
    assert torch.equal(pay2, pay) and torch.equal(sfps2, sfps) and torch.equal(route2, route)


def test_owner_route_refuses_meshes_past_its_bound():
    fps, flatc, sel, rank = _inputs(0, 10)
    args = (fps_from_u64(fps), torch.from_numpy(flatc), torch.from_numpy(sel),
            torch.from_numpy(rank), 0, A)
    with pytest.raises(ValueError, match="at most 1024 shards"):
        owner_route(*args, MAX_OWNERS + 1, 4)
    with pytest.raises(ValueError):
        owner_route(*args, 0, 4)
