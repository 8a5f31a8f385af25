"""The owner route of the sharded chunk step: which shard owns each new
candidate, and the send blocks of the exchange.

Counterpart of ``raft_tpu/parallel/sharded.py:_cs_pre`` steps 4 (:576-606)
with the route-overflow bit and the routed-lane count of its ``pre_stats``
(:608-615). ``owner_route`` launches the ``owner_route`` kernel
(csrc/owner_route.cu) on CUDA tensors and runs ``owner_route_plain``, the
reference's formula in torch, on CPU tensors.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..ops.hashing import INT64_MAX

MAX_OWNERS = 1024  # the largest mesh the kernel routes (csrc/owner_route.cu OR_MAX_OWNERS)
_THREADS = 256  # lanes per block of the kernel's passes (OR_THREADS)
_M32 = 0xFFFFFFFF


def lane_rank(rank: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """The action rank of each compacted lane: rank.flat[sel], -1 past the
    compacted prefix (sel = C * A)."""
    flat = rank.reshape(-1)
    ext = torch.cat([flat, torch.full((1,), -1, dtype=flat.dtype, device=flat.device)])
    return ext[sel.to(torch.int64)]


def owner_route_plain(fps, flatc, sel, rank, lgid0: int, A: int, D: int, RC: int):
    """Plain version of ``owner_route``: the reference's owner routing
    (``sharded.py:576-606``): fp mod D in u32 pieces, a stable argsort by
    owner, positions from ``searchsorted``, and a scatter into the D blocks
    of RC slots."""
    VC, W = flatc.shape
    dev = fps.device
    u = fps ^ (-(1 << 63))  # the u64 value's bits
    hi, lo = (u >> 32) & _M32, u & _M32
    t32 = (1 << 32) % D
    owner = ((hi % D) * t32 + lo % D) % D
    owner = torch.where(fps == INT64_MAX, D, owner)
    order = torch.argsort(owner, stable=True)
    owner_s = owner[order]
    start = torch.searchsorted(owner_s, torch.arange(D + 1, dtype=torch.int64, device=dev))
    pos = torch.arange(VC, dtype=torch.int64, device=dev) - start[owner_s]
    ok = (owner_s < D) & (pos < RC)
    route_ovf = bool(((owner_s < D) & (pos >= RC)).any())
    slot = torch.where(ok, owner_s * RC + pos, D * RC)
    sel64 = sel.to(torch.int64)
    payload = torch.cat([
        flatc, (lgid0 + sel64 // A).to(torch.int32)[:, None],
        (sel64 % A).to(torch.int32)[:, None], lane_rank(rank, sel).to(torch.int32)[:, None],
    ], dim=1)
    send_pay = torch.zeros((D * RC + 1, W + 3), dtype=torch.int32, device=dev)
    send_pay[slot] = payload[order]
    send_fps = torch.full((D * RC + 1,), INT64_MAX, dtype=torch.int64, device=dev)
    send_fps[slot] = torch.where(ok, fps[order], INT64_MAX)
    route_stats = torch.tensor([4 if route_ovf else 0, int(ok.sum())], dtype=torch.int64,
                               device=dev)
    return send_pay[:-1], send_fps[:-1], route_stats


def owner_route(fps: torch.Tensor, flatc: torch.Tensor, sel: torch.Tensor, rank: torch.Tensor,
                lgid0: int, A: int, D: int, RC: int):
    """Route the VC compacted lanes of a chunk to their owner shards.

    ``fps`` enc int64 [VC] (INT64_MAX: an invalid lane), ``flatc`` int32
    [VC, W] successor rows, ``sel`` int32 [VC] flat lanes of the [C, A]
    candidate grid, ``rank`` int32 [C, A] action ranks, ``lgid0`` the
    chunk's first parent lgid (base_lgid + cursor). Returns ``(send_pay
    int32 [D * RC, W + 3], send_fps int64 [D * RC], route_stats int64
    [2])``: block d of the sends holds, in lane order, the lanes whose
    fingerprint is d mod D, each row [state, parent lgid, candidate,
    action rank] (zeros and INT64_MAX in unfilled slots); route_stats is
    [4 if a block overflowed RC else 0, lanes routed]."""
    if not 1 <= D <= MAX_OWNERS:
        raise ValueError(f"owner_route routes at most {MAX_OWNERS} shards, got D={D}")
    if kernels.route(fps) == "cpu":
        return owner_route_plain(fps, flatc, sel, rank, lgid0, A, D, RC)
    k = kernels.OWNER_ROUTE
    VC, W = flatc.shape
    kernels.require(fps, torch.int64, "fps", shape=(VC,))
    kernels.require(flatc, torch.int32, "flatc", ndim=2)
    kernels.require(sel, torch.int32, "sel", shape=(VC,))
    kernels.require(rank, torch.int32, "rank")
    dev = fps.device
    nblk = -(-VC // _THREADS)
    hist = torch.empty(max(1, (D + 1) * nblk), dtype=torch.int32, device=dev)
    lane_of_slot = torch.empty(D * RC, dtype=torch.int32, device=dev)
    send_pay = torch.empty((D * RC, W + 3), dtype=torch.int32, device=dev)
    send_fps = torch.empty(D * RC, dtype=torch.int64, device=dev)
    route_stats = torch.empty(2, dtype=torch.int64, device=dev)
    rc = k.lib.owner_route(fps.data_ptr(), VC, flatc.data_ptr(), W, sel.data_ptr(),
                           rank.data_ptr(), rank.numel(), A, int(lgid0), D, RC, hist.data_ptr(),
                           nblk, lane_of_slot.data_ptr(), send_pay.data_ptr(),
                           send_fps.data_ptr(), route_stats.data_ptr(), kernels.stream(dev))
    k.launched(rc)
    return send_pay, send_fps, route_stats
