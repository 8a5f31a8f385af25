"""Capacity-growth policy, the seen-run probe and the compaction / emit
of the chunk pipeline.

Counterpart of ``raft_tpu/checker/util.py`` plus the lane-compaction and
dedup steps of ``raft_tpu/checker/device_bfs.py``. Two kernels live here:

  ``chunk_dedup``     (csrc/chunk_dedup.cu) the dedup stage of a chunk:
                      one sort of its fingerprints, the first occurrences
                      probed against a set of sorted runs, and the chunk's
                      sorted run of new fingerprints;
  ``compact_append``  (csrc/compact_append.cu) with two entry points:
                      ``compact_indices`` (mask -> dense worklist) and
                      ``append_rows`` (cursor append into a buffer with a
                      drop region past capacity).

Each wrapper launches its kernel on CUDA tensors and runs the plain
PyTorch version beside it on CPU tensors. Fingerprints are enc int64
(``ops/hashing.py``): the runs are sorted as int64, which is u64 order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..ops.hashing import INT64_MAX, sort_fps, sort_fps_with_idx

GROWTH = 4  # enlarge factor per growth step
HEADROOM = 3  # grow when the next wave could need more than cap/HEADROOM
I32_MAX = 2**31 - 1  # "no violation" sentinel in journal folds
MAX_RUNS = 32  # runs one chunk_dedup call takes (csrc/chunk_dedup.cu)
_DEDUP_SCRATCH: dict[int, int] = {}  # lanes -> chunk_dedup's scratch words


def next_cap(needed: int, cap: int, max_cap: int, growth: int, unit: int) -> int:
    """Smallest growth**k * cap >= needed, rounded up to a multiple of
    unit, never exceeding max_cap (rounded down to a unit multiple)."""
    eff_max = max(cap, (max_cap // unit) * unit)
    new = cap
    while new < needed and new < eff_max:
        new = min(new * growth, eff_max)
    new = ((new + unit - 1) // unit) * unit
    return min(new, eff_max)


# ---------------- chunk_dedup ----------------


def probe_sorted(sorted_arr: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Membership of vals in a sorted enc run padded with INT64_MAX
    (``raft_tpu/checker/util.py:21``)."""
    pos = torch.searchsorted(sorted_arr, vals)
    pos = torch.clamp(pos, 0, sorted_arr.shape[0] - 1)
    return sorted_arr[pos] == vals


def probe_runs_plain(fps: torch.Tensor, runs) -> torch.Tensor:
    """fresh = (fp is a real fingerprint) and (fp is in no run): the probe
    of ``raft_tpu/checker/device_bfs.py:401 _st_dedup``."""
    fresh = fps != INT64_MAX
    for r in runs:
        if r.numel():
            fresh = fresh & ~probe_sorted(r, fps)
    return fresh


def chunk_sort_plain(fps: torch.Tensor, fresh: torch.Tensor, run_len: int,
                     with_order: bool = False):
    """The reference's two sorts over a chunk with its fresh mask
    (``device_bfs.py:413-420`` first occurrence, ``:495`` run emit):
    new = fresh and no earlier lane holds the fingerprint; the run of the
    new fingerprints ascending, INT64_MAX-padded to ``run_len``; with
    ``with_order`` also the stable sort's permutation (int32)."""
    rf, order = sort_fps_with_idx(fps)
    first_s = torch.ones_like(fresh)
    first_s[1:] = rf[1:] != rf[:-1]
    new = fresh & torch.empty_like(first_s).scatter_(0, order, first_s)
    run = sort_fps(torch.where(new, fps, INT64_MAX))
    if run_len > run.numel():
        pad = torch.full((run_len - run.numel(),), INT64_MAX, dtype=torch.int64,
                         device=fps.device)
        run = torch.cat([run, pad])
    return (new, run, order.to(torch.int32)) if with_order else (new, run)


def chunk_dedup_plain(fps: torch.Tensor, runs, run_len: int, with_order: bool = False):
    """Plain version of ``chunk_dedup``: the probe, then the two sorts."""
    return chunk_sort_plain(fps, probe_runs_plain(fps, runs), run_len, with_order)


def chunk_dedup(fps: torch.Tensor, runs, run_len: int, with_order: bool = False):
    """The dedup stage of a chunk (``raft_tpu/checker/device_bfs.py:401
    _st_dedup`` and the run emit of ``:495``).

    ``fps`` is enc int64 [n], ``runs`` sorted enc int64 runs padded with
    INT64_MAX (the seen run and the wave's ladder; an empty list or a
    zero-length run answers "absent"). Returns ``(new, run)``: new[i] =
    fps[i] is a real fingerprint (not INT64_MAX), no lane before i holds it
    and no run holds it; run = the new fingerprints ascending, padded with
    INT64_MAX to ``run_len`` (>= n) lanes. ``with_order`` also returns the
    lanes ordered by (fingerprint, lane), int32 [n]: the stable sort's
    permutation, which the sharded engine emits in."""
    n = fps.numel()
    if run_len < n:
        raise ValueError("chunk_dedup: run_len must be at least len(fps)")
    if kernels.route(fps) == "cpu":
        return chunk_dedup_plain(fps, runs, run_len, with_order)
    k = kernels.CHUNK_DEDUP
    kernels.require(fps, torch.int64, "fps", ndim=1)
    if n >= 2**31:
        raise ValueError("chunk_dedup takes fewer than 2^31 lanes")
    live = []
    for r in runs:
        if r.numel():
            kernels.require(r, torch.int64, "run", ndim=1)
            live.append(r)
    if len(live) > MAX_RUNS:
        raise ValueError(f"chunk_dedup takes at most {MAX_RUNS} runs")
    words = _DEDUP_SCRATCH.get(n)
    if words is None:
        words = _DEDUP_SCRATCH[n] = k.lib.chunk_dedup_scratch(n)
    dev = fps.device
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    new = torch.empty(n, dtype=torch.bool, device=dev)
    run = torch.empty(run_len, dtype=torch.int64, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev) if with_order else None
    # the runs' device pointers, then their lengths
    spec = (ctypes.c_longlong * (2 * len(live)))(*[r.data_ptr() for r in live],
                                                  *[r.numel() for r in live])
    rc = k.lib.chunk_dedup(ctypes.addressof(spec), len(live), fps.data_ptr(), n, new.data_ptr(),
                           run.data_ptr(), run_len, order.data_ptr() if with_order else None,
                           scratch.data_ptr(), words, kernels.stream(dev))
    k.launched(rc)
    return (new, run, order) if with_order else (new, run)


# ---------------- compact_append: indices ----------------


def dense_prefix_sel(new: torch.Tensor, n_out: int, fill: int):
    """Plain version of ``compact_indices``: sel[j] = index of the j-th
    set lane of ``new`` for j < min(count, n_out), ``fill`` past that;
    lanes beyond the first n_out set ones are dropped (the reference's
    confined one-hot scatter, ``device_bfs.py:358-368`` and
    ``checker/util.py:30``). Returns (sel int32 [n_out], count 0-d
    int64)."""
    n = new.shape[0]
    pos = torch.cumsum(new.to(torch.int64), 0) - 1
    dst = torch.where(new, torch.clamp(pos, max=n_out), n_out)
    sel = torch.full((n_out + 1,), fill, dtype=torch.int32, device=new.device)
    lane = torch.arange(n, dtype=torch.int32, device=new.device)
    sel.scatter_(0, dst, lane)
    return sel[:n_out], new.sum()


def compact_indices(mask: torch.Tensor, n_out: int, fill: int):
    """Dense worklist of the set lanes of ``mask`` (bool [N]): returns
    (sel int32 [n_out], count 0-d int64) — see ``dense_prefix_sel``."""
    if kernels.route(mask) == "cpu":
        return dense_prefix_sel(mask, n_out, fill)
    k = kernels.COMPACT_APPEND
    kernels.require(mask, torch.bool, "mask", ndim=1)
    n = mask.numel()
    nblk = (n + 2047) // 2048  # csrc/compact_append.cu COMPACT_TILE
    scratch = torch.empty(nblk, dtype=torch.int64, device=mask.device)
    sel = torch.empty(n_out, dtype=torch.int32, device=mask.device)
    count = torch.empty((), dtype=torch.int64, device=mask.device)
    rc = k.lib.compact_indices(mask.data_ptr(), n, sel.data_ptr(), n_out, fill,
                               scratch.data_ptr(), count.data_ptr(), nblk,
                               kernels.stream(mask.device))
    k.launched(rc)
    return sel, count


# ---------------- compact_append: rows ----------------


def emit_append(buf: torch.Tensor, block: torch.Tensor, count, n_new, cap: int):
    """The reference's contiguous cursor-append (``checker/util.py:48``),
    in place: write ``block`` (B rows) into ``buf`` at row
    ``min(count, cap)``; rows [cap, cap+B) of ``buf`` are the drop
    region. Returns overflow = count + n_new > cap."""
    count = torch.as_tensor(count, device=buf.device)
    start = torch.clamp(count, max=cap)
    B = block.shape[0]
    idx = start + torch.arange(B, device=buf.device)
    buf.index_copy_(0, idx, block.to(buf.dtype))
    return count + n_new > cap


def append_rows_plain(buf, src, esel, count, cap: int):
    """Plain version of ``append_rows``: the gathered block
    ``concat(src, zero row)[esel]`` appended by ``emit_append``."""
    zero = torch.zeros((1,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    block = torch.cat([src, zero])[esel.to(torch.int64)]
    emit_append(buf, block, count.reshape(()), 0, cap)


def append_rows(buf: torch.Tensor, src: torch.Tensor, esel: torch.Tensor,
                count: torch.Tensor, cap: int) -> None:
    """Append the worklist rows ``src[esel[j]]`` (a zero row where
    ``esel[j] >= len(src)``) to ``buf`` IN PLACE at row
    ``min(count, cap)``, where ``count`` is a one-element int64 tensor
    read on the device (the cursor never visits the host). ``buf`` is
    [cap + B, W] (or 1-D [cap + B]) with B = len(esel): rows past cap are
    the drop region, bit-identical to ``emit_append``. ``src`` is [n, W]
    (or 1-D for a 1-D ``buf``), contiguous or a column range of wider
    rows (unit column stride: the sharded engine's received payload). The
    emit of ``raft_tpu/checker/device_bfs.py:462-485`` and
    ``raft_tpu/parallel/sharded.py:_cs_post`` (:661-684)."""
    W = 1 if buf.ndim == 1 else buf.shape[1]
    rows = src.view(-1, 1) if src.ndim == 1 else src
    if (rows.ndim != 2 or rows.shape[1] != W or rows.stride(1) != 1
            or (rows.shape[0] > 1 and rows.stride(0) < W)):
        raise ValueError("append_rows: src must be rows of buf's width with unit column stride")
    if kernels.route(buf) == "cpu":
        return append_rows_plain(buf, rows if buf.ndim == 2 else rows[:, 0], esel, count, cap)
    k = kernels.COMPACT_APPEND
    kernels.require(buf, torch.int32, "buf")
    kernels.require(esel, torch.int32, "esel", ndim=1)
    kernels.require(count, torch.int64, "count")
    if not rows.is_cuda or rows.dtype != torch.int32:
        raise TypeError("append_rows: src must be a CUDA int32 tensor")
    B = esel.numel()
    if buf.shape[0] < cap + B:
        raise ValueError("append_rows: buf needs cap + len(esel) rows")
    rc = k.lib.append_rows(buf.data_ptr(), rows.data_ptr(), rows.shape[0], max(W, rows.stride(0)),
                           esel.data_ptr(), B, W, count.data_ptr(), cap,
                           kernels.stream(buf.device))
    k.launched(rc)


# ---------------- trace replay ----------------


def replay_chain(model, device, state: np.ndarray, chain) -> list[tuple[str, dict]]:
    """The labelled trace of the candidates ``chain`` taken one after the
    other from ``state`` (a [W] int32 row): each goes through the model's
    guard and a one-lane apply on ``device`` (the reference's replays
    through ``_expand1``). Raises if a candidate is not enabled."""
    out = [("Initial predicate", model.decode(state))]
    cov = torch.zeros((len(model.ACTION_NAMES), 3), dtype=torch.int64, device=device)
    for cand in chain:
        batch = torch.from_numpy(np.ascontiguousarray(state[None])).to(device)
        valid, rank, _ovf, _scal = model.chunk_guards(batch, 1, cov)
        if not bool(valid[0, cand]):
            raise RuntimeError("journalled candidate not enabled on replay")
        sel = torch.tensor([cand], dtype=torch.int32, device=device)
        state = model.chunk_apply(batch, sel)[0].cpu().numpy()
        out.append((model.action_label(int(rank[0, cand]), cand), model.decode(state)))
    return out
