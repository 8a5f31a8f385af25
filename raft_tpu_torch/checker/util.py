"""Capacity-growth policy, the seen-run probe and the compaction / emit
of the chunk pipeline.

Counterpart of ``raft_tpu/checker/util.py`` plus the lane-compaction and
dedup steps of ``raft_tpu/checker/device_bfs.py``. Three kernels live here:

  ``probe_runs``      (csrc/probe_runs.cu) membership of each fingerprint
                      in a set of sorted runs, folded with "fresh";
  ``chunk_sort``      (csrc/chunk_sort.cu) one stable sort of the chunk's
                      fingerprints: the first-occurrence dedup and the
                      chunk's sorted run of new fingerprints;
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

import torch

from .. import kernels
from ..ops.hashing import INT64_MAX, sort_fps, sort_fps_with_idx

GROWTH = 4  # enlarge factor per growth step
HEADROOM = 3  # grow when the next wave could need more than cap/HEADROOM
I32_MAX = 2**31 - 1  # "no violation" sentinel in journal folds
MAX_RUNS = 32  # runs one probe_runs launch takes (csrc/probe_runs.cu)
CHUNK_SORT_TILE = 2048  # pairs one chunk_sort block sorts (csrc/chunk_sort.cu)


def next_cap(needed: int, cap: int, max_cap: int, growth: int, unit: int) -> int:
    """Smallest growth**k * cap >= needed, rounded up to a multiple of
    unit, never exceeding max_cap (rounded down to a unit multiple)."""
    eff_max = max(cap, (max_cap // unit) * unit)
    new = cap
    while new < needed and new < eff_max:
        new = min(new * growth, eff_max)
    new = ((new + unit - 1) // unit) * unit
    return min(new, eff_max)


# ---------------- probe_runs ----------------


def probe_sorted(sorted_arr: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Membership of vals in a sorted enc run padded with INT64_MAX
    (``raft_tpu/checker/util.py:21``)."""
    pos = torch.searchsorted(sorted_arr, vals)
    pos = torch.clamp(pos, 0, sorted_arr.shape[0] - 1)
    return sorted_arr[pos] == vals


def probe_runs_plain(fps: torch.Tensor, runs) -> torch.Tensor:
    """fresh = (fp is a real fingerprint) and (fp is in no run)."""
    fresh = fps != INT64_MAX
    for r in runs:
        fresh = fresh & ~probe_sorted(r, fps)
    return fresh


def probe_runs(fps: torch.Tensor, runs) -> torch.Tensor:
    """``fps != INT64_MAX`` and absent from every sorted run in ``runs``
    (each a 1-D enc int64 tensor, INT64_MAX-padded; an empty list or a
    zero-length run answers "absent"). The dedup probe of
    ``raft_tpu/checker/device_bfs.py:401 _st_dedup``."""
    if kernels.route(fps) == "cpu":
        return probe_runs_plain(fps, runs)
    k = kernels.PROBE_RUNS
    kernels.require(fps, torch.int64, "fps", ndim=1)
    runs = [r for r in runs if r.numel()]
    if len(runs) > MAX_RUNS:
        raise ValueError(f"probe_runs takes at most {MAX_RUNS} runs")
    for r in runs:
        kernels.require(r, torch.int64, "run", ndim=1)
    ptrs = (ctypes.c_longlong * MAX_RUNS)(*[r.data_ptr() for r in runs])
    lens = (ctypes.c_longlong * MAX_RUNS)(*[r.numel() for r in runs])
    out = torch.empty(fps.shape, dtype=torch.bool, device=fps.device)
    rc = k.lib.probe_runs(ctypes.cast(ptrs, ctypes.c_void_p), len(runs),
                          ctypes.cast(lens, ctypes.c_void_p), fps.data_ptr(),
                          out.data_ptr(), fps.numel(), kernels.stream(fps.device))
    k.launched(rc)
    return out


# ---------------- chunk_sort ----------------


def chunk_sort_plain(fps: torch.Tensor, fresh: torch.Tensor, run_len: int):
    """Plain version of ``chunk_sort``: the reference's two sorts
    (``device_bfs.py:413-420`` first occurrence, ``:495`` run emit)."""
    rf, order = sort_fps_with_idx(fps)
    first_s = torch.ones_like(fresh)
    first_s[1:] = rf[1:] != rf[:-1]
    new = fresh & torch.empty_like(first_s).scatter_(0, order, first_s)
    run = sort_fps(torch.where(new, fps, INT64_MAX))
    if run_len > run.numel():
        pad = torch.full((run_len - run.numel(),), INT64_MAX, dtype=torch.int64,
                         device=fps.device)
        run = torch.cat([run, pad])
    return new, run


def chunk_sort(fps: torch.Tensor, fresh: torch.Tensor, run_len: int):
    """First occurrence and the sorted run of a chunk's fingerprints.

    ``fps`` is enc int64 [n], ``fresh`` bool [n] (not in any seen run).
    Returns ``(new, run)``: new[i] = fresh[i] and no lane before i holds
    fps[i]; run = the fingerprints of the new lanes ascending, padded
    with INT64_MAX to ``run_len`` (>= n) lanes."""
    if run_len < fps.numel():
        raise ValueError("chunk_sort: run_len must be at least len(fps)")
    if kernels.route(fps) == "cpu":
        return chunk_sort_plain(fps, fresh, run_len)
    k = kernels.CHUNK_SORT
    n = fps.numel()
    kernels.require(fps, torch.int64, "fps", ndim=1)
    kernels.require(fresh, torch.bool, "fresh", shape=(n,))
    np_ = CHUNK_SORT_TILE
    while np_ < n:
        np_ <<= 1
    dev = fps.device
    keys = torch.empty((2, np_), dtype=torch.int64, device=dev)
    idx = torch.empty((2, np_), dtype=torch.int32, device=dev)
    blk = torch.empty(max(1, -(-n // 1024)), dtype=torch.int32, device=dev)
    new = torch.empty(n, dtype=torch.bool, device=dev)
    run = torch.empty(run_len, dtype=torch.int64, device=dev)
    rc = k.lib.chunk_sort(fps.data_ptr(), fresh.data_ptr(), n, np_, keys[0].data_ptr(),
                          idx[0].data_ptr(), keys[1].data_ptr(), idx[1].data_ptr(),
                          blk.data_ptr(), new.data_ptr(), run.data_ptr(), run_len,
                          kernels.stream(dev))
    k.launched(rc)
    return new, run


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
    the drop region, bit-identical to ``emit_append``. The emit of
    ``raft_tpu/checker/device_bfs.py:462-485``."""
    if kernels.route(buf) == "cpu":
        return append_rows_plain(buf, src, esel, count, cap)
    k = kernels.COMPACT_APPEND
    W = 1 if buf.ndim == 1 else buf.shape[1]
    kernels.require(buf, torch.int32, "buf")
    kernels.require(src, torch.int32, "src")
    kernels.require(esel, torch.int32, "esel", ndim=1)
    kernels.require(count, torch.int64, "count")
    B = esel.numel()
    if buf.shape[0] < cap + B or src.numel() != src.shape[0] * W:
        raise ValueError("append_rows: buf needs cap + len(esel) rows of src's width")
    rc = k.lib.append_rows(buf.data_ptr(), src.data_ptr(), src.shape[0],
                           esel.data_ptr(), B, W, count.data_ptr(), cap,
                           kernels.stream(buf.device))
    k.launched(rc)
