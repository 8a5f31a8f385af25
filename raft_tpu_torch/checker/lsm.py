"""Sorted fingerprint runs: the canon memo's geometry and the merge of
two sorted runs.

Counterpart of ``raft_tpu/checker/lsm.py`` (``CanonMemo``,
``pow2_at_least``) and of the reference's sort-concat merges
(``device_bfs.py:285 _seen_merge_spec``, ``:598-630`` ladder cascade,
``lsm.py:159 RunLSM._merge``). Those merge by sorting the concatenation;
here two runs that are already sorted merge with the ``merge_runs``
kernel (csrc/merge_runs.cu, a merge-path merge), a cascade of several
runs as pairwise merges.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..ops.hashing import INT64_MAX


def pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class CanonMemo:
    """The direct-mapped canon memo table: int64 [MCAP, 2] enc rows of
    (raw view hash, canonical fingerprint), empty rows keyed INT64_MAX.
    ``cap`` rounds up to a power of two (the slot mask needs it)."""

    def __init__(self, cap: int):
        self.MCAP = pow2_at_least(max(1, cap))
        self.table = None

    def reset(self, device) -> torch.Tensor:
        """(Re)allocate the all-empty table on ``device`` and return it."""
        self.table = torch.full((self.MCAP, 2), INT64_MAX, dtype=torch.int64,
                                device=device)
        return self.table


def merge_runs_plain(a: torch.Tensor, b: torch.Tensor, target: int) -> torch.Tensor:
    """sort(concat(a, b))[:target], padded with INT64_MAX up to target."""
    out = torch.sort(torch.cat([a, b])).values[:target]
    if out.shape[0] < target:
        pad = torch.full((target - out.shape[0],), INT64_MAX, dtype=out.dtype,
                         device=out.device)
        out = torch.cat([out, pad])
    return out


def merge_runs(a: torch.Tensor, b: torch.Tensor, target: int) -> torch.Tensor:
    """Merge two ascending enc runs into exactly ``target`` lanes: the
    smallest ``target`` values of a ∪ b (a multiset), INT64_MAX-padded
    when the two hold fewer. Equal to ``merge_runs_plain`` bit for bit."""
    if kernels.route(a) == "cpu":
        return merge_runs_plain(a, b, target)
    k = kernels.MERGE_RUNS
    kernels.require(a, torch.int64, "a", ndim=1)
    kernels.require(b, torch.int64, "b", ndim=1)
    out = torch.empty(target, dtype=torch.int64, device=a.device)
    rc = k.lib.merge_runs(a.data_ptr(), a.numel(), b.data_ptr(), b.numel(),
                          out.data_ptr(), target, kernels.stream(a.device))
    k.launched(rc)
    return out


def merge_many(runs, target: int) -> torch.Tensor:
    """sort(concat(runs))[:target] (padded) as a chain of pairwise
    ``merge_runs``; intermediate merges keep at most ``target`` lanes
    (truncation only ever drops the largest values)."""
    acc = runs[0]
    for r in runs[1:]:
        acc = merge_runs(acc, r, min(acc.numel() + r.numel(), target))
    if acc.numel() != target:
        empty = acc[:0]
        acc = merge_runs(acc, empty, target)
    return acc
