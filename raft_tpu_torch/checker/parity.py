"""Parity gate: the same BFS at two chunk sizes, identical counts.

Counterpart of raft_tpu/checker/parity.py:39. A fault of the fast path
that depends on the batch geometry (a kernel that mishandles a partial
block, a worklist or scan bound) gives counts that are wrong but
self-consistent; explored at two chunk sizes, the workload must give
identical per-depth counts, total and terminal count.
"""

from __future__ import annotations

from dataclasses import dataclass

from .device_bfs import DeviceBFS


@dataclass
class ParityGateResult:
    ok: bool
    depth: int
    chunks: tuple[int, int]
    counts: tuple[list[int], list[int]]

    def __str__(self):
        s = "PASS" if self.ok else "FAIL"
        return (f"parity gate {s}: depth={self.depth} chunks={self.chunks} "
                f"counts={'==' if self.ok else self.counts}")


def parity_gate(model=None, invariants: tuple[str, ...] = (), symmetry: bool = True,
                depth: int = 12, chunks: tuple[int, int] = (2048, 4096),
                frontier_cap: int = 1 << 16, seen_cap: int = 1 << 20,
                checkers: tuple[DeviceBFS, DeviceBFS] | None = None,
                device=None) -> ParityGateResult:
    """Run the workload to ``depth`` at two chunk sizes; identical
    depth_counts, total and terminal pass. Pass prebuilt ``checkers`` (a
    long run's engine as one arm, say) or let the gate build both from
    ``model``; the two arms must differ in chunk size."""
    if checkers is None and model is None:
        raise ValueError("parity_gate needs either `model` or prebuilt `checkers`")
    if checkers is None:
        checkers = tuple(DeviceBFS(model, invariants=invariants, symmetry=symmetry,
                                   chunk=chunk, frontier_cap=max(frontier_cap, chunk),
                                   seen_cap=seen_cap, journal_cap=seen_cap, device=device)
                         for chunk in chunks)
    if checkers[0].chunk == checkers[1].chunk:
        raise ValueError(f"the parity gate's arms share chunk={checkers[0].chunk}; the gate "
                         "needs two different geometries to mean anything")
    sigs = []
    for checker in checkers:
        res = checker.run(max_depth=depth)
        sigs.append((res.depth_counts, res.total, res.terminal))
    return ParityGateResult(ok=sigs[0] == sigs[1], depth=depth,
                            chunks=(checkers[0].chunk, checkers[1].chunk),
                            counts=(sigs[0][0], sigs[1][0]))
