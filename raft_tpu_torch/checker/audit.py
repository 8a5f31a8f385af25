"""Fingerprint-collision audit: the BFS re-run under a second hash family.

Counterpart of raft_tpu/checker/audit.py:44. Dedup runs on 64-bit
canonical fingerprints, and a collision silently merges two distinct
states (counts drop, the swallowed state's successors are never explored).
The audit explores the same workload to ``depth`` under two fingerprint
seeds (two independent splitmix64 hash families: the seeded positional
salts and the per-stream xors of the bag hash, ops/symmetry.py) and
demands identical depth counts, total and terminal count; agreement bounds
the silent-collision probability at the square of one run's.
"""

from __future__ import annotations

from dataclasses import dataclass

from .device_bfs import DeviceBFS


@dataclass
class AuditResult:
    ok: bool
    depth: int
    seeds: tuple[int, int]
    counts: tuple[list[int], list[int]]
    totals: tuple[int, int]
    terminals: tuple[int, int]

    def __str__(self):
        s = "PASS" if self.ok else "FAIL"
        return (f"collision audit {s}: depth={self.depth} seeds={self.seeds} "
                f"counts={'==' if self.ok else self.counts}")


def collision_audit(model, invariants: tuple[str, ...] = (), symmetry: bool = True,
                    depth: int = 10, seeds: tuple[int, int] = (0, 0x5EED5EED),
                    chunk: int = 1024, frontier_cap: int | None = None,
                    seen_cap: int = 1 << 20, journal_cap: int = 1 << 20, device=None,
                    **caps) -> AuditResult:
    """Explore to ``depth`` under the two hash ``seeds``; identical
    depth_counts, total and terminal pass. Extra ``caps`` (max_*_cap)
    forward to DeviceBFS, so a run audits at its own capacities."""
    if seeds[0] == seeds[1]:
        raise ValueError("the audit needs two distinct hash families")
    if frontier_cap is None:  # the smallest chunk multiple >= 2^16
        frontier_cap = -(-max(1 << 16, chunk) // chunk) * chunk
    runs = [DeviceBFS(model, invariants=invariants, symmetry=symmetry, chunk=chunk,
                      frontier_cap=frontier_cap, seen_cap=seen_cap, journal_cap=journal_cap,
                      fingerprint_seed=seed, device=device, **caps).run(max_depth=depth)
            for seed in seeds]
    a, b = runs
    ok = (a.depth_counts, a.total, a.terminal) == (b.depth_counts, b.total, b.terminal)
    return AuditResult(ok=ok, depth=depth, seeds=tuple(seeds),
                       counts=(a.depth_counts, b.depth_counts), totals=(a.total, b.total),
                       terminals=(a.terminal, b.terminal))
