"""Result types of a BFS run (counterpart of the ``Violation`` and
``CheckResult`` types of ``raft_tpu/checker/bfs.py``)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Violation:
    invariant: str
    global_id: int
    depth: int


@dataclass
class CheckResult:
    distinct: int
    total: int
    depth: int  # BFS diameter reached
    depth_counts: list[int]
    violation: Violation | None
    terminal: int  # states with no successors (reported under -deadlock)
    seconds: float
    states_per_sec: float
    exhausted: bool = True  # False if stopped by max_depth/time budget
    trace: list[tuple[str, dict]] | None = None  # (action label, decoded state)
    # per-action [enabled, fired, new-distinct] in ACTION_NAMES rank order
    coverage: list[list[int]] | None = None
    exit_cause: str | None = None
