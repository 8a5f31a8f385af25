"""Typed failures of the engines' capacity and checkpoint paths.

Counterpart of ``raft_tpu/resilience/errors.py`` for what the port's
engines raise: ``CapacityOverflow`` IS-A ``OverflowError`` and
``CheckpointMismatch`` IS-A ``ValueError``, as in the reference, so a
caller that catches the builtin classes keeps working. The supervisor's
classes (``ShardLost``, ``ShardStall``, the chaos harness's injected
faults, ``is_transient``) come with the supervisor (ROADMAP.md Queue 1
item 3).
"""

from __future__ import annotations


class CapacityOverflow(OverflowError):
    """A static device capacity was exceeded mid-run; the run aborts
    rather than drop states.

    ``what`` names the offending capacities (a subset of ``frontier``,
    ``journal``, ``valid``, ``route``, ``msg``, ``seen``), ``bits`` is the
    engine's raw overflow-bit vector (``OVF_NAMES`` of the engine), and
    ``checkpoint_saved`` is True when the engine wrote a resumable
    checkpoint before raising."""

    def __init__(self, message: str, bits: int = 0, what: tuple[str, ...] = (),
                 checkpoint_saved: bool = False):
        super().__init__(message)
        self.bits = int(bits)
        self.what = tuple(what)
        self.checkpoint_saved = bool(checkpoint_saved)


class CheckpointError(RuntimeError):
    """Base of every checkpoint load or save problem."""


class CheckpointCorrupt(CheckpointError):
    """No intact generation could be loaded (truncation, hash mismatch,
    unreadable zip). ``problems`` lists one line per rejected candidate."""

    def __init__(self, message: str, problems: tuple[str, ...] = ()):
        super().__init__(message)
        self.problems = tuple(problems)


class CheckpointMismatch(CheckpointError, ValueError):
    """The checkpoint loaded but belongs to another spec, mesh or format:
    resuming it would be unsound (exit 64 at the CLI)."""
