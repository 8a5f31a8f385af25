"""Simulation mode: batched random walks on the device.

Counterpart of ``raft_tpu/checker/simulate.py`` (TLC's ``-simulate``, the
mode ``FlexibleRaft.cfg:5`` prescribes) with the same walks, step for
step, for the same seed: R walks advance in lock-step as one [R, W] batch
on the device. One step (the reference's ``_step_impl``, :66):

  1. guard: valid/rank/ovf over the [R, A] candidate grid
     (``model.chunk_guards``; raft_guard);
  2. pick: per walk, the reference's float64 uniform draw, the k-th
     enabled candidate, ``moved``, and the int64 restart draw
     (``sim_pick``, csrc/sim_step.cu);
  3. apply: the chosen successor of each walk that moved
     (``model.chunk_apply``; raft_apply);
  4. check and settle: the first invariant each new row breaks, the new
     depth, ``done``, the restart of done walks from the initial-state
     pool and the journal (``model.sim_check``; raft_sim_check of
     csrc/raft_predicates.cu).

The draws are ``jax.random``'s as the reference runs them (``ops/prng.py``).
The journal of chosen candidates stays on the device as int32
[R, max_behavior_depth + 1] with a length per walk; the host reads four
scalars a step (walks moved, overflow, walks done, the lowest violating
walk) and copies only the violating walk's journal row, for the replay.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels, resolve_device
from ..ops import prng
from ..ops.expand import NO_WALK
from .util import replay_chain


@dataclass
class SimViolation:
    invariant: str
    walk: int
    depth: int  # steps from the behavior's start


@dataclass
class SimResult:
    behaviors: int  # completed behaviors (terminal or depth-capped)
    steps: int  # total transitions taken across all walks
    violation: SimViolation | None
    seconds: float
    states_per_sec: float
    trace: list[tuple[str, dict]] | None = None


# ---------------- sim_pick ----------------


def sim_pick_plain(valid, ovf, key, n_init: int, stats):
    """Plain version of ``sim_pick`` (``raft_tpu/checker/simulate.py:75-81,
    99-103``)."""
    R, A = valid.shape
    dev = valid.device
    n_valid = valid.sum(dim=1)
    ku, kr = prng.split(key)
    u = prng.uniform(ku, R, dev)
    k = torch.floor(u * n_valid.clamp(min=1).to(torch.float64)).to(torch.int64)
    hit = torch.cumsum(valid.to(torch.int64), dim=1) > k[:, None]
    chosen = torch.where(hit.any(dim=1), hit.to(torch.int8).argmax(dim=1), 0)
    moved = n_valid > 0
    w = torch.arange(R, device=dev)
    sel = torch.where(moved, w * A + chosen, R * A).to(torch.int32)
    ridx = prng.randint(kr, R, n_init, dev).to(torch.int32)
    stats[0] = moved.sum()
    stats[1] = (ovf[w, chosen] & moved).any()
    return chosen.to(torch.int32), moved, sel, ridx


def sim_pick(valid, ovf, key, n_init: int, stats):
    """The pick of one simulate step over the guard's valid/ovf [R, A]
    bool grids, for the step's PRNG ``key`` (two u32 words). Returns
    (chosen int32 [R]: the k-th enabled candidate, 0 where none; moved
    bool [R]; sel int32 [R]: raft_apply's worklist, w * A + chosen, or
    the drop lane R * A where the walk did not move; ridx int32 [R]: the
    restart draw in [0, n_init)) and sets stats[0] (walks moved) and
    stats[1] (1 when a chosen lane overflows its bag) of the int64 [4]
    ``stats``."""
    if kernels.route(valid) == "cpu":
        return sim_pick_plain(valid, ovf, key, n_init, stats)
    k = kernels.SIM_PICK
    R, A = valid.shape
    kernels.require(valid, torch.bool, "valid", ndim=2)
    kernels.require(ovf, torch.bool, "ovf", shape=(R, A))
    kernels.require(stats, torch.int64, "stats", shape=(4,))
    dev = valid.device
    chosen = torch.empty(R, dtype=torch.int32, device=dev)
    moved = torch.empty(R, dtype=torch.bool, device=dev)
    sel = torch.empty(R, dtype=torch.int32, device=dev)
    ridx = torch.empty(R, dtype=torch.int32, device=dev)
    ku, kr = prng.split(key)
    ka, kb = prng.split(kr)  # randint's two keys
    rc = k.lib.sim_pick(valid.data_ptr(), ovf.data_ptr(), R, A, *ku, *ka, *kb, n_init,
                        chosen.data_ptr(), moved.data_ptr(), sel.data_ptr(), ridx.data_ptr(),
                        stats.data_ptr(), kernels.stream(dev))
    k.launched(rc)
    return chosen, moved, sel, ridx


# ---------------- the simulator ----------------


class Simulator:
    """R random walks of at most ``max_behavior_depth`` steps each, with
    the reference's restart, violation and journal semantics. ``device``
    defaults to ``cuda`` and raises without a card."""

    def __init__(self, model, invariants: tuple[str, ...] = (), walks: int = 128,
                 max_behavior_depth: int = 50, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.invariants = tuple(invariants)
        unknown = [n for n in self.invariants if n not in model.invariants]
        if unknown:
            raise KeyError(f"unknown invariant(s) {unknown}")
        model.prepare_device(self.device, self.invariants)
        self.R = walks
        self.max_behavior_depth = max_behavior_depth
        self.seed = seed
        self.last: dict[str, torch.Tensor] = {}  # the last step's per-walk outputs

    def start(self) -> SimResult | None:
        """Draw the initial walks (the reference's ``run`` up to its loop).
        Returns the result when an initial state breaks an invariant."""
        model, dev, R = self.model, self.device, self.R
        self.rng = prng.PRNGKey(self.seed)
        init = model.init_states()
        self.init_pool = torch.from_numpy(init).to(dev)
        if self.invariants:
            ok = model.chunk_predicates(self.init_pool, self.invariants).cpu().numpy()
            for name, row in zip(self.invariants, ok):
                if not row.all():
                    bad = int(np.nonzero(~row)[0][0])
                    return SimResult(
                        behaviors=0, steps=0,
                        violation=SimViolation(invariant=name, walk=0, depth=0),
                        seconds=0.0, states_per_sec=0.0,
                        trace=[("Initial predicate", model.decode(init[bad]))])
        self.rng, k0 = prng.split(self.rng)
        init_idx = prng.randint(k0, R, len(init), dev).to(torch.int32)
        self.states = self.init_pool[init_idx.long()]
        self.depth = torch.zeros(R, dtype=torch.int32, device=dev)
        self.journal = torch.zeros((R, max(self.max_behavior_depth, 1) + 1),
                                   dtype=torch.int32, device=dev)
        self.journal[:, 0] = init_idx
        self.jlen = torch.ones(R, dtype=torch.int32, device=dev)
        self.stats = torch.zeros(4, dtype=torch.int64, device=dev)
        self.cov = torch.zeros((len(model.ACTION_NAMES), 3), dtype=torch.int64, device=dev)
        return None

    def step(self) -> np.ndarray:
        """One lock-step move of all R walks on the device. Returns the
        host copy of stats: [walks moved, chosen-lane overflow, walks
        done, lowest violating walk (``NO_WALK``: none)]."""
        model = self.model
        self.rng, key = prng.split(self.rng)
        valid, _rank, ovf, _scal = model.chunk_guards(self.states, self.R, self.cov)
        chosen, moved, sel, ridx = sim_pick(valid, ovf, key, self.init_pool.shape[0],
                                            self.stats)
        nxt = model.chunk_apply(self.states, sel)
        inv_bad, done = model.sim_check(self.states, nxt, moved, chosen, ridx, self.init_pool,
                                        self.depth, self.max_behavior_depth, self.journal,
                                        self.jlen, self.invariants, self.stats)
        self.states = nxt
        self.last = dict(chosen=chosen, moved=moved, done=done, ridx=ridx, inv_bad=inv_bad)
        return self.stats.cpu().numpy()

    def run(self, max_steps: int | None = None, time_budget_s: float | None = None,
            max_behaviors: int | None = None, verbose: bool = False) -> SimResult:
        t0 = time.perf_counter()
        early = self.start()
        if early is not None:
            early.seconds = time.perf_counter() - t0
            return early
        R = self.R
        behaviors = steps = 0
        self.moves = 0  # lock-step moves of the R walks
        violation = None
        while violation is None:
            if max_steps is not None and steps >= max_steps:
                break
            if time_budget_s is not None and time.perf_counter() - t0 > time_budget_s:
                break
            if max_behaviors is not None and behaviors >= max_behaviors:
                break
            n_moved, ovf, n_done, bad = (int(x) for x in self.step())
            self.moves += 1
            if ovf:
                raise OverflowError(
                    "message-slot overflow during simulation: re-run with a "
                    "larger msg_slots")
            steps += n_moved
            if bad != NO_WALK:
                violation = SimViolation(
                    invariant=self.invariants[int(self.last["inv_bad"][bad])], walk=bad,
                    depth=int(self.jlen[bad]) - 1)
                break
            behaviors += n_done
            if verbose and steps % (50 * R) < R:
                el = time.perf_counter() - t0
                print(f"simulate: {steps} steps, {behaviors} behaviors, "
                      f"{steps / el:.0f} states/s", file=sys.stderr)
        dt = time.perf_counter() - t0
        trace = self._replay(violation.walk) if violation else None
        return SimResult(behaviors=behaviors, steps=steps, violation=violation, seconds=dt,
                         states_per_sec=steps / dt if dt > 0 else 0.0, trace=trace)

    def _replay(self, walk: int) -> list[tuple[str, dict]]:
        """Re-run one behavior's journal (its initial-pool row, then its
        chosen candidates) into a labelled trace through the kernels."""
        row = self.journal[walk, : int(self.jlen[walk])].cpu().tolist()
        init = self.init_pool[row[0]].cpu().numpy()
        return replay_chain(self.model, self.device, init, row[1:])
