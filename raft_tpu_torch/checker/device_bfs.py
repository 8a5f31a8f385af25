"""Device-resident BFS — the port's model-checking engine.

Counterpart of ``raft_tpu/checker/device_bfs.py:DeviceBFS`` with the same
exploration semantics: identical distinct sets, gid numbering,
first-occurrence tie-breaking, coverage and violation reporting.

Pipeline per chunk of ``chunk`` frontier states (``_chunk_step``, which
composes ``_st_expand`` (1-2), ``_st_canon`` (3), ``_st_dedup`` (4 and
the run of 7) and ``_st_finish`` (5-6)):
  1. guard: valid/rank/ovf over the [chunk, A] candidate grid, with the
     chunk's enabled/fired coverage (``model.chunk_guards``; for Raft the
     raft_guard kernel)
  2. compact the valid lanes into a dense worklist (``compact_indices``,
     the compact_append kernel), then apply: successor rows for the
     worklist lanes only (``model.chunk_apply``; raft_apply)
  3. canonical fingerprints through the canon memo (canon_memo kernel;
     canon_tiered from five servers), or, for a model's own canonicalizer
     without a memo (KRaftWithReconfig), of the compacted lanes directly
     (the slot_canon kernel)
  4. dedup: probe the seen run and this wave's ladder runs (probe_runs
     kernel), then first occurrence within the chunk and the chunk's
     sorted run of new fingerprints from one stable sort (chunk_sort)
  5. emit: append the survivors' rows at the device-side cursor of the
     next-frontier buffer, and their (parent gid, candidate) rows at the
     journal cursor (``append_rows``, the compact_append kernel)
  6. invariants on the new lanes, folding the first violating journal
     index per invariant, and the new-distinct coverage
     (``model.chunk_fold``; raft_fold)
  7. the chunk's run of new fingerprints (from stage 4) inserted into a
     binary-counter ladder of sorted runs (merge_runs kernel)

The reference runs a wave as one ``lax.while_loop``; here the host runs a
Python loop over the wave's chunks WITHOUT a host sync per chunk: the
cursor, stats, coverage and violation accumulators stay on the device
and the kernels read the cursor from device memory. The ladder cascade
depends only on the chunk index, so the host knows every level's
occupancy without reading the device. The host reads the stats once per
wave; at the wave's end the ladder is merged into the single sorted seen
run.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops.hashing import INT64_MAX
from ..ops.symmetry import Canonicalizer
from .bfs import CheckResult, Violation
from .lsm import CanonMemo, merge_many, merge_runs, pow2_at_least
from .util import (
    GROWTH, HEADROOM, I32_MAX, append_rows, chunk_sort, compact_indices,
    next_cap, probe_runs, replay_chain,
)


class CapacityOverflow(RuntimeError):
    """A static buffer bound was exceeded; the run aborts rather than
    drop states. ``bits`` uses ``DeviceBFS.OVF_NAMES``."""

    def __init__(self, msg: str, bits: int, what: tuple[str, ...] = ()):
        super().__init__(msg)
        self.bits = bits
        self.what = what


class DeviceBFS:
    """Single-device BFS with device-resident frontier, seen run and
    journal (see the module docstring). Capacities as in the reference:
      frontier_cap     per-wave distinct states (frontier buffer rows)
      journal_cap      total distinct states beyond Init (trace journal)
      valid_per_state  compaction budget: worklist lanes per state (a
                       wave whose worklist overflows is redone with it
                       doubled, up to A: the reference's grow_for_overflow)
      max_*_cap        growth bounds (frontier/journal grow between
                       waves; the seen run grows through its size ladder)
    ``device`` defaults to ``cuda`` and raises without a card."""

    GROWTH = GROWTH
    HEADROOM = HEADROOM
    OVF_NAMES = ((1, "msg"), (2, "valid"), (4, "frontier"), (8, "journal"))
    SEEN_OVF_BIT = 16

    def __init__(
        self,
        model,
        invariants: tuple[str, ...] = (),
        symmetry: bool = True,
        chunk: int = 1024,
        frontier_cap: int = 1 << 18,
        seen_cap: int = 1 << 22,
        journal_cap: int = 1 << 22,
        valid_per_state: int = 16,
        max_frontier_cap: int = 1 << 22,
        max_seen_cap: int = 1 << 25,
        max_journal_cap: int = 1 << 25,
        fingerprint_seed: int = 0,
        canon_memo_cap: int = 1 << 21,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.invariants = tuple(invariants)
        unknown = [n for n in self.invariants if n not in model.invariants]
        if unknown:
            raise KeyError(f"unknown invariant(s) {unknown}")
        model.prepare_device(self.device, self.invariants)
        self.chunk = chunk
        self.A = model.A
        self.W = model.layout.W
        self.n_actions = len(getattr(model, "ACTION_NAMES", ()))
        self.FCAP = frontier_cap
        self.JCAP = journal_cap
        self.MAX_FCAP = max(max_frontier_cap, frontier_cap)
        self.MAX_SCAP = max(max_seen_cap, seen_cap)
        self.MAX_JCAP = max(max_journal_cap, journal_cap)
        if chunk > frontier_cap or frontier_cap % chunk:
            raise ValueError("frontier_cap must be a multiple of chunk")
        self.TOPSZ = pow2_at_least(self.MAX_SCAP)
        self._set_worklist(valid_per_state)
        self.redone_chunks = 0  # chunks of waves redone after a worklist overflow
        self._seen: torch.Tensor | None = None
        self.canon = Canonicalizer.for_model(
            model, symmetry=symmetry, seed=fingerprint_seed)
        # the canon memo caches raw view hash -> canonical fingerprint; a
        # model's own canonicalizer without a memo (KRaftWithReconfig's slot
        # canon) takes the unmemoized path and allocates no table
        self._use_memo = hasattr(self.canon, "fingerprints_memo")
        self._memo = CanonMemo(canon_memo_cap if self._use_memo else 1)
        self.MCAP = self._memo.MCAP
        self._init_distinct: np.ndarray | None = None
        self._jparent = self._jcand = None
        self._jcount = 0
        self.frontier_rows: torch.Tensor | None = None  # last wave's states

    def _set_worklist(self, valid_per_state: int) -> None:
        """Worklist geometry: VC lanes per chunk, the R0-lane run of a
        chunk's new fingerprints, and the seen run's size ladder (one
        sorted run climbing x4 from max(R0, 2^18) to TOPSZ, the
        reference's single-run design)."""
        self.VC = self.chunk * min(self.A, valid_per_state)
        self.R0 = pow2_at_least(self.VC)
        sizes = []
        s = min(max(self.R0, 1 << 18), self.TOPSZ)
        while s < self.TOPSZ:
            sizes.append(s)
            s <<= 2
        sizes.append(self.TOPSZ)
        self._seen_sizes = sizes

    # ---------------- seen run ----------------

    def _seen_size_for(self, n: int) -> int:
        for s in self._seen_sizes:
            if n <= s:
                return s
        raise OverflowError(
            f"seen-set of {n} exceeds the {self.TOPSZ}-lane capacity; "
            "raise max_seen_cap"
        )

    def _seed_seen(self, sorted_fps: np.ndarray) -> None:
        size = self._seen_size_for(len(sorted_fps))
        host = np.full((size,), INT64_MAX, np.int64)
        host[: len(sorted_fps)] = sorted_fps
        self._seen = torch.from_numpy(host).to(self.device)

    def _merge_seen(self, ladder, new_real: int) -> None:
        """seen <- sort(concat(seen, *ladder))[:target], INT64_MAX-padded
        to exactly the ladder size ``target`` (``_merge_seen`` of the
        reference): the wave's runs merge first, then one merge with the
        seen run."""
        target = self._seen_size_for(new_real)
        runs = [r for r in ladder if r is not None]
        if runs:
            wave = merge_many(runs, sum(r.numel() for r in runs))
        else:
            wave = self._seen[:0]
        self._seen = merge_runs(self._seen, wave, target)

    def _wave_geom(self) -> int:
        """Ladder depth K: levels R0<<0 .. R0<<K, top >= pow2(FCAP), so a
        whole wave's new fingerprints fit (the top absorbs by truncating
        merges, sound while the wave's new count <= FCAP)."""
        K = 0
        while (self.R0 << K) < pow2_at_least(self.FCAP):
            K += 1
        return K

    # ---------------- the chunk pipeline ----------------
    # Four stage methods, as in the reference (_st_expand -> _st_canon ->
    # _st_dedup -> _st_finish); _chunk_step composes them without a host
    # sync.

    def _st_expand(self, frontier, cursor: int, fcount: int, cov):
        """Stages 1-2: the guard pass over the chunk at ``cursor`` (adding
        its enabled/fired coverage into ``cov``), compaction of its valid
        lanes into the [VC] worklist (sel[j] = flat lane of the j-th valid
        candidate), and the apply pass for the worklist lanes. Returns
        (flatc [VC, W], sel, selv, valid, rank, n_gen, terminal,
        expand_ovf, compact_ovf)."""
        C, A, VC = self.chunk, self.A, self.VC
        batch = frontier[cursor:cursor + C]
        valid, rank, _ovf, scal = self.model.chunk_guards(
            batch, min(C, fcount - cursor), cov)
        n_gen, terminal, expand_ovf = scal[0], scal[1], scal[2] != 0
        sel, _ = compact_indices(valid.reshape(-1), VC, C * A)
        compact_ovf = n_gen > VC
        flatc = self.model.chunk_apply(batch, sel)
        return (flatc, sel, sel < C * A, valid, rank, n_gen, terminal, expand_ovf,
                compact_ovf)

    def _st_canon(self, flatc, selv, memo):
        """Stage 3: canonical fingerprints of the compacted lanes (invalid
        lanes INT64_MAX), through the memo where the canonicalizer has one.
        Returns (fps, n_memo_hit)."""
        if self._use_memo:
            return self.canon.fingerprints_memo(flatc, selv, memo)
        return self.canon.fingerprints(flatc, selv), torch.zeros((), dtype=torch.int64,
                                                                 device=flatc.device)

    def _st_dedup(self, fps, runs):
        """Stage 4: fresh against the seen run and this wave's ladder
        runs, then the first occurrence within the chunk and the chunk's
        new fingerprints as one sorted R0-lane run, from one stable sort
        (``chunk_sort``). Returns (new, new_run)."""
        return chunk_sort(fps, probe_runs(fps, runs), self.R0)

    def _st_finish(self, next_buf, jparent, jcand, viol, stats, cov, ex, n_hit,
                   new, cursor: int, base_gid: int):
        """Stages 5-6: the cursor-append emit, the new-distinct coverage
        and invariant fold, and the stats fold, all in place."""
        (flatc, sel, _selv, valid, rank, n_gen, terminal, expand_ovf,
         compact_ovf) = ex
        A, VC = self.A, self.VC
        n_new = new.sum()
        sel64 = sel.to(torch.int64)

        # emit at the device-side cursors (stats[0] frontier, stats[1]
        # journal); rows past capacity land in the drop region
        esel, _ = compact_indices(new, VC, VC)
        append_rows(next_buf, flatc, esel, stats[0:1], self.FCAP)
        jp_src = (sel64 // A + (base_gid + cursor)).to(torch.int32)
        jc_src = (sel64 % A).to(torch.int32)
        append_rows(jparent, jp_src, esel, stats[1:2], self.JCAP)
        append_rows(jcand, jc_src, esel, stats[1:2], self.JCAP)
        frontier_ovf = stats[0] + n_new > self.FCAP
        journal_ovf = stats[1] + n_new > self.JCAP

        # new-distinct coverage and invariants on the new lanes: first bad
        # journal index (the journal cursor before this chunk's append)
        self.model.chunk_fold(flatc, new, stats[1:2], viol, self.invariants, cov=cov,
                              sel=sel, valid=valid, rank=rank)

        ovf_bits = (expand_ovf.to(torch.int64) + 2 * compact_ovf.to(torch.int64)
                    + 4 * frontier_ovf.to(torch.int64)
                    + 8 * journal_ovf.to(torch.int64))
        zero = torch.zeros_like(n_new)
        stats += torch.stack([n_new, n_new, n_gen, terminal, zero, n_hit])
        stats[4:5] |= ovf_bits

    def _chunk_step(self, frontier, next_buf, jparent, jcand, viol, stats,
                    memo, cov, cursor: int, fcount: int, base_gid: int, runs):
        """One chunk of the current wave; every carry is updated in place
        on the device. stats is int64[6]: [wave new count, journal
        count, cumulative generated, cumulative terminal, overflow bits,
        cumulative canon-memo hits]. Returns the chunk's new fingerprints
        as a sorted R0-lane run."""
        ex = self._st_expand(frontier, cursor, fcount, cov)
        fps, n_hit = self._st_canon(ex[0], ex[2], memo)
        new, new_run = self._st_dedup(fps, runs)
        self._st_finish(next_buf, jparent, jcand, viol, stats, cov, ex, n_hit, new,
                        cursor, base_gid)
        return new_run

    def _run_wave(self, frontier, next_buf, jparent, jcand, viol, stats, memo,
                  cov, fcount: int, base_gid: int):
        """All chunks of one wave, deduplicating in-wave against a
        binary-counter ladder of sorted runs: after chunk k the ladder
        encodes k+1 (level i holds R0<<i lanes); the merge chain length
        is the number of trailing zero bits of k+1, capped at K where the
        top level absorbs by truncating merges (``_wave_step`` of the
        reference, :571-655). Returns the ladder (None = empty level)."""
        C, R0 = self.chunk, self.R0
        K = self._wave_geom()
        topsz = R0 << K
        # wave-new and overflow lanes restart each wave (zero_ on a view:
        # a device fill, where assigning a Python number would sync)
        stats[0:1].zero_()
        stats[4:5].zero_()
        ladder: list[torch.Tensor | None] = [None] * (K + 1)
        for k in range(-(-fcount // C)):
            runs = [self._seen] + [r for r in ladder if r is not None]
            new_run = self._chunk_step(
                frontier, next_buf, jparent, jcand, viol, stats, memo, cov,
                k * C, fcount, base_gid, runs)
            kp1, tt = k + 1, 0
            while tt < K and kp1 % (1 << (tt + 1)) == 0:
                tt += 1
            lower = [r for r in (ladder[:tt] if tt < K else ladder) if r is not None]
            merged = merge_many([new_run] + lower, R0 << tt if tt < K else topsz)
            for i in range(tt):
                ladder[i] = None
            ladder[tt] = merged
        return ladder

    def _wave_carries(self):
        """Fresh device carries of the wave loop: (next_buf, jparent,
        jcand, viol, stats, cov), sized to the current capacities."""
        dev, W = self.device, self.W
        i32 = dict(dtype=torch.int32, device=dev)
        n_inv = max(1, len(self.invariants))
        return (
            torch.zeros((self.FCAP + self.VC, W), **i32),
            torch.zeros(self.JCAP + self.VC, **i32),
            torch.zeros(self.JCAP + self.VC, **i32),
            torch.full((n_inv,), I32_MAX, dtype=torch.int64, device=dev),
            torch.zeros(6, dtype=torch.int64, device=dev),
            torch.zeros((self.n_actions, 3), dtype=torch.int64, device=dev),
        )

    # ---------------- capacity growth ----------------

    def _rows(self, n: int) -> torch.Tensor:
        return torch.zeros((n, self.W), dtype=torch.int32, device=self.device)

    def _grow_journal(self, jparent, jcand, new: int):
        z = torch.zeros(new + self.VC - jparent.numel(), dtype=torch.int32,
                        device=self.device)
        return torch.cat([jparent, z]), torch.cat([jcand, z])

    def _next_buffers(self, bufs: list, ncount: int, jparent, jcand, jcount: int):
        """Between waves: the wave's output becomes the next frontier, and
        any buffer the next wave could outgrow is enlarged first (frontier
        speculatively by HEADROOM, journal exactly). ``bufs`` is [frontier,
        next_buf], emptied here so that the caller holds no reference: a
        grown frontier never coexists with the dead input rows, and at
        most the live rows and the two new buffers are held at once.
        Returns (frontier, next_buf, jparent, jcand)."""
        frontier, next_buf = bufs
        bufs.clear()
        if ncount * self.HEADROOM > self.FCAP and self.FCAP < self.MAX_FCAP:
            new = next_cap(ncount * self.HEADROOM, self.FCAP, self.MAX_FCAP,
                           self.GROWTH, self.chunk)
            del frontier  # the wave's input rows are dead
            frontier = self._rows(new + self.VC)
            frontier[:ncount] = next_buf[:ncount]
            del next_buf
            next_buf = self._rows(new + self.VC)
            self.FCAP = new
        else:
            frontier, next_buf = next_buf, frontier
        if jcount + ncount * self.HEADROOM > self.JCAP and self.JCAP < self.MAX_JCAP:
            new = next_cap(jcount + ncount * self.HEADROOM, self.JCAP,
                           self.MAX_JCAP, self.GROWTH, 1)
            jparent, jcand = self._grow_journal(jparent, jcand, new)
            self.JCAP = new
        return frontier, next_buf, jparent, jcand

    def _widen_worklist(self, bufs: list, jparent, jcand, fcount: int):
        """Double the worklist lanes per state (up to A) after a wave
        whose worklist overflowed, and size the buffers to the new VC; the
        wave is then redone. ``bufs`` as in ``_next_buffers``."""
        frontier, next_buf = bufs
        bufs.clear()
        self._set_worklist(2 * (self.VC // self.chunk))
        del next_buf  # the overflowed wave's output is dropped
        grown = self._rows(self.FCAP + self.VC)
        grown[:fcount] = frontier[:fcount]
        del frontier
        jparent, jcand = self._grow_journal(jparent, jcand, self.JCAP)
        self.redone_chunks += -(-fcount // self.chunk)
        return grown, self._rows(self.FCAP + self.VC), jparent, jcand

    # ---------------- host loop ----------------

    def run(self, max_depth: int | None = None, verbose: bool = False,
            time_budget_s: float | None = None) -> CheckResult:
        model, dev = self.model, self.device
        W = self.W
        t0 = time.perf_counter()
        exhausted = True
        exit_cause = None

        init = model.init_states()
        init_fps = self.canon.fingerprints(torch.from_numpy(init).to(dev)).cpu().numpy()
        order = np.argsort(init_fps, kind="stable")
        sf = init_fps[order]
        dup = np.zeros(len(order), dtype=bool)
        dup[1:] = sf[1:] == sf[:-1]
        keep = np.ones(len(order), dtype=bool)
        keep[order[dup]] = False
        init_d = np.asarray(init[keep])
        n0 = len(init_d)
        if n0 > self.FCAP:
            raise ValueError("initial states exceed frontier_cap")
        self._init_distinct = init_d
        violation = self._check_init(init_d)
        self._seed_seen(np.sort(init_fps[keep]))
        fcount = scount = distinct = n0
        total = len(init)  # pre-dedup, as the reference seeds it
        terminal = depth = base_gid = gen_prev = 0
        depth_counts = [n0]
        cov_h = np.zeros((self.n_actions, 3), np.int64)

        frontier = torch.zeros((self.FCAP + self.VC, W), dtype=torch.int32, device=dev)
        frontier[:n0] = torch.from_numpy(init_d).to(dev)
        next_buf, jparent, jcand, viol, stats, cov = self._wave_carries()
        n_inv = viol.numel()
        memo = self._memo.reset(dev)
        self.redone_chunks = 0

        while fcount and violation is None:
            if max_depth is not None and depth >= max_depth:
                exhausted, exit_cause = False, "max_depth"
                break
            if time_budget_s is not None and time.perf_counter() - t0 > time_budget_s:
                exhausted, exit_cause = False, "time_budget"
                break
            # the top ladder level absorbs by truncation, sound only while
            # every real fingerprint fits
            if scount + min(self.FCAP, fcount * self.VC) > self.TOPSZ:
                raise CapacityOverflow(
                    "seen-set capacity overflow; raise max_seen_cap",
                    bits=self.SEEN_OVF_BIT, what=("seen",))
            before = (stats.clone(), viol.clone(), cov.clone())
            ladder = self._run_wave(frontier, next_buf, jparent, jcand, viol,
                                    stats, memo, cov, fcount, base_gid)
            # the wave's one host read: stats, violations and coverage
            snap = torch.cat([stats, viol, cov.reshape(-1)]).cpu().numpy()
            stats_h, viol_h = snap[:6], snap[6:6 + n_inv]
            ncount, ovf_bits = int(stats_h[0]), int(stats_h[4])
            if ovf_bits & 2 and not ovf_bits & 1 and self.VC < self.chunk * self.A:
                # the worklist overflowed: redo the wave with it doubled
                for t, b in zip((stats, viol, cov), before):
                    t.copy_(b)
                bufs = [frontier, next_buf]
                del frontier, next_buf, ladder
                frontier, next_buf, jparent, jcand = self._widen_worklist(
                    bufs, jparent, jcand, fcount)
                if verbose:
                    print(f"depth {depth + 1}: worklist overflow, redone with "
                          f"{self.VC // self.chunk} lanes per state", file=sys.stderr)
                continue
            if ovf_bits:
                raise CapacityOverflow(
                    f"device BFS capacity overflow (bits={ovf_bits:04b}: "
                    "1=msg-slots 2=valid_per_state 4=frontier_cap "
                    "8=journal_cap)",
                    bits=ovf_bits,
                    what=tuple(n for b, n in self.OVF_NAMES if ovf_bits & b))
            cov_h = snap[6 + n_inv:].reshape(self.n_actions, 3)
            n_gen = int(stats_h[2])
            wave_gen = n_gen - gen_prev
            total += wave_gen
            gen_prev = n_gen
            terminal = int(stats_h[3])
            if ncount == 0:
                exit_cause = "exhausted"
                break
            scount += ncount
            self._merge_seen(ladder, scount)
            depth += 1
            distinct += ncount
            depth_counts.append(ncount)
            for k, name in enumerate(self.invariants):
                if viol_h[k] != I32_MAX:
                    violation = Violation(
                        invariant=name, global_id=n0 + int(viol_h[k]), depth=depth)
                    break
            base_gid = n0 + int(stats_h[1]) - ncount
            fcount = ncount
            bufs = [frontier, next_buf]
            del frontier, next_buf, ladder
            frontier, next_buf, jparent, jcand = self._next_buffers(
                bufs, ncount, jparent, jcand, scount - n0)
            if verbose:
                el = time.perf_counter() - t0
                print(f"depth {depth}: frontier {ncount}, distinct {distinct}, "
                      f"total {total}, {distinct / el:.0f} distinct/s",
                      file=sys.stderr)

        self._jparent, self._jcand = jparent, jcand
        self._jcount = int(stats[1].item())
        self.frontier_rows = frontier[:fcount]
        self.memo_hits = int(stats[5].item())
        dt = time.perf_counter() - t0
        if violation is not None:
            exit_cause = "violation"
        elif exit_cause is None:
            exit_cause = "exhausted"
        trace = self.reconstruct_trace(violation) if violation else None
        return CheckResult(
            distinct=distinct, total=total, depth=depth,
            depth_counts=depth_counts, violation=violation, terminal=terminal,
            seconds=dt, states_per_sec=distinct / dt if dt > 0 else 0.0,
            exhausted=exhausted and violation is None, trace=trace,
            coverage=[[int(x) for x in row] for row in cov_h] if self.n_actions else None,
            exit_cause=exit_cause,
        )

    def _check_init(self, init_d: np.ndarray) -> Violation | None:
        """The invariants on the initial states, through the fold: every
        state is new and the journal cursor is 0, so viol[k] is the index
        of the first state that violates invariant k."""
        if not self.invariants:
            return None
        states = torch.from_numpy(init_d).to(self.device)
        viol = torch.full((len(self.invariants),), I32_MAX, dtype=torch.int64,
                          device=self.device)
        new = torch.ones(len(init_d), dtype=torch.bool, device=self.device)
        jcount = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.model.chunk_fold(states, new, jcount, viol, self.invariants)
        for name, v in zip(self.invariants, viol.cpu().tolist()):
            if v != I32_MAX:
                return Violation(invariant=name, global_id=int(v), depth=0)
        return None

    # ---------------- trace reconstruction ----------------

    def journal_chain(self, gid: int) -> tuple[np.ndarray, list[int]]:
        """(initial state row, candidates taken) of the journalled state
        ``gid``, by its parent pointers."""
        n0 = len(self._init_distinct)
        jp = self._jparent[: self._jcount].cpu().numpy()
        jc = self._jcand[: self._jcount].cpu().numpy()
        chain: list[int] = []
        while gid >= n0:
            chain.append(int(jc[gid - n0]))
            gid = int(jp[gid - n0])
        chain.reverse()
        return self._init_distinct[gid], chain

    def reconstruct_trace(self, violation: Violation) -> list[tuple[str, dict]]:
        """Parent-pointer replay through the journal (``reconstruct_trace``
        of the reference, :1821): each journalled candidate goes through
        the guard and a one-lane apply on the engine's device."""
        init, chain = self.journal_chain(violation.global_id)
        return replay_chain(self.model, self.device, init, chain)
