"""Sharded-frontier BFS over ``torch.distributed`` — one process per shard.

Counterpart of ``raft_tpu/parallel/sharded.py:ShardedBFS`` (TLC's
``-workers N`` replacement): shard d of a D-shard mesh owns the
fingerprints ``fp mod D`` and holds its own frontier, journal lanes
(``jps``, ``jpl``, ``jcand``, ``jfp``), seen run and canon memo. A wave
expands every shard's frontier in chunks; each chunk is

  pre       (the generating shard) guard, compaction and apply, then the
            canonical fingerprints through the shard's memo — DeviceBFS's
            own stages (``_st_expand``, ``_st_canon``) — and the owner
            route (``owner_route``, csrc/owner_route.cu): the lanes
            partitioned stably by owner into D blocks of RC payload rows
            [state, parent lgid, candidate, action rank] and fingerprints;
  exchange  two ``all_to_all_single`` calls (the payload, the
            fingerprints): block d of a send goes to shard d, received
            block d came from shard d, so the parent's shard is
            ``received row // RC`` and is never routed;
  post      (the owner) ``chunk_dedup`` of the received fingerprints
            against the shard's seen run and this wave's ladder, with their
            lane order (first occurrence, the chunk's sorted run), the
            survivors emitted in fingerprint order into the next frontier
            and the four journal lanes
            (``compact_append``), the owner-side fold (new-distinct
            coverage by the routed rank column, the invariants; the
            family's fold kernel) and the run into the wave's ladder
            (``merge_runs``).

The exchange runs at every D, D = 1 included. Shards agree on every
decision through one ``all_gather`` of their stats per wave (the wave's
one host read): counts, overflow bits, growth, the violation site and
rank 0's clock (time budget, checkpoint interval). Within a wave the
discovery order is the reference's: the stable owner partition, the
received block order and the fingerprint-ordered emit decide the journal
and hence the counterexample, equal to the reference's at equal D.

Checkpoints are the reference's mesh-portable payload (version 2, with
the ``jfp`` lane): rank 0 gathers and writes them, and on resume loads,
re-routes a payload written at another D by ``fp mod D``
(``_reshard_payload``) and scatters the shards. Not ported yet
(ROADMAP.md Queue 1): telemetry and ``MemWatch`` (item 4); the
supervisor, preemption, chaos, the stall watchdog, the overflow-abort
wave-start spill and v1 payload recovery (item 3); ``run_fleet``,
``--timeline`` and the audit surface (item 5).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..checker.device_bfs import DeviceBFS
from ..checker.lsm import pow2_at_least
from ..checker.util import (
    GROWTH, HEADROOM, I32_MAX, append_rows, chunk_dedup,
    compact_indices, next_cap, replay_chain,
)
from ..ops.hashing import INT64_MAX
from ..resilience import ckpt as rckpt
from ..resilience.errors import CapacityOverflow, CheckpointMismatch
from .route import owner_route

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
N_STATS = 7  # [wave new, jcount, cum generated, cum terminal, ovf bits, cum routed, cum memo hits]

# arguments of the reference's run whose modules are not ported, and the
# ROADMAP.md Queue 1 item that brings each
UNPORTED = {"telemetry": 4, "preempt": 3, "chaos": 3, "stall_abort_factor": 3}


def refuse_unported(**given) -> None:
    bad = [f"{k} (ROADMAP.md Queue 1 item {UNPORTED[k]})" for k, v in given.items()
           if v is not None]
    if bad:
        raise NotImplementedError(f"ShardedBFS: not ported to raft_tpu_torch: {', '.join(bad)}")


def ckpt_ident(model, canon, invariants, D: int) -> str:
    """The reference's checkpoint ident of a sharded run
    (``_ckpt_ident``, :807): ``/D=<n>`` is provenance, not identity
    (``ckpt.check_spec`` strips it when the payload may reshard)."""
    wl = getattr(canon, "refine_rounds", 1)
    return (f"sharded/{model.name}/{model.p}/W={model.layout.W}/D={D}"
            f"/sym={canon.symmetry}/hashv=5/wl={wl}/inv={','.join(invariants)}")


@dataclass
class ShardedResult:
    distinct: int
    total: int
    depth: int
    depth_counts: list[int]
    violation_invariant: str | None
    seconds: float
    states_per_sec: float
    terminal: int = 0
    exhausted: bool = True
    trace: list[tuple[str, dict]] | None = None
    metrics: list[dict] | None = None  # per wave
    stats: dict | None = None  # memo hits, per-shard skew, capacities
    coverage: list[list[int]] | None = None  # mesh-summed [enabled, fired, new] per rank
    exit_cause: str | None = None


class ShardedBFS:
    """Multi-process exhaustive BFS, one shard per rank of the current
    ``torch.distributed`` process group (``parallel/launch.py`` starts
    them). Capacities are per shard, as in the reference:
      chunk            frontier states expanded per chunk step
      valid_per_state  compaction budget (lanes per state; a wave whose
                       worklist overflows is redone with it doubled)
      route_cap        exchange slots per (source, owner) pair per chunk,
                       RC; default the worklist VC, which no chunk can
                       overflow
      frontier_cap     per-wave distinct states (grows, multiple of chunk)
      seen_cap         initial seen lanes (bound: max_seen_cap)
      journal_cap      journal rows = owned distinct states beyond Init
    ``device`` defaults to ``cuda`` (shard r on card r mod the card count)
    and raises without a card."""

    GROWTH = GROWTH
    HEADROOM = HEADROOM
    OVF_NAMES = ((1, "msg"), (2, "valid"), (4, "route"), (8, "frontier"), (16, "journal"))
    SEEN_OVF_BIT = 32

    def __init__(self, model, invariants: tuple[str, ...] = (), symmetry: bool = True,
                 chunk: int = 256, valid_per_state: int = 16, route_cap: int | None = None,
                 frontier_cap: int = 1 << 12, seen_cap: int = 1 << 16,
                 journal_cap: int | None = None, max_frontier_cap: int = 1 << 20,
                 max_seen_cap: int = 1 << 24, max_journal_cap: int = 1 << 24,
                 canon_memo_cap: int = 1 << 21, device=None, group=None, telemetry=None,
                 preempt=None, chaos=None, stall_abort_factor=None):
        refuse_unported(telemetry=telemetry, preempt=preempt, chaos=chaos,
                        stall_abort_factor=stall_abort_factor)
        if not dist.is_initialized():
            raise RuntimeError("ShardedBFS runs in a torch.distributed process group: start it "
                               "with raft_tpu_torch.parallel.launch.run_sharded")
        self.group = group
        self.D = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", self.rank % torch.cuda.device_count())
        self.device = dev
        self.model = model
        self.invariants = tuple(invariants)
        self.chunk = chunk
        self.A = model.A
        self.W = model.layout.W
        self.n_actions = len(getattr(model, "ACTION_NAMES", ()))
        # the generating shard's stages are DeviceBFS's (guard, compaction,
        # apply; canon through the shard's memo), by composition
        self.local = DeviceBFS(model, invariants=self.invariants, symmetry=symmetry,
                               chunk=chunk, frontier_cap=chunk, seen_cap=chunk,
                               journal_cap=chunk, valid_per_state=valid_per_state,
                               canon_memo_cap=canon_memo_cap, device=dev)
        self.canon = self.local.canon
        self._route_cap = route_cap
        frontier_cap = -(-frontier_cap // chunk) * chunk
        self.FCAP = frontier_cap
        self.JCAP = journal_cap if journal_cap is not None else seen_cap
        self.MAX_FCAP = max(max_frontier_cap, frontier_cap)
        self.MAX_SCAP = max(max_seen_cap, seen_cap)
        self.MAX_JCAP = max(max_journal_cap, self.JCAP)
        self.TOPSZ = pow2_at_least(self.MAX_SCAP)
        self._geometry()
        self._seen: torch.Tensor | None = None
        self._journals = None  # (jps, jpl, jcand, jcounts, n0) on rank 0 after a violation
        self._init_by_shard: list[list[np.ndarray]] | None = None
        self.redone_chunks = 0

    def _geometry(self) -> None:
        """VC (the worklist), RC (route slots per owner), EPAD = D * RC
        (the received lanes a chunk appends at most: the emit drop region)
        and R0 = pow2(D * RC), the lanes of a chunk's sorted run."""
        self.VC = self.local.VC
        self.RC = self._route_cap if self._route_cap is not None else self.VC
        self.EPAD = self.D * self.RC
        self.R0 = pow2_at_least(self.D * self.RC)
        sizes, s = [], min(max(self.R0, 1 << 18), self.TOPSZ)
        while s < self.TOPSZ:
            sizes.append(s)
            s <<= 2
        self._seen_sizes = sizes + [self.TOPSZ]
        dev, B = self.device, self.EPAD
        self._iota_b = torch.arange(B, dtype=torch.int32, device=dev)
        self._shard_of_lane = (self._iota_b // self.RC).to(torch.int32)
        self._zero1 = torch.zeros(1, dtype=torch.int64, device=dev)

    # ---------------- seen run (per shard) ----------------
    # DeviceBFS's single sorted seen run and its wave ladder, on this
    # shard's R0 (a chunk's run holds the D * RC received lanes)

    _seen_size_for = DeviceBFS._seen_size_for
    _seed_seen = DeviceBFS._seed_seen
    _merge_seen = DeviceBFS._merge_seen
    _wave_geom = DeviceBFS._wave_geom
    _ladder_push = DeviceBFS._ladder_push

    # ---------------- the chunk step ----------------

    def _cs_pre(self, frontier, fcount: int, memo, cov, cursor: int, base_lgid: int):
        """Pre-exchange stages of one chunk on the generating shard
        (``_cs_pre`` of the reference, :498): DeviceBFS's expand and canon
        stages, then the owner route. Returns (send_pay, send_fps,
        pre_stats int64 [4] = [n_gen, terminal, ovf bits (1 msg, 2 valid,
        4 route), routed lanes] with the memo hits as a fifth lane)."""
        ex = self.local._st_expand(frontier, cursor, max(fcount, cursor), cov)
        flatc, sel, selv, valid, rank, n_gen, terminal, expand_ovf, compact_ovf = ex
        fps, n_hit = self.local._st_canon(flatc, selv, memo)
        send_pay, send_fps, route = owner_route(fps, flatc, sel, rank, base_lgid + cursor,
                                                self.A, self.D, self.RC)
        ovf = expand_ovf.to(torch.int64) + 2 * compact_ovf.to(torch.int64) + route[0]
        pre = torch.stack([n_gen.to(torch.int64), terminal.to(torch.int64), ovf, route[1],
                           n_hit.to(torch.int64).reshape(())])
        return send_pay, send_fps, pre

    def _exchange(self, send_pay, send_fps):
        """The two all-to-alls (``_chunk_step`` :486-487)."""
        recv_pay = torch.empty_like(send_pay)
        recv_fps = torch.empty_like(send_fps)
        dist.all_to_all_single(recv_pay, send_pay, group=self.group)
        dist.all_to_all_single(recv_fps, send_fps, group=self.group)
        return recv_pay, recv_fps

    def _cs_post(self, recv_pay, recv_fps, st, pre, runs):
        """Post-exchange stages on the owner (``_cs_post``, :623-729), all
        in place on the carries ``st``; returns the chunk's sorted run."""
        W, B = self.W, self.EPAD
        stats = st["stats"]
        new, run, order = chunk_dedup(recv_fps, runs, self.R0, with_order=True)
        # the survivors in fingerprint order (the reference's emit order):
        # their positions in the sorted order, then their received lanes
        pos, n_new = compact_indices(new[order.to(torch.int64)], B, B)
        fill = torch.full((1,), B, dtype=torch.int32, device=order.device)
        lanes = torch.cat([order, fill])[pos.to(torch.int64)]
        frontier_ovf = stats[0] + n_new > self.FCAP
        journal_ovf = stats[1] + n_new > self.JCAP
        append_rows(st["next_buf"], recv_pay[:, :W], lanes, stats[0:1], self.FCAP)
        jcur = stats[1:2]
        append_rows(st["jps"], self._shard_of_lane, lanes, jcur, self.JCAP)
        append_rows(st["jpl"], recv_pay[:, W:W + 1], lanes, jcur, self.JCAP)
        append_rows(st["jcand"], recv_pay[:, W + 1:W + 2], lanes, jcur, self.JCAP)
        # the run's first n_new lanes are the survivors' fingerprints in
        # emit order; the int64 lane appends as two int32 words a row
        append_rows(st["jfp"].view(torch.int32).view(-1, 2), run.view(torch.int32).view(-1, 2),
                    self._iota_b, jcur, self.JCAP)
        # the owner-side fold over the survivors' rows in emit order: the
        # journal index of row j is jcount + j, its rank the routed column
        blk = torch.empty((B, W), dtype=torch.int32, device=recv_pay.device)
        append_rows(blk, recv_pay[:, :W], lanes, self._zero1, 0)
        rank_blk = torch.empty(B, dtype=torch.int32, device=recv_pay.device)
        append_rows(rank_blk, recv_pay[:, W + 2:W + 3], lanes, self._zero1, 0)
        newp = self._iota_b < n_new
        self.model.chunk_fold(blk, newp, jcur, st["viol"], self.invariants, cov=st["cov"],
                              sel=self._iota_b, valid=newp, rank=rank_blk)
        ovf = pre[2] | 8 * frontier_ovf.to(torch.int64) | 16 * journal_ovf.to(torch.int64)
        zero = torch.zeros_like(n_new)
        stats += torch.stack([n_new, n_new, pre[0], pre[1], zero, pre[3], pre[4]])
        stats[4:5] |= ovf
        return run

    def _run_wave(self, st, fcount: int, max_fc: int, base_lgid: int):
        """Every chunk of one wave (``max_fc``, the mesh's largest frontier,
        sets the chunk count: the exchange is collective), with the same
        binary-counter ladder of sorted runs as DeviceBFS. Returns the
        ladder."""
        C = self.chunk
        st["stats"][0:1].zero_()
        st["stats"][4:5].zero_()
        ladder: list[torch.Tensor | None] = [None] * (self._wave_geom() + 1)
        for k in range(-(-max_fc // C)):
            runs = [self._seen] + [r for r in ladder if r is not None]
            send_pay, send_fps, pre = self._cs_pre(st["frontier"], fcount, st["memo"],
                                                   st["cov"], k * C, base_lgid)
            recv_pay, recv_fps = self._exchange(send_pay, send_fps)
            del send_pay, send_fps
            self._ladder_push(ladder, self._cs_post(recv_pay, recv_fps, st, pre, runs), k)
        return ladder

    # ---------------- buffers and growth ----------------

    def _carries(self, frontier_rows, jrows, stats0, cov0):
        """Fresh per-shard carries sized to the current capacities, with
        the given frontier rows and journal lanes (jps, jpl, jcand, jfp enc)
        copied in."""
        dev, W = self.device, self.W
        i32 = dict(dtype=torch.int32, device=dev)
        n_inv = max(1, len(self.invariants))
        F, J = self.FCAP + self.EPAD, self.JCAP + self.EPAD
        st = {
            "frontier": torch.zeros((F, W), **i32), "next_buf": torch.zeros((F, W), **i32),
            "jps": torch.zeros(J, **i32), "jpl": torch.zeros(J, **i32),
            "jcand": torch.zeros(J, **i32),
            "jfp": torch.full((J,), INT64_MAX, dtype=torch.int64, device=dev),
            "viol": torch.full((n_inv,), I32_MAX, dtype=torch.int64, device=dev),
            "stats": torch.as_tensor(np.asarray(stats0, np.int64)).to(dev),
            "cov": torch.as_tensor(np.asarray(cov0, np.int64).reshape(self.n_actions, 3)).to(dev),
        }
        if len(frontier_rows):
            st["frontier"][:len(frontier_rows)] = torch.as_tensor(
                np.ascontiguousarray(frontier_rows, dtype=np.int32)).to(dev)
        for key, h in zip(("jps", "jpl", "jcand", "jfp"), jrows):
            if len(h):
                st[key][:len(h)] = torch.as_tensor(np.ascontiguousarray(h)).to(dev)
        return st

    def _resize(self, st, fcount: int, jcount: int, swap: bool) -> None:
        """Reallocate the capacity-shaped carries at the current FCAP,
        JCAP and EPAD, keeping the frontier's ``fcount`` rows (the
        next_buf's when ``swap``: the wave's output becomes the frontier)
        and the journal's ``jcount`` rows."""
        dev, W = self.device, self.W
        F, J = self.FCAP + self.EPAD, self.JCAP + self.EPAD
        src = st.pop("next_buf" if swap else "frontier")
        st.pop("frontier" if swap else "next_buf")
        st["frontier"] = torch.zeros((F, W), dtype=torch.int32, device=dev)
        st["frontier"][:fcount] = src[:fcount]
        del src
        st["next_buf"] = torch.zeros((F, W), dtype=torch.int32, device=dev)
        for key in ("jps", "jpl", "jcand", "jfp"):
            old = st[key]
            if old.numel() == J:
                continue
            fillv = INT64_MAX if key == "jfp" else 0
            st[key] = torch.full((J,), fillv, dtype=old.dtype, device=dev)
            st[key][:jcount] = old[:jcount]

    def _maybe_grow(self, st, fmax: int, jmax: int, fcount: int, jcount: int) -> None:
        """Between waves (``_maybe_grow`` of the reference, :731): the
        wave's output becomes the frontier, and every shard enlarges the
        buffers the next wave could outgrow, from the mesh's largest
        frontier ``fmax`` and journal ``jmax``."""
        grow_f = fmax * self.HEADROOM > self.FCAP and self.FCAP < self.MAX_FCAP
        grow_j = jmax + fmax * self.HEADROOM > self.JCAP and self.JCAP < self.MAX_JCAP
        if grow_f:
            self.FCAP = next_cap(fmax * self.HEADROOM, self.FCAP, self.MAX_FCAP, self.GROWTH,
                                 self.chunk)
        if grow_j:
            self.JCAP = next_cap(jmax + fmax * self.HEADROOM, self.JCAP, self.MAX_JCAP,
                                 self.GROWTH, 1)
        if grow_f or grow_j:
            self._resize(st, fcount, jcount, swap=True)
        else:
            st["frontier"], st["next_buf"] = st["next_buf"], st["frontier"]

    def grow_for_overflow(self, bits: int) -> dict | None:
        """Constructor overrides that would clear the overflow ``bits`` on a
        rebuilt engine, or None when no growth helps (``grow_for_overflow``
        of the reference, :764)."""
        bits = int(bits)
        if bits & 1:
            return None  # the message slots are a model property
        growth: dict = {}
        if bits & 2:
            growth["valid_per_state"] = min(self.A, -(-self.VC // self.chunk) * 2)
        if bits & 4:
            growth["route_cap"] = self.RC * 2
        if bits & 8:
            growth["frontier_cap"] = self.FCAP * 2
            growth["max_frontier_cap"] = max(self.MAX_FCAP, self.FCAP * 4)
        if bits & 16:
            growth["journal_cap"] = self.JCAP * 2
            growth["max_journal_cap"] = max(self.MAX_JCAP, self.JCAP * 4)
        if bits & self.SEEN_OVF_BIT:
            growth["max_seen_cap"] = self.MAX_SCAP * 4
        return growth or None

    # ---------------- collectives of the host loop ----------------

    def _all_gather(self, t: torch.Tensor) -> np.ndarray:
        """[D, *t.shape] of every shard's ``t`` on every shard (one host
        read)."""
        parts = [torch.empty_like(t) for _ in range(self.D)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.stack(parts).cpu().numpy()

    def _scatter_obj(self, objs):
        """Rank 0's ``objs[d]`` on shard d."""
        out = [None]
        dist.scatter_object_list(out, objs if self.rank == 0 else None, src=0, group=self.group)
        return out[0]

    # ---------------- checkpoints ----------------

    def _ckpt_ident(self) -> str:
        return ckpt_ident(self.model, self.canon, self.invariants, self.D)

    def _save_checkpoint(self, path, st, h) -> None:
        """Gather every shard's state to rank 0 and write the reference's
        v2 payload (``_save_checkpoint``, :822). ``h`` holds the host
        counters (per-shard vectors and the run's totals). Collective."""
        D, W = self.D, self.W
        fmax = int(h["fcounts"].max())
        jmax = int(h["jcounts"].max())
        smax = int(h["scounts"].max())
        fc, sc, jc = (int(h[k][self.rank]) for k in ("fcounts", "scounts", "jcounts"))
        seen = torch.full((max(smax, 1),), INT64_MAX, dtype=torch.int64, device=self.device)
        seen[:sc] = self._seen[:sc]
        front = torch.zeros((max(fmax, 1), W), dtype=torch.int32, device=self.device)
        front[:fc] = st["frontier"][:fc]

        def lane(key, fillv):
            t = torch.full((max(jmax, 1),), fillv, dtype=st[key].dtype, device=self.device)
            t[:jc] = st[key][:jc]
            return self._all_gather(t)[:, :jmax]

        parts = {"frontier": self._all_gather(front)[:, :fmax],
                 "seen": rckpt.u64_of_enc(self._all_gather(seen)[:, :smax]),
                 "jps": lane("jps", 0), "jpl": lane("jpl", 0), "jcand": lane("jcand", 0),
                 "jfp": rckpt.u64_of_enc(lane("jfp", INT64_MAX))}
        if self.rank != 0:
            return
        rckpt.save_npz(path, dict(
            version=2, spec=self._ckpt_ident(),
            fcounts=h["fcounts"], scounts=h["scounts"], jcounts=h["jcounts"], n0=h["n0"],
            base_lgid=h["base_lgid"], **parts,
            init_by_shard_flat=np.concatenate(
                [np.stack(s) if s else np.zeros((0, W), np.int32)
                 for s in self._init_by_shard], axis=0),
            init_by_shard_count=np.asarray([len(s) for s in self._init_by_shard], np.int64),
            distinct=h["distinct"], total=h["total"], terminal=h["terminal"], depth=h["depth"],
            gen_prev=h["gen_prev"], routed_prev=h["routed_prev"],
            depth_counts=np.asarray(h["depth_counts"], dtype=np.int64),
            coverage=np.asarray(h["coverage"], dtype=np.int64),
        ), keep=self._ckpt_keep)

    def _fingerprints_u64(self, rows: np.ndarray) -> np.ndarray:
        if not len(rows):
            return np.zeros(0, np.uint64)
        fps = self.canon.fingerprints(torch.from_numpy(np.ascontiguousarray(rows)).to(self.device))
        return rckpt.u64_of_enc(fps.cpu().numpy())

    def _reshard_payload(self, ck: dict, d_old: int) -> dict:
        """Re-route a payload written on a D=``d_old`` mesh onto this
        engine's D (``_reshard_payload`` of the reference, :1026): inits
        and seen fingerprints by fp mod D; journal rows by their jfp, in
        (old shard, old row) order per new shard except that frontier rows
        go last (frontier row i of shard d stays journal row
        jcounts[d] - fcounts[d] + i); parent pointers rewritten through the
        old -> new (shard, lgid) maps; coverage summed into shard 0."""
        D_new, W = self.D, self.W
        fcounts_o = np.asarray(ck["fcounts"], np.int64)
        scounts_o = np.asarray(ck["scounts"], np.int64)
        jcounts_o = np.asarray(ck["jcounts"], np.int64)
        frontier_o = np.asarray(ck["frontier"])
        seen_o = np.asarray(ck["seen"])
        jps_o, jpl_o, jcand_o = (np.asarray(ck[k]) for k in ("jps", "jpl", "jcand"))
        jfp_o = np.asarray(ck["jfp"], np.uint64)
        counts_o = np.asarray(ck["init_by_shard_count"], np.int64)
        flat = np.asarray(ck["init_by_shard_flat"]).astype(np.int32)
        n0_o = np.asarray(ck["n0"], np.int64)

        def cat(parts, dtype):
            return np.concatenate(parts).astype(dtype) if parts else np.zeros(0, dtype)

        # inits: by fingerprint, stable flat order per shard
        n_init = len(flat)
        ifp = self._fingerprints_u64(flat)
        iowner = (ifp % np.uint64(D_new)).astype(np.int64)
        ioff_o = np.concatenate([[0], np.cumsum(counts_o)]).astype(np.int64)
        n0_n = np.bincount(iowner, minlength=D_new).astype(np.int64)
        iord = np.argsort(iowner, kind="stable")
        new_il = np.empty(n_init, np.int64)
        new_il[iord] = cat([np.arange(int(c)) for c in n0_n], np.int64)
        init_by_shard_n: list[list[np.ndarray]] = [[] for _ in range(D_new)]
        for idx in iord:
            init_by_shard_n[int(iowner[idx])].append(np.asarray(flat[idx]))

        # journal rows: flattened, routed by jfp, frontier rows last
        nrows = int(jcounts_o.sum())
        glob_d = np.repeat(np.arange(d_old), jcounts_o)
        glob_j = cat([np.arange(int(c)) for c in jcounts_o], np.int64)
        joff_o = np.concatenate([[0], np.cumsum(jcounts_o)]).astype(np.int64)
        jfp_flat = cat([jfp_o[d, :int(jcounts_o[d])] for d in range(d_old)], np.uint64)
        jowner = (jfp_flat % np.uint64(D_new)).astype(np.int64)
        front0 = jcounts_o - fcounts_o
        is_front = glob_j >= front0[glob_d]
        order = np.lexsort((glob_j, glob_d, is_front, jowner))
        jcounts_n = np.bincount(jowner, minlength=D_new).astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(jcounts_n)]).astype(np.int64)
        new_jd = np.repeat(np.arange(D_new), jcounts_n)
        new_jj = cat([np.arange(int(c)) for c in jcounts_n], np.int64)
        jd_of = np.empty(nrows, np.int64)
        jj_of = np.empty(nrows, np.int64)
        jd_of[order] = new_jd
        jj_of[order] = new_jj

        # parent pointers through the old -> new maps
        pd = cat([jps_o[d, :int(jcounts_o[d])] for d in range(d_old)], np.int64)
        pl = cat([jpl_o[d, :int(jcounts_o[d])] for d in range(d_old)], np.int64)
        cand_flat = cat([jcand_o[d, :int(jcounts_o[d])] for d in range(d_old)], np.int64)
        isin = pl < n0_o[pd]
        rew_pd = np.empty(nrows, np.int64)
        rew_pl = np.empty(nrows, np.int64)
        fi = ioff_o[pd[isin]] + pl[isin]
        rew_pd[isin] = iowner[fi]
        rew_pl[isin] = new_il[fi]
        fj = joff_o[pd[~isin]] + (pl[~isin] - n0_o[pd[~isin]])
        rew_pd[~isin] = jd_of[fj]
        rew_pl[~isin] = n0_n[jd_of[fj]] + jj_of[fj]

        jmax_n = int(jcounts_n.max()) if nrows else 0
        jps_n = np.zeros((D_new, jmax_n), np.int32)
        jpl_n = np.zeros((D_new, jmax_n), np.int32)
        jcand_n = np.zeros((D_new, jmax_n), np.int32)
        jfp_n = np.full((D_new, jmax_n), U64_MAX)
        rew_pd_s, rew_pl_s = rew_pd[order], rew_pl[order]
        cand_s, fp_s = cand_flat[order], jfp_flat[order]
        for d in range(D_new):
            s, c = int(starts[d]), int(jcounts_n[d])
            jps_n[d, :c] = rew_pd_s[s:s + c]
            jpl_n[d, :c] = rew_pl_s[s:s + c]
            jcand_n[d, :c] = cand_s[s:s + c]
            jfp_n[d, :c] = fp_s[s:s + c]

        # frontier: the journal-tail rows in new-journal order (the inits
        # themselves when no wave has committed yet)
        if nrows:
            isf_s = is_front[order]
            gd_s, gj_s = glob_d[order], glob_j[order]
            fcounts_n = np.bincount(jowner[is_front], minlength=D_new).astype(np.int64)
            frontier_n = np.zeros((D_new, max(1, int(fcounts_n.max())), W), np.int32)
            fpos = np.zeros(D_new, np.int64)
            for k in np.nonzero(isf_s)[0]:
                d = int(new_jd[k])
                frontier_n[d, fpos[d]] = frontier_o[gd_s[k], int(gj_s[k] - front0[gd_s[k]])]
                fpos[d] += 1
        else:
            fcounts_n = n0_n.copy()
            frontier_n = np.zeros((D_new, max(1, int(fcounts_n.max())), W), np.int32)
            for d in range(D_new):
                for i, row in enumerate(init_by_shard_n[d]):
                    frontier_n[d, i] = row

        # seen: repartitioned, sorted per new shard
        seen_parts: list[list[np.ndarray]] = [[] for _ in range(D_new)]
        for d in range(d_old):
            s = seen_o[d, :int(scounts_o[d])].astype(np.uint64)
            own = (s % np.uint64(D_new)).astype(np.int64)
            for dn in range(D_new):
                seen_parts[dn].append(s[own == dn])
        seen_n = [np.sort(cat(p, np.uint64)) for p in seen_parts]
        scounts_n = np.asarray([len(s) for s in seen_n], np.int64)
        assert (scounts_n == n0_n + jcounts_n).all(), \
            "reshard broke the seen = inits + journal invariant"
        seen_h = np.full((D_new, max(1, int(scounts_n.max()))), U64_MAX)
        for d, s in enumerate(seen_n):
            seen_h[d, :len(s)] = s

        cov_o = (np.asarray(ck["coverage"], np.int64) if "coverage" in ck
                 else np.zeros((d_old, self.n_actions, 3), np.int64))
        cov_n = np.zeros((D_new, self.n_actions, 3), np.int64)
        if self.n_actions:
            cov_n[0] = cov_o.sum(axis=0)

        out = dict(ck)
        out.update(
            version=np.int64(2), spec=self._ckpt_ident(),
            fcounts=fcounts_n, scounts=scounts_n, jcounts=jcounts_n, n0=n0_n,
            base_lgid=n0_n + jcounts_n - fcounts_n, frontier=frontier_n, seen=seen_h,
            jps=jps_n, jpl=jpl_n, jcand=jcand_n, jfp=jfp_n,
            init_by_shard_flat=np.concatenate(
                [np.stack(s) if s else np.zeros((0, W), np.int32) for s in init_by_shard_n],
                axis=0),
            init_by_shard_count=np.asarray([len(s) for s in init_by_shard_n], np.int64),
            coverage=cov_n,
        )
        return out

    def _load_shards(self, resume: str, keep: int, reshard: bool):
        """Rank 0 loads the checkpoint, checks its spec, reshards it when
        it was written at another D, and scatters one part per shard (a
        failure is scattered too, so every shard raises it). Returns this
        shard's (part, D of the file)."""
        parts = None
        if self.rank == 0:
            try:
                ck, _gen, _skipped = rckpt.load_npz(resume, keep=keep)
                rckpt.check_spec(ck, self._ckpt_ident(), resume, allow_reshard=reshard)
                if "jfp" not in ck:
                    raise CheckpointMismatch(
                        f"{resume}: a payload without the jfp journal lane (version 1) cannot "
                        "resume here: its recovery by replay is not ported to raft_tpu_torch "
                        "(ROADMAP.md Queue 1 item 3)")
                d_ck = rckpt.mesh_d_of(str(ck["spec"])) or self.D
                if d_ck != self.D:
                    ck = self._reshard_payload(ck, d_ck)
                shared = {k: ck[k] for k in ("n0", "fcounts", "scounts", "jcounts",
                                             "base_lgid", "init_by_shard_count",
                                             "init_by_shard_flat", "distinct", "total",
                                             "terminal", "depth", "gen_prev", "routed_prev",
                                             "depth_counts")}
                cov = (np.asarray(ck["coverage"], np.int64) if "coverage" in ck
                       else np.zeros((self.D, self.n_actions, 3), np.int64))
                shared["coverage_all"] = cov
                parts = []
                for d in range(self.D):
                    fc, sc, jc = (int(ck[k][d]) for k in ("fcounts", "scounts", "jcounts"))
                    parts.append(dict(
                        shared, d_ck=d_ck, frontier=ck["frontier"][d, :fc],
                        seen=ck["seen"][d, :sc], coverage=cov[d],
                        **{k: ck[k][d, :jc] for k in ("jps", "jpl", "jcand", "jfp")}))
            except Exception as e:  # every shard raises rank 0's failure
                parts = [e] * self.D
        part = self._scatter_obj(parts)
        if isinstance(part, BaseException):
            raise part
        return part

    # ---------------- host loop ----------------

    def run(self, max_depth: int | None = None, verbose: bool = False,
            time_budget_s: float | None = None, collect_metrics: bool = False,
            checkpoint_path: str | None = None, checkpoint_every_s: float = 300.0,
            checkpoint_keep: int = rckpt.DEFAULT_KEEP, resume: str | None = None,
            reshard: bool = True, stall_abort_factor: float | None = None, telemetry=None,
            preempt=None, chaos=None) -> ShardedResult:
        """Explore on every shard; collective (every rank calls it with the
        same arguments). The result is whole on rank 0 (the trace only
        there)."""
        refuse_unported(telemetry=telemetry, preempt=preempt, chaos=chaos,
                        stall_abort_factor=stall_abort_factor)
        model, D, rank, dev = self.model, self.D, self.rank, self.device
        t0 = time.perf_counter()
        exhausted, exit_cause = True, None
        self._ckpt_keep = checkpoint_keep
        self.redone_chunks = 0
        n_inv = max(1, len(self.invariants))
        K = self.n_actions

        init = np.asarray(model.init_states())
        init_fps = self._fingerprints_u64(init)
        order = np.argsort(init_fps, kind="stable")
        dup = np.zeros(len(order), dtype=bool)
        dup[1:] = init_fps[order][1:] == init_fps[order][:-1]
        keep = np.ones(len(order), dtype=bool)
        keep[order[dup]] = False
        init_d, init_fps = init[keep], init_fps[keep]

        violation = viol_site = init_trace = None
        if resume is not None:
            part = self._load_shards(resume, checkpoint_keep, reshard)
            fcounts, scounts, jcounts, n0, base_lgid = (
                np.asarray(part[k], np.int64) for k in ("fcounts", "scounts", "jcounts", "n0",
                                                        "base_lgid"))
            fmax, jmax = int(fcounts.max()), int(jcounts.max())
            self.FCAP = next_cap(max(self.FCAP, fmax * self.HEADROOM), self.FCAP,
                                 self.MAX_FCAP, self.GROWTH, self.chunk)
            self.JCAP = next_cap(max(self.JCAP, jmax + fmax * self.HEADROOM), self.JCAP,
                                 self.MAX_JCAP, self.GROWTH, 1)
            self._seed_seen(rckpt.enc_of_u64(part["seen"]))
            counts = np.asarray(part["init_by_shard_count"], np.int64)
            flat = np.asarray(part["init_by_shard_flat"])
            offs = np.concatenate([[0], np.cumsum(counts)])
            self._init_by_shard = [[flat[i] for i in range(offs[d], offs[d + 1])]
                                   for d in range(D)]
            distinct, total = int(part["distinct"]), int(part["total"])
            depth = int(part["depth"])
            depth_counts = [int(x) for x in part["depth_counts"]]
            # the per-shard cumulative counters restart at 0 over these bases
            gen_base, term_base = int(part["gen_prev"]), int(part["terminal"])
            routed_base = int(part["routed_prev"])
            stats0 = np.zeros(N_STATS, np.int64)
            stats0[1] = jcounts[rank]
            st = self._carries(part["frontier"], (part["jps"], part["jpl"], part["jcand"],
                                                  rckpt.enc_of_u64(part["jfp"])),
                               stats0, part["coverage"])
            if verbose and rank == 0 and part["d_ck"] != D:
                print(f"resume: resharded {resume} from D={part['d_ck']} to D={D}",
                      file=sys.stderr)
        else:
            owner = (init_fps % np.uint64(D)).astype(np.int64)
            self._init_by_shard = [[np.asarray(r) for r in init_d[owner == d]] for d in range(D)]
            n0 = np.bincount(owner, minlength=D).astype(np.int64)
            fcounts, scounts = n0.copy(), n0.copy()
            jcounts = np.zeros(D, np.int64)
            base_lgid = np.zeros(D, np.int64)
            self._seed_seen(np.sort(rckpt.enc_of_u64(init_fps[owner == rank])))
            v = self.local._check_init(init_d)
            if v is not None:
                violation = v.invariant
                init_trace = [("Initial predicate", model.decode(init_d[v.global_id]))]
            distinct = int(len(init_d))
            total = int(len(init))  # pre-dedup, as the reference seeds it
            depth = 0
            depth_counts = [distinct]
            gen_base = term_base = routed_base = 0
            mine = init_d[owner == rank]
            st = self._carries(mine, (), np.zeros(N_STATS, np.int64),
                               np.zeros((K, 3), np.int64))
        gen_prev = routed_prev = memo_prev = 0
        terminal = 0
        cov_hd = (np.asarray(part["coverage_all"], np.int64) if resume is not None
                  else np.zeros((D, K, 3), np.int64))
        routed_prev_d = np.zeros(D, np.int64)
        per_shard_memo = np.zeros(D, np.int64)
        metrics: list[dict] | None = [] if collect_metrics else None
        st["memo"] = self.local._memo.reset(dev)
        el0 = 0.0  # rank 0's elapsed seconds at the last gather
        last_ckpt = 0.0

        def host():
            return dict(fcounts=fcounts, scounts=scounts, jcounts=jcounts, n0=n0,
                        base_lgid=base_lgid, distinct=distinct, total=total,
                        terminal=terminal + term_base, depth=depth,
                        gen_prev=gen_prev + gen_base, routed_prev=routed_prev + routed_base,
                        depth_counts=depth_counts, coverage=cov_hd)

        while fcounts.sum() and violation is None:
            if max_depth is not None and depth >= max_depth:
                exhausted, exit_cause = False, "max_depth"
                break
            if time_budget_s is not None and el0 > time_budget_s:
                exhausted, exit_cause = False, "time_budget"
                break
            # top-absorb guard: a shard's wave-new count is bounded by FCAP
            # and by the whole mesh's routed candidates
            if int(scounts.max()) + min(self.FCAP, int(fcounts.sum()) * self.VC) > self.TOPSZ:
                if checkpoint_path is not None:
                    self._save_checkpoint(checkpoint_path, st, host())
                raise CapacityOverflow(
                    "sharded seen-set capacity overflow; raise max_seen_cap",
                    bits=self.SEEN_OVF_BIT, what=("seen",),
                    checkpoint_saved=checkpoint_path is not None)
            tw = time.perf_counter()
            before = {k: st[k].clone() for k in ("stats", "viol", "cov")}
            ladder = self._run_wave(st, int(fcounts[rank]), int(fcounts.max()),
                                    int(base_lgid[rank]))
            # the wave's one host read: every shard's stats, violations,
            # coverage and rank 0's clock
            clock_us = torch.tensor([int((time.perf_counter() - t0) * 1e6)]).to(dev)
            g = self._all_gather(torch.cat([st["stats"], st["viol"], st["cov"].reshape(-1),
                                            clock_us]))
            stats_h = g[:, :N_STATS]
            viol_h = g[:, N_STATS:N_STATS + n_inv]
            cov_w = g[:, N_STATS + n_inv:N_STATS + n_inv + 3 * K]
            el0 = float(g[0, -1]) / 1e6
            new_d = stats_h[:, 0].copy()
            ovf_bits = int(np.bitwise_or.reduce(stats_h[:, 4]))
            widen = 0
            if ovf_bits & 2 and not ovf_bits & 1 and self.VC < self.chunk * self.A:
                widen = 2
            elif ovf_bits == 4 and self.RC < self.VC:
                widen = 4
            if widen:
                # the worklist (or a route block) overflowed: every shard
                # redoes the wave with it doubled (its seen run, frontier
                # and journal[:jcount] are as at the wave's start)
                for k, b in before.items():
                    st[k] = b
                del ladder
                if widen == 2:
                    self.local._set_worklist(2 * (self.VC // self.chunk))
                else:
                    self._route_cap = 2 * self.RC
                self._geometry()
                self._resize(st, int(fcounts[rank]), int(jcounts[rank]), swap=False)
                self.redone_chunks += -(-int(fcounts.max()) // self.chunk)
                if verbose and rank == 0:
                    print(f"depth {depth + 1}: {'worklist' if widen == 2 else 'route'} "
                          f"overflow, redone with {self.VC // self.chunk} lanes per state, "
                          f"route cap {self.RC}", file=sys.stderr)
                continue
            if ovf_bits:
                # the aborted wave touched neither the seen runs nor the
                # frontiers nor journal[:jcount]: the wave-start state saves
                if checkpoint_path is not None:
                    self._save_checkpoint(checkpoint_path, st, host())
                raise CapacityOverflow(
                    f"sharded BFS capacity overflow (bits={ovf_bits:05b}: "
                    "1=msg-slots 2=valid_per_state 4=route_cap 8=frontier_cap "
                    "16=journal_cap)"
                    + (f"; wave-start checkpoint saved to {checkpoint_path}"
                       if checkpoint_path is not None else ""),
                    bits=ovf_bits, what=tuple(n for b, n in self.OVF_NAMES if ovf_bits & b),
                    checkpoint_saved=checkpoint_path is not None)
            cov_hd = cov_w.reshape(D, K, 3)
            global_new = int(new_d.sum())
            n_gen_cum = int(stats_h[:, 2].sum())
            wave_gen = n_gen_cum - gen_prev
            total += wave_gen
            gen_prev = n_gen_cum
            terminal = int(stats_h[:, 3].sum())
            wave_routed = int(stats_h[:, 5].sum()) - routed_prev
            routed_prev = int(stats_h[:, 5].sum())
            routed_prev_d = stats_h[:, 5].copy()
            memo_hits = int(stats_h[:, 6].sum())
            wave_memo = memo_hits - memo_prev
            memo_prev = memo_hits
            per_shard_memo = stats_h[:, 6].copy()
            if global_new == 0:
                exit_cause = "exhausted"
                break
            self._merge_seen(ladder, int(scounts[rank] + new_d[rank]))
            del ladder
            depth += 1
            distinct += global_new
            depth_counts.append(global_new)
            prev_front = int(fcounts.sum())
            base_lgid = n0 + stats_h[:, 1] - new_d
            scounts = scounts + new_d
            jcounts = stats_h[:, 1].copy()
            for k, name in enumerate(self.invariants):
                col = viol_h[:, k]
                if (col != I32_MAX).any():
                    d = int(np.argmin(col))  # the lowest journal index, lowest shard
                    violation = name
                    viol_site = (d, int(n0[d] + col[d]))
                    break
            fcounts = new_d
            if violation is None:
                self._maybe_grow(st, int(fcounts.max()), int(jcounts.max()),
                                 int(fcounts[rank]), int(jcounts[rank]))
                if checkpoint_path is not None and el0 - last_ckpt > checkpoint_every_s:
                    self._save_checkpoint(checkpoint_path, st, host())
                    last_ckpt = el0
            else:
                st["frontier"], st["next_buf"] = st["next_buf"], st["frontier"]
            if metrics is not None or (verbose and rank == 0):
                wave_s = time.perf_counter() - tw
                el = max(el0, 1e-9)
                wm = {
                    "depth": depth, "frontier": prev_front, "new": global_new,
                    "distinct": distinct, "generated": wave_gen, "generated_total": total,
                    "terminal": terminal + term_base,
                    "dedup_hit_rate": round(1.0 - global_new / max(1, wave_gen), 4),
                    "canon_memo_hits": wave_memo,
                    "canon_memo_hit_rate": round(wave_memo / max(1, wave_gen), 4),
                    "overflow_bits": ovf_bits, "wave_s": round(wave_s, 3),
                    "elapsed_s": round(el, 3), "distinct_per_s": round(distinct / el, 1),
                    "a2a_lanes": wave_routed,
                    # the payload is W + 3 int32 words and an 8-byte fingerprint
                    "a2a_bytes": wave_routed * (4 * (self.W + 3) + 8),
                    "shard_new": [int(x) for x in new_d],
                    "shard_new_min": int(new_d.min()), "shard_new_max": int(new_d.max()),
                    "emit_rows": global_new,
                    "frontier_fill": round(int(new_d.max()) / self.FCAP, 4),
                    "enabled_density": round(wave_gen / max(1, prev_front * self.A), 4),
                }
                if metrics is not None:
                    metrics.append(wm)
                if verbose and rank == 0:
                    print(f"depth {depth}: +{global_new} distinct={distinct} "
                          f"a2a={wave_routed} lanes balance={new_d.min()}/{new_d.max()} "
                          f"({distinct / el:.0f} distinct/s)", file=sys.stderr)

        if checkpoint_path is not None and violation is None and not exhausted:
            self._save_checkpoint(checkpoint_path, st, host())

        trace = init_trace
        self.violation_site = viol_site
        if violation is not None and viol_site is not None:
            # the journals of every shard to rank 0 for the replay
            jmax = max(1, int(jcounts.max()))
            lanes = [self._all_gather(st[k][:jmax].contiguous())
                     for k in ("jps", "jpl", "jcand")]
            self._journals = (*lanes, jcounts.copy(), n0.copy())
            if rank == 0:
                trace = self.reconstruct_trace(viol_site)
        dt = time.perf_counter() - t0
        if violation is not None:
            exit_cause = "violation"
        elif exit_cause is None:
            exit_cause = "exhausted"
        stats = {
            "canon_memo_hits": memo_prev,
            "canon_memo_hit_rate": round(memo_prev / max(1, gen_prev), 4),
            "shard_memo_hits": [int(x) for x in per_shard_memo],
            "shard_distinct": [int(x) for x in scounts],
            "shard_skew": round(int(scounts.max()) / max(1, int(scounts.min())), 3),
            "shard_routed": [int(x) for x in routed_prev_d],
            "frontier_cap": self.FCAP, "journal_cap": self.JCAP, "valid_cap": self.VC,
            "route_cap": self.RC, "redone_chunks": self.redone_chunks,
            **self._coverage_fields(depth, cov_hd, scounts, depth_counts),
        }
        return ShardedResult(
            distinct=distinct, total=total, depth=depth, depth_counts=depth_counts,
            violation_invariant=violation, seconds=dt,
            states_per_sec=distinct / dt if dt > 0 else 0.0, terminal=terminal + term_base,
            exhausted=exhausted and violation is None, trace=trace, metrics=metrics,
            stats=stats, coverage=stats["actions"] if K else None, exit_cause=exit_cause)

    # ---------------- trace reconstruction ----------------

    def journal_chain(self, site: tuple[int, int]) -> tuple[np.ndarray, list[int]]:
        """(initial state row, candidates taken) of the journalled state at
        ``site`` = (shard, local gid), by its cross-shard parent pointers
        (rank 0, after a violation)."""
        jps_h, jpl_h, jcand_h, jcounts, n0 = self._journals
        d, lgid = site
        chain: list[int] = []
        while lgid >= n0[d]:
            j = int(lgid - n0[d])
            assert j < jcounts[d], "journal index out of range"
            chain.append(int(jcand_h[d, j]))
            d, lgid = int(jps_h[d, j]), int(jpl_h[d, j])
        chain.reverse()
        return self._init_by_shard[d][int(lgid)], chain

    def reconstruct_trace(self, site: tuple[int, int]) -> list[tuple[str, dict]]:
        """The labelled trace to the state at ``site``: the journal chain
        replayed through the guard and a one-lane apply
        (``reconstruct_trace`` of the reference, :2096)."""
        init, chain = self.journal_chain(site)
        return replay_chain(self.model, self.device, init, chain)

    def _coverage_fields(self, depth: int, cov_hd, scounts, depth_counts) -> dict:
        """The coverage fields of the result's stats (``_coverage_fields``
        of the reference, :2040, whose other reader, the telemetry coverage
        event, waits for ROADMAP.md Queue 1 item 4): the per-shard
        [enabled, fired, new] counters summed over the mesh."""
        fleet = np.asarray(cov_hd).sum(axis=0)
        return {
            "depth": depth,
            "actions": [[int(x) for x in row] for row in fleet],
            "actions_total": self.n_actions,
            "actions_fired": int(np.count_nonzero(fleet[:, 1])) if self.n_actions else 0,
            "seen_real": int(np.asarray(scounts).sum()),
            "frontier_hist": [int(x) for x in depth_counts],
        }

