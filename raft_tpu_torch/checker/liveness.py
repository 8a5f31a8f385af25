"""Liveness / temporal-property checking under ``WF_vars(Next)``.

Counterpart of ``raft_tpu/checker/liveness.py`` with the same graph (the
same gids in discovery order, the same edge arrays), verdicts and lassos.
The reference's semantics: on the finite, fully explored state graph
(symmetry always off, full-state fingerprints) ``P ~> Q`` is violated iff
some reachable P-state can avoid Q forever, i.e. lies in the largest set
of ~Q-states each of which is terminal or has a successor in the set (a
nu-fixpoint peel); ``[]<>Q`` is ``TRUE ~> Q``. The counterexample is a
lasso: an Init prefix to the P-state, then a Q-free walk inside the set
to a terminal state or around a cycle.

The device passes per chunk of frontier states: ``model.chunk_guards``
(raft_guard) over the chunk, ``compact_indices`` of the valid lanes in
flat [chunk * A] order (the reference's ``np.nonzero(valid)`` order),
``model.chunk_apply`` (raft_apply) over those lanes, and ``hash_rows``
(the full-state hash) of each successor row. The rows of the lanes that
may be new states stay on the device, so the reference's second expand
(its pass B) is not needed. The global dedup, the peel, the shortest
paths and the lasso walk are the reference's numpy code. The graph's
predicates go through ``model.chunk_predicates`` (raft_predicates).

Model contract: ``model.liveness`` maps a property name to a list of
(instance label, P or None, Q), P and Q naming state predicates of
``model.predicates``.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..ops.hashing import hash_rows
from .util import compact_indices


@dataclass
class LivenessViolation:
    prop: str
    instance: str
    prefix: list[tuple[str, dict]]  # Init -> P-state (action label, state)
    cycle: list[tuple[str, dict]]  # the sustained Q-free loop (or terminal)
    terminal: bool  # True: lasso "cycle" is a terminal stutter


@dataclass
class LivenessResult:
    distinct: int
    total_edges: int
    properties: tuple[str, ...]
    violation: LivenessViolation | None
    seconds: float


class LivenessChecker:
    """Explores the FULL graph (symmetry off) and checks the model's
    registered temporal properties. The graph's states stay on
    ``device`` (``cuda`` by default; raises without a card), its edges on
    the host."""

    def __init__(self, model, properties: tuple[str, ...], chunk: int = 4096,
                 max_states: int = 8_000_000, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.properties = tuple(properties)
        self.chunk = chunk
        self.max_states = max_states
        unknown = [p for p in self.properties if p not in getattr(model, "liveness", {})]
        if unknown:
            raise ValueError(
                f"spec {model.name} has no liveness support for: {', '.join(unknown)}")
        preds = {x for p in self.properties for inst in model.liveness[p] for x in inst[1:]
                 if x is not None}
        model.prepare_device(self.device, tuple(sorted(preds)))
        # FULL-state fingerprints, not the VIEW projection (the reference's
        # reasoning, liveness.py:93-103); seed 0 is the primary family and
        # run(audit_seed=k) re-explores under family k
        self._seed = 0

    # ---------------- graph construction ----------------

    def _expand_chunk(self, batch: torch.Tensor, cov: torch.Tensor):
        """The valid successors of a chunk: (sel int64 [n] host flat lane
        ids in ascending order, rows [n, W] on the device, fps int64 [n]
        host enc full-state fingerprints)."""
        model, A = self.model, self.model.A
        nb = batch.shape[0]
        valid, _rank, _ovf, scal = model.chunk_guards(batch, nb, cov)
        n_gen, _terminal, ovf = (int(x) for x in scal.cpu())
        if ovf:
            raise OverflowError("message-slot overflow during liveness graph build")
        sel, _ = compact_indices(valid.reshape(-1), n_gen, nb * A)
        rows = model.chunk_apply(batch, sel)
        fps = hash_rows(rows, self._seed)
        return sel.cpu().numpy().astype(np.int64), rows, fps.cpu().numpy()

    def _explore(self, verbose: bool = False):
        model, dev = self.model, self.device
        t0 = time.perf_counter()
        B, A = self.chunk, model.A
        cov = torch.zeros((len(model.ACTION_NAMES), 3), dtype=torch.int64, device=dev)
        init = model.init_states()
        init_t = torch.from_numpy(init).to(dev)
        fp0 = hash_rows(init_t, self._seed).cpu().numpy()
        _uq, first = np.unique(fp0, return_index=True)
        first.sort()
        init_d = init_t[torch.from_numpy(first).to(dev)]  # first-occurrence order = gid order
        n = len(first)
        state_blocks = [init_d]
        order0 = np.argsort(fp0[first], kind="stable")
        sorted_fps = fp0[first][order0]
        sorted_gids = order0.astype(np.int64)
        frontier = init_d
        frontier_gids = np.arange(n, dtype=np.int64)
        esrc_l: list[np.ndarray] = []
        edst_l: list[np.ndarray] = []
        ecand_l: list[np.ndarray] = []
        self.chunks = 0  # chunks expanded (each a guard, compaction, apply and hash)

        while len(frontier):
            # ---- per chunk: valid lanes, their rows and fingerprints ----
            srcs_l, cands_l, fps_l, pos_l, hit_l = [], [], [], [], []
            cand_rows, cand_lanes, n_lanes = [], [], []
            for off in range(0, len(frontier), B):
                sel, rows, fps = self._expand_chunk(frontier[off:off + B], cov)
                self.chunks += 1
                pos = np.clip(np.searchsorted(sorted_fps, fps), 0, len(sorted_fps) - 1)
                hit = sorted_fps[pos] == fps
                # the lanes that may hold a new state: not in the table and
                # first of their fingerprint in this chunk (the first lane of
                # a new state in the wave is one of them); their rows stay
                miss = np.nonzero(~hit)[0]
                _u, fi = np.unique(fps[miss], return_index=True)
                keep = np.sort(miss[fi])
                cand_rows.append(rows[torch.from_numpy(keep).to(dev)])
                cand_lanes.append(keep)
                n_lanes.append(len(sel))
                srcs_l.append(frontier_gids[off + sel // A])
                cands_l.append((sel % A).astype(np.int32))
                fps_l.append(fps)
                pos_l.append(pos)
                hit_l.append(hit)
                del rows
            fps_w = np.concatenate(fps_l)
            if len(fps_w) == 0:
                break
            srcs = np.concatenate(srcs_l)
            cands = np.concatenate(cands_l)
            hit = np.concatenate(hit_l)

            # ---- resolve against the global table (the reference's code) ----
            gid_w = np.where(hit, sorted_gids[np.concatenate(pos_l)], -1)
            nf_mask = ~hit
            new_states = frontier[:0]
            if nf_mask.any():
                nf = fps_w[nf_mask]
                uq, first_u = np.unique(nf, return_index=True)
                disc = np.argsort(first_u, kind="stable")  # discovery order
                new_count = len(uq)
                if n + new_count > self.max_states:
                    raise OverflowError(
                        "liveness graph exceeds max_states; raise it or "
                        "use a smaller config (liveness needs the full graph): "
                        f"{n} states and {new_count} new ones, cap {self.max_states}")
                uq_gids = np.empty(new_count, np.int64)
                uq_gids[disc] = n + np.arange(new_count)
                gid_w[nf_mask] = uq_gids[np.searchsorted(uq, nf)]

                # ---- the new states' rows, from the candidates in hand ----
                nf_wave_lane = np.nonzero(nf_mask)[0][first_u]  # per uq
                bounds = np.cumsum([0] + n_lanes)
                ci = np.searchsorted(bounds, nf_wave_lane, side="right") - 1
                cand_off = np.cumsum([0] + [len(k) for k in cand_lanes])
                j = np.empty(new_count, np.int64)
                for c in np.unique(ci):
                    at = np.nonzero(ci == c)[0]
                    j[at] = cand_off[c] + np.searchsorted(cand_lanes[c],
                                                          nf_wave_lane[at] - bounds[c])
                allcand = torch.cat(cand_rows)
                new_states = allcand[torch.from_numpy(j[disc]).to(dev)]
                del allcand
                state_blocks.append(new_states)
                frontier_gids = n + np.arange(new_count, dtype=np.int64)
                n += new_count
                merged_fps = np.concatenate([sorted_fps, uq])
                merged_gids = np.concatenate([sorted_gids, uq_gids])
                order2 = np.argsort(merged_fps, kind="stable")
                sorted_fps = merged_fps[order2]
                sorted_gids = merged_gids[order2]
            del cand_rows
            esrc_l.append(srcs)
            edst_l.append(gid_w)
            ecand_l.append(cands)
            frontier = new_states
            if verbose:
                print(f"liveness wave {len(esrc_l)}: {n} states, {len(new_states)} new, "
                      f"{sum(map(len, esrc_l))} edges, {time.perf_counter() - t0:.1f} s",
                      file=sys.stderr)

        # one [n, W] tensor of the graph's rows. The blocks pass through the
        # host, each freed on the card once copied, so the card never holds
        # the rows twice (a full graph can fill half of it)
        W, dtype = init_d.shape[1], init_d.dtype
        frontier = new_states = init_d = None
        host = []
        while state_blocks:
            host.append(state_blocks.pop(0).cpu())
        self._states = torch.empty((n, W), dtype=dtype, device=dev)
        off = 0
        for block in host:
            self._states[off:off + len(block)] = block
            off += len(block)
        del host
        self._esrc = np.concatenate(esrc_l) if esrc_l else np.zeros(0, np.int64)
        self._edst = np.concatenate(edst_l) if edst_l else np.zeros(0, np.int64)
        self._ecand = np.concatenate(ecand_l) if ecand_l else np.zeros(0, np.int32)
        self._n_init = len(init)
        self._fwd = None

    def _eval(self, name: str) -> np.ndarray:
        """A state predicate of ``model.predicates`` over all graph states."""
        return self.model.chunk_predicates(self._states, (name,))[0].cpu().numpy()

    # ---------------- the nu-fixpoint lasso search (the reference's) ----------------

    def _fwd_adj(self):
        """CSR forward adjacency (edge order, dst-by-src, row starts);
        built once per run and cached."""
        if self._fwd is None:
            n = len(self._states)
            order = np.argsort(self._esrc, kind="stable")
            self._fwd = (order, self._edst[order],
                         np.searchsorted(self._esrc[order], np.arange(n + 1)))
        return self._fwd

    def _sustain_set(self, notq: np.ndarray) -> np.ndarray:
        """Largest S subset of ~Q whose members are terminal or have a
        successor in S (the reference's incremental peel)."""
        n = len(notq)
        esrc, edst = self._esrc, self._edst
        in_s = notq.copy()
        terminal = np.bincount(esrc, minlength=n) == 0
        rev = np.argsort(edst, kind="stable")
        rstart = np.searchsorted(edst[rev], np.arange(n + 1))
        live = in_s[edst] & in_s[esrc]
        exit_count = np.bincount(esrc[live], minlength=n)
        while True:
            drop = in_s & ~terminal & (exit_count == 0)
            dnodes = np.nonzero(drop)[0]
            if not dnodes.size:
                return in_s
            in_s &= ~drop
            # edges into dropped nodes whose src is still a member were all
            # counted (both endpoints were in S) and are dead now
            idx = np.concatenate([rev[rstart[d]: rstart[d + 1]] for d in dnodes])
            srcs = esrc[idx]
            srcs = srcs[in_s[srcs]]
            if srcs.size:
                exit_count -= np.bincount(srcs, minlength=n)

    def _shortest_path(self, from_set: np.ndarray, to_set: np.ndarray):
        """BFS (by gid) from any node in from_set to any node in to_set;
        returns (list of edge indices, target gid), or None."""
        n = len(self._states)
        order, ssorted_dst, sstart = self._fwd_adj()
        prev_edge = np.full(n, -1, np.int64)
        seen = from_set.copy()
        q = list(np.nonzero(seen)[0])
        if any(to_set[g] for g in q):
            return [], int(next(g for g in q if to_set[g]))
        qi = 0
        while qi < len(q):
            s = q[qi]
            qi += 1
            for k in range(sstart[s], sstart[s + 1]):
                t = int(ssorted_dst[k])
                if seen[t]:
                    continue
                seen[t] = True
                prev_edge[t] = order[k]
                if to_set[t]:
                    path = []
                    cur = t
                    while prev_edge[cur] >= 0 and not from_set[cur]:
                        path.append(int(prev_edge[cur]))
                        cur = int(self._esrc[prev_edge[cur]])
                    path.reverse()
                    return path, t
                q.append(t)
        return None

    def _decode_path(self, edge_idxs: list[int]) -> list[tuple[str, dict]]:
        """(action label, decoded destination) of each edge; the labels'
        ranks from one guard pass over the edges' source states."""
        if not edge_idxs:
            return []
        model, dev = self.model, self.device
        e = np.asarray(edge_idxs, np.int64)
        srcs = self._states[torch.from_numpy(self._esrc[e]).to(dev)]
        cov = torch.zeros((len(model.ACTION_NAMES), 3), dtype=torch.int64, device=dev)
        valid, rank, _ovf, _scal = model.chunk_guards(srcs, len(e), cov)
        lane = torch.arange(len(e), device=dev)
        cand = torch.from_numpy(self._ecand[e].astype(np.int64)).to(dev)
        if not bool(valid[lane, cand].all()):
            raise RuntimeError("recorded candidate not enabled on replay")
        ranks = rank[lane, cand].cpu().tolist()
        dsts = self._states[torch.from_numpy(self._edst[e]).to(dev)].cpu().numpy()
        return [(model.action_label(int(r), int(c)), model.decode(d))
                for r, c, d in zip(ranks, self._ecand[e], dsts)]

    # ---------------- the run ----------------

    def run(self, verbose: bool = False, audit_seed: int | None = None) -> LivenessResult:
        t0 = time.perf_counter()
        self._explore(verbose)
        n = len(self._states)
        if audit_seed is not None:
            self._audit(audit_seed, verbose)
        if verbose:
            print(f"liveness graph: {n} states, {len(self._esrc)} edges", file=sys.stderr)
        out_deg = np.bincount(self._esrc, minlength=n)
        violation = None
        for prop in self.properties:
            for label, p_name, q_name in self.model.liveness[prop]:
                q = self._eval(q_name)
                p = np.ones(n, dtype=bool) if p_name is None else self._eval(p_name)
                sustain = self._sustain_set(~q)
                starts = p & sustain
                if not starts.any():
                    if verbose:
                        print(f"  {prop}[{label}]: OK", file=sys.stderr)
                    continue
                violation = self._lasso(prop, label, starts, sustain, out_deg)
                break
            if violation:
                break
        return LivenessResult(distinct=n, total_edges=len(self._esrc),
                              properties=self.properties, violation=violation,
                              seconds=time.perf_counter() - t0)

    def _lasso(self, prop, label, starts, sustain, out_deg) -> LivenessViolation:
        """The counterexample: the shortest Init prefix to a start state,
        then a walk inside the sustain set to a terminal state or until a
        gid repeats (the walk up to the loop entry is stem)."""
        n = len(self._states)
        init_set = np.zeros(n, dtype=bool)
        init_set[: self._n_init] = True
        pre = self._shortest_path(init_set, starts)
        assert pre is not None, "violating state must be reachable"
        pre_edges, s0 = pre
        walk_edges: list[int] = []
        term = False
        order, ssorted_dst, sstart = self._fwd_adj()
        visited_at: dict[int, int] = {}
        cur = s0
        while True:
            if out_deg[cur] == 0:
                term = True
                stem, loop = walk_edges, []
                break
            if cur in visited_at:
                cut = visited_at[cur]
                stem, loop = walk_edges[:cut], walk_edges[cut:]
                break
            visited_at[cur] = len(walk_edges)
            nxt = None
            for k in range(sstart[cur], sstart[cur + 1]):
                t = int(ssorted_dst[k])
                if sustain[t]:
                    nxt = (int(order[k]), t)
                    break
            assert nxt is not None, "sustain set must have an exit"
            walk_edges.append(nxt[0])
            cur = nxt[1]
        init_gid = int(self._esrc[pre_edges[0]]) if pre_edges else s0
        init_row = self._states[init_gid].cpu().numpy()
        prefix = ([("Initial predicate", self.model.decode(init_row))]
                  + self._decode_path(pre_edges + stem))
        return LivenessViolation(prop=prop, instance=label, prefix=prefix,
                                 cycle=self._decode_path(loop), terminal=term)

    def _audit(self, audit_seed: int, verbose: bool) -> None:
        """Two-seed collision audit: rebuild the graph under the hash
        family ``audit_seed`` and require the same state and edge counts
        (a 64-bit collision in either family would shift them)."""
        if audit_seed == 0:
            # seed 0 IS the primary family: a 0-seed audit would vacuously
            # compare a family against itself
            raise ValueError("audit_seed must be nonzero (seed 0 is "
                             "the primary fingerprint family)")
        base = (len(self._states), len(self._esrc))
        saved = (self._states, self._esrc, self._edst, self._ecand, self._n_init)
        self._seed = audit_seed
        try:
            try:
                self._explore()
            except OverflowError as e:
                # a collision in the PRIMARY family merges states, so the
                # audit family can see more true states and trip the cap
                raise RuntimeError(
                    f"liveness collision audit (seed={audit_seed}) overflowed where the "
                    f"primary family did not — likely a fingerprint collision in the "
                    f"primary family merged distinct states ({e})") from e
            other = (len(self._states), len(self._esrc))
        finally:
            self._seed = 0
            self._states, self._esrc, self._edst, self._ecand, self._n_init = saved
            self._fwd = None
        if other != base:
            raise RuntimeError(
                f"liveness graph collision audit FAILED: primary family saw {base[0]} "
                f"states/{base[1]} edges, seed={audit_seed} family saw {other[0]}/"
                f"{other[1]} — a fingerprint collision merged distinct states in one family")
        if verbose:
            print(f"liveness collision audit (seed={audit_seed}): OK ({base[0]} states / "
                  f"{base[1]} edges both families)", file=sys.stderr)
