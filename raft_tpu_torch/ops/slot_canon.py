"""The slot canonicalizer of KRaftWithReconfig: canonical fingerprints of its
identity-slot encoding under ``symmHostsAndValues`` (KRaftWithReconfig.tla
:462-463).

Counterpart of ``raft_tpu/models/kraft_reconfig.py:2017 SlotCanonicalizer``.
A host permutation sigma maps identity (h, d) to (sigma(h), d); the slots
do not move (they are creation order), but the oracle's view lists servers
in sorted-identity order, so the canon is data-dependent. For each
(sigma, tau) pair of host and value permutations:

  1. remap the hosts, ``host2 = sigma[clip(host)]``;
  2. sort the slots stably by ``host2 * BIG + diskId`` (used slots) and
     ``BIG * BIG + slot`` (unused ones, last in creation order), BIG =
     max(NS, H) + 2: ``order`` (new row r <- old slot order[r]) and its
     inverse ``inv``;
  3. gather every per-slot row by ``order``; remap the slot + 1 references
     (leader, votedFor, pf_dest, log_who; Nil stays 0) through ``inv``, the
     slot bitmasks (votesGranted, cfg_members, eo_dom, log_members: new bit
     r = old bit order[r]) and both axes of ``endOffset``; the host lanes
     become ``where(used, host2, 0)``;
  4. remap the values through tau: the value of each AppendCommand entry
     (``log_val``, value > 0) and ``acked`` (acked'[tau[v]] = acked[v]);
  5. remap the same fields inside the occupied message keys (msource and
     mdest through ``inv``, mleader and e_who by the reference map, e_members
     by the bitmask map, e_val by tau for an AppendCommand entry) and re-sort
     the bag (``ops/bag.py wide_bag_sort``);
  6. hash the VIEW prefix (``hash_lanes`` with the fingerprint seed).

The fingerprint is the minimum over the pairs as an unsigned u64 (the
port's int64 ``enc`` keeps that order). With symmetry off only the
identity pair runs; the slot sort still runs.

``fingerprints`` launches ``slot_canon`` (csrc/slot_canon.cu) on a CUDA
tensor and runs the plain version below on a CPU one. There is no canon
memo for this family (the reference has none): DeviceBFS takes its
unmemoized path, fingerprints of the compacted lanes with the invalid ones
set to the INT64_MAX sentinel.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import kernels
from .bag import wide_bag_sort
from .hashing import INT64_MAX, hash_lanes, seed_salts
from .packing import EMPTY

REF_FIELDS = ("leader", "votedFor", "pf_dest")  # slot + 1 valued, 0 = Nil
MASK_FIELDS = ("votesGranted", "cfg_members", "eo_dom")  # slot bitmasks
GATHER_FIELDS = ("diskId", "used", "role", "state", "currentEpoch", "pf_active", "pf_epoch",
                 "pf_offset", "pf_lastepoch", "pf_observer", "cfg_id", "cfg_committed",
                 "log_cmd", "log_epoch", "log_cfgid", "log_len", "highWatermark")
C_APPEND = 2  # models/kraft_reconfig.py C_APPEND


class SlotCanonicalizer:
    """Canonical fingerprints of KRaftWithReconfig states (see the module
    docstring); ``for_model`` of ``ops/symmetry.py`` returns it for a model
    with ``make_canonicalizer``."""

    def __init__(self, model, symmetry: bool = True, seed: int = 0):
        self.model = model
        self.symmetry, self.seed = symmetry, seed
        H, V = model.p.n_hosts, model.p.n_values
        if symmetry:
            pairs = [(s, t) for s in itertools.permutations(range(H))
                     for t in itertools.permutations(range(V))]
        else:
            pairs = [(tuple(range(H)), tuple(range(V)))]
        self.sigmas = np.asarray([s for s, _t in pairs], np.int64)
        self.taus = np.asarray([t for _s, t in pairs], np.int64)
        self.P = len(pairs)
        self._dev: dict = {}

    # ---------------- the plain version ----------------

    def canon_rows(self, states: torch.Tensor, k: int) -> torch.Tensor:
        """The [N, W] rows of pair k's remapped, slot-sorted states (the
        VIEW prefix is what ``fingerprints`` hashes; the aux lanes are the
        input's)."""
        m = self.model
        lay, NS, H = m.layout, m.NS, m.p.n_hosts
        dev = states.device
        sigma = torch.as_tensor(self.sigmas[k], device=dev)
        tau = torch.as_tensor(self.taus[k], device=dev)
        g = lambda n: lay.get(states, n)  # noqa: E731
        used = g("used") > 0
        iota = torch.arange(NS, device=dev)
        host2 = sigma[g("host").clamp(0, H - 1).long()]
        big = max(NS, H) + 2
        key = torch.where(used, host2 * big + g("diskId"), big * big + iota)
        order = torch.argsort(key, dim=1, stable=True)  # [N, NS]: new row r <- old slot
        inv = torch.argsort(order, dim=1)  # old slot -> new row

        def gather(x):  # per-slot rows [N, NS, ...]
            idx = order.reshape(order.shape + (1,) * (x.ndim - 2)).expand(x.shape)
            return x.gather(1, idx)

        out = states.clone()

        def put(name, val):
            out[:, lay.sl(name)] = val.reshape(val.shape[0], -1).to(torch.int32)

        put("host", gather(torch.where(used, host2, 0)))
        for f in GATHER_FIELDS:
            put(f, gather(g(f)))
        for f in REF_FIELDS:
            put(f, gather(self.refmap(g(f), inv)))
        for f in MASK_FIELDS:
            put(f, gather(self.maskmap(g(f), order)))
        put("log_who", gather(self.refmap(g("log_who"), inv)))
        put("log_members", gather(self.maskmap(g("log_members"), order)))
        put("endOffset", self.eo_perm(g("endOffset"), order))
        put("log_val", gather(self.valmap(g("log_val"), g("log_cmd"), tau)))
        put("acked", self.tauperm(g("acked"), tau))

        # the message bag: remap the occupied keys' fields, re-sort
        pk = m.packer
        words = [g(f"msg_w{w}") for w in range(m.n_words)]
        occ = words[0] != EMPTY
        u = lambda name: pk.unpack(words, name)  # noqa: E731
        ws = list(words)
        for name, val in (
                ("msource", self.slotmap(u("msource"), inv)),
                ("mdest", self.slotmap(u("mdest"), inv)),
                ("mleader", self.refmap(u("mleader"), inv)),
                ("e_who", self.refmap(u("e_who"), inv)),
                ("e_members", self.maskmap(u("e_members"), order)),
                ("e_val", self.valmap(u("e_val"), u("e_cmd"), tau))):
            new = pk.replace(tuple(ws), name, val)
            ws = [torch.where(occ, a, b) for a, b in zip(new, ws)]
        sw, scnt = wide_bag_sort(ws, g("msg_cnt"))
        for w in range(m.n_words):
            put(f"msg_w{w}", sw[w])
        put("msg_cnt", scnt)
        return out

    # the remap kinds (a test leaves each out to show that it is needed)

    @staticmethod
    def slotmap(x, inv):
        """A raw slot index through the sort (clamped, as JAX gathers)."""
        return inv.gather(1, x.clamp(0, inv.shape[1] - 1).reshape(x.shape[0], -1).long()
                          ).reshape(x.shape)

    @classmethod
    def refmap(cls, x, inv):
        """A slot + 1 reference through the sort; Nil (0) stays 0."""
        return torch.where(x > 0, cls.slotmap(x - 1, inv) + 1, 0)

    @staticmethod
    def maskmap(mask, order):
        """A slot bitmask through the sort: new bit r = old bit order[r]."""
        NS = order.shape[1]
        o = order.reshape((order.shape[0],) + (1,) * (mask.ndim - 1) + (NS,))
        bits = (mask.unsqueeze(-1) >> o) & 1
        return (bits << torch.arange(NS, device=mask.device)).sum(-1)

    @staticmethod
    def eo_perm(eo, order):
        """endOffset [N, NS, NS] with both axes gathered by ``order``."""
        NS = order.shape[1]
        rows = eo.gather(1, order[:, :, None].expand(-1, NS, NS))
        return rows.gather(2, order[:, None, :].expand(-1, NS, NS))

    @staticmethod
    def valmap(val, cmd, tau):
        """tau on an AppendCommand entry's value (value > 0)."""
        t = tau[(val - 1).clamp(0, tau.shape[0] - 1).long()] + 1
        return torch.where((cmd == C_APPEND) & (val > 0), t, val)

    @staticmethod
    def tauperm(acked, tau):
        """acked [N, V] through tau: acked'[tau[v]] = acked[v]."""
        return torch.zeros_like(acked).scatter(1, tau.expand(acked.shape[0], -1), acked)

    def fingerprints_plain(self, states: torch.Tensor) -> torch.Tensor:
        VL = self.model.layout.view_len
        if not states.shape[0]:
            return torch.empty(0, dtype=torch.int64, device=states.device)
        best = None
        for k in range(self.P):
            fp = hash_lanes(self.canon_rows(states, k)[:, :VL], seed=self.seed)
            best = fp if best is None else torch.minimum(best, fp)
        return best

    # ---------------- the kernel ----------------

    def _tables(self, dev):
        key = str(dev)
        if key not in self._dev:
            self._dev[key] = tuple(torch.tensor(a.reshape(-1), dtype=torch.int32, device=dev)
                                   for a in (self.sigmas, self.taus))
        return self._dev[key]

    def fingerprints_cuda(self, states: torch.Tensor, valid=None) -> torch.Tensor:
        k = kernels.SLOT_CANON
        m = self.model
        N = states.shape[0]
        kernels.require(states, torch.int32, "states", shape=(N, m.layout.W))
        if valid is not None:
            kernels.require(valid, torch.bool, "valid", shape=(N,))
        spec, _cand, _ids = m.kernel_spec(states.device)
        sig, tau = self._tables(states.device)
        sa, sb = seed_salts(self.seed)
        out = torch.empty(N, dtype=torch.int64, device=states.device)
        # a warp's shared memory: the canonical view and the remapped bag
        warp_ints = m.layout.view_len + (m.n_words + 1) * m.p.msg_slots
        rc = k.fn(states.data_ptr(), N, None if valid is None else valid.data_ptr(),
                  spec.data_ptr(), spec.numel(), sig.data_ptr(), tau.data_ptr(), self.P,
                  warp_ints, sa, sb, int(bool(self.seed)), out.data_ptr(),
                  kernels.stream(states.device))
        k.launched(rc)
        return out

    def fingerprints(self, states: torch.Tensor, valid=None) -> torch.Tensor:
        """Canonical enc fingerprints int64 [N] of int32 [N, W] rows; with
        ``valid`` (bool [N]) the rows where it is false get INT64_MAX."""
        if kernels.route(states) == "cuda":
            return self.fingerprints_cuda(states, valid)
        if valid is None:
            return self.fingerprints_plain(states)
        out = torch.full((states.shape[0],), INT64_MAX, dtype=torch.int64)
        out[valid] = self.fingerprints_plain(states[valid])
        return out
