"""Batched PyTorch lowering of the core Raft spec.

Counterpart of ``raft_tpu/models/raft.py``; the TLA+ line citations are
the reference's. The reference vmaps a per-state, per-binding kernel;
here each action is one batched computation over a ``[C, n]`` grid
(chunk states x the action's bindings), written in the one-hot helpers
of ``models/base.py`` so every value — including the successor rows of
disabled candidates — is bit-identical to ``jax.vmap(_expand1)``.

One ``RaftModel`` serves three specs: standard Raft, FlexibleRaft
(count-based quorums, strict send-once, no pendingResponse, term-mismatch
truncation) and RaftFsync (fsyncIndex, split Timeout/RequestVote,
AdvanceFsyncIndex). Fleet lanes and the opt-in network-fault actions
are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import bag
from .. import kernels
from ..ops.packing import EMPTY, BitPacker, bits_for
from .base import (
    ACK_FALSE,
    ACK_NIL,
    ACK_TRUE,
    CANDIDATE,
    FOLLOWER,
    INVARIANT_IDS,
    LEADER,
    PRED_VALUE_AON,  # noqa: F401 - the Raft family's predicate ids
    ActionLabelMixin,
    KernelModel,
    Layout,
    SparseExpandMixin,
    raft_invariants,
    values_not_stuck,
    onehot_row as orow,
    onehot_set as oset,
    onehot_set2 as oset2,
    select as _sel,
)

# state[i] encoding (CONSTANTS Follower/Candidate/Leader, Raft.tla:38) and
# acked[v] (Raft.tla:62-65) are base.py's FOLLOWER.. and ACK_NIL..
NIL = 0  # votedFor Nil (Raft.tla:41); server i is stored as i+1
RVREQ, RVRESP, AEREQ, AERESP = 1, 2, 3, 4  # mtype (Raft.tla:44-45)

# Next-disjunct order (Raft.tla:527-539), used for TLC-order tie-breaking.
(
    R_RESTART,
    R_REQUESTVOTE,
    R_BECOMELEADER,
    R_CLIENTREQUEST,
    R_ADVANCECOMMIT,
    R_APPENDENTRIES,
    R_UPDATETERM,
    R_HANDLE_RVREQ,
    R_HANDLE_RVRESP,
    R_REJECT_AE,
    R_ACCEPT_AE,
    R_HANDLE_AERESP,
) = range(12)
R_TIMEOUT, R_ADVANCEFSYNC = 12, 13  # RaftFsync-only disjuncts

ACTION_NAMES = [
    "Restart",
    "RequestVote",
    "BecomeLeader",
    "ClientRequest",
    "AdvanceCommitIndex",
    "AppendEntries",
    "UpdateTerm",
    "HandleRequestVoteRequest",
    "HandleRequestVoteResponse",
    "RejectAppendEntriesRequest",
    "AcceptAppendEntriesRequest",
    "HandleAppendEntriesResponse",
    "Timeout",
    "AdvanceFsyncIndex",
]

STATE_NAMES = {FOLLOWER: "Follower", CANDIDATE: "Candidate", LEADER: "Leader"}
MTYPE_NAMES = {
    RVREQ: "RequestVoteRequest",
    RVRESP: "RequestVoteResponse",
    AEREQ: "AppendEntriesRequest",
    AERESP: "AppendEntriesResponse",
}


@dataclass(frozen=True)
class RaftParams:
    """The reference's ``RaftParams``, field for field (so
    ``convert.params_from_reference`` is a plain constructor call)."""

    n_servers: int
    n_values: int
    max_elections: int
    max_restarts: int
    msg_slots: int = 48
    # FlexibleRaft (FlexibleRaft.tla:262,296): count-based quorums;
    # None means strict majority.
    election_quorum: int | None = None
    replication_quorum: int | None = None
    # FlexibleRaft/RaftFsync Send and Reply are strictly once
    # (FlexibleRaft.tla:127-129,148-151).
    strict_send_once: bool = False
    # pendingResponse flow control (Raft.tla:103-107).
    has_pending_response: bool = True
    # NeedsTruncation as a term-mismatch test (FlexibleRaft.tla:413-416).
    trunc_term_mismatch: bool = False
    # RaftFsync (raft-and-fsync/RaftFsync.tla:50-52,92,203-243,339).
    has_fsync: bool = False
    fsync_leader_before_ae: bool = False
    fsync_leader_quorum: bool = False
    fsync_follower_reply: bool = False
    # Not ported yet: network-fault actions and fleet lanes.
    net_faults: bool = False
    max_msg_copies: int = 2
    dyn_consts: tuple = ()
    fleet: bool = False

    @property
    def max_term(self) -> int:
        return 1 + self.max_elections

    @property
    def max_log(self) -> int:
        return max(1, self.n_values)


def _build_layout(p: RaftParams) -> Layout:
    S, V, L, M = p.n_servers, p.n_values, p.max_log, p.msg_slots
    lay = Layout(S)
    # VIEW variables (Raft.tla:115)
    lay.add("currentTerm", "per_server", (S,))
    lay.add("state", "per_server", (S,))
    lay.add("votedFor", "per_server_val", (S,))
    lay.add("votesGranted", "server_bitmask", (S,))  # set -> bitmask (Raft.tla:93)
    lay.add("log_term", "per_server", (S, L))
    lay.add("log_value", "per_server", (S, L))
    lay.add("log_len", "per_server", (S,))
    lay.add("commitIndex", "per_server", (S,))
    if p.has_fsync:
        lay.add("fsyncIndex", "per_server", (S,))  # RaftFsync.tla:92,117
    lay.add("nextIndex", "per_server_pair", (S, S))
    lay.add("matchIndex", "per_server_pair", (S, S))
    if p.has_pending_response:
        lay.add("pendingResponse", "server_bitmask", (S,))  # bool matrix -> bitmask
    lay.add("msg_hi", "msg_hi", (M,))
    lay.add("msg_lo", "msg_lo", (M,))
    lay.add("msg_cnt", "msg_cnt", (M,))
    # aux (VIEW-excluded: Raft.tla:60-68,115)
    lay.add("acked", "aux", (V,))
    lay.add("electionCtr", "aux")
    lay.add("restartCtr", "aux")
    return lay.finish()


def _build_packer(p: RaftParams) -> BitPacker:
    tb = bits_for(p.max_term)
    sb = bits_for(p.n_servers - 1)
    lb = bits_for(p.max_log + 1)  # indices in 0..L (+1 headroom)
    vb = bits_for(p.n_values)
    return BitPacker(
        [
            ("mtype", 3),
            ("mterm", tb),
            ("msource", sb),
            ("mdest", sb),
            ("mlastLogTerm", tb),  # RequestVoteRequest (Raft.tla:251-256)
            ("mlastLogIndex", lb),
            ("mvoteGranted", 1),  # RequestVoteResponse (Raft.tla:374-378)
            ("mprevLogIndex", lb),  # AppendEntriesRequest (Raft.tla:277-284)
            ("mprevLogTerm", tb),
            ("nentries", 1),  # <=1 entry per request (Raft.tla:260-274)
            ("eterm", tb),
            ("evalue", vb),
            ("mcommitIndex", lb),
            ("msuccess", 1),  # AppendEntriesResponse (Raft.tla:422-427,476-482)
            ("mmatchIndex", lb),
        ]
    )


# ---- the kernels' view of a model (csrc/raft_actions.cuh) ----
# Order of the int32 spec vector; it mirrors the SP_* enum of
# raft_actions.cuh, whose kernels refuse a spec of any other length.
# field offsets (-1 where the layout has no such field)
SPEC_OFFSETS = (
    "currentTerm", "state", "votedFor", "votesGranted", "log_term", "log_value",
    "log_len", "commitIndex", "fsyncIndex", "nextIndex", "matchIndex",
    "pendingResponse", "msg_hi", "msg_lo", "msg_cnt", "acked", "electionCtr",
    "restartCtr",
)
SPEC_SCALARS = ("S", "V", "L", "M", "W", "A", "K") + SPEC_OFFSETS + (
    # parameter flags (quorums: -1 = strict majority)
    "has_fsync", "fsync_leader_before_ae", "fsync_leader_quorum",
    "fsync_follower_reply", "strict_send_once", "trunc_term_mismatch",
    "has_pending_response", "election_quorum", "replication_quorum",
    "max_elections", "max_restarts",
)
# message fields, each as (word, shift, mask) after the scalars (MF_* enum)
MSG_FIELDS = (
    "mtype", "mterm", "msource", "mdest", "mlastLogTerm", "mlastLogIndex",
    "mvoteGranted", "mprevLogIndex", "mprevLogTerm", "nentries", "eterm",
    "evalue", "mcommitIndex", "msuccess", "mmatchIndex",
)
SPEC_LEN = len(SPEC_SCALARS) + 3 * len(MSG_FIELDS)
# action groups (G_* enum); a candidate row is (group, p0, p1, rank)
GROUP_IDS = {
    "Restart": 0, "Timeout": 1, "RequestVotePair": 2, "RequestVote": 3,
    "BecomeLeader": 4, "ClientRequest": 5, "AdvanceCommitIndex": 6,
    "AppendEntries": 7, "AdvanceFsyncIndex": 8, "HandleMessage": 9,
}
GROUP_RANKS = {
    "Restart": R_RESTART, "Timeout": R_TIMEOUT, "RequestVotePair": R_REQUESTVOTE,
    "RequestVote": R_REQUESTVOTE, "BecomeLeader": R_BECOMELEADER,
    "ClientRequest": R_CLIENTREQUEST, "AdvanceCommitIndex": R_ADVANCECOMMIT,
    "AppendEntries": R_APPENDENTRIES, "AdvanceFsyncIndex": R_ADVANCEFSYNC,
    # the six receipt disjuncts: R_UPDATETERM + 0..5 in Next order
    "HandleMessage": R_UPDATETERM,
}
class RaftModel(KernelModel, SparseExpandMixin, ActionLabelMixin):
    """Batched successor/invariant kernels for one (spec, constants) pair."""

    name = "Raft"
    ACTIONS_HEADER = "raft_actions.cuh"
    KERNELS = kernels.RAFT_FAMILY
    GROUP_IDS = GROUP_IDS
    GROUP_RANKS = GROUP_RANKS

    def __init__(self, params: RaftParams, server_names=None, value_names=None):
        if params.net_faults or params.fleet:
            raise NotImplementedError(
                "network-fault actions and fleet lanes are not ported to "
                "raft_tpu_torch yet"
            )
        self.p = params
        self.ACTION_NAMES = (
            list(ACTION_NAMES) if params.has_fsync else list(ACTION_NAMES[:12])
        )
        self.layout = _build_layout(params)
        self.packer = _build_packer(params)
        S, V, M = params.n_servers, params.n_values, params.msg_slots
        self.server_names = list(server_names or [f"s{i+1}" for i in range(S)])
        self.value_names = list(value_names or [f"v{i+1}" for i in range(V)])

        # Candidate table in Next-disjunct order (Raft.tla:527-539); the
        # six message-receipt disjuncts fuse into one kernel per slot.
        self.bindings: list[tuple[str, tuple]] = []
        self._ae_pairs = [(i, j) for i in range(S) for j in range(S) if i != j]
        for i in range(S):
            self.bindings.append(("Restart", (i,)))
        if params.has_fsync:
            for i in range(S):
                self.bindings.append(("Timeout", (i,)))
            for ij in self._ae_pairs:
                self.bindings.append(("RequestVotePair", ij))
        else:
            for i in range(S):
                self.bindings.append(("RequestVote", (i,)))
        for i in range(S):
            self.bindings.append(("BecomeLeader", (i,)))
        for i in range(S):
            for v in range(V):
                self.bindings.append(("ClientRequest", (i, v)))
        for i in range(S):
            self.bindings.append(("AdvanceCommitIndex", (i,)))
        for ij in self._ae_pairs:
            self.bindings.append(("AppendEntries", ij))
        if params.has_fsync:
            for i in range(S):
                self.bindings.append(("AdvanceFsyncIndex", (i,)))
        for m in range(M):
            self.bindings.append(("HandleMessage", (m,)))
        self.A = len(self.bindings)
        self._consts: dict = {}

        self.invariants = raft_invariants(self)
        # temporal properties under WF_vars(Next) (checker/liveness.py):
        # ValuesNotStuck (Raft.tla:567-576)
        self.predicates = {}
        self._pred_ids = dict(INVARIANT_IDS)
        values_not_stuck(self)

    # ---------------- field access helpers ----------------

    def _bind_tables(self) -> dict:
        S, V, M = self.p.n_servers, self.p.n_values, self.p.msg_slots
        return {
            "iota_s": list(range(S)),
            "ae_i": [ij[0] for ij in self._ae_pairs],
            "ae_j": [ij[1] for ij in self._ae_pairs],
            "cr_i": [i for i in range(S) for _ in range(V)],
            "cr_v": [v for _ in range(S) for v in range(V)],
            "iota_m": list(range(M)),
        }

    def _pack(self, **vals):
        """Pack a key; a word made of constant fields only comes back as
        a 0-d tensor (built with ``torch.full``, which needs no host
        upload) on the device of the tensor-valued fields."""
        dev = next(v.device for v in vals.values() if isinstance(v, torch.Tensor))
        return tuple(
            w if isinstance(w, torch.Tensor)
            else torch.full((), w, dtype=torch.int64, device=dev)
            for w in self.packer.pack(**vals)
        )

    @staticmethod
    def _last_term(d, i):
        """LastTerm(log[i]) — Raft.tla:126."""
        ll = orow(d["log_len"], i)
        lt = orow(d["log_term"], i)
        return torch.where(ll > 0, orow(lt, torch.clamp(ll - 1, min=0)), 0)

    # ---------------- action kernels ----------------
    # Each returns (valid [C, n], succ [C, n, W], rank [C, n], ovf [C, n]).

    def _restart(self, d, i, C, dev):
        """Restart(i) — Raft.tla:226-235 (RaftFsync.tla:203-218 truncates
        the log back to fsyncIndex[i])."""
        p, S = self.p, self.p.n_servers
        n = i.shape[1]
        valid = (d["restartCtr"] < p.max_restarts).expand(C, n)
        row0 = torch.zeros((1, 1, S), dtype=torch.int32, device=dev)
        upd = dict(
            state=oset(d["state"], i, FOLLOWER),
            votesGranted=oset(d["votesGranted"], i, 0),
            nextIndex=oset(d["nextIndex"], i, row0 + 1),
            matchIndex=oset(d["matchIndex"], i, row0),
            commitIndex=oset(d["commitIndex"], i, 0),
            restartCtr=d["restartCtr"] + 1,
        )
        if p.has_pending_response:
            upd["pendingResponse"] = oset(d["pendingResponse"], i, 0)
        if p.has_fsync:
            new_ll = torch.minimum(orow(d["log_len"], i), orow(d["fsyncIndex"], i))
            keep = torch.arange(p.max_log, device=dev) < new_ll.unsqueeze(-1)
            upd["log_term"] = oset(
                d["log_term"], i, torch.where(keep, orow(d["log_term"], i), 0))
            upd["log_value"] = oset(
                d["log_value"], i, torch.where(keep, orow(d["log_value"], i), 0))
            upd["log_len"] = oset(d["log_len"], i, new_ll)
        succ = self._asm(d, C, n, **upd)
        return (valid, succ, self._full(C, n, R_RESTART, torch.int32, dev),
                self._full(C, n, False, torch.bool, dev))

    def _timeout(self, d, i, C, dev):
        """Timeout(i) — RaftFsync.tla:222-230."""
        n = i.shape[1]
        st_i = orow(d["state"], i)
        valid = (d["electionCtr"] < self.p.max_elections) & (
            (st_i == FOLLOWER) | (st_i == CANDIDATE)
        )
        succ = self._asm(
            d, C, n,
            state=oset(d["state"], i, CANDIDATE),
            currentTerm=oset(d["currentTerm"], i, orow(d["currentTerm"], i) + 1),
            votedFor=oset(d["votedFor"], i, i + 1),
            votesGranted=oset(d["votesGranted"], i, torch.ones_like(i) << i),
            electionCtr=d["electionCtr"] + 1,
        )
        return (valid, succ, self._full(C, n, R_TIMEOUT, torch.int32, dev),
                self._full(C, n, False, torch.bool, dev))

    def _request_vote_pair(self, d, i, j, C, dev):
        """RequestVote(i, j) — RaftFsync.tla:234-243 (send-once)."""
        n = i.shape[1]
        valid = orow(d["state"], i) == CANDIDATE
        khi, klo = self._pack(
            mtype=RVREQ,
            mterm=orow(d["currentTerm"], i),
            mlastLogTerm=self._last_term(d, i),
            mlastLogIndex=orow(d["log_len"], i),
            msource=i,
            mdest=j,
        )
        hi, lo, cnt, existed, ovf = bag.bag_put(
            d["msg_hi"], d["msg_lo"], d["msg_cnt"], khi, klo)
        valid = valid & ~existed
        succ = self._asm(d, C, n, msg_hi=hi, msg_lo=lo, msg_cnt=cnt)
        return (valid, succ, self._full(C, n, R_REQUESTVOTE, torch.int32, dev),
                ovf & valid)

    def _advance_fsync_index(self, d, i, C, dev):
        """AdvanceFsyncIndex(i) — RaftFsync.tla:339-343."""
        n = i.shape[1]
        fs_i = orow(d["fsyncIndex"], i)
        valid = fs_i < orow(d["log_len"], i)
        succ = self._asm(d, C, n, fsyncIndex=oset(d["fsyncIndex"], i, fs_i + 1))
        return (valid, succ, self._full(C, n, R_ADVANCEFSYNC, torch.int32, dev),
                self._full(C, n, False, torch.bool, dev))

    def _request_vote(self, d, i, C, dev):
        """RequestVote(i) — Raft.tla:242-257 (fused Timeout+RequestVote)."""
        S = self.p.n_servers
        n = i.shape[1]
        st_i = orow(d["state"], i)
        valid = (d["electionCtr"] < self.p.max_elections) & (
            (st_i == FOLLOWER) | (st_i == CANDIDATE)
        )
        new_term = orow(d["currentTerm"], i) + 1
        last_t = self._last_term(d, i)
        ll_i = orow(d["log_len"], i)
        hi, lo, cnt = d["msg_hi"], d["msg_lo"], d["msg_cnt"]
        ovf = self._full(C, n, False, torch.bool, dev)
        # SendMultipleOnce to all peers (Raft.tla:250-256)
        for delta in range(1, S):
            j = torch.remainder(i + delta, S)
            khi, klo = self._pack(
                mtype=RVREQ,
                mterm=new_term,
                mlastLogTerm=last_t,
                mlastLogIndex=ll_i,
                msource=i,
                mdest=j,
            )
            hi, lo, cnt, existed, o = bag.bag_put(hi, lo, cnt, khi, klo)
            valid = valid & ~existed
            ovf = ovf | o
        succ = self._asm(
            d, C, n,
            state=oset(d["state"], i, CANDIDATE),
            currentTerm=oset(d["currentTerm"], i, new_term),
            votedFor=oset(d["votedFor"], i, i + 1),
            votesGranted=oset(d["votesGranted"], i, torch.ones_like(i) << i),
            electionCtr=d["electionCtr"] + 1,
            msg_hi=hi,
            msg_lo=lo,
            msg_cnt=cnt,
        )
        return (valid, succ, self._full(C, n, R_REQUESTVOTE, torch.int32, dev),
                ovf & valid)

    def _become_leader(self, d, i, C, dev):
        """BecomeLeader(i) — Raft.tla:289-300 (FlexibleRaft.tla:260-269)."""
        p, S = self.p, self.p.n_servers
        n = i.shape[1]
        vg_i = orow(d["votesGranted"], i)
        votes = ((vg_i.unsqueeze(-1) >> torch.arange(S, device=dev)) & 1).sum(-1)
        if p.election_quorum is not None:
            quorum = votes >= p.election_quorum
        else:
            quorum = 2 * votes > S
        valid = (orow(d["state"], i) == CANDIDATE) & quorum
        nrow = (orow(d["log_len"], i) + 1).unsqueeze(-1).expand(C, n, S)
        upd = dict(
            state=oset(d["state"], i, LEADER),
            nextIndex=oset(d["nextIndex"], i, nrow),
            matchIndex=oset(
                d["matchIndex"], i,
                torch.zeros((1, 1, S), dtype=torch.int32, device=dev)),
        )
        if p.has_pending_response:
            upd["pendingResponse"] = oset(d["pendingResponse"], i, 0)
        succ = self._asm(d, C, n, **upd)
        return (valid, succ, self._full(C, n, R_BECOMELEADER, torch.int32, dev),
                self._full(C, n, False, torch.bool, dev))

    def _client_request(self, d, i, v, C, dev):
        """ClientRequest(i, v) — Raft.tla:304-313."""
        L = self.p.max_log
        n = i.shape[1]
        valid = (orow(d["state"], i) == LEADER) & (orow(d["acked"], v) == ACK_NIL)
        pos = orow(d["log_len"], i)
        ovf = valid & (pos >= L)
        posc = torch.clamp(pos, 0, L - 1)
        succ = self._asm(
            d, C, n,
            log_term=oset2(d["log_term"], i, posc, orow(d["currentTerm"], i)),
            log_value=oset2(d["log_value"], i, posc, (v + 1).expand(C, n)),
            log_len=oset(d["log_len"], i, pos + 1),
            acked=oset(d["acked"], v, ACK_FALSE),
        )
        return (valid, succ, self._full(C, n, R_CLIENTREQUEST, torch.int32, dev),
                ovf)

    def _advance_commit_index(self, d, i, C, dev):
        """AdvanceCommitIndex(i) — Raft.tla:320-344."""
        p = self.p
        S, L, V = p.n_servers, p.max_log, p.n_values
        n = i.shape[1]
        ll_i = orow(d["log_len"], i)  # [C, n]
        ci_i = orow(d["commitIndex"], i)
        match_row = orow(d["matchIndex"], i)  # [C, n, S]
        idxs = torch.arange(1, L + 1, device=dev)  # candidate indexes
        # Agree(index) = {i} u {k : matchIndex[i][k] >= index}
        # (Raft.tla:323-324); RaftFsync.tla:313-315 drops the leader when
        # LeaderFsyncBeforeIncludeInQuorum and index > fsyncIndex[i].
        self_in = (torch.arange(S, device=dev) == i.unsqueeze(-1)).unsqueeze(-2)
        if p.has_fsync and p.fsync_leader_quorum:
            fs_i = orow(d["fsyncIndex"], i)
            self_in = self_in & (idxs[:, None] <= fs_i[..., None, None])
        agree = self_in | (match_row.unsqueeze(-2) >= idxs[:, None])  # [C,n,L,S]
        agree_cnt = agree.sum(-1)
        if p.replication_quorum is not None:
            quorum_ok = agree_cnt >= p.replication_quorum
        else:
            quorum_ok = 2 * agree_cnt > S
        is_agree = quorum_ok & (idxs <= ll_i.unsqueeze(-1))
        max_agree = torch.where(is_agree, idxs, 0).max(-1).values  # Max (Raft.tla:333)
        term_at = orow(orow(d["log_term"], i), torch.clamp(max_agree - 1, 0, L - 1))
        new_ci = torch.where(
            (max_agree > 0) & (term_at == orow(d["currentTerm"], i)),
            max_agree, ci_i)
        valid = (orow(d["state"], i) == LEADER) & (ci_i < new_ci)
        lanes = torch.arange(L, device=dev)
        in_range = (lanes + 1 > ci_i.unsqueeze(-1)) & (lanes + 1 <= new_ci.unsqueeze(-1))
        vals_row = orow(d["log_value"], i)  # [C, n, L]
        committed = torch.any(
            in_range.unsqueeze(-2)
            & (vals_row.unsqueeze(-2)
               == torch.arange(1, V + 1, device=dev)[:, None]),
            dim=-1,
        )  # [C, n, V]
        acked = torch.where(
            (d["acked"] == ACK_FALSE) & committed, ACK_TRUE, d["acked"])
        succ = self._asm(
            d, C, n, commitIndex=oset(d["commitIndex"], i, new_ci), acked=acked)
        return (valid, succ, self._full(C, n, R_ADVANCECOMMIT, torch.int32, dev),
                self._full(C, n, False, torch.bool, dev))

    def _append_entries(self, d, i, j, C, dev):
        """AppendEntries(i, j) — Raft.tla:263-285 (FlexibleRaft.tla:236-256
        has no pendingResponse gate)."""
        p = self.p
        L = p.max_log
        n = i.shape[1]
        valid = orow(d["state"], i) == LEADER
        if p.has_pending_response:
            pending = (orow(d["pendingResponse"], i) >> j) & 1
            valid = valid & (pending == 0)
        ni_ij = orow(orow(d["nextIndex"], i), j)
        prev_idx = ni_ij - 1
        lt_row = orow(d["log_term"], i)
        lv_row = orow(d["log_value"], i)
        prev_term = torch.where(
            prev_idx > 0, orow(lt_row, torch.clamp(prev_idx - 1, 0, L - 1)), 0)
        last_entry = torch.minimum(orow(d["log_len"], i), ni_ij)  # Min (Raft.tla:273)
        if p.has_fsync and p.fsync_leader_before_ae:
            # LeaderFsyncBeforeAppendEntries gate (RaftFsync.tla:261-263)
            valid = valid & (orow(d["fsyncIndex"], i) >= last_entry)
        nent = (last_entry >= ni_ij).to(torch.int32)  # <=1 entry
        epos = torch.clamp(ni_ij - 1, 0, L - 1)
        eterm = torch.where(nent > 0, orow(lt_row, epos), 0)
        evalue = torch.where(nent > 0, orow(lv_row, epos), 0)
        khi, klo = self._pack(
            mtype=AEREQ,
            mterm=orow(d["currentTerm"], i),
            mprevLogIndex=prev_idx,
            mprevLogTerm=prev_term,
            nentries=nent,
            eterm=eterm,
            evalue=evalue,
            mcommitIndex=torch.minimum(orow(d["commitIndex"], i), last_entry),
            msource=i,
            mdest=j,
        )
        hi, lo, cnt, existed, ovf = bag.bag_put(
            d["msg_hi"], d["msg_lo"], d["msg_cnt"], khi, klo)
        if p.strict_send_once:
            valid = valid & ~existed  # FlexibleRaft.tla:127-129
        else:
            valid = valid & ((nent > 0) | ~existed)  # Raft.tla:145-149
        upd = dict(msg_hi=hi, msg_lo=lo, msg_cnt=cnt)
        if p.has_pending_response:
            upd["pendingResponse"] = oset(
                d["pendingResponse"], i,
                orow(d["pendingResponse"], i) | (torch.ones_like(j) << j))
        succ = self._asm(d, C, n, **upd)
        return (valid, succ, self._full(C, n, R_APPENDENTRIES, torch.int32, dev),
                ovf & valid)

    # -------- fused message-receipt kernel (all M slots at once) --------
    # The six receipt disjuncts of Next (Raft.tla:534-539) are mutually
    # exclusive for a fixed record, so one kernel per slot computes
    # whichever fires; `rank` reports which.

    def _handle_message(self, d, C, dev):
        p, packer = self.p, self.packer
        L, M = p.max_log, p.msg_slots
        m = self._idx("iota_m", dev)
        hi, lo, cnt = d["msg_hi"], d["msg_lo"], d["msg_cnt"]  # [C, 1, M]
        khi, klo, kcnt = hi[:, 0], lo[:, 0], cnt[:, 0]  # slot m = binding m
        occupied = khi != EMPTY

        def u(name):
            return packer.unpack(khi, klo, name)

        mtype, mterm = u("mtype"), u("mterm")
        src, dst = u("msource"), u("mdest")
        ct_dst = orow(d["currentTerm"], dst)
        st_dst = orow(d["state"], dst)
        recv = occupied & (kcnt > 0)  # ReceivableMessage (Raft.tla:181-187)

        # incoming Discard, shared by every branch (Raft.tla:170-176)
        c2 = bag.bag_discard_at(cnt, m)

        # --- UpdateTerm (Raft.tla:348-355): any DOMAIN record
        b_upd = occupied & (mterm > ct_dst)

        # --- HandleRequestVoteRequest (Raft.tla:360-381)
        last_t = self._last_term(d, dst)
        ll_dst = orow(d["log_len"], dst)
        vf_dst = orow(d["votedFor"], dst)
        rv_logok = (u("mlastLogTerm") > last_t) | (
            (u("mlastLogTerm") == last_t) & (u("mlastLogIndex") >= ll_dst)
        )
        grant = (mterm == ct_dst) & rv_logok & ((vf_dst == NIL) | (vf_dst == src + 1))
        b_rvreq = recv & (mtype == RVREQ) & (mterm <= ct_dst)
        rhi, rlo = self._pack(
            mtype=RVRESP, mterm=ct_dst, mvoteGranted=grant.to(torch.int32),
            msource=dst, mdest=src,
        )

        # --- HandleRequestVoteResponse (Raft.tla:386-401)
        b_rvresp = recv & (mtype == RVRESP) & (mterm == ct_dst)
        vgf = d["votesGranted"]
        vg = _sel(
            u("mvoteGranted") > 0,
            oset(vgf, dst, orow(vgf, dst) | (torch.ones_like(src) << src)),
            vgf,
        )

        # --- AppendEntries request handling: LogOk (Raft.tla:406-410)
        prev_idx = u("mprevLogIndex")
        prev_term = u("mprevLogTerm")
        nent = u("nentries")
        lt_row = orow(d["log_term"], dst)  # [C, M, L]
        lv_row = orow(d["log_value"], dst)
        ae_logok = (prev_idx == 0) | (
            (prev_idx > 0)
            & (prev_idx <= ll_dst)
            & (prev_term == orow(lt_row, torch.clamp(prev_idx - 1, 0, L - 1)))
        )

        # --- RejectAppendEntriesRequest (Raft.tla:412-430)
        b_reject = (
            recv & (mtype == AEREQ) & (mterm <= ct_dst)
            & ((mterm < ct_dst)
               | ((mterm == ct_dst) & (st_dst == FOLLOWER) & ~ae_logok))
        )
        rjhi, rjlo = self._pack(
            mtype=AERESP, mterm=ct_dst, msuccess=0, mmatchIndex=0,
            msource=dst, mdest=src,
        )

        # --- AcceptAppendEntriesRequest (Raft.tla:454-485)
        b_accept = (
            recv & (mtype == AEREQ) & (mterm == ct_dst)
            & ((st_dst == FOLLOWER) | (st_dst == CANDIDATE))
            & ae_logok
        )
        can_append = (nent != 0) & (ll_dst == prev_idx)  # Raft.tla:438-440
        if p.trunc_term_mismatch:
            at_idx = orow(lt_row, torch.clamp(prev_idx, 0, L - 1))
            needs_trunc = (nent != 0) & (ll_dst >= prev_idx + 1) & (at_idx != u("eterm"))
        else:
            needs_trunc = ((nent != 0) & (ll_dst >= prev_idx + 1)) | (
                (nent == 0) & (ll_dst > prev_idx)
            )  # NeedsTruncation (Raft.tla:445-449)
        appending = can_append | (needs_trunc & (nent != 0))
        new_ll = torch.where(
            appending, prev_idx + 1, torch.where(needs_trunc, prev_idx, ll_dst))
        lanes = torch.arange(L, device=dev)
        changes = appending | needs_trunc
        keep = lanes < prev_idx.unsqueeze(-1)
        app_pos = torch.clamp(prev_idx, 0, L - 1)
        nlt = oset(torch.where(keep, lt_row, 0), app_pos,
                   torch.where(appending, u("eterm"), 0))
        nlv = oset(torch.where(keep, lv_row, 0), app_pos,
                   torch.where(appending, u("evalue"), 0))
        nlt = _sel(changes, nlt, lt_row)
        nlv = _sel(changes, nlv, lv_row)
        ac_ovf = b_accept & appending & (prev_idx >= L)
        achi, aclo = self._pack(
            mtype=AERESP, mterm=ct_dst, msuccess=1, mmatchIndex=prev_idx + nent,
            msource=dst, mdest=src,
        )

        # --- HandleAppendEntriesResponse (Raft.tla:490-505)
        b_aeresp = recv & (mtype == AERESP) & (mterm == ct_dst)
        succm = u("msuccess") > 0
        mmatch = u("mmatchIndex")
        ni = d["nextIndex"]
        ni_ds = orow(orow(ni, dst), src)
        ni2 = oset2(ni, dst, src, torch.where(
            succm, mmatch + 1, torch.clamp(ni_ds - 1, min=1)))
        mi = d["matchIndex"]
        mi2 = _sel(succm, oset2(mi, dst, src, mmatch), mi)

        # --- shared Reply: put the branch-selected response once ---
        resp_hi = torch.where(b_rvreq, rhi, torch.where(b_reject, rjhi, achi))
        resp_lo = torch.where(b_rvreq, rlo, torch.where(b_reject, rjlo, aclo))
        phi, plo, pcnt, ex, povf = bag.bag_put(hi, lo, c2, resp_hi, resp_lo)
        if p.strict_send_once:
            # FlexibleRaft Reply (FlexibleRaft.tla:148-151)
            b_rvreq = b_rvreq & ~ex
            b_reject = b_reject & ~ex
            b_accept = b_accept & ~ex
        putb = b_rvreq | b_reject | b_accept
        dropb = b_rvresp | b_aeresp  # Discard only, no response

        upd = dict(
            currentTerm=_sel(b_upd, oset(d["currentTerm"], dst, mterm),
                             d["currentTerm"]),
            state=_sel(b_upd | b_accept, oset(d["state"], dst, FOLLOWER),
                       d["state"]),
            votedFor=_sel(
                b_upd, oset(d["votedFor"], dst, NIL),
                _sel(b_rvreq & grant, oset(d["votedFor"], dst, src + 1),
                     d["votedFor"])),
            votesGranted=_sel(b_rvresp, vg, vgf),
            commitIndex=_sel(
                b_accept, oset(d["commitIndex"], dst, u("mcommitIndex")),
                d["commitIndex"]),
            log_term=_sel(b_accept, oset(d["log_term"], dst, nlt), d["log_term"]),
            log_value=_sel(b_accept, oset(d["log_value"], dst, nlv),
                           d["log_value"]),
            log_len=_sel(b_accept, oset(d["log_len"], dst, new_ll), d["log_len"]),
            nextIndex=_sel(b_aeresp, ni2, ni),
            matchIndex=_sel(b_aeresp, mi2, mi),
            msg_hi=_sel(putb, phi, hi),
            msg_lo=_sel(putb, plo, lo),
            msg_cnt=_sel(putb, pcnt, _sel(dropb, c2, cnt)),
        )
        if p.has_fsync and p.fsync_follower_reply:
            # FollowerFsyncBeforeReply (RaftFsync.tla:468-470)
            upd["fsyncIndex"] = _sel(
                b_accept, oset(d["fsyncIndex"], dst, new_ll), d["fsyncIndex"])
        if p.has_pending_response:
            prf = d["pendingResponse"]
            upd["pendingResponse"] = _sel(
                b_aeresp,
                oset(prf, dst, orow(prf, dst) & ~(torch.ones_like(src) << src)),
                prf)
        succ = self._asm(d, C, M, **upd)

        false = torch.zeros_like(b_upd)
        branches = [
            (b_upd, R_UPDATETERM, false),
            (b_rvreq, R_HANDLE_RVREQ, povf),
            (b_rvresp, R_HANDLE_RVRESP, false),
            (b_reject, R_REJECT_AE, povf),
            (b_accept, R_ACCEPT_AE, povf | ac_ovf),
            (b_aeresp, R_HANDLE_AERESP, false),
        ]
        valid = false
        rank = self._full(C, M, -1, torch.int32, dev)
        ovf = false
        for b, rk, ob in branches:
            valid = valid | b
            rank = torch.where(b, rk, rank)
            ovf = ovf | (b & ob)
        return valid, succ, rank, ovf

    # ---------------- full expansion ----------------

    def expand(self, states: torch.Tensor):
        """All successor candidates of a [C, W] int32 state batch, in
        Next-disjunct order: (succs [C, A, W] int32, valid [C, A] bool,
        rank [C, A] int32, ovf [C, A] bool) — ``jax.vmap(_expand1)`` of
        the reference."""
        p = self.p
        C = states.shape[0]
        dev = states.device
        d = self._dec(states)
        I = lambda name: self._idx(name, dev)  # noqa: E731
        outs = [self._restart(d, I("iota_s"), C, dev)]
        if p.has_fsync:
            outs.append(self._timeout(d, I("iota_s"), C, dev))
            outs.append(self._request_vote_pair(d, I("ae_i"), I("ae_j"), C, dev))
        else:
            outs.append(self._request_vote(d, I("iota_s"), C, dev))
        outs.append(self._become_leader(d, I("iota_s"), C, dev))
        outs.append(self._client_request(d, I("cr_i"), I("cr_v"), C, dev))
        outs.append(self._advance_commit_index(d, I("iota_s"), C, dev))
        outs.append(self._append_entries(d, I("ae_i"), I("ae_j"), C, dev))
        if p.has_fsync:
            outs.append(self._advance_fsync_index(d, I("iota_s"), C, dev))
        outs.append(self._handle_message(d, C, dev))
        valid = torch.cat([o[0] for o in outs], dim=1)
        succs = torch.cat([o[1] for o in outs], dim=1)
        rank = torch.cat([o[2].to(torch.int32) for o in outs], dim=1)
        ovf = torch.cat([o[3] for o in outs], dim=1)
        return succs, valid, rank, ovf

    # ---------------- the kernels' spec ----------------

    def _spec_vector(self) -> list[int]:
        """The int32 spec vector of csrc/raft_actions.cuh (SPEC_SCALARS,
        then (word, shift, mask) of each of MSG_FIELDS)."""
        p, lay = self.p, self.layout
        off = {n: (lay.fields[n].offset if n in lay.fields else -1)
               for n in SPEC_OFFSETS}
        flags = dict(
            has_fsync=p.has_fsync, fsync_leader_before_ae=p.fsync_leader_before_ae,
            fsync_leader_quorum=p.fsync_leader_quorum,
            fsync_follower_reply=p.fsync_follower_reply,
            strict_send_once=p.strict_send_once,
            trunc_term_mismatch=p.trunc_term_mismatch,
            has_pending_response=p.has_pending_response,
            election_quorum=-1 if p.election_quorum is None else p.election_quorum,
            replication_quorum=(-1 if p.replication_quorum is None
                                else p.replication_quorum),
            max_elections=p.max_elections, max_restarts=p.max_restarts,
        )
        vals = dict(S=p.n_servers, V=p.n_values, L=p.max_log, M=p.msg_slots,
                    W=lay.W, A=self.A, K=len(self.ACTION_NAMES), **off, **flags)
        spec = [int(vals[n]) for n in SPEC_SCALARS]
        for name in MSG_FIELDS:
            spec += list(self.packer.locate(name))
        assert len(spec) == SPEC_LEN
        return spec

    # ---------------- initial states ----------------

    def init_states(self) -> np.ndarray:
        """Init — Raft.tla:213-218. A single state."""
        lay = self.layout
        vec = lay.zeros((1,))
        vec[0, lay.sl("currentTerm")] = 1
        vec[0, lay.sl("state")] = FOLLOWER
        vec[0, lay.sl("votedFor")] = NIL
        vec[0, lay.sl("nextIndex")] = 1
        vec[0, lay.sl("msg_hi")] = EMPTY
        vec[0, lay.sl("msg_lo")] = EMPTY
        vec[0, lay.sl("acked")] = ACK_NIL
        return vec

    # ---------------- host-side decode/encode ----------------

    def decode(self, vec: np.ndarray) -> dict:
        """Decode one packed state into the canonical python form shared
        with the reference's oracle interpreter."""
        lay = self.layout
        p = self.p
        vec = np.asarray(vec)
        g = lambda n: vec[lay.sl(n)]  # noqa: E731
        S, L = p.n_servers, p.max_log
        lt = g("log_term").reshape(S, L)
        lv = g("log_value").reshape(S, L)
        ll = g("log_len")
        log = tuple(
            tuple((int(lt[i, k]), int(lv[i, k]) - 1) for k in range(int(ll[i])))
            for i in range(S)
        )
        vg = g("votesGranted")
        votes = tuple(
            frozenset(j for j in range(S) if (int(vg[i]) >> j) & 1) for i in range(S)
        )
        if p.has_pending_response:
            pr = g("pendingResponse")
            pending = tuple(
                tuple(bool((int(pr[i]) >> j) & 1) for j in range(S)) for i in range(S)
            )
        else:
            pending = ((False,) * S,) * S
        msgs = {}
        hi, lo, cnt = g("msg_hi"), g("msg_lo"), g("msg_cnt")
        for k in range(p.msg_slots):
            if int(hi[k]) == EMPTY:
                continue
            msgs[self.decode_msg(int(hi[k]), int(lo[k]))] = int(cnt[k])
        extra = (
            {"fsyncIndex": tuple(int(x) for x in g("fsyncIndex"))}
            if p.has_fsync else {}
        )
        return extra | {
            "currentTerm": tuple(int(x) for x in g("currentTerm")),
            "state": tuple(int(x) for x in g("state")),
            "votedFor": tuple(int(x) - 1 if x > 0 else None for x in g("votedFor")),
            "votesGranted": votes,
            "log": log,
            "commitIndex": tuple(int(x) for x in g("commitIndex")),
            "nextIndex": tuple(
                tuple(int(x) for x in row) for row in g("nextIndex").reshape(S, S)
            ),
            "matchIndex": tuple(
                tuple(int(x) for x in row) for row in g("matchIndex").reshape(S, S)
            ),
            "pendingResponse": pending,
            "messages": frozenset(msgs.items()),
            "acked": tuple(
                {ACK_NIL: None, ACK_FALSE: False, ACK_TRUE: True}[int(x)]
                for x in g("acked")
            ),
            "electionCtr": int(vec[lay.fields["electionCtr"].offset]),
            "restartCtr": int(vec[lay.fields["restartCtr"].offset]),
        }

    def decode_msg(self, hi: int, lo: int) -> tuple:
        """Packed key -> canonical record tuple (sorted (field, value))."""
        u = self.packer.unpack_all(hi, lo)
        mtype = int(u["mtype"])
        rec = {
            "mtype": MTYPE_NAMES[mtype],
            "mterm": int(u["mterm"]),
            "msource": int(u["msource"]),
            "mdest": int(u["mdest"]),
        }
        if mtype == RVREQ:
            rec["mlastLogTerm"] = int(u["mlastLogTerm"])
            rec["mlastLogIndex"] = int(u["mlastLogIndex"])
        elif mtype == RVRESP:
            rec["mvoteGranted"] = bool(u["mvoteGranted"])
        elif mtype == AEREQ:
            rec["mprevLogIndex"] = int(u["mprevLogIndex"])
            rec["mprevLogTerm"] = int(u["mprevLogTerm"])
            rec["mentries"] = (
                ((int(u["eterm"]), int(u["evalue"]) - 1),) if u["nentries"] else ()
            )
            rec["mcommitIndex"] = int(u["mcommitIndex"])
        elif mtype == AERESP:
            rec["msuccess"] = bool(u["msuccess"])
            rec["mmatchIndex"] = int(u["mmatchIndex"])
        return tuple(sorted(rec.items()))

    def encode_msg(self, rec: tuple) -> tuple[int, int]:
        d = dict(rec)
        mtype = {v: k for k, v in MTYPE_NAMES.items()}[d["mtype"]]
        kw = dict(mtype=mtype, mterm=d["mterm"], msource=d["msource"], mdest=d["mdest"])
        if mtype == RVREQ:
            kw.update(mlastLogTerm=d["mlastLogTerm"], mlastLogIndex=d["mlastLogIndex"])
        elif mtype == RVRESP:
            kw.update(mvoteGranted=int(d["mvoteGranted"]))
        elif mtype == AEREQ:
            ent = d["mentries"]
            kw.update(
                mprevLogIndex=d["mprevLogIndex"],
                mprevLogTerm=d["mprevLogTerm"],
                nentries=len(ent),
                eterm=ent[0][0] if ent else 0,
                evalue=ent[0][1] + 1 if ent else 0,
                mcommitIndex=d["mcommitIndex"],
            )
        elif mtype == AERESP:
            kw.update(msuccess=int(d["msuccess"]), mmatchIndex=d["mmatchIndex"])
        return self.packer.pack(**kw)

    def encode(self, st: dict) -> np.ndarray:
        """Inverse of decode (canonical slot order for the message bag)."""
        lay, p = self.layout, self.p
        S, L = p.n_servers, p.max_log
        vec = lay.zeros(())
        vec[lay.sl("currentTerm")] = st["currentTerm"]
        vec[lay.sl("state")] = st["state"]
        vec[lay.sl("votedFor")] = [0 if v is None else v + 1 for v in st["votedFor"]]
        vec[lay.sl("votesGranted")] = [
            sum(1 << j for j in vs) for vs in st["votesGranted"]
        ]
        lt = np.zeros((S, L), np.int32)
        lv = np.zeros((S, L), np.int32)
        for i, lg in enumerate(st["log"]):
            for k, (t, v) in enumerate(lg):
                lt[i, k] = t
                lv[i, k] = v + 1
        vec[lay.sl("log_term")] = lt.reshape(-1)
        vec[lay.sl("log_value")] = lv.reshape(-1)
        vec[lay.sl("log_len")] = [len(lg) for lg in st["log"]]
        vec[lay.sl("commitIndex")] = st["commitIndex"]
        if p.has_fsync:
            vec[lay.sl("fsyncIndex")] = st["fsyncIndex"]
        vec[lay.sl("nextIndex")] = np.asarray(st["nextIndex"]).reshape(-1)
        vec[lay.sl("matchIndex")] = np.asarray(st["matchIndex"]).reshape(-1)
        if p.has_pending_response:
            vec[lay.sl("pendingResponse")] = [
                sum(1 << j for j, b in enumerate(row) if b)
                for row in st["pendingResponse"]
            ]
        keys = sorted((self.encode_msg(rec), cnt) for rec, cnt in st["messages"])
        if len(keys) > p.msg_slots:
            raise OverflowError("message bag exceeds msg_slots")
        hi = np.full(p.msg_slots, EMPTY, np.int32)
        lo = np.full(p.msg_slots, EMPTY, np.int32)
        cn = np.zeros(p.msg_slots, np.int32)
        for k, ((h, l), c) in enumerate(keys):
            hi[k], lo[k], cn[k] = h, l, c
        vec[lay.sl("msg_hi")] = hi
        vec[lay.sl("msg_lo")] = lo
        vec[lay.sl("msg_cnt")] = cn
        vec[lay.sl("acked")] = [
            {None: ACK_NIL, False: ACK_FALSE, True: ACK_TRUE}[a] for a in st["acked"]
        ]
        vec[lay.fields["electionCtr"].offset] = st["electionCtr"]
        vec[lay.fields["restartCtr"].offset] = st["restartCtr"]
        return vec
