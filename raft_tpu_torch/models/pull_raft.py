"""Batched PyTorch lowering of the PullRaft and PullRaftVariant2 specs.

Counterpart of ``raft_tpu/models/pull_raft.py``; the TLA+ line citations
are the reference's. As in ``models/raft.py``, each action is one batched
computation over a ``[C, n]`` grid (chunk states x the action's
bindings), so every value — including the successor rows of disabled
candidates — is bit-identical to ``jax.vmap(_expand1)``. The reference
indexes with traced server indices (``x[dst]``, ``x.at[dst].set``), which
JAX clamps on a read and drops on an out-of-range write; the
``jax_take``/``jax_set`` helpers of ``models/base.py`` keep those
semantics, so rows whose message fields name no server (a record's
``mdest`` past the last server) give the reference's successors too.

Pull-based replication: followers pull entries from the leader they
learned of, every message is sent at most once (``PullRaft.tla:137-161``),
and the leader advances its commit index inside AcceptPullEntriesRequest.
Variant2 adds ``votedFor`` and ``votesLastEntry`` (the ``vle_*`` pairs),
moves ``acked`` out of the VIEW, and piggybacks each voter's last common
entry on the LeaderNotify (``PullRaftVariant2.tla:361-379``). A log may
outgrow |Value| entries (stale success responses each append), so
``max_log`` has headroom and a log overflow is a hard error (``ovf``).
Fleet lanes (``models/base.py`` FleetConstMixin) let one model serve a
group of MaxElections/MaxRestarts points.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..ops import bag
from ..ops.packing import EMPTY, BitPacker, bits_for
from .base import (
    ACK_FALSE,
    ACK_NIL,
    ACK_TRUE,
    CANDIDATE,
    FOLLOWER,
    INVARIANT_IDS,
    LEADER,
    ActionLabelMixin,
    FleetConstMixin,
    KernelModel,
    Layout,
    SparseExpandMixin,
    jax_set as jset,
    jax_set2 as jset2,
    jax_take as jtake,
    fleet_lanes,
    popcount,
    raft_invariants,
    select as _sel,
)

NIL = 0  # leader/votedFor Nil; server i is stored as i+1
RVREQ, RVRESP, PULLREQ, PULLRESP, NOTIFY = 1, 2, 3, 4, 5

# Next-disjunct order (PullRaft.tla:542-558 == PullRaftVariant2.tla:560-576).
(
    R_RESTART,
    R_UPDATETERM,
    R_REQUESTVOTE,
    R_HANDLE_RVREQ,
    R_HANDLE_RVRESP,
    R_BECOMELEADER,
    R_CLIENTREQUEST,
    R_REJECT_PULL,
    R_ACCEPT_PULL,
    R_LEARNOFLEADER,
    R_SENDPULL,
    R_HANDLE_SUCCESS_PULL,
    R_HANDLE_FAIL_PULL,
) = range(13)

ACTION_NAMES = [
    "Restart",
    "UpdateTerm",
    "RequestVote",
    "HandleRequestVoteRequest",
    "HandleRequestVoteResponse",
    "BecomeLeader",
    "ClientRequest",
    "RejectPullEntriesRequest",
    "AcceptPullEntriesRequest",
    "LearnOfLeader",
    "SendPullEntriesRequest",
    "HandleSuccessPullEntriesResponse",
    "HandleFailPullEntriesResponse",
]

STATE_NAMES = {FOLLOWER: "Follower", CANDIDATE: "Candidate", LEADER: "Leader"}
MTYPE_NAMES = {
    RVREQ: "RequestVoteRequest",
    RVRESP: "RequestVoteResponse",
    PULLREQ: "PullEntriesRequest",
    PULLRESP: "PullEntriesResponse",
    NOTIFY: "LeaderNotifyRequest",
}


@dataclass(frozen=True)
class PullRaftParams:
    """The reference's ``PullRaftParams``, field for field (so
    ``convert.params_from_reference`` is a plain constructor call)."""

    n_servers: int
    n_values: int
    max_elections: int
    max_restarts: int
    msg_slots: int = 64
    variant2: bool = False
    # headroom above |Value| for stale-response appends; 0 means auto
    # (n_values + 4). Overflow is a hard error either way.
    max_log_override: int = 0
    # Fleet packing (models/base.py FleetConstMixin), as in RaftParams.
    dyn_consts: tuple = ()
    fleet: bool = False

    @property
    def max_term(self) -> int:
        return 1 + self.max_elections

    @property
    def max_log(self) -> int:
        if self.max_log_override:
            return self.max_log_override
        return self.n_values + 4


def _build_layout(p: PullRaftParams) -> Layout:
    S, V, L, M = p.n_servers, p.n_values, p.max_log, p.msg_slots
    lay = Layout(S)
    # VIEW (PullRaft.tla:123: messages, serverVars, candidateVars,
    # leaderVars, logVars, acked; PullRaftVariant2.tla:114 drops acked)
    lay.add("currentTerm", "per_server", (S,))
    lay.add("state", "per_server", (S,))
    lay.add("leader", "per_server_val", (S,))
    if p.variant2:
        lay.add("votedFor", "per_server_val", (S,))
        lay.add("vle_has", "per_server_pair", (S, S))  # votesLastEntry # Nil
        lay.add("vle_idx", "per_server_pair", (S, S))
        lay.add("vle_term", "per_server_pair", (S, S))
    lay.add("votesGranted", "server_bitmask", (S,))
    lay.add("log_term", "per_server", (S, L))
    lay.add("log_value", "per_server", (S, L))
    lay.add("log_len", "per_server", (S,))
    lay.add("commitIndex", "per_server", (S,))
    lay.add("matchIndex", "per_server_pair", (S, S))
    lay.add("msg_hi", "msg_hi", (M,))
    lay.add("msg_lo", "msg_lo", (M,))
    lay.add("msg_cnt", "msg_cnt", (M,))
    fleet_lanes(lay, p)  # the fleet config axis, before the first aux field
    # acked is in the VIEW for PullRaft (PullRaft.tla:123), aux for
    # Variant2 (PullRaftVariant2.tla:114)
    lay.add("acked", "aux" if p.variant2 else "scalar", (V,))
    lay.add("electionCtr", "aux")
    lay.add("restartCtr", "aux")
    return lay.finish()


def _build_packer(p: PullRaftParams) -> BitPacker:
    tb = bits_for(p.max_term)
    sb = bits_for(p.n_servers - 1)
    lb = bits_for(p.max_log + 1)
    vb = bits_for(p.n_values)
    return BitPacker(
        [
            ("mtype", 3),
            ("mterm", tb),
            ("msource", sb),
            ("mdest", sb),
            ("mlastLogTerm", tb),  # RVReq/PullReq (+Variant2 RVResp)
            ("mlastLogIndex", lb),
            ("mvoteGranted", 1),
            ("msuccess", 1),
            ("nentries", 1),  # a success PullResp carries exactly 1 entry
            ("eterm", tb),
            ("evalue", vb),
            ("mcommitIndex", lb),
            ("mlcHas", 1),  # mlastCommonEntry # Nil (Variant2 notify; fail resp)
            ("mlcIndex", lb),
            ("mlcTerm", tb),
        ]
    )


# ---- the kernels' view of a model (csrc/pull_actions.cuh) ----
# Order of the int32 spec vector; it mirrors the PS_* enum of
# pull_actions.cuh, whose kernels refuse a spec of any other length.
# field offsets (-1 where the layout has no such field)
SPEC_OFFSETS = (
    "currentTerm", "state", "leader", "votedFor", "vle_has", "vle_idx", "vle_term",
    "votesGranted", "log_term", "log_value", "log_len", "commitIndex", "matchIndex",
    "msg_hi", "msg_lo", "msg_cnt", "acked", "electionCtr", "restartCtr",
)
SPEC_SCALARS = ("S", "V", "L", "M", "W", "A", "K") + SPEC_OFFSETS + (
    "variant2", "max_elections", "max_restarts",
    # the offsets of the fleet lanes the guards read (-1 when static)
    "c_max_elections", "c_max_restarts",
)
# message fields, each as (word, shift, mask) after the scalars (PF_* enum)
MSG_FIELDS = (
    "mtype", "mterm", "msource", "mdest", "mlastLogTerm", "mlastLogIndex",
    "mvoteGranted", "msuccess", "nentries", "eterm", "evalue", "mcommitIndex",
    "mlcHas", "mlcIndex", "mlcTerm",
)
SPEC_LEN = len(SPEC_SCALARS) + 3 * len(MSG_FIELDS)
# action groups (PG_* enum); a candidate row is (group, p0, p1, rank)
GROUP_IDS = {
    "Restart": 0, "RequestVote": 1, "BecomeLeader": 2, "ClientRequest": 3,
    "SendPullEntriesRequest": 4, "HandleMessage": 5,
}
GROUP_RANKS = {
    "Restart": R_RESTART, "RequestVote": R_REQUESTVOTE, "BecomeLeader": R_BECOMELEADER,
    "ClientRequest": R_CLIENTREQUEST, "SendPullEntriesRequest": R_SENDPULL,
    # the eight receipt disjuncts resolve their rank at run time
    "HandleMessage": R_UPDATETERM,
}


class PullRaftModel(KernelModel, SparseExpandMixin, FleetConstMixin, ActionLabelMixin):
    """Batched successor/invariant kernels for one (spec, constants) pair."""

    name = "PullRaft"
    ACTION_NAMES = ACTION_NAMES
    ACTIONS_HEADER = "pull_actions.cuh"
    KERNELS = kernels.PULL_FAMILY
    GROUP_IDS = GROUP_IDS
    GROUP_RANKS = GROUP_RANKS

    def __init__(self, params: PullRaftParams, server_names=None, value_names=None):
        self.p = params
        self.layout = _build_layout(params)
        self.packer = _build_packer(params)
        S, V, M = params.n_servers, params.n_values, params.msg_slots
        self.server_names = list(server_names or [f"s{i+1}" for i in range(S)])
        self.value_names = list(value_names or [f"v{i+1}" for i in range(V)])
        if params.variant2:
            self.name = "PullRaftVariant2"

        self.bindings: list[tuple[str, tuple]] = []
        self._pairs = [(i, j) for i in range(S) for j in range(S) if i != j]
        for i in range(S):
            self.bindings.append(("Restart", (i,)))
        for i in range(S):
            self.bindings.append(("RequestVote", (i,)))
        for i in range(S):
            self.bindings.append(("BecomeLeader", (i,)))
        for i in range(S):
            for v in range(V):
                self.bindings.append(("ClientRequest", (i, v)))
        for ij in self._pairs:
            self.bindings.append(("SendPullEntriesRequest", ij))
        for m in range(M):
            self.bindings.append(("HandleMessage", (m,)))
        self.A = len(self.bindings)
        self._consts: dict = {}

        self.invariants = raft_invariants(self)
        # PullRaft defines no liveness formula (the reference's CLI refuses
        # a PROPERTY line on either pull spec)
        self.predicates: dict = {}
        self.liveness: dict = {}
        self._pred_ids = dict(INVARIANT_IDS)

    # ---------------- helpers ----------------

    def _bind_tables(self) -> dict:
        S, V, M = self.p.n_servers, self.p.n_values, self.p.msg_slots
        return {
            "iota_s": list(range(S)),
            "pr_i": [ij[0] for ij in self._pairs],
            "pr_j": [ij[1] for ij in self._pairs],
            "cr_i": [i for i in range(S) for _ in range(V)],
            "cr_v": [v for _ in range(S) for v in range(V)],
            "iota_m": list(range(M)),
        }

    _pack = KernelModel.pack_i32

    @staticmethod
    def _last_term(d, i):
        """LastTerm(log[i]) — PullRaft.tla:134."""
        ll = jtake(d["log_len"], i)
        return torch.where(ll > 0, jtake(jtake(d["log_term"], i), torch.clamp(ll - 1, min=0)), 0)

    def _last_common(self, lt_row, ll, last_idx, last_term):
        """LastCommonEntry — PullRaft.tla:211-226: the highest index k in
        1..ll whose entry (k, term[k]) is at or below (last_idx,
        last_term) in CompareEntries' term-precedence order (:203-207);
        (0, 0) if none. lt_row [C, n, L], the rest [C, n]."""
        L = self.p.max_log
        lanes = torch.arange(1, L + 1, device=lt_row.device)
        lt = last_term.unsqueeze(-1)
        ok = (lanes <= ll.unsqueeze(-1)) & (
            (lt_row < lt) | ((lt_row == lt) & (lanes <= last_idx.unsqueeze(-1))))
        idx = torch.where(ok, lanes, 0).max(-1).values
        term = torch.where(idx > 0, jtake(lt_row, torch.clamp(idx - 1, 0, L - 1)), 0)
        return idx, term

    # ---------------- action kernels ----------------
    # Each returns (valid [C, n], succ [C, n, W], rank [C, n], ovf [C, n]).

    def _restart(self, d, i, C, dev):
        """Restart(i) — PullRaft.tla:258-265 (keeps currentTerm, leader and
        the log); Variant2 (PullRaftVariant2.tla:251-260) keeps votedFor
        but clears leader and votesLastEntry."""
        p, S = self.p, self.p.n_servers
        n = i.shape[1]
        valid = (d["restartCtr"] < self._cv(d, "max_restarts")).expand(C, n)
        row0 = torch.zeros((1, 1, S), dtype=torch.int32, device=dev)
        upd = dict(
            state=jset(d["state"], i, FOLLOWER),
            votesGranted=jset(d["votesGranted"], i, 0),
            matchIndex=jset(d["matchIndex"], i, row0),
            commitIndex=jset(d["commitIndex"], i, 0),
            restartCtr=d["restartCtr"] + 1,
        )
        if p.variant2:
            upd["leader"] = jset(d["leader"], i, NIL)
            for f in ("vle_has", "vle_idx", "vle_term"):
                upd[f] = jset(d[f], i, row0)
        succ = self._asm(d, C, n, **upd)
        return (valid, succ, self._full(C, n, R_RESTART, torch.int32, dev),
                self._full(C, n, False, torch.bool, dev))

    def _request_vote(self, d, i, C, dev):
        """RequestVote(i) — PullRaft.tla:283-298 (leader[i] := i);
        Variant2 (PullRaftVariant2.tla:279-295): votedFor := i, leader :=
        Nil. SendMultiple puts one request per peer, each send-once."""
        p, S = self.p, self.p.n_servers
        n = i.shape[1]
        st_i = jtake(d["state"], i)
        valid = (d["electionCtr"] < self._cv(d, "max_elections")) & (
            (st_i == FOLLOWER) | (st_i == CANDIDATE))
        new_term = jtake(d["currentTerm"], i) + 1
        last_t = self._last_term(d, i)
        ll_i = jtake(d["log_len"], i)
        hi, lo, cnt = d["msg_hi"], d["msg_lo"], d["msg_cnt"]
        ovf = self._full(C, n, False, torch.bool, dev)
        for delta in range(1, S):
            j = torch.remainder(i + delta, S)
            khi, klo = self._pack(mtype=RVREQ, mterm=new_term, mlastLogTerm=last_t,
                                  mlastLogIndex=ll_i, msource=i, mdest=j)
            hi, lo, cnt, existed, o = bag.bag_put(hi, lo, cnt, khi, klo)
            valid = valid & ~existed  # SendMultiple (PullRaft.tla:141-143)
            ovf = ovf | o
        upd = dict(
            state=jset(d["state"], i, CANDIDATE),
            currentTerm=jset(d["currentTerm"], i, new_term),
            votesGranted=jset(d["votesGranted"], i, torch.ones_like(i) << i),
            electionCtr=d["electionCtr"] + 1,
            msg_hi=hi, msg_lo=lo, msg_cnt=cnt,
        )
        if p.variant2:
            upd["votedFor"] = jset(d["votedFor"], i, i + 1)
            upd["leader"] = jset(d["leader"], i, NIL)
        else:
            upd["leader"] = jset(d["leader"], i, i + 1)
        succ = self._asm(d, C, n, **upd)
        return (valid, succ, self._full(C, n, R_REQUESTVOTE, torch.int32, dev),
                ovf & valid)

    def _become_leader(self, d, i, C, dev):
        """BecomeLeader(i) — PullRaft.tla:354-366: a LeaderNotifyRequest to
        each peer that did not vote for i; Variant2
        (PullRaftVariant2.tla:361-379): to every peer, each with its own
        mlastCommonEntry, and leader[i] := i."""
        p, S = self.p, self.p.n_servers
        n = i.shape[1]
        vg_i = jtake(d["votesGranted"], i)
        valid = (jtake(d["state"], i) == CANDIDATE) & (2 * popcount(vg_i, S) > S)
        ct_i = jtake(d["currentTerm"], i)
        hi, lo, cnt = d["msg_hi"], d["msg_lo"], d["msg_cnt"]
        ovf = self._full(C, n, False, torch.bool, dev)
        for delta in range(1, S):
            j = torch.remainder(i + delta, S)
            if p.variant2:
                send_j = torch.ones_like(valid)
                has = jtake(jtake(d["vle_has"], i), j) > 0
                lce_i, lce_t = self._last_common(
                    jtake(d["log_term"], i), jtake(d["log_len"], i),
                    jtake(jtake(d["vle_idx"], i), j), jtake(jtake(d["vle_term"], i), j))
                khi, klo = self._pack(
                    mtype=NOTIFY, mterm=ct_i, mlcHas=has.to(torch.int32),
                    mlcIndex=torch.where(has, lce_i, 0), mlcTerm=torch.where(has, lce_t, 0),
                    msource=i, mdest=j)
            else:
                # only peers that did not vote for i (PullRaft.tla:364)
                send_j = ((vg_i >> j) & 1) == 0
                khi, klo = self._pack(mtype=NOTIFY, mterm=ct_i, msource=i, mdest=j)
            nhi, nlo, ncnt, existed, o = bag.bag_put(hi, lo, cnt, khi, klo)
            valid = valid & ~(existed & send_j)
            ovf = ovf | (o & send_j)
            hi, lo, cnt = (_sel(send_j, a, b) for a, b in ((nhi, hi), (nlo, lo), (ncnt, cnt)))
        upd = dict(
            state=jset(d["state"], i, LEADER),
            matchIndex=jset(d["matchIndex"], i,
                            torch.zeros((1, 1, S), dtype=torch.int32, device=dev)),
            msg_hi=hi, msg_lo=lo, msg_cnt=cnt,
        )
        if p.variant2:
            upd["leader"] = jset(d["leader"], i, i + 1)
        succ = self._asm(d, C, n, **upd)
        return (valid, succ, self._full(C, n, R_BECOMELEADER, torch.int32, dev),
                ovf & valid)

    def _client_request(self, d, i, v, C, dev):
        """ClientRequest(i, v) — PullRaft.tla:370-379; a log at max_log
        overflows (a hard error)."""
        L = self.p.max_log
        n = i.shape[1]
        valid = (jtake(d["state"], i) == LEADER) & (jtake(d["acked"], v) == ACK_NIL)
        pos = jtake(d["log_len"], i)
        ovf = valid & (pos >= L)
        posc = torch.clamp(pos, 0, L - 1)
        succ = self._asm(
            d, C, n,
            log_term=jset2(d["log_term"], i, posc, jtake(d["currentTerm"], i)),
            log_value=jset2(d["log_value"], i, posc, (v + 1).expand(C, n)),
            log_len=jset(d["log_len"], i, pos + 1),
            acked=jset(d["acked"], v, ACK_FALSE),
        )
        return (valid, succ, self._full(C, n, R_CLIENTREQUEST, torch.int32, dev), ovf)

    def _send_pull(self, d, i, j, C, dev):
        """SendPullEntriesRequest(i, j) — PullRaft.tla:396-411."""
        n = i.shape[1]
        valid = (jtake(d["state"], i) == FOLLOWER) & (jtake(d["leader"], i) == j + 1)
        khi, klo = self._pack(
            mtype=PULLREQ, mterm=jtake(d["currentTerm"], i),
            mlastLogIndex=jtake(d["log_len"], i), mlastLogTerm=self._last_term(d, i),
            msource=i, mdest=j)
        hi, lo, cnt, existed, ovf = bag.bag_put(
            d["msg_hi"], d["msg_lo"], d["msg_cnt"], khi, klo)
        valid = valid & ~existed  # Send (PullRaft.tla:137-139)
        succ = self._asm(d, C, n, msg_hi=hi, msg_lo=lo, msg_cnt=cnt)
        return (valid, succ, self._full(C, n, R_SENDPULL, torch.int32, dev), ovf & valid)

    # -------- fused message-receipt kernel (all M slots at once) --------
    # The eight receipt disjuncts (UpdateTerm, HandleRVReq, HandleRVResp,
    # RejectPull, AcceptPull, LearnOfLeader, HandleSuccessPull,
    # HandleFailPull) are mutually exclusive for a record: they partition
    # on mtype, the term comparison, ValidPullPosition and msuccess. So
    # each field of the successor takes the value of whichever branch
    # fired, and the three that reply share one put.

    def _handle_message(self, d, C, dev):
        p, packer = self.p, self.packer
        S, L, V, M = p.n_servers, p.max_log, p.n_values, p.msg_slots
        m = self._idx("iota_m", dev)
        hi, lo, cnt = d["msg_hi"], d["msg_lo"], d["msg_cnt"]  # [C, 1, M]
        khi, klo, kcnt = hi[:, 0], lo[:, 0], cnt[:, 0]  # slot m = binding m
        occupied = khi != EMPTY

        def u(name):
            return packer.unpack(khi, klo, name)

        mtype, mterm = u("mtype"), u("mterm")
        src, dst = u("msource"), u("mdest")
        ct_dst = jtake(d["currentTerm"], dst)
        st_dst = jtake(d["state"], dst)
        recv = occupied & (kcnt > 0)  # ReceivableMessage (PullRaft.tla:166-172)
        ll_dst = jtake(d["log_len"], dst)
        lt_dst = jtake(d["log_term"], dst)  # [C, M, L]
        lv_dst = jtake(d["log_value"], dst)
        # the incoming Discard, shared by every branch (Reply discards
        # first, PullRaft.tla:158-161)
        c2 = bag.bag_discard_at(cnt, m)

        # --- UpdateTerm (PullRaft.tla:269-276): count-0 records included
        b_upd = occupied & (mterm > ct_dst)

        # --- HandleRequestVoteRequest (PullRaft.tla:306-330;
        # PullRaftVariant2.tla:303-326)
        last_t = self._last_term(d, dst)
        rv_logok = (u("mlastLogTerm") > last_t) | (
            (u("mlastLogTerm") == last_t) & (u("mlastLogIndex") >= ll_dst))
        vote_name = "votedFor" if p.variant2 else "leader"
        vote_var = d[vote_name]
        vote_dst = jtake(vote_var, dst)
        grant = (mterm == ct_dst) & rv_logok & ((vote_dst == NIL) | (vote_dst == src + 1))
        b_rvreq = recv & (mtype == RVREQ) & (mterm <= ct_dst)
        resp_kw = dict(mtype=RVRESP, mterm=ct_dst, mvoteGranted=grant.to(torch.int32),
                       msource=dst, mdest=src)
        if p.variant2:  # the response carries the last entry (PullRaftVariant2.tla:320-321)
            resp_kw.update(mlastLogIndex=ll_dst, mlastLogTerm=last_t)
        rvhi, rvlo = self._pack(**resp_kw)

        # --- HandleRequestVoteResponse (PullRaft.tla:335-350; Variant2
        # also records votesLastEntry, PullRaftVariant2.tla:339-344)
        b_rvresp = recv & (mtype == RVRESP) & (mterm == ct_dst)
        g = u("mvoteGranted") > 0
        vgf = d["votesGranted"]
        vg = _sel(g, jset(vgf, dst, jtake(vgf, dst) | (torch.ones_like(src) << src)), vgf)

        # --- pull-request handling: ValidPullPosition (PullRaft.tla:192-196)
        pull_idx = u("mlastLogIndex")
        pull_term = u("mlastLogTerm")
        valid_pos = (pull_idx == 0) | (
            (pull_idx > 0) & (pull_idx <= ll_dst)
            & (pull_term == jtake(lt_dst, torch.clamp(pull_idx - 1, 0, L - 1))))
        is_pullreq = recv & (mtype == PULLREQ) & (mterm == ct_dst) & (st_dst == LEADER)

        # --- RejectPullEntriesRequest (PullRaft.tla:418-436)
        b_reject = is_pullreq & ~valid_pos
        lce_i, lce_t = self._last_common(lt_dst, ll_dst, pull_idx, pull_term)
        rjhi, rjlo = self._pack(mtype=PULLRESP, mterm=ct_dst, msuccess=0, mlcHas=1,
                                mlcIndex=lce_i, mlcTerm=lce_t, msource=dst, mdest=src)

        # --- AcceptPullEntriesRequest (PullRaft.tla:460-488)
        index = pull_idx + 1
        b_accept = is_pullreq & valid_pos & (index <= ll_dst)
        mi = d["matchIndex"]
        new_match = jset2(mi, dst, src, pull_idx)
        # NewCommitIndex (PullRaft.tla:446-458)
        idxs = torch.arange(1, L + 1, device=dev)
        self_in = torch.arange(S, device=dev) == dst.unsqueeze(-1)  # [C, M, S]
        agree = self_in.unsqueeze(-2) | (jtake(new_match, dst).unsqueeze(-2) >= idxs[:, None])
        quorum_ok = 2 * agree.sum(-1) > S  # [C, M, L]
        is_agree = quorum_ok & (idxs <= ll_dst.unsqueeze(-1))
        max_agree = torch.where(is_agree, idxs, 0).max(-1).values
        term_at = jtake(lt_dst, torch.clamp(max_agree - 1, 0, L - 1))
        ci_dst = jtake(d["commitIndex"], dst)
        new_ci = torch.where((max_agree > 0) & (term_at == ct_dst), max_agree, ci_dst)
        # acked[v]: FALSE -> TRUE for v committed in (ci, new_ci] (PullRaft.tla:476-479)
        lanes0 = torch.arange(L, device=dev)
        in_range = (lanes0 + 1 > ci_dst.unsqueeze(-1)) & (lanes0 + 1 <= new_ci.unsqueeze(-1))
        committed = torch.any(
            in_range.unsqueeze(-2)
            & (lv_dst.unsqueeze(-2) == torch.arange(1, V + 1, device=dev)[:, None]),
            dim=-1)  # [C, M, V]
        acked2 = torch.where((d["acked"] == ACK_FALSE) & committed, ACK_TRUE, d["acked"])
        epos = torch.clamp(index - 1, 0, L - 1)
        achi, aclo = self._pack(
            mtype=PULLRESP, mterm=ct_dst, msuccess=1, nentries=1,
            eterm=jtake(lt_dst, epos), evalue=jtake(lv_dst, epos),
            mcommitIndex=torch.minimum(new_ci, index), msource=dst, mdest=src)

        # --- LearnOfLeader (PullRaft.tla:383-391; Variant2 may truncate,
        # PullRaftVariant2.tla:398-410: NeedsTruncation :171-173 when the
        # notify carries an entry and Len(log) >= its index, TruncateLog
        # :176-179 to that index)
        b_learn = recv & (mtype == NOTIFY) & (mterm == ct_dst)
        if p.variant2:
            mlc_idx = u("mlcIndex")
            do_trunc = (u("mlcHas") > 0) & (ll_dst >= mlc_idx)
            ll_learn = torch.where(do_trunc, mlc_idx, ll_dst)
        else:
            ll_learn = ll_dst

        # --- HandleSuccessPullEntriesResponse (PullRaft.tla:493-503): a
        # log at max_log overflows (a hard error)
        is_pullresp = recv & (mtype == PULLRESP) & (mterm == ct_dst)
        b_succ = is_pullresp & (u("msuccess") > 0)
        app_pos = torch.clamp(ll_dst, 0, L - 1)
        suc_ovf = b_succ & (ll_dst >= L)

        # --- HandleFailPullEntriesResponse (PullRaft.tla:510-520):
        # TruncateLog to mlastCommonEntry.index (clamped to Len)
        b_fail = is_pullresp & (u("msuccess") == 0)
        ll_fail = torch.minimum(u("mlcIndex"), ll_dst)

        # --- the shared Reply: the branch-selected response, put once into
        # the bag whose slot m was discarded (counts change neither
        # existed nor overflow); a response already in the bag disables
        # the branch (send-once, PullRaft.tla:158-161)
        resp_hi = torch.where(b_rvreq, rvhi, torch.where(b_reject, rjhi, achi))
        resp_lo = torch.where(b_rvreq, rvlo, torch.where(b_reject, rjlo, aclo))
        phi, plo, pcnt, ex, povf = bag.bag_put(hi, lo, c2, resp_hi, resp_lo)
        b_rvreq = b_rvreq & ~ex
        b_reject = b_reject & ~ex
        b_accept = b_accept & ~ex
        putb = b_rvreq | b_reject | b_accept
        dropb = b_rvresp | b_learn | b_succ | b_fail  # Discard only, no response

        # truncated rows (learn in Variant2, fail) keep the lanes below the
        # new length and zero the rest
        trunc = b_fail | (b_learn if p.variant2 else torch.zeros_like(b_fail))
        ll_cut = torch.where(b_fail, ll_fail, ll_learn)
        keep = lanes0 < ll_cut.unsqueeze(-1)
        lt, lv, ll = d["log_term"], d["log_value"], d["log_len"]
        upd = dict(
            currentTerm=_sel(b_upd, jset(d["currentTerm"], dst, mterm), d["currentTerm"]),
            state=_sel(b_upd, jset(d["state"], dst, FOLLOWER), d["state"]),
            votesGranted=_sel(b_rvresp, vg, vgf),
            commitIndex=_sel(
                b_accept, jset(d["commitIndex"], dst, new_ci),
                _sel(b_succ, jset(d["commitIndex"], dst, u("mcommitIndex")),
                     d["commitIndex"])),
            matchIndex=_sel(b_accept, new_match, mi),
            acked=_sel(b_accept, acked2, d["acked"]),
            log_term=_sel(trunc, jset(lt, dst, torch.where(keep, lt_dst, 0)),
                          _sel(b_succ, jset2(lt, dst, app_pos, u("eterm")), lt)),
            log_value=_sel(trunc, jset(lv, dst, torch.where(keep, lv_dst, 0)),
                           _sel(b_succ, jset2(lv, dst, app_pos, u("evalue")), lv)),
            log_len=_sel(trunc, jset(ll, dst, ll_cut),
                         _sel(b_succ, jset(ll, dst, ll_dst + 1), ll)),
            msg_hi=_sel(putb, phi, hi),
            msg_lo=_sel(putb, plo, lo),
            msg_cnt=_sel(putb, pcnt, _sel(dropb, c2, cnt)),
        )
        granted = _sel(grant, jset(vote_var, dst, src + 1), vote_var)
        learned = jset(d["leader"], dst, src + 1)
        upd_nil = jset(d["leader"], dst, NIL)
        if p.variant2:
            upd["leader"] = _sel(b_upd, upd_nil, _sel(b_learn, learned, d["leader"]))
            upd["votedFor"] = _sel(b_upd, jset(vote_var, dst, NIL),
                                   _sel(b_rvreq, granted, vote_var))
            for f, val in (("vle_has", torch.ones_like(src)), ("vle_idx", u("mlastLogIndex")),
                           ("vle_term", u("mlastLogTerm"))):
                upd[f] = _sel(b_rvresp & g, jset2(d[f], dst, src, val), d[f])
        else:
            upd["leader"] = _sel(b_upd, upd_nil,
                                 _sel(b_rvreq, granted, _sel(b_learn, learned, d["leader"])))
        succ = self._asm(d, C, M, **upd)

        false = torch.zeros_like(b_upd)
        branches = [
            (b_upd, R_UPDATETERM, false),
            (b_rvreq, R_HANDLE_RVREQ, povf),
            (b_rvresp, R_HANDLE_RVRESP, false),
            (b_reject, R_REJECT_PULL, povf),
            (b_accept, R_ACCEPT_PULL, povf),
            (b_learn, R_LEARNOFLEADER, false),
            (b_succ, R_HANDLE_SUCCESS_PULL, suc_ovf),
            (b_fail, R_HANDLE_FAIL_PULL, false),
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
        the reference (``raft_tpu/models/pull_raft.py:667``)."""
        C = states.shape[0]
        dev = states.device
        d = self._dec(states)
        I = lambda name: self._idx(name, dev)  # noqa: E731
        outs = [
            self._restart(d, I("iota_s"), C, dev),
            self._request_vote(d, I("iota_s"), C, dev),
            self._become_leader(d, I("iota_s"), C, dev),
            self._client_request(d, I("cr_i"), I("cr_v"), C, dev),
            self._send_pull(d, I("pr_i"), I("pr_j"), C, dev),
            self._handle_message(d, C, dev),
        ]
        valid = torch.cat([o[0] for o in outs], dim=1)
        succs = torch.cat([o[1] for o in outs], dim=1)
        rank = torch.cat([o[2].to(torch.int32) for o in outs], dim=1)
        ovf = torch.cat([o[3] for o in outs], dim=1)
        return succs, valid, rank, ovf

    # ---------------- the kernels' spec ----------------

    def _spec_vector(self) -> list[int]:
        """The int32 spec vector of csrc/pull_actions.cuh (SPEC_SCALARS,
        then (word, shift, mask) of each of MSG_FIELDS)."""
        p, lay = self.p, self.layout
        off = {n: (lay.fields[n].offset if n in lay.fields else -1) for n in SPEC_OFFSETS}
        vals = dict(S=p.n_servers, V=p.n_values, L=p.max_log, M=p.msg_slots, W=lay.W,
                    A=self.A, K=len(self.ACTION_NAMES), **off, variant2=p.variant2,
                    max_elections=p.max_elections, max_restarts=p.max_restarts,
                    c_max_elections=self._lane_offset("max_elections"),
                    c_max_restarts=self._lane_offset("max_restarts"))
        spec = [int(vals[n]) for n in SPEC_SCALARS]
        for name in MSG_FIELDS:
            spec += list(self.packer.locate(name))
        assert len(spec) == SPEC_LEN
        return spec

    # ---------------- initial states ----------------

    def init_states(self) -> np.ndarray:
        """Init — PullRaft.tla:231-250. A single state."""
        lay = self.layout
        vec = lay.zeros((1,))
        vec[0, lay.sl("currentTerm")] = 1
        vec[0, lay.sl("msg_hi")] = EMPTY
        vec[0, lay.sl("msg_lo")] = EMPTY
        return self._fleet_stamp(vec)

    # ---------------- host-side decode/encode ----------------

    def decode(self, vec: np.ndarray) -> dict:
        """Decode one packed state into the canonical python form shared
        with the reference's oracle interpreter."""
        lay, p = self.layout, self.p
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
        msgs = {}
        hi, lo, cnt = g("msg_hi"), g("msg_lo"), g("msg_cnt")
        for k in range(p.msg_slots):
            if int(hi[k]) == EMPTY:
                continue
            msgs[self.decode_msg(int(hi[k]), int(lo[k]))] = int(cnt[k])
        extra = {}
        if p.variant2:
            vh = g("vle_has").reshape(S, S)
            vi = g("vle_idx").reshape(S, S)
            vt = g("vle_term").reshape(S, S)
            extra["votedFor"] = tuple(int(x) - 1 if x > 0 else None for x in g("votedFor"))
            extra["votesLastEntry"] = tuple(
                tuple((int(vi[a, b]), int(vt[a, b])) if vh[a, b] else None for b in range(S))
                for a in range(S)
            )
        return extra | {
            "currentTerm": tuple(int(x) for x in g("currentTerm")),
            "state": tuple(int(x) for x in g("state")),
            "leader": tuple(int(x) - 1 if x > 0 else None for x in g("leader")),
            "votesGranted": votes,
            "log": log,
            "commitIndex": tuple(int(x) for x in g("commitIndex")),
            "matchIndex": tuple(
                tuple(int(x) for x in row) for row in g("matchIndex").reshape(S, S)
            ),
            "messages": frozenset(msgs.items()),
            "acked": tuple(
                {ACK_NIL: None, ACK_FALSE: False, ACK_TRUE: True}[int(x)] for x in g("acked")
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
            if self.p.variant2:
                rec["mlastLogIndex"] = int(u["mlastLogIndex"])
                rec["mlastLogTerm"] = int(u["mlastLogTerm"])
        elif mtype == PULLREQ:
            rec["mlastLogIndex"] = int(u["mlastLogIndex"])
            rec["mlastLogTerm"] = int(u["mlastLogTerm"])
        elif mtype == PULLRESP:
            rec["msuccess"] = bool(u["msuccess"])
            if u["msuccess"]:
                rec["mentries"] = ((int(u["eterm"]), int(u["evalue"]) - 1),)
                rec["mcommitIndex"] = int(u["mcommitIndex"])
            else:
                rec["mlastCommonEntry"] = (int(u["mlcIndex"]), int(u["mlcTerm"]))
        elif mtype == NOTIFY:
            if self.p.variant2:
                rec["mlastCommonEntry"] = (
                    (int(u["mlcIndex"]), int(u["mlcTerm"])) if u["mlcHas"] else None)
        return tuple(sorted(rec.items()))

    def encode_msg(self, rec: tuple) -> tuple[int, int]:
        d = dict(rec)
        mtype = {v: k for k, v in MTYPE_NAMES.items()}[d["mtype"]]
        kw = dict(mtype=mtype, mterm=d["mterm"], msource=d["msource"], mdest=d["mdest"])
        if mtype == RVREQ:
            kw.update(mlastLogTerm=d["mlastLogTerm"], mlastLogIndex=d["mlastLogIndex"])
        elif mtype == RVRESP:
            kw.update(mvoteGranted=int(d["mvoteGranted"]))
            if self.p.variant2:
                kw.update(mlastLogIndex=d["mlastLogIndex"], mlastLogTerm=d["mlastLogTerm"])
        elif mtype == PULLREQ:
            kw.update(mlastLogIndex=d["mlastLogIndex"], mlastLogTerm=d["mlastLogTerm"])
        elif mtype == PULLRESP:
            kw.update(msuccess=int(d["msuccess"]))
            if d["msuccess"]:
                ent = d["mentries"][0]
                kw.update(nentries=1, eterm=ent[0], evalue=ent[1] + 1,
                          mcommitIndex=d["mcommitIndex"])
            else:
                lce = d["mlastCommonEntry"]
                kw.update(mlcHas=1, mlcIndex=lce[0], mlcTerm=lce[1])
        elif mtype == NOTIFY:
            if self.p.variant2:
                lce = d["mlastCommonEntry"]
                if lce is not None:
                    kw.update(mlcHas=1, mlcIndex=lce[0], mlcTerm=lce[1])
        return self.packer.pack(**kw)

    def encode(self, st: dict) -> np.ndarray:
        """Inverse of decode (canonical slot order for the message bag)."""
        lay, p = self.layout, self.p
        S, L = p.n_servers, p.max_log
        vec = lay.zeros(())
        vec[lay.sl("currentTerm")] = st["currentTerm"]
        vec[lay.sl("state")] = st["state"]
        vec[lay.sl("leader")] = [0 if v is None else v + 1 for v in st["leader"]]
        if p.variant2:
            vec[lay.sl("votedFor")] = [0 if v is None else v + 1 for v in st["votedFor"]]
            vle = np.zeros((3, S, S), np.int32)
            for a in range(S):
                for b in range(S):
                    e = st["votesLastEntry"][a][b]
                    if e is not None:
                        vle[:, a, b] = 1, e[0], e[1]
            for f, arr in zip(("vle_has", "vle_idx", "vle_term"), vle):
                vec[lay.sl(f)] = arr.reshape(-1)
        vec[lay.sl("votesGranted")] = [sum(1 << j for j in vs) for vs in st["votesGranted"]]
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
        vec[lay.sl("matchIndex")] = np.asarray(st["matchIndex"]).reshape(-1)
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
