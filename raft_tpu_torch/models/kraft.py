"""Batched PyTorch lowering of the Kafka KRaft spec.

Counterpart of ``raft_tpu/models/kraft.py``; the TLA+ line citations are
the reference's. As in ``models/pull_raft.py``, each action is one batched
computation over a ``[C, n]`` grid (chunk states x the action's bindings),
so every value — the successor rows of disabled candidates included — is
bit-identical to ``jax.vmap(_expand1)``. The reference indexes with traced
server indices, which JAX clamps on a read and drops on an out-of-range
write; the ``jax_take``/``jax_set`` helpers of ``models/base.py`` keep
those semantics (a record's 2-bit ``mdest`` may name no server of three).

KRaft (KIP-595): five server states plus IllegalState, a QuorumState
transition machine (``MaybeTransition``, ``MaybeHandleCommonResponse``:
first-match CASE chains), fetch-based replication where a follower holds
its one outstanding FetchRequest in ``pendingFetch`` (four per-server
lanes, ``pf_epoch > 0`` the non-Nil flag) and a FetchResponse embeds the
request as its ``correlation``, and the leader's high watermark advanced
by a quorum over ``endOffset``. Message records carry ``mleader`` (0 = Nil,
i + 1 = server i), the first Nil-able server field of a message key: the
canon remaps it by the ``server_nil`` kind (``msg_server_nil_fields``).
Fleet lanes are not ported.
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
    INVARIANT_IDS,
    ActionLabelMixin,
    InvFields,
    KernelModel,
    Layout,
    SparseExpandMixin,
    jax_set as jset,
    jax_set2 as jset2,
    jax_take as jtake,
    popcount,
    raft_invariants,
    select as _sel,
    values_not_stuck,
)

# state[i] enum (KRaft.tla:69,87)
UNATTACHED, VOTED, FOLLOWER, CANDIDATE, LEADER, ILLEGAL = range(6)
NIL = 0  # votedFor/leader Nil; server i is stored as i+1
# mtype (KRaft.tla:75-78); BeginQuorumResponse records are sent but never
# received (KRaft.tla:17-21)
RVREQ, RVRESP, BQREQ, BQRESP, FETCHREQ, FETCHRESP = 1, 2, 3, 4, 5, 6
# merror (KRaft.tla:84); 0 = Nil
E_NONE, E_FENCED, E_NOTLEADER, E_UNKNOWN = 0, 1, 2, 3
# mresult (KRaft.tla:81); 0 = absent (records other than fetch responses)
R_NONE, R_OK, R_NOTOK, R_DIVERGING = 0, 1, 2, 3

# Next-disjunct order (KRaft.tla:823-840), for trace labels.
(
    K_RESTART,
    K_REQUESTVOTE,
    K_HANDLE_RVREQ,
    K_HANDLE_RVRESP,
    K_BECOMELEADER,
    K_CLIENTREQUEST,
    K_REJECT_FETCH,
    K_DIVERGING_FETCH,
    K_ACCEPT_FETCH,
    K_HANDLE_BQREQ,
    K_SENDFETCH,
    K_HANDLE_FETCH_OK,
    K_HANDLE_FETCH_DIV,
    K_HANDLE_FETCH_ERR,
) = range(14)

ACTION_NAMES = [
    "Restart",
    "RequestVote",
    "HandleRequestVoteRequest",
    "HandleRequestVoteResponse",
    "BecomeLeader",
    "ClientRequest",
    "RejectFetchRequest",
    "DivergingFetchRequest",
    "AcceptFetchRequest",
    "HandleBeginQuorumRequest",
    "SendFetchRequest",
    "HandleSuccessFetchResponse",
    "HandleDivergingFetchResponse",
    "HandleErrorFetchResponse",
]

STATE_NAMES = {
    UNATTACHED: "Unattached",
    VOTED: "Voted",
    FOLLOWER: "Follower",
    CANDIDATE: "Candidate",
    LEADER: "Leader",
    ILLEGAL: "IllegalState",
}
MTYPE_NAMES = {
    RVREQ: "RequestVoteRequest",
    RVRESP: "RequestVoteResponse",
    BQREQ: "BeginQuorumRequest",
    BQRESP: "BeginQuorumResponse",
    FETCHREQ: "FetchRequest",
    FETCHRESP: "FetchResponse",
}
ERROR_NAMES = {E_NONE: None, E_FENCED: "FencedLeaderEpoch",
               E_NOTLEADER: "NotLeader", E_UNKNOWN: "UnknownLeader"}
RESULT_NAMES = {R_OK: "Ok", R_NOTOK: "NotOk", R_DIVERGING: "Diverging"}

# what the shared invariants and ValueAllOrNothing read of KRaft
KRAFT_FIELDS = InvFields(term="currentEpoch", commit="highWatermark", log_term="log_epoch",
                         leader=LEADER)


@dataclass(frozen=True)
class KRaftParams:
    """The reference's ``KRaftParams``, field for field (so
    ``convert.params_from_reference`` is a plain constructor call)."""

    n_servers: int
    n_values: int
    max_elections: int
    max_restarts: int
    msg_slots: int = 64

    @property
    def max_epoch(self) -> int:
        return 1 + self.max_elections

    @property
    def max_log(self) -> int:
        return max(1, self.n_values)


def _build_layout(p: KRaftParams) -> Layout:
    S, V, L, M = p.n_servers, p.n_values, p.max_log, p.msg_slots
    lay = Layout(S)
    # VIEW (KRaft.tla:154) = messages, serverVars, candidateVars,
    # leaderVars, logVars and acked; only electionCtr/restartCtr are aux.
    lay.add("currentEpoch", "per_server", (S,))
    lay.add("state", "per_server", (S,))
    lay.add("votedFor", "per_server_val", (S,))
    lay.add("leader", "per_server_val", (S,))
    # pendingFetch (KRaft.tla:123) decomposed; pf_epoch > 0 <=> non-Nil
    lay.add("pf_epoch", "per_server", (S,))
    lay.add("pf_offset", "per_server", (S,))
    lay.add("pf_lastepoch", "per_server", (S,))
    lay.add("pf_dest", "per_server_val", (S,))
    lay.add("log_epoch", "per_server", (S, L))
    lay.add("log_value", "per_server", (S, L))
    lay.add("log_len", "per_server", (S,))
    lay.add("highWatermark", "per_server", (S,))
    lay.add("votesGranted", "server_bitmask", (S,))
    lay.add("endOffset", "per_server_pair", (S, S))
    lay.add("acked", "scalar", (V,))
    lay.add("msg_hi", "msg_hi", (M,))
    lay.add("msg_lo", "msg_lo", (M,))
    lay.add("msg_cnt", "msg_cnt", (M,))
    lay.add("electionCtr", "aux")
    lay.add("restartCtr", "aux")
    return lay.finish()


def _build_packer(p: KRaftParams) -> BitPacker:
    tb = bits_for(p.max_epoch)
    sb = bits_for(p.n_servers - 1)
    nb = bits_for(p.n_servers)  # Nil-able server fields (0..S)
    lb = bits_for(p.max_log + 1)
    vb = bits_for(p.n_values)
    return BitPacker(
        [
            ("mtype", 3),
            ("mepoch", tb),
            ("msource", sb),
            ("mdest", sb),
            ("mlastLogEpoch", tb),  # RequestVoteRequest (KRaft.tla:450-455)
            ("mlastLogOffset", lb),
            ("mleader", nb),  # RequestVote/Fetch responses (KRaft.tla:500)
            ("mvoteGranted", 1),
            ("merror", 2),
            ("mresult", 2),  # FetchResponse only (KRaft.tla:81)
            ("mfetchOffset", lb),  # FetchRequest (KRaft.tla:616-621)
            ("mlastFetchedEpoch", tb),
            ("mhwm", lb),
            ("nentries", 1),  # <= 1 entry per response (KRaft.tla:710-712)
            ("eepoch", tb),
            ("evalue", vb),
            ("mdivergingEpoch", tb),  # Diverging response (KRaft.tla:671-672)
            ("mdivergingEndOffset", lb),
            ("cepoch", tb),  # correlation = the embedded request (KRaft.tla:649);
            ("cfetchOffset", lb),  # its source/dest are implied (swapped)
            ("clastFetchedEpoch", tb),
        ]
    )


# ---- the kernels' view of a model (csrc/kraft_actions.cuh) ----
# Order of the int32 spec vector; it mirrors the KS_* enum of
# kraft_actions.cuh, whose kernels refuse a spec of any other length.
SPEC_OFFSETS = (
    "currentEpoch", "state", "votedFor", "leader", "pf_epoch", "pf_offset", "pf_lastepoch",
    "pf_dest", "log_epoch", "log_value", "log_len", "highWatermark", "votesGranted",
    "endOffset", "acked", "msg_hi", "msg_lo", "msg_cnt", "electionCtr", "restartCtr",
)
SPEC_SCALARS = ("S", "V", "L", "M", "W", "A", "K") + SPEC_OFFSETS + (
    "max_elections", "max_restarts",
)
# message fields, each as (word, shift, mask) after the scalars (KF_* enum):
# every field of the packer, in its order
MSG_FIELDS = (
    "mtype", "mepoch", "msource", "mdest", "mlastLogEpoch", "mlastLogOffset", "mleader",
    "mvoteGranted", "merror", "mresult", "mfetchOffset", "mlastFetchedEpoch", "mhwm",
    "nentries", "eepoch", "evalue", "mdivergingEpoch", "mdivergingEndOffset", "cepoch",
    "cfetchOffset", "clastFetchedEpoch",
)
SPEC_LEN = len(SPEC_SCALARS) + 3 * len(MSG_FIELDS)
# action groups (KG_* enum); a candidate row is (group, p0, p1, rank)
GROUP_IDS = {
    "Restart": 0, "RequestVote": 1, "BecomeLeader": 2, "ClientRequest": 3,
    "SendFetchRequest": 4, "HandleMessage": 5,
}
GROUP_RANKS = {
    "Restart": K_RESTART, "RequestVote": K_REQUESTVOTE, "BecomeLeader": K_BECOMELEADER,
    "ClientRequest": K_CLIENTREQUEST, "SendFetchRequest": K_SENDFETCH,
    # the nine receipt disjuncts resolve their rank at run time
    "HandleMessage": K_HANDLE_RVREQ,
}
# KRaft's own invariants, by kernel id after the shared ones (the KR_INV_*
# enum of kraft_actions.cuh)
KRAFT_INVARIANT_IDS = {"NoIllegalState": 5, "NeverTwoLeadersInSameEpoch": 6}


def _at(row, idx):
    """``row[..., idx]`` as JAX gathers on the last axis (clamped)."""
    idx = idx.clamp(0, row.shape[-1] - 1).to(torch.int64)
    return row.gather(-1, idx.unsqueeze(-1)).squeeze(-1)


class KRaftModel(KernelModel, SparseExpandMixin, ActionLabelMixin):
    """Batched successor/invariant kernels for one (spec, constants) pair."""

    name = "KRaft"
    ACTION_NAMES = ACTION_NAMES
    STATE_NAMES = STATE_NAMES
    ACTIONS_HEADER = "kraft_actions.cuh"
    KERNELS = kernels.KRAFT_FAMILY
    GROUP_IDS = GROUP_IDS
    GROUP_RANKS = GROUP_RANKS
    # symmetry: mleader is a Nil-able server field inside packed records
    msg_server_fields = ("msource", "mdest")
    msg_server_nil_fields = ("mleader",)
    _pack = KernelModel.pack_i32

    def __init__(self, params: KRaftParams, server_names=None, value_names=None):
        self.p = params
        self.layout = _build_layout(params)
        self.packer = _build_packer(params)
        S, V, M = params.n_servers, params.n_values, params.msg_slots
        self.server_names = list(server_names or [f"s{i+1}" for i in range(S)])
        self.value_names = list(value_names or [f"v{i+1}" for i in range(V)])

        # Candidate table: the non-receipt disjuncts in Next order
        # (KRaft.tla:823-840), the receipt disjuncts fused per slot at the
        # end (mutually exclusive per record; rank resolved at run time).
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
            self.bindings.append(("SendFetchRequest", ij))
        for m in range(M):
            self.bindings.append(("HandleMessage", (m,)))
        self.A = len(self.bindings)
        self._consts: dict = {}

        # the shared formulas over KRaft's fields (KRaft.tla:894-957), and
        # its own two (KRaft.tla:887-889, 916-921)
        self.invariants = raft_invariants(self, KRAFT_FIELDS)
        self.invariants["NoIllegalState"] = self._inv_no_illegal
        self.invariants["NeverTwoLeadersInSameEpoch"] = self._inv_never_two_leaders
        self._pred_ids = dict(INVARIANT_IDS) | KRAFT_INVARIANT_IDS
        # ValuesNotStuck (KRaft.tla:867-879), as core Raft's
        self.predicates: dict = {}
        values_not_stuck(self, KRAFT_FIELDS)

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

    @staticmethod
    def _last_epoch(d, i):
        """LastEpoch(log[i]) — KRaft.tla:165."""
        ll = jtake(d["log_len"], i)
        return torch.where(ll > 0, _at(jtake(d["log_epoch"], i), ll - 1), 0)

    # ---------------- transition machine (KRaft.tla:312-392) ----------------
    # (state, epoch, leader) triples of [C, n] tensors, leader in 0..S (0 = Nil)

    def _maybe_transition(self, d, i, leader_enc, epoch):
        """MaybeTransition — KRaft.tla:351-367 (a CASE chain, first match
        wins: illegal, unattached, follower, no-op)."""
        st_i = jtake(d["state"], i)
        cur = jtake(d["currentEpoch"], i)
        led = jtake(d["leader"], i)
        # HasConsistentLeader (KRaft.tla:316-327)
        hcl = torch.where(
            leader_enc == i + 1,
            st_i == LEADER,
            (epoch != cur) | (leader_enc == NIL) | (led == NIL) | (led == leader_enc),
        )
        # TransitionToFollower (KRaft.tla:344-349)
        tf_ill = (cur == epoch) & ((st_i == FOLLOWER) | (st_i == LEADER))
        tf = (torch.where(tf_ill, ILLEGAL, FOLLOWER), torch.where(tf_ill, 0, epoch),
              torch.where(tf_ill, 0, leader_enc))
        una = (UNATTACHED, epoch, NIL)
        noop = (st_i, cur, led)
        ill = (ILLEGAL, 0, NIL)
        c2_pick = torch.where(leader_enc == NIL, 1, 2)  # 1 = unattached, 2 = follower
        c3 = (leader_enc != NIL) & (led == NIL)
        sel = torch.where(~hcl, 0, torch.where(epoch > cur, c2_pick, torch.where(c3, 2, 3)))
        return tuple(
            torch.where(sel == 0, ill[k], torch.where(
                sel == 1, una[k], torch.where(sel == 2, tf[k], noop[k])))
            for k in range(3))

    def _maybe_handle_common(self, d, i, leader_enc, epoch, err):
        """MaybeHandleCommonResponse — KRaft.tla:369-392. Returns (state,
        epoch, leader, handled)."""
        st_i = jtake(d["state"], i)
        cur = jtake(d["currentEpoch"], i)
        led = jtake(d["leader"], i)
        mt = self._maybe_transition(d, i, leader_enc, epoch)
        c_stale = epoch < cur
        c_trans = (epoch > cur) | (err != E_NONE)
        c_follow = (epoch == cur) & (leader_enc != NIL) & (led == NIL)
        sel = torch.where(c_stale, 0, torch.where(c_trans, 1, torch.where(c_follow, 2, 3)))
        fol = (FOLLOWER, cur, leader_enc)
        noop = (st_i, cur, led)
        out = [torch.where(sel == 1, mt[k], torch.where(sel == 2, fol[k], noop[k]))
               for k in range(3)]
        return out[0], out[1], out[2], sel != 3

    # ---------------- log-position math (KRaft.tla:247-310) ----------------

    def _end_offset_for_epoch(self, lt_row, ll, last_fetched_epoch):
        """EndOffsetForEpoch — KRaft.tla:285-301: (offset, epoch) of the
        highest entry with epoch <= last_fetched_epoch; (0, 0) if none.
        lt_row [C, n, L], the rest [C, n]."""
        lanes = torch.arange(self.p.max_log, device=lt_row.device)
        mask = (lanes < ll.unsqueeze(-1)) & (lt_row <= last_fetched_epoch.unsqueeze(-1))
        off = torch.where(mask, lanes + 1, 0).max(-1).values
        return off, torch.where(off > 0, _at(lt_row, off - 1), 0)

    def _highest_common_offset(self, lt_row, ll, end_off, epoch):
        """HighestCommonOffset — KRaft.tla:255-273: the highest offset with
        CompareEntries(offset, entry.epoch, end_off, epoch) <= 0."""
        lanes = torch.arange(self.p.max_log, device=lt_row.device)
        ep = epoch.unsqueeze(-1)
        le = (lt_row < ep) | ((lt_row == ep) & (lanes + 1 <= end_off.unsqueeze(-1)))
        mask = (lanes < ll.unsqueeze(-1)) & le
        return torch.where(mask, lanes + 1, 0).max(-1).values

    # ---------------- action kernels ----------------
    # Each returns (valid [C, n], succ [C, n, W], rank [C, n], ovf [C, n]).

    def _clear_pf(self, d, i, upd, cond=None):
        """pendingFetch[i] := Nil (the four lanes zeroed), where ``cond``."""
        for f in ("pf_epoch", "pf_offset", "pf_lastepoch", "pf_dest"):
            upd[f] = jset(d[f], i, 0) if cond is None else _sel(cond, jset(d[f], i, 0), d[f])
        return upd

    def _restart(self, d, i, C, dev):
        """Restart(i) — KRaft.tla:423-432: keeps currentEpoch, votedFor and
        the log; loses leader belief, votes, endOffset, hwm, pendingFetch."""
        p, S = self.p, self.p.n_servers
        n = i.shape[1]
        valid = (d["restartCtr"] < p.max_restarts).expand(C, n)
        upd = dict(
            state=jset(d["state"], i, FOLLOWER),
            leader=jset(d["leader"], i, NIL),
            votesGranted=jset(d["votesGranted"], i, 0),
            endOffset=jset(d["endOffset"], i,
                           torch.zeros((1, 1, S), dtype=torch.int32, device=dev)),
            highWatermark=jset(d["highWatermark"], i, 0),
            restartCtr=d["restartCtr"] + 1,
        )
        succ = self._asm(d, C, n, **self._clear_pf(d, i, upd))
        return (valid, succ, self._full(C, n, K_RESTART, torch.int32, dev),
                self._full(C, n, False, torch.bool, dev))

    def _request_vote(self, d, i, C, dev):
        """RequestVote(i) — KRaft.tla:439-456 (fused Timeout + RequestVote,
        from Follower, Candidate or Unattached): a request to each peer,
        each send-once (SendMultipleOnce, KRaft.tla:199-201)."""
        p, S = self.p, self.p.n_servers
        n = i.shape[1]
        st_i = jtake(d["state"], i)
        valid = (d["electionCtr"] < p.max_elections) & (
            (st_i == FOLLOWER) | (st_i == CANDIDATE) | (st_i == UNATTACHED))
        new_epoch = jtake(d["currentEpoch"], i) + 1
        last_ep = self._last_epoch(d, i)
        ll_i = jtake(d["log_len"], i)
        hi, lo, cnt = d["msg_hi"], d["msg_lo"], d["msg_cnt"]
        ovf = self._full(C, n, False, torch.bool, dev)
        for delta in range(1, S):
            j = torch.remainder(i + delta, S)
            khi, klo = self._pack(mtype=RVREQ, mepoch=new_epoch, mlastLogEpoch=last_ep,
                                  mlastLogOffset=ll_i, msource=i, mdest=j)
            hi, lo, cnt, existed, o = bag.bag_put(hi, lo, cnt, khi, klo)
            valid = valid & ~existed
            ovf = ovf | o
        upd = dict(
            state=jset(d["state"], i, CANDIDATE),
            currentEpoch=jset(d["currentEpoch"], i, new_epoch),
            leader=jset(d["leader"], i, NIL),
            votedFor=jset(d["votedFor"], i, i + 1),
            votesGranted=jset(d["votesGranted"], i, torch.ones_like(i) << i),
            electionCtr=d["electionCtr"] + 1,
            msg_hi=hi, msg_lo=lo, msg_cnt=cnt,
        )
        succ = self._asm(d, C, n, **self._clear_pf(d, i, upd))
        return (valid, succ, self._full(C, n, K_REQUESTVOTE, torch.int32, dev),
                ovf & valid)

    def _become_leader(self, d, i, C, dev):
        """BecomeLeader(i) — KRaft.tla:546-558: a BeginQuorumRequest to each
        peer, each send-once."""
        S = self.p.n_servers
        n = i.shape[1]
        votes = popcount(jtake(d["votesGranted"], i), S)
        valid = (jtake(d["state"], i) == CANDIDATE) & (2 * votes > S)
        ep_i = jtake(d["currentEpoch"], i)
        hi, lo, cnt = d["msg_hi"], d["msg_lo"], d["msg_cnt"]
        ovf = self._full(C, n, False, torch.bool, dev)
        for delta in range(1, S):
            j = torch.remainder(i + delta, S)
            khi, klo = self._pack(mtype=BQREQ, mepoch=ep_i, msource=i, mdest=j)
            hi, lo, cnt, existed, o = bag.bag_put(hi, lo, cnt, khi, klo)
            valid = valid & ~existed
            ovf = ovf | o
        succ = self._asm(
            d, C, n,
            state=jset(d["state"], i, LEADER),
            leader=jset(d["leader"], i, i + 1),
            endOffset=jset(d["endOffset"], i,
                           torch.zeros((1, 1, S), dtype=torch.int32, device=dev)),
            msg_hi=hi, msg_lo=lo, msg_cnt=cnt,
        )
        return (valid, succ, self._full(C, n, K_BECOMELEADER, torch.int32, dev),
                ovf & valid)

    def _client_request(self, d, i, v, C, dev):
        """ClientRequest(i, v) — KRaft.tla:594-603; a log at max_log
        overflows (a hard error)."""
        L = self.p.max_log
        n = i.shape[1]
        valid = (jtake(d["state"], i) == LEADER) & (jtake(d["acked"], v) == ACK_NIL)
        pos = jtake(d["log_len"], i)
        ovf = valid & (pos >= L)
        posc = torch.clamp(pos, 0, L - 1)
        succ = self._asm(
            d, C, n,
            log_epoch=jset2(d["log_epoch"], i, posc, jtake(d["currentEpoch"], i)),
            log_value=jset2(d["log_value"], i, posc, (v + 1).expand(C, n)),
            log_len=jset(d["log_len"], i, pos + 1),
            acked=jset(d["acked"], v, ACK_FALSE),
        )
        return (valid, succ, self._full(C, n, K_CLIENTREQUEST, torch.int32, dev), ovf)

    def _send_fetch_request(self, d, i, j, C, dev):
        """SendFetchRequest(i, j) — KRaft.tla:607-624: an unrestricted send
        (KRaft.tla:190-194); the pendingFetch[i] = Nil gate is the flow
        control."""
        n = i.shape[1]
        ep_i = jtake(d["currentEpoch"], i)
        valid = ((jtake(d["state"], i) == FOLLOWER) & (jtake(d["leader"], i) == j + 1)
                 & (jtake(d["pf_epoch"], i) == 0))
        ll_i = jtake(d["log_len"], i)
        last_ep = self._last_epoch(d, i)
        khi, klo = self._pack(mtype=FETCHREQ, mepoch=ep_i, mfetchOffset=ll_i,
                              mlastFetchedEpoch=last_ep, msource=i, mdest=j)
        hi, lo, cnt, _existed, ovf = bag.bag_put(d["msg_hi"], d["msg_lo"], d["msg_cnt"], khi, klo)
        succ = self._asm(
            d, C, n,
            pf_epoch=jset(d["pf_epoch"], i, ep_i),
            pf_offset=jset(d["pf_offset"], i, ll_i),
            pf_lastepoch=jset(d["pf_lastepoch"], i, last_ep),
            pf_dest=jset(d["pf_dest"], i, j + 1),
            msg_hi=hi, msg_lo=lo, msg_cnt=cnt,
        )
        return (valid, succ, self._full(C, n, K_SENDFETCH, torch.int32, dev), ovf & valid)

    # -------- fused message-receipt kernel (all M slots at once) --------
    # The nine receipt disjuncts of Next (KRaft.tla:827-840) are mutually
    # exclusive for a record (they partition on mtype, then on the error,
    # the fetch position and mresult), so each field of the successor takes
    # the value of whichever branch fired, and the five that reply share
    # one put of the branch's response.

    def _handle_message(self, d, C, dev):
        p, packer = self.p, self.packer
        S, L, V, M = p.n_servers, p.max_log, p.n_values, p.msg_slots
        m = self._idx("iota_m", dev)
        hi, lo, cnt = d["msg_hi"], d["msg_lo"], d["msg_cnt"]  # [C, 1, M]
        khi, klo, kcnt = hi[:, 0], lo[:, 0], cnt[:, 0]  # slot m = binding m

        def u(name):
            return packer.unpack(khi, klo, name)

        mtype, mepoch = u("mtype"), u("mepoch")
        src, dst = u("msource"), u("mdest")
        cur = jtake(d["currentEpoch"], dst)
        st_dst = jtake(d["state"], dst)
        led_dst = jtake(d["leader"], dst)
        hwm_dst = jtake(d["highWatermark"], dst)
        ll_dst = jtake(d["log_len"], dst)
        lt_dst = jtake(d["log_epoch"], dst)  # [C, M, L]
        lv_dst = jtake(d["log_value"], dst)
        recv = (khi != EMPTY) & (kcnt > 0)  # ReceivableMessage (KRaft.tla:230-235)
        equal_epoch = mepoch == cur
        # the incoming Discard, shared by every branch (Reply discards
        # first, KRaft.tla:220-227)
        c2 = bag.bag_discard_at(cnt, m)

        # --- HandleRequestVoteRequest (KRaft.tla:464-513)
        b_rvreq = recv & (mtype == RVREQ)
        rv_err = mepoch < cur  # FencedLeaderEpoch
        up = mepoch > cur  # state0 (KRaft.tla:472-474)
        s0_st = torch.where(up, UNATTACHED, st_dst)
        s0_ep = torch.where(up, mepoch, cur)
        s0_ld = torch.where(up, NIL, led_dst)
        last_ep = torch.where(ll_dst > 0, _at(lt_dst, ll_dst - 1), 0)
        mlle = u("mlastLogEpoch")
        log_ok = (mlle > last_ep) | ((mlle == last_ep) & (u("mlastLogOffset") >= ll_dst))
        grant = ((s0_st == UNATTACHED) | (
            (s0_st == VOTED) & (jtake(d["votedFor"], dst) == src + 1))) & log_ok
        # TransitionToVoted from Unattached (KRaft.tla:483-485)
        take_voted = grant & (s0_st == UNATTACHED)
        f_st = torch.where(take_voted, VOTED, s0_st)
        f_ep = torch.where(take_voted, mepoch, s0_ep)
        f_ld = torch.where(take_voted, NIL, s0_ld)
        rvhi, rvlo = self._pack(
            mtype=RVRESP, mepoch=torch.where(rv_err, cur, mepoch),
            mleader=torch.where(rv_err, led_dst, f_ld),
            mvoteGranted=torch.where(rv_err, 0, grant.to(torch.int32)),
            merror=torch.where(rv_err, E_FENCED, E_NONE), msource=dst, mdest=src)
        rv_ok = ~rv_err
        # IF state # state' THEN reset pendingFetch (KRaft.tla:495-497)
        pf_reset = rv_ok & (f_st != st_dst)

        # --- HandleRequestVoteResponse (KRaft.tla:519-541)
        mh_st, mh_ep, mh_ld, handled = self._maybe_handle_common(
            d, dst, u("mleader"), mepoch, u("merror"))
        b_rvresp = recv & (mtype == RVRESP) & (handled | (st_dst == CANDIDATE))
        granted_bit = (u("mvoteGranted") > 0) & ~handled

        # --- HandleBeginQuorumRequest (KRaft.tla:563-590)
        b_bqreq = recv & (mtype == BQREQ)
        bq_ok = mepoch >= cur
        bt_st, bt_ep, bt_ld = self._maybe_transition(d, dst, src + 1, mepoch)
        bqhi, bqlo = self._pack(mtype=BQRESP, mepoch=torch.where(bq_ok, mepoch, cur),
                                msource=dst, mdest=src,
                                merror=torch.where(bq_ok, E_NONE, E_FENCED))

        # --- FetchRequest branches (KRaft.tla:631-736)
        is_fetchreq = recv & (mtype == FETCHREQ)
        is_leader = st_dst == LEADER
        ferr = torch.where(~is_leader, E_NOTLEADER, torch.where(
            mepoch < cur, E_FENCED, torch.where(mepoch > cur, E_UNKNOWN, E_NONE)))
        foff, flep = u("mfetchOffset"), u("mlastFetchedEpoch")
        eo_off, eo_ep = self._end_offset_for_epoch(lt_dst, ll_dst, flep)
        # ValidFetchPosition (KRaft.tla:305-310)
        valid_pos = ((foff == 0) & (flep == 0)) | ((foff <= eo_off) & (flep == eo_ep))
        corr_kw = dict(mtype=FETCHRESP, mleader=led_dst, mepoch=cur, msource=dst, mdest=src,
                       cepoch=mepoch, cfetchOffset=foff, clastFetchedEpoch=flep)
        # RejectFetchRequest (KRaft.tla:631-651)
        b_reject = is_fetchreq & (ferr != E_NONE)
        rjhi, rjlo = self._pack(mresult=R_NOTOK, merror=ferr, mhwm=hwm_dst, **corr_kw)
        # DivergingFetchRequest (KRaft.tla:658-679)
        b_div = is_fetchreq & equal_epoch & is_leader & ~valid_pos
        dvhi, dvlo = self._pack(mresult=R_DIVERGING, merror=E_NONE, mdivergingEpoch=eo_ep,
                                mdivergingEndOffset=eo_off, mhwm=hwm_dst, **corr_kw)
        # AcceptFetchRequest (KRaft.tla:703-736)
        b_accept = is_fetchreq & equal_epoch & is_leader & valid_pos
        offset = foff + 1
        have_entry = offset <= ll_dst
        new_end = jset(jtake(d["endOffset"], dst), src, foff)  # [C, M, S]
        # NewHighwaterMark (KRaft.tla:689-701): a quorum per log index over
        # the new endOffset row, the leader counted itself
        idxs = torch.arange(1, L + 1, device=dev)
        self_in = torch.arange(S, device=dev) == dst.unsqueeze(-1)  # [C, M, S]
        agree = self_in.unsqueeze(-2) | (new_end.unsqueeze(-2) >= idxs[:, None])
        quorum_ok = 2 * agree.sum(-1) > S  # [C, M, L]
        max_agree = torch.where(quorum_ok & (idxs <= ll_dst.unsqueeze(-1)), idxs, 0).max(-1).values
        ep_at = _at(lt_dst, max_agree - 1)
        new_hwm = torch.where((max_agree > 0) & (ep_at == cur), max_agree, hwm_dst)
        # acked: FALSE -> TRUE for values committed in (hwm_old, new_hwm]
        # (KRaft.tla:721-724)
        lanes = torch.arange(L, device=dev)
        in_range = (lanes + 1 > hwm_dst.unsqueeze(-1)) & (lanes + 1 <= new_hwm.unsqueeze(-1))
        committed = torch.any(
            in_range.unsqueeze(-2)
            & (lv_dst.unsqueeze(-2) == torch.arange(1, V + 1, device=dev)[:, None]),
            dim=-1)  # [C, M, V]
        acked2 = torch.where((d["acked"] == ACK_FALSE) & committed, ACK_TRUE, d["acked"])
        achi, aclo = self._pack(
            mresult=R_OK, merror=E_NONE, nentries=have_entry.to(torch.int32),
            eepoch=torch.where(have_entry, _at(lt_dst, offset - 1), 0),
            evalue=torch.where(have_entry, _at(lv_dst, offset - 1), 0),
            mhwm=torch.minimum(new_hwm, offset), **corr_kw)

        # --- FetchResponse branches (KRaft.tla:742-801): the correlation
        # match, pendingFetch[dst] = m.correlation (:749); the request's
        # msource is dst (implied) and its mdest the responder src
        is_fresp = recv & (mtype == FETCHRESP)
        pf_ep = jtake(d["pf_epoch"], dst)
        corr = ((pf_ep > 0) & (pf_ep == u("cepoch"))
                & (jtake(d["pf_offset"], dst) == u("cfetchOffset"))
                & (jtake(d["pf_lastepoch"], dst) == u("clastFetchedEpoch"))
                & (jtake(d["pf_dest"], dst) == src + 1))
        mres = u("mresult")
        # HandleSuccessFetchResponse (KRaft.tla:742-757): a log at max_log
        # overflows (a hard error)
        b_ok = is_fresp & ~handled & corr & (mres == R_OK)
        app = u("nentries") > 0
        ok_ovf = b_ok & app & (ll_dst >= L)
        # HandleDivergingFetchResponse (KRaft.tla:766-780): truncate to the
        # highest common offset
        b_divr = is_fresp & ~handled & corr & (mres == R_DIVERGING)
        hco = self._highest_common_offset(lt_dst, ll_dst, u("mdivergingEndOffset"),
                                          u("mdivergingEpoch"))
        keep = lanes < hco.unsqueeze(-1)
        # HandleErrorFetchResponse (KRaft.tla:786-801)
        b_err = is_fresp & handled & corr

        # --- the shared Reply: the branch's response, put once into the bag
        # whose slot m was discarded; only the FetchResponse replies are
        # disabled by a response already in the bag (KRaft.tla:224-227)
        def pick(a, b, c, e, f):
            return torch.where(b_rvreq, a, torch.where(b_bqreq, b, torch.where(
                b_reject, c, torch.where(b_div, e, f))))

        phi, plo, pcnt, ex, povf = bag.bag_put(
            hi, lo, c2, pick(rvhi, bqhi, rjhi, dvhi, achi), pick(rvlo, bqlo, rjlo, dvlo, aclo))
        b_reject = b_reject & ~ex
        b_div = b_div & ~ex
        b_accept = b_accept & ~ex
        putb = b_rvreq | b_bqreq | b_reject | b_div | b_accept
        dropb = b_rvresp | b_ok | b_divr | b_err  # Discard only, no response

        # (state, epoch, leader) of dst: HandleRVReq's final triple, the
        # BeginQuorum transition, MaybeHandleCommonResponse's triple
        w_sle = (b_rvreq & rv_ok) | (b_bqreq & bq_ok) | (b_rvresp & handled) | b_err
        triple = [torch.where(b_rvreq, a, torch.where(b_bqreq, b, c))
                  for a, b, c in ((f_st, bt_st, mh_st), (f_ep, bt_ep, mh_ep),
                                  (f_ld, bt_ld, mh_ld))]
        upd = {name: _sel(w_sle, jset(d[name], dst, val), d[name])
               for name, val in zip(("state", "currentEpoch", "leader"), triple)}
        upd["votedFor"] = _sel(b_rvreq & rv_ok & grant,
                               jset(d["votedFor"], dst, src + 1), d["votedFor"])
        vg = d["votesGranted"]
        upd["votesGranted"] = _sel(
            b_rvresp & granted_bit,
            jset(vg, dst, jtake(vg, dst) | (torch.ones_like(src) << src)), vg)
        self._clear_pf(d, dst, upd, (b_rvreq & pf_reset) | (b_bqreq & bq_ok) | b_ok | b_divr
                       | b_err)
        upd["endOffset"] = _sel(b_accept, jset(d["endOffset"], dst, new_end), d["endOffset"])
        hwm = d["highWatermark"]
        upd["highWatermark"] = _sel(b_accept, jset(hwm, dst, new_hwm),
                                    _sel(b_ok, jset(hwm, dst, u("mhwm")), hwm))
        upd["acked"] = _sel(b_accept, acked2, d["acked"])
        apos = torch.clamp(ll_dst, 0, L - 1)
        b_app = b_ok & app
        lt, lv, ll = d["log_epoch"], d["log_value"], d["log_len"]
        upd["log_epoch"] = _sel(b_app, jset2(lt, dst, apos, u("eepoch")),
                                _sel(b_divr, jset(lt, dst, torch.where(keep, lt_dst, 0)), lt))
        upd["log_value"] = _sel(b_app, jset2(lv, dst, apos, u("evalue")),
                                _sel(b_divr, jset(lv, dst, torch.where(keep, lv_dst, 0)), lv))
        upd["log_len"] = _sel(b_app, jset(ll, dst, ll_dst + 1),
                              _sel(b_divr, jset(ll, dst, hco), ll))
        upd["msg_hi"] = _sel(putb, phi, hi)
        upd["msg_lo"] = _sel(putb, plo, lo)
        upd["msg_cnt"] = _sel(putb, pcnt, _sel(dropb, c2, cnt))
        succ = self._asm(d, C, M, **upd)

        false = torch.zeros_like(b_rvreq)
        branches = [
            (b_rvreq, K_HANDLE_RVREQ, povf),
            (b_rvresp, K_HANDLE_RVRESP, false),
            (b_reject, K_REJECT_FETCH, povf),
            (b_div, K_DIVERGING_FETCH, povf),
            (b_accept, K_ACCEPT_FETCH, povf),
            (b_bqreq, K_HANDLE_BQREQ, povf),
            (b_ok, K_HANDLE_FETCH_OK, ok_ovf),
            (b_divr, K_HANDLE_FETCH_DIV, false),
            (b_err, K_HANDLE_FETCH_ERR, false),
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
        the reference (``raft_tpu/models/kraft.py:857``)."""
        C = states.shape[0]
        dev = states.device
        d = self._dec(states)
        I = lambda name: self._idx(name, dev)  # noqa: E731
        outs = [
            self._restart(d, I("iota_s"), C, dev),
            self._request_vote(d, I("iota_s"), C, dev),
            self._become_leader(d, I("iota_s"), C, dev),
            self._client_request(d, I("cr_i"), I("cr_v"), C, dev),
            self._send_fetch_request(d, I("pr_i"), I("pr_j"), C, dev),
            self._handle_message(d, C, dev),
        ]
        valid = torch.cat([o[0] for o in outs], dim=1)
        succs = torch.cat([o[1] for o in outs], dim=1)
        rank = torch.cat([o[2].to(torch.int32) for o in outs], dim=1)
        ovf = torch.cat([o[3] for o in outs], dim=1)
        return succs, valid, rank, ovf

    # ---------------- the kernels' spec ----------------

    def _spec_vector(self) -> list[int]:
        """The int32 spec vector of csrc/kraft_actions.cuh (SPEC_SCALARS,
        then (word, shift, mask) of each of MSG_FIELDS)."""
        p, lay = self.p, self.layout
        off = {n: lay.fields[n].offset for n in SPEC_OFFSETS}
        vals = dict(S=p.n_servers, V=p.n_values, L=p.max_log, M=p.msg_slots, W=lay.W,
                    A=self.A, K=len(self.ACTION_NAMES), **off,
                    max_elections=p.max_elections, max_restarts=p.max_restarts)
        spec = [int(vals[n]) for n in SPEC_SCALARS]
        for name in MSG_FIELDS:
            spec += list(self.packer.locate(name))
        assert len(spec) == SPEC_LEN
        return spec

    # ---------------- initial states ----------------

    def init_states(self) -> np.ndarray:
        """Init — KRaft.tla:397-415. A single state; all Unattached."""
        lay = self.layout
        vec = lay.zeros((1,))
        vec[0, lay.sl("currentEpoch")] = 1
        vec[0, lay.sl("state")] = UNATTACHED
        vec[0, lay.sl("msg_hi")] = EMPTY
        vec[0, lay.sl("msg_lo")] = EMPTY
        vec[0, lay.sl("acked")] = ACK_NIL
        return vec

    # ---------------- KRaft's own invariants ----------------

    def _inv_no_illegal(self, states):
        """NoIllegalState — KRaft.tla:887-889."""
        return torch.all(self.layout.get(states, "state") != ILLEGAL, dim=1)

    def _inv_never_two_leaders(self, states):
        """NeverTwoLeadersInSameEpoch — KRaft.tla:916-921."""
        led = self.layout.get(states, "leader")
        ep = self.layout.get(states, "currentEpoch")
        both = (led[:, :, None] != NIL) & (led[:, None, :] != NIL)
        conflict = both & (led[:, :, None] != led[:, None, :]) & (
            ep[:, :, None] == ep[:, None, :])
        return ~conflict.flatten(1).any(dim=1)

    # ---------------- host-side decode/encode ----------------

    def decode(self, vec: np.ndarray) -> dict:
        """Decode one packed state into the canonical python form shared
        with the reference's oracle interpreter."""
        lay, p = self.layout, self.p
        vec = np.asarray(vec)
        g = lambda n: vec[lay.sl(n)]  # noqa: E731
        S, L = p.n_servers, p.max_log
        lt = g("log_epoch").reshape(S, L)
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
        pf_ep, pf_off = g("pf_epoch"), g("pf_offset")
        pf_le, pf_d = g("pf_lastepoch"), g("pf_dest")
        pending = tuple(
            None if int(pf_ep[i]) == 0 else tuple(sorted({
                "mtype": "FetchRequest", "mepoch": int(pf_ep[i]),
                "mfetchOffset": int(pf_off[i]), "mlastFetchedEpoch": int(pf_le[i]),
                "msource": i, "mdest": int(pf_d[i]) - 1}.items()))
            for i in range(S)
        )
        msgs = {}
        hi, lo, cnt = g("msg_hi"), g("msg_lo"), g("msg_cnt")
        for k in range(p.msg_slots):
            if int(hi[k]) == EMPTY:
                continue
            msgs[self.decode_msg(int(hi[k]), int(lo[k]))] = int(cnt[k])
        return {
            "currentEpoch": tuple(int(x) for x in g("currentEpoch")),
            "state": tuple(int(x) for x in g("state")),
            "votedFor": tuple(int(x) - 1 if x > 0 else None for x in g("votedFor")),
            "leader": tuple(int(x) - 1 if x > 0 else None for x in g("leader")),
            "pendingFetch": pending,
            "votesGranted": votes,
            "endOffset": tuple(
                tuple(int(x) for x in row) for row in g("endOffset").reshape(S, S)
            ),
            "log": log,
            "highWatermark": tuple(int(x) for x in g("highWatermark")),
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
            "mepoch": int(u["mepoch"]),
            "msource": int(u["msource"]),
            "mdest": int(u["mdest"]),
        }
        leader = int(u["mleader"]) - 1 if u["mleader"] else None
        if mtype == RVREQ:
            rec["mlastLogEpoch"] = int(u["mlastLogEpoch"])
            rec["mlastLogOffset"] = int(u["mlastLogOffset"])
        elif mtype == RVRESP:
            rec["mleader"] = leader
            rec["mvoteGranted"] = bool(u["mvoteGranted"])
            rec["merror"] = ERROR_NAMES[int(u["merror"])]
        elif mtype == BQRESP:
            rec["merror"] = ERROR_NAMES[int(u["merror"])]
        elif mtype == FETCHREQ:
            rec["mfetchOffset"] = int(u["mfetchOffset"])
            rec["mlastFetchedEpoch"] = int(u["mlastFetchedEpoch"])
        elif mtype == FETCHRESP:
            res = int(u["mresult"])
            rec["mresult"] = RESULT_NAMES[res]
            rec["merror"] = ERROR_NAMES[int(u["merror"])]
            rec["mleader"] = leader
            rec["mhwm"] = int(u["mhwm"])
            if res == R_OK:
                rec["mentries"] = (
                    ((int(u["eepoch"]), int(u["evalue"]) - 1),) if u["nentries"] else ())
            if res == R_DIVERGING:
                rec["mdivergingEpoch"] = int(u["mdivergingEpoch"])
                rec["mdivergingEndOffset"] = int(u["mdivergingEndOffset"])
            rec["correlation"] = tuple(sorted({
                "mtype": "FetchRequest", "mepoch": int(u["cepoch"]),
                "mfetchOffset": int(u["cfetchOffset"]),
                "mlastFetchedEpoch": int(u["clastFetchedEpoch"]),
                "msource": int(u["mdest"]), "mdest": int(u["msource"])}.items()))
        return tuple(sorted(rec.items()))

    def encode_msg(self, rec: tuple) -> tuple[int, int]:
        d = dict(rec)
        inv_err = {v: k for k, v in ERROR_NAMES.items()}
        inv_res = {v: k for k, v in RESULT_NAMES.items()}
        mtype = {v: k for k, v in MTYPE_NAMES.items()}[d["mtype"]]
        kw = dict(mtype=mtype, mepoch=d["mepoch"], msource=d["msource"], mdest=d["mdest"])
        leader = 0 if d.get("mleader") is None else d["mleader"] + 1
        if mtype == RVREQ:
            kw.update(mlastLogEpoch=d["mlastLogEpoch"], mlastLogOffset=d["mlastLogOffset"])
        elif mtype == RVRESP:
            kw.update(mleader=leader, mvoteGranted=int(d["mvoteGranted"]),
                      merror=inv_err[d["merror"]])
        elif mtype == BQRESP:
            kw.update(merror=inv_err[d["merror"]])
        elif mtype == FETCHREQ:
            kw.update(mfetchOffset=d["mfetchOffset"], mlastFetchedEpoch=d["mlastFetchedEpoch"])
        elif mtype == FETCHRESP:
            corr = dict(d["correlation"])
            kw.update(mresult=inv_res[d["mresult"]], merror=inv_err[d["merror"]],
                      mleader=leader, mhwm=d["mhwm"], cepoch=corr["mepoch"],
                      cfetchOffset=corr["mfetchOffset"],
                      clastFetchedEpoch=corr["mlastFetchedEpoch"])
            if d["mresult"] == "Ok":
                ent = d["mentries"]
                kw.update(nentries=len(ent), eepoch=ent[0][0] if ent else 0,
                          evalue=ent[0][1] + 1 if ent else 0)
            if d["mresult"] == "Diverging":
                kw.update(mdivergingEpoch=d["mdivergingEpoch"],
                          mdivergingEndOffset=d["mdivergingEndOffset"])
        return self.packer.pack(**kw)

    def encode(self, st: dict) -> np.ndarray:
        """Inverse of decode (canonical slot order for the message bag)."""
        lay, p = self.layout, self.p
        S, L = p.n_servers, p.max_log
        vec = lay.zeros(())
        vec[lay.sl("currentEpoch")] = st["currentEpoch"]
        vec[lay.sl("state")] = st["state"]
        vec[lay.sl("votedFor")] = [0 if v is None else v + 1 for v in st["votedFor"]]
        vec[lay.sl("leader")] = [0 if v is None else v + 1 for v in st["leader"]]
        pf = np.zeros((4, S), np.int32)
        for i, req in enumerate(st["pendingFetch"]):
            if req is not None:
                c = dict(req)
                pf[:, i] = c["mepoch"], c["mfetchOffset"], c["mlastFetchedEpoch"], c["mdest"] + 1
        for f, row in zip(("pf_epoch", "pf_offset", "pf_lastepoch", "pf_dest"), pf):
            vec[lay.sl(f)] = row
        lt = np.zeros((S, L), np.int32)
        lv = np.zeros((S, L), np.int32)
        for i, lg in enumerate(st["log"]):
            for k, (t, v) in enumerate(lg):
                lt[i, k] = t
                lv[i, k] = v + 1
        vec[lay.sl("log_epoch")] = lt.reshape(-1)
        vec[lay.sl("log_value")] = lv.reshape(-1)
        vec[lay.sl("log_len")] = [len(lg) for lg in st["log"]]
        vec[lay.sl("highWatermark")] = st["highWatermark"]
        vec[lay.sl("votesGranted")] = [sum(1 << j for j in vs) for vs in st["votesGranted"]]
        vec[lay.sl("endOffset")] = np.asarray(st["endOffset"]).reshape(-1)
        vec[lay.sl("acked")] = [
            {None: ACK_NIL, False: ACK_FALSE, True: ACK_TRUE}[a] for a in st["acked"]
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
        vec[lay.fields["electionCtr"].offset] = st["electionCtr"]
        vec[lay.fields["restartCtr"].offset] = st["restartCtr"]
        return vec
