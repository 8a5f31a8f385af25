"""Batched PyTorch lowering of KRaftWithReconfig, the dynamic-server-universe
spec.

Counterpart of ``raft_tpu/models/kraft_reconfig.py``; the TLA+ line
citations are the reference's (``pull-raft/KRaftWithReconfig.tla``). As in
``models/kraft.py``, each action is one batched computation over a
``[C, n]`` grid (chunk states x the action's bindings), so every value —
the successor rows of disabled candidates included — is bit-identical to
``jax.vmap(_expand1)``. The reference indexes with traced slot indices,
which JAX clamps on a read and drops on an out-of-range write; the
``jax_take``/``jax_set`` helpers of ``models/base.py`` keep those
semantics (a record's 3-bit ``mdest`` may name no slot of five).

The lowering (the reference's module docstring has the long form):

  - the growing ``servers`` universe becomes ``NS = MaxSpawnedServers``
    identity slots with a ``used`` mask; initial ``(h, 0)`` sits in slot
    h, a spawned ``(h, d)`` in slot ``ics + d - 1`` (``diskIdGen`` feeds d);
  - every server reference is a slot: ``leader``, ``votedFor``,
    ``pf_dest``, ``log_who``, ``mleader`` and ``e_who`` store slot + 1
    (0 = Nil), ``msource``/``mdest`` the raw slot, member sets are slot
    bitmasks; ``endOffset``'s domain is the ``eo_dom`` bitmask;
  - a log entry spans six lanes (cmd/epoch/val/cfgid/who/members);
  - messages are 3-word WidePacker keys (a FetchResponse embeds its
    request as the ``c*`` correlation fields);
  - SYMMETRY permutes hosts and values, not slots: the canonical
    fingerprint re-sorts the slots per permutation (``ops/slot_canon.py``).

The reference's quirks are kept: RestartWithoutState is never enabled,
``_addReconfigCtr`` is a constant 0 (not stored), HandleRejectJoinResponse
reaches only its Discard arm, and NoProgressPossible reduces to
``electionCtr == MaxElections``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..ops import bag
from ..ops.packing import EMPTY, WidePacker, bits_for
from .base import (
    ACK_FALSE,
    ACK_NIL,
    ACK_TRUE,
    INVARIANT_IDS,
    ActionLabelMixin,
    KernelModel,
    Layout,
    SparseExpandMixin,
    jax_set as jset,
    jax_set2 as jset2,
    jax_take as jtake,
    messages_are_valid_kernel,
    popcount,
    select as _sel,
)

# server states (KRaftWithReconfig.tla:354-360); UNATTACHED = 0 doubles as
# the unused-slot filler, every action gates on `used`
UNATTACHED, VOTED, FOLLOWER, CANDIDATE, LEADER, RESIGNED, DEAD, ILLEGAL = range(8)
R_NONE, R_VOTER, R_OBSERVER, R_DEAD = range(4)  # roles (:349-351); 0 = unused
NIL = 0
RVREQ, RVRESP, BQREQ, FETCHREQ, FETCHRESP, JOINREQ, JOINRESP = range(1, 8)
E_NONE, E_FENCED, E_NOTLEADER, E_UNKNOWN_LEADER, E_UNKNOWN_MEMBER, E_ALREADY_MEMBER = range(6)
R_RESULT_NONE, R_OK, R_NOTOK, R_DIVERGING = range(4)
C_NONE, C_INIT, C_APPEND, C_ADD, C_REMOVE = range(5)  # log entry commands (:363-366)

# Next-disjunct order (:1730-1756), for trace labels
(
    KR_RESTART, KR_REQUESTVOTE, KR_HANDLE_RVREQ, KR_HANDLE_RVRESP, KR_BECOMELEADER,
    KR_CLIENTREQUEST, KR_REJECT_FETCH, KR_DIVERGING_FETCH, KR_ACCEPT_FETCH_VOTER,
    KR_ACCEPT_FETCH_OBSERVER, KR_ACCEPT_BQREQ, KR_SENDFETCH, KR_HANDLE_FETCH_OK,
    KR_HANDLE_FETCH_DIV, KR_HANDLE_FETCH_NONSUCCESS, KR_STARTNEWSERVER, KR_SENDJOIN,
    KR_ACCEPT_JOIN, KR_REJECT_JOIN, KR_HANDLE_REJECT_JOIN, KR_HANDLE_REMOVE,
) = range(21)

ACTION_NAMES = [
    "RestartWithState", "RequestVote", "HandleRequestVoteRequest",
    "HandleRequestVoteResponse", "BecomeLeader", "ClientRequest", "RejectFetchRequest",
    "DivergingFetchRequest", "AcceptFetchRequestFromVoter", "AcceptFetchRequestFromObserver",
    "AcceptBeginQuorumRequest", "SendFetchRequest", "HandleSuccessFetchResponse",
    "HandleDivergingFetchResponse", "HandleNonSuccessFetchResponse", "StartNewServer",
    "SendJoinRequest", "AcceptJoinRequest", "RejectJoinRequest", "HandleRejectJoinResponse",
    "HandleRemoveRequest",
]

STATE_NAMES = {
    UNATTACHED: "Unattached", VOTED: "Voted", FOLLOWER: "Follower", CANDIDATE: "Candidate",
    LEADER: "Leader", RESIGNED: "Resigned", DEAD: "DeadNoState", ILLEGAL: "IllegalState",
}
ROLE_NAMES = {R_VOTER: "Voter", R_OBSERVER: "Observer", R_DEAD: "DeadNoState"}
MTYPE_NAMES = {
    RVREQ: "RequestVoteRequest", RVRESP: "RequestVoteResponse", BQREQ: "BeginQuorumRequest",
    FETCHREQ: "FetchRequest", FETCHRESP: "FetchResponse", JOINREQ: "JoinRequest",
    JOINRESP: "JoinResponse",
}
ERROR_NAMES = {
    E_NONE: None, E_FENCED: "FencedLeaderEpoch", E_NOTLEADER: "NotLeader",
    E_UNKNOWN_LEADER: "UnknownLeader", E_UNKNOWN_MEMBER: "UnknownMember",
    E_ALREADY_MEMBER: "AlreadyMember",
}
RESULT_NAMES = {R_OK: "Ok", R_NOTOK: "NotOk", R_DIVERGING: "Diverging"}
CMD_NAMES = {C_INIT: "InitClusterCommand", C_APPEND: "AppendCommand",
             C_ADD: "AddServerCommand", C_REMOVE: "RemoveServerCommand"}

ENTRY_FIELDS = ("cmd", "epoch", "val", "cfgid", "who", "members")  # log_* lanes of an entry
PF_FIELDS = ("pf_active", "pf_epoch", "pf_offset", "pf_lastepoch", "pf_dest", "pf_observer")


def rec(**kw) -> tuple:
    """A message record in the reference oracle's form (sorted items)."""
    return tuple(sorted(kw.items()))


@dataclass(frozen=True)
class KRaftReconfigParams:
    """The reference's ``KRaftReconfigParams``, field for field (so
    ``convert.params_from_reference`` is a plain constructor call)."""

    n_hosts: int
    n_values: int
    init_cluster_size: int
    min_cluster_size: int
    max_cluster_size: int
    max_elections: int
    max_restarts: int
    max_values_per_epoch: int
    max_add_reconfigs: int
    max_remove_reconfigs: int
    max_spawned_servers: int
    msg_slots: int = 40

    @property
    def n_servers(self) -> int:
        """The identity slots (what the engines and drivers call servers)."""
        return self.max_spawned_servers

    @property
    def max_epoch(self) -> int:
        return 1 + self.max_elections

    @property
    def max_log(self) -> int:
        # values (bounded per epoch) + InitClusterCommand + config commands
        return (self.max_values_per_epoch * self.max_epoch + 1 + self.max_add_reconfigs
                + self.max_remove_reconfigs)

    @property
    def max_cfg_id(self) -> int:
        return 1 + self.max_add_reconfigs + self.max_remove_reconfigs


def _build_layout(p: KRaftReconfigParams) -> Layout:
    NS, V, L, M, E = p.max_spawned_servers, p.n_values, p.max_log, p.msg_slots, p.max_epoch
    lay = Layout(NS)
    # VIEW (:460) = everything but the _-prefixed aux variables, acked
    # included; the identity slots first
    for name in ("host", "diskId", "used", "role", "state", "currentEpoch"):
        lay.add(name, "per_server", (NS,))
    lay.add("leader", "per_server_val", (NS,))
    lay.add("votedFor", "per_server_val", (NS,))
    # pendingFetch (:409); pf_active is the non-Nil flag (a spawned
    # server's first fetch has mepoch 0)
    for name in ("pf_active", "pf_epoch", "pf_offset", "pf_lastepoch"):
        lay.add(name, "per_server", (NS,))
    lay.add("pf_dest", "per_server_val", (NS,))
    lay.add("pf_observer", "per_server", (NS,))
    lay.add("votesGranted", "server_bitmask", (NS,))
    lay.add("cfg_id", "per_server", (NS,))  # config cache (:397)
    lay.add("cfg_members", "server_bitmask", (NS,))
    lay.add("cfg_committed", "per_server", (NS,))
    lay.add("eo_dom", "server_bitmask", (NS,))  # endOffset's domain
    lay.add("endOffset", "per_server_pair", (NS, NS))
    for name in ENTRY_FIELDS:
        lay.add(f"log_{name}", "per_server", (NS, L))
    lay.add("log_len", "per_server", (NS,))
    lay.add("highWatermark", "per_server", (NS,))
    lay.add("acked", "scalar", (V,))
    for k in range(_build_packer(p).n_words):
        lay.add(f"msg_w{k}", "msg_word", (M,))
    lay.add("msg_cnt", "msg_cnt", (M,))
    for name in ("electionCtr", "restartCtr", "removeCtr", "diskIdGen"):
        lay.add(name, "aux")
    lay.add("valueCtr", "aux", (E,))  # per-epoch value counter (:446)
    return lay.finish()


def _build_packer(p: KRaftReconfigParams) -> WidePacker:
    NS = p.max_spawned_servers
    eb, sb, nb = bits_for(p.max_epoch), bits_for(NS - 1), bits_for(NS)
    lb, vb, cb = bits_for(p.max_log), bits_for(p.n_values), bits_for(p.max_cfg_id)
    fields = [
        ("mtype", 3), ("mepoch", eb), ("msource", sb), ("mdest", sb),
        ("mlastLogEpoch", eb), ("mlastLogOffset", lb),  # RequestVoteRequest (:947-952)
        ("mleader", nb), ("mvoteGranted", 1), ("merror", 3), ("mresult", 2),
        ("mfetchOffset", lb), ("mlastFetchedEpoch", eb), ("mobserver", 1),  # (:1155-1162)
        ("mhwm", lb), ("nentries", 1),  # <= 1 entry per response (:1306-1310)
        ("e_cmd", 3), ("e_epoch", eb), ("e_val", vb), ("e_cfgid", cb), ("e_who", nb),
        ("e_members", NS),
        ("mdivergingEpoch", eb), ("mdivergingEndOffset", lb),  # (:1236-1241)
        ("cepoch", eb), ("cfetchOffset", lb), ("clastFetchedEpoch", eb), ("cobserver", 1),
    ]
    total = sum(b for _n, b in fields)
    for n_words in range(max(1, (total + 29) // 30), 8):
        try:
            return WidePacker(fields, n_words)
        except ValueError:
            continue
    raise ValueError("message schema does not fit in 7 words")


# ---- the kernels' view of a model (csrc/kreconfig_actions.cuh) ----
# The layout offsets the kernels read, in the order of the KC_* enum of
# kreconfig_actions.cuh, then the model's bounds; its kernels refuse a spec
# vector of any other length.
SPEC_OFFSETS = (
    "host", "diskId", "used", "role", "state", "currentEpoch", "leader", "votedFor",
    *PF_FIELDS, "votesGranted", "cfg_id", "cfg_members", "cfg_committed", "eo_dom",
    "endOffset", *(f"log_{n}" for n in ENTRY_FIELDS), "log_len", "highWatermark", "acked",
    "msg_w0", "msg_cnt", "electionCtr", "restartCtr", "removeCtr", "diskIdGen", "valueCtr",
)
SPEC_PARAMS = (
    "n_hosts", "init_cluster_size", "min_cluster_size", "max_cluster_size", "max_elections",
    "max_restarts", "max_values_per_epoch", "max_add_reconfigs", "max_remove_reconfigs",
    "max_epoch",
)
SPEC_SCALARS = ("S", "V", "L", "M", "W", "A", "K", "NW", "VL") + SPEC_OFFSETS + SPEC_PARAMS
# every field of the packer in its order, each as (word, shift, mask) after
# the scalars (the KF_* enum)
MSG_FIELDS = tuple(n for n, _b in _build_packer(KRaftReconfigParams(
    3, 2, 3, 2, 4, 2, 1, 1, 1, 1, 5)).fields.items())
SPEC_LEN = len(SPEC_SCALARS) + 3 * len(MSG_FIELDS)
MAX_SLOTS, MAX_LOG, MAX_WORDS = 8, 8, 3  # csrc/kreconfig_actions.cuh KC_MAX_*
# action groups (the KG_* enum); a candidate row is (group, p0, p1, rank)
GROUP_IDS = {
    "RestartWithState": 0, "RequestVote": 1, "BecomeLeader": 2, "ClientRequest": 3,
    "SendFetchRequest": 4, "StartNewServer": 5, "SendJoinRequest": 6,
    "HandleRemoveRequest": 7, "HandleMessage": 8,
}
GROUP_RANKS = {
    "RestartWithState": KR_RESTART, "RequestVote": KR_REQUESTVOTE,
    "BecomeLeader": KR_BECOMELEADER, "ClientRequest": KR_CLIENTREQUEST,
    "SendFetchRequest": KR_SENDFETCH, "StartNewServer": KR_STARTNEWSERVER,
    "SendJoinRequest": KR_SENDJOIN, "HandleRemoveRequest": KR_HANDLE_REMOVE,
    # the thirteen receipt disjuncts resolve their rank at run time
    "HandleMessage": KR_HANDLE_RVREQ,
}
# the family's own invariants after the shared ids (KC_INV_*), and its
# liveness predicates: CommittedValueOrNothing(v) is PRED_VALUE + v,
# ConfigAllOrNothing(cid) is PRED_CONFIG + cid
KRECONFIG_INVARIANT_IDS = {"NoIllegalState": 5, "NeverTwoLeadersInSameEpoch": 6,
                           "StatesMatchRoles": 7}
PRED_VALUE, PRED_CONFIG = 16, 24


def _at(row, idx):
    """``row[..., idx]`` as JAX gathers on the last axis (clamped); the
    leading axes of ``row`` and ``idx`` broadcast."""
    lead = torch.broadcast_shapes(row.shape[:-1], idx.shape)
    idx = idx.clamp(0, row.shape[-1] - 1).to(torch.int64).expand(lead)
    return row.expand(lead + row.shape[-1:]).gather(-1, idx.unsqueeze(-1)).squeeze(-1)


def _set_last(row, idx, val):
    """``row.at[..., idx].set(val)`` on the last axis (no write where idx is
    out of range)."""
    lanes = torch.arange(row.shape[-1], device=row.device)
    if isinstance(val, torch.Tensor):
        val = val.unsqueeze(-1)
    return torch.where(lanes == idx.unsqueeze(-1), val, row)


def _bit(mask, j):
    return ((mask >> j) & 1) > 0


class KRaftReconfigModel(KernelModel, SparseExpandMixin, ActionLabelMixin):
    """Batched successor/invariant kernels for one constants binding."""

    name = "KRaftWithReconfig"
    ACTION_NAMES = ACTION_NAMES
    STATE_NAMES = STATE_NAMES
    ACTIONS_HEADER = "kreconfig_actions.cuh"
    KERNELS = kernels.KRECONFIG_FAMILY
    GROUP_IDS = GROUP_IDS
    GROUP_RANKS = GROUP_RANKS
    _pack = KernelModel.pack_i32

    def __init__(self, params: KRaftReconfigParams, server_names=None, value_names=None):
        self.p = params
        self.layout = _build_layout(params)
        self.packer = _build_packer(params)
        self.n_words = self.packer.n_words
        NS, V, H, M = params.max_spawned_servers, params.n_values, params.n_hosts, params.msg_slots
        self.NS = NS
        self.server_names = list(server_names or [f"h{i+1}" for i in range(H)])
        self.value_names = list(value_names or [f"v{i+1}" for i in range(V)])

        # the non-receipt disjuncts in Next order (:1730-1756), the receipt
        # disjuncts fused per message slot at the end
        self._pairs = [(i, j) for i in range(NS) for j in range(NS) if i != j]
        b: list = []
        for name in ("RestartWithState", "RequestVote", "BecomeLeader"):
            b += [(name, (i,)) for i in range(NS)]
        b += [("ClientRequest", (i, v)) for i in range(NS) for v in range(V)]
        b += [("SendFetchRequest", ij) for ij in self._pairs]
        b += [("StartNewServer", (h, j)) for h in range(H) for j in range(NS)]
        b += [("SendJoinRequest", ij) for ij in self._pairs]
        b += [("HandleRemoveRequest", (i, r)) for i in range(NS) for r in range(NS)]
        b += [("HandleMessage", (m,)) for m in range(M)]
        self.bindings = b
        self.A = len(b)
        self._consts: dict = {}

        self.invariants = {
            "NoIllegalState": self._inv_no_illegal,
            "NoLogDivergence": self._inv_no_log_divergence,
            "StatesMatchRoles": self._inv_states_match_roles,
            "NeverTwoLeadersInSameEpoch": self._inv_never_two_leaders,
            "LeaderHasAllAckedValues": self._inv_leader_has_acked,
            "MessagesAreValid": messages_are_valid_kernel(self.layout, self.packer),
            "TestInv": lambda s: torch.ones(s.shape[:-1], dtype=torch.bool, device=s.device),
        }
        self._pred_ids = {n: INVARIANT_IDS[n] for n in
                          ("MessagesAreValid", "NoLogDivergence", "LeaderHasAllAckedValues",
                           "TestInv")} | KRECONFIG_INVARIANT_IDS
        # temporal properties (:1810-1839): ValuesNotStuck = \A v :
        # []<> CommittedValueOrNothing(v); ReconfigurationNotStuck = \A cid
        # in 1..(MaxAdd + MaxRemove) : []<> ConfigAllOrNothing(cid)
        self.predicates: dict = {}
        self.liveness = {"ValuesNotStuck": [], "ReconfigurationNotStuck": []}
        for v, vname in enumerate(self.value_names):
            q = f"CommittedValueOrNothing({vname})"
            self.predicates[q] = lambda s, v=v: self._live_committed_value_or_nothing(v, s)
            self._pred_ids[q] = PRED_VALUE + v
            self.liveness["ValuesNotStuck"].append((vname, None, q))
        for cid in range(1, params.max_add_reconfigs + params.max_remove_reconfigs + 1):
            q = f"ConfigAllOrNothing({cid})"
            self.predicates[q] = lambda s, cid=cid: self._live_config_all_or_nothing(cid, s)
            self._pred_ids[q] = PRED_CONFIG + cid
            self.liveness["ReconfigurationNotStuck"].append((f"config_id={cid}", None, q))

    def make_canonicalizer(self, symmetry: bool = True, seed: int = 0):
        """The model's own canon (``Canonicalizer.for_model`` returns it):
        the data-dependent slot canonicalizer of ``ops/slot_canon.py``."""
        from ..ops.slot_canon import SlotCanonicalizer

        return SlotCanonicalizer(self, symmetry, seed=seed)

    # ---------------- helpers ----------------

    def _bind_tables(self) -> dict:
        NS, V, H, M = self.NS, self.p.n_values, self.p.n_hosts, self.p.msg_slots
        return {
            "iota_s": list(range(NS)),
            "pr_i": [ij[0] for ij in self._pairs],
            "pr_j": [ij[1] for ij in self._pairs],
            "cr_i": [i for i in range(NS) for _ in range(V)],
            "cr_v": [v for _ in range(NS) for v in range(V)],
            "sn_h": [h for h in range(H) for _ in range(NS)],
            "sn_j": [j for _ in range(H) for j in range(NS)],
            "rm_i": [i for i in range(NS) for _ in range(NS)],
            "rm_r": [r for _ in range(NS) for r in range(NS)],
            "iota_m": list(range(M)),
        }

    def _words(self, d):
        return [d[f"msg_w{k}"] for k in range(self.n_words)]

    def _wupd(self, words, cnt):
        upd = {f"msg_w{k}": w for k, w in enumerate(words)}
        upd["msg_cnt"] = cnt
        return upd

    def _popcount(self, x):
        return popcount(x, self.NS)

    def _used_mask(self, d):
        """The bitmask of used slots, [C, 1]."""
        bits = torch.ones(self.NS, dtype=torch.int32, device=d["used"].device) << torch.arange(
            self.NS, device=d["used"].device)
        return torch.where(d["used"] > 0, bits, 0).sum(-1, dtype=torch.int32)

    def _last_epoch(self, d, i):
        """LastEpoch(log[i]) — :498."""
        ll = jtake(d["log_len"], i)
        return torch.where(ll > 0, _at(jtake(d["log_epoch"], i), ll - 1), 0)

    def _clear_pf(self, d, i, upd, cond=None):
        """pendingFetch[i] := Nil (the six lanes zeroed), where ``cond``."""
        for f in PF_FIELDS:
            upd[f] = jset(d[f], i, 0) if cond is None else _sel(cond, jset(d[f], i, 0), d[f])
        return upd

    def _zero_row(self, dev):
        return torch.zeros((1, 1, self.NS), dtype=torch.int32, device=dev)

    def _rank(self, C, n, r, dev):
        return self._full(C, n, r, torch.int32, dev)

    def _cond_put(self, words, cnt, key, do):
        """wide_bag_put applied only where ``do``; (words, cnt, existed &
        do, ovf & do)."""
        w2, c2, existed, ovf = bag.wide_bag_put(words, cnt, key)
        m = do.unsqueeze(-1)
        return ([torch.where(m, a, b) for a, b in zip(w2, words)], torch.where(m, c2, cnt),
                existed & do, ovf & do)

    # -------- transition machine (:599-715); triples (state, epoch, leader) --------

    def _has_consistent_leader(self, d, i, leader_enc, epoch):
        """HasConsistentLeader — :599-616 (resigned/observer carve-outs)."""
        cur, st_i, led = jtake(d["currentEpoch"], i), jtake(d["state"], i), jtake(d["leader"], i)
        self_case = torch.where(
            (cur == epoch) & ((jtake(d["role"], i) == R_OBSERVER) | (st_i == RESIGNED)),
            True, st_i == LEADER)
        other = (epoch != cur) | (leader_enc == NIL) | (led == NIL) | (led == leader_enc)
        return torch.where(leader_enc == i + 1, self_case, other)

    def _maybe_transition(self, d, i, leader_enc, epoch):
        """MaybeTransition — :656-675 (TransitionToFollower's illegal arm
        folded in, :645-653; case 3 adds leaderId # i)."""
        cur, st_i, led = jtake(d["currentEpoch"], i), jtake(d["state"], i), jtake(d["leader"], i)
        hcl = self._has_consistent_leader(d, i, leader_enc, epoch)
        tf_ill = (cur == epoch) & ((st_i == FOLLOWER) | (st_i == LEADER))
        tf = (torch.where(tf_ill, ILLEGAL, FOLLOWER), torch.where(tf_ill, 0, epoch),
              torch.where(tf_ill, 0, leader_enc))
        una = (UNATTACHED, epoch, NIL)
        noop = (st_i, cur, led)
        ill = (ILLEGAL, 0, NIL)
        c2_pick = torch.where(leader_enc == NIL, 1, 2)  # 1 = unattached, 2 = follower
        c3 = (leader_enc != NIL) & (led == NIL) & (leader_enc != i + 1)
        sel = torch.where(~hcl, 0, torch.where(epoch > cur, c2_pick, torch.where(c3, 2, 3)))
        return tuple(
            torch.where(sel == 0, ill[k], torch.where(
                sel == 1, una[k], torch.where(sel == 2, tf[k], noop[k])))
            for k in range(3))

    def _mhcr(self, d, i, leader_enc, epoch, err):
        """MaybeHandleCommonResponse — :683-715. Returns (state, epoch,
        leader, handled)."""
        cur, st_i, led = jtake(d["currentEpoch"], i), jtake(d["state"], i), jtake(d["leader"], i)
        mt = self._maybe_transition(d, i, leader_enc, epoch)
        c_stale = epoch < cur
        c_trans = (epoch > cur) | (err == E_FENCED) | (err == E_NOTLEADER)
        c_follow = (epoch == cur) & (leader_enc != NIL) & (led == NIL)
        sel = torch.where(c_stale, 0, torch.where(c_trans, 1, torch.where(c_follow, 2, 3)))
        fol = (FOLLOWER, cur, leader_enc)
        noop = (st_i, cur, led)
        out = [torch.where(sel == 1, mt[k], torch.where(sel == 2, fol[k], noop[k]))
               for k in range(3)]
        handled = torch.where(sel == 2, err != E_NONE, (sel == 0) | (sel == 1))
        return out[0], out[1], out[2], handled

    # -------- log-position and config math (:498-777); rows [..., L] --------

    def _lanes(self, dev):
        return torch.arange(self.p.max_log, device=dev)

    def _end_offset_for_epoch(self, row, ll, lfe):
        """EndOffsetForEpoch — :551-567."""
        lanes = self._lanes(row.device)
        mask = (lanes < ll.unsqueeze(-1)) & (row <= lfe.unsqueeze(-1))
        off = torch.where(mask, lanes + 1, 0).max(-1).values
        return off, torch.where(off > 0, _at(row, off - 1), 0)

    def _highest_common_offset(self, row, ll, end_off, epoch):
        """HighestCommonOffset — :521-539."""
        lanes = self._lanes(row.device)
        ep = epoch.unsqueeze(-1)
        le = (row < ep) | ((row == ep) & (lanes + 1 <= end_off.unsqueeze(-1)))
        mask = (lanes < ll.unsqueeze(-1)) & le
        return torch.where(mask, lanes + 1, 0).max(-1).values

    def _most_recent_reconfig(self, cmd_row, log_len):
        """MostRecentReconfigEntry — :729-735: the offset of the last config
        command among the first log_len lanes, 0 if none."""
        lanes = self._lanes(cmd_row.device)
        is_cfg = (((cmd_row == C_INIT) | (cmd_row == C_ADD) | (cmd_row == C_REMOVE))
                  & (lanes < log_len.unsqueeze(-1)))
        return torch.where(is_cfg, lanes + 1, 0).max(-1).values

    def _leader_committed_in_epoch(self, d, i):
        """LeaderHasCommittedOffsetsInCurrentEpoch — :774-777."""
        lanes = self._lanes(d["log_len"].device)
        return torch.any(
            (lanes < jtake(d["log_len"], i).unsqueeze(-1))
            & (jtake(d["log_epoch"], i) == jtake(d["currentEpoch"], i).unsqueeze(-1))
            & (jtake(d["highWatermark"], i).unsqueeze(-1) >= lanes + 1), dim=-1)

    # ---------------- action kernels ----------------
    # Each returns (valid [C, n], succ [C, n, W], rank [C, n], ovf [C, n]).

    def _restart_with_state(self, d, i, C, dev):
        """RestartWithState — :873-896: a leader restarts as Resigned (voter)
        or Unattached (observer); keeps epoch, role, votedFor and the log."""
        n = i.shape[1]
        st_i = jtake(d["state"], i)
        valid = ((d["restartCtr"] < self.p.max_restarts) & (jtake(d["used"], i) > 0)
                 & (st_i != DEAD))
        was_leader = st_i == LEADER
        new_state = torch.where(
            was_leader, torch.where(jtake(d["role"], i) == R_VOTER, RESIGNED, UNATTACHED), st_i)
        upd = dict(
            state=jset(d["state"], i, new_state),
            leader=jset(d["leader"], i, torch.where(was_leader, NIL, jtake(d["leader"], i))),
            votesGranted=jset(d["votesGranted"], i, 0),
            eo_dom=jset(d["eo_dom"], i, self._used_mask(d).expand(C, n)),
            endOffset=jset(d["endOffset"], i, self._zero_row(dev)),
            highWatermark=jset(d["highWatermark"], i, 0),
            restartCtr=d["restartCtr"] + 1,
        )
        succ = self._asm(d, C, n, **self._clear_pf(d, i, upd))
        return (valid.expand(C, n), succ, self._rank(C, n, KR_RESTART, dev),
                self._full(C, n, False, torch.bool, dev))

    def _request_vote(self, d, i, C, dev):
        """RequestVote — :932-955: Voter only, a member of its own config;
        RequestVoteRequests to the config members via SendMultipleOnce."""
        p, NS = self.p, self.NS
        n = i.shape[1]
        st_i = jtake(d["state"], i)
        members = jtake(d["cfg_members"], i)
        valid = ((d["electionCtr"] < p.max_elections) & (jtake(d["used"], i) > 0)
                 & (jtake(d["role"], i) == R_VOTER)
                 & ((st_i == FOLLOWER) | (st_i == CANDIDATE) | (st_i == UNATTACHED))
                 & _bit(members, i))
        new_epoch = jtake(d["currentEpoch"], i) + 1
        last_ep = self._last_epoch(d, i)
        ll_i = jtake(d["log_len"], i)
        words, cnt = self._words(d), d["msg_cnt"]
        ovf = self._full(C, n, False, torch.bool, dev)
        for delta in range(1, NS):
            j = torch.remainder(i + delta, NS)
            key = self._pack(mtype=RVREQ, mepoch=new_epoch, mlastLogEpoch=last_ep,
                             mlastLogOffset=ll_i, msource=i, mdest=j)
            words, cnt, existed, o = self._cond_put(words, cnt, key, _bit(members, j))
            valid = valid & ~existed
            ovf = ovf | o
        upd = dict(
            state=jset(d["state"], i, CANDIDATE),
            currentEpoch=jset(d["currentEpoch"], i, new_epoch),
            leader=jset(d["leader"], i, NIL),
            votedFor=jset(d["votedFor"], i, i + 1),
            votesGranted=jset(d["votesGranted"], i, torch.ones_like(i) << i),
            electionCtr=d["electionCtr"] + 1,
            **self._wupd(words, cnt),
        )
        succ = self._asm(d, C, n, **self._clear_pf(d, i, upd))
        return valid, succ, self._rank(C, n, KR_REQUESTVOTE, dev), ovf & valid

    def _become_leader(self, d, i, C, dev):
        """BecomeLeader — :1056-1071: a quorum of the candidate's own
        config; BeginQuorumRequests via SendMultipleOnce; endOffset reset
        over all servers."""
        NS = self.NS
        n = i.shape[1]
        members = jtake(d["cfg_members"], i)
        vg = jtake(d["votesGranted"], i)
        valid = ((jtake(d["used"], i) > 0) & (jtake(d["state"], i) == CANDIDATE)
                 & ((vg & ~members) == 0) & (2 * self._popcount(vg) > self._popcount(members)))
        ep_i = jtake(d["currentEpoch"], i)
        words, cnt = self._words(d), d["msg_cnt"]
        ovf = self._full(C, n, False, torch.bool, dev)
        for delta in range(1, NS):
            j = torch.remainder(i + delta, NS)
            key = self._pack(mtype=BQREQ, mepoch=ep_i, msource=i, mdest=j)
            words, cnt, existed, o = self._cond_put(words, cnt, key, _bit(members, j))
            valid = valid & ~existed
            ovf = ovf | o
        succ = self._asm(
            d, C, n,
            state=jset(d["state"], i, LEADER),
            leader=jset(d["leader"], i, i + 1),
            eo_dom=jset(d["eo_dom"], i, self._used_mask(d).expand(C, n)),
            endOffset=jset(d["endOffset"], i, self._zero_row(dev)),
            **self._wupd(words, cnt),
        )
        return valid, succ, self._rank(C, n, KR_BECOMELEADER, dev), ovf & valid

    def _client_request(self, d, i, v, C, dev):
        """ClientRequest — :1110-1126: bounded per epoch by valueCtr; a log
        at max_log overflows."""
        p, L = self.p, self.p.max_log
        n = i.shape[1]
        ep = jtake(d["currentEpoch"], i)
        epc = torch.clamp(ep - 1, 0, p.max_epoch - 1)
        valid = ((jtake(d["used"], i) > 0) & (jtake(d["state"], i) == LEADER)
                 & (jtake(d["acked"], v) == ACK_NIL)
                 & (jtake(d["valueCtr"], epc) < p.max_values_per_epoch))
        pos = jtake(d["log_len"], i)
        ovf = valid & (pos >= L)
        posc = torch.clamp(pos, 0, L - 1)
        succ = self._asm(
            d, C, n,
            log_cmd=jset2(d["log_cmd"], i, posc, C_APPEND),
            log_epoch=jset2(d["log_epoch"], i, posc, ep),
            log_val=jset2(d["log_val"], i, posc, (v + 1).expand(C, n)),
            log_len=jset(d["log_len"], i, pos + 1),
            acked=jset(d["acked"], v, ACK_FALSE),
            valueCtr=jset(d["valueCtr"], epc, jtake(d["valueCtr"], epc) + 1),
        )
        return valid, succ, self._rank(C, n, KR_CLIENTREQUEST, dev), ovf

    def _send_fetch_request(self, d, i, j, C, dev):
        """SendFetchRequest — :1137-1169: a known-leader follower's fetch, or
        an Unattached observer probing a voter of its config."""
        n = i.shape[1]
        st_i, role_i = jtake(d["state"], i), jtake(d["role"], i)
        path_a = (jtake(d["leader"], i) == j + 1) & (st_i == FOLLOWER)
        path_b = (role_i == R_OBSERVER) & (st_i == UNATTACHED) & _bit(
            jtake(d["cfg_members"], i), j)
        valid = ((jtake(d["used"], i) > 0) & (jtake(d["used"], j) > 0)
                 & (jtake(d["pf_active"], i) == 0) & (path_a | path_b))
        ll_i = jtake(d["log_len"], i)
        last_ep = self._last_epoch(d, i)
        ep_i = jtake(d["currentEpoch"], i)
        is_obs = (role_i == R_OBSERVER).to(torch.int32)
        key = self._pack(mtype=FETCHREQ, mepoch=ep_i, mfetchOffset=ll_i,
                         mlastFetchedEpoch=last_ep, mobserver=is_obs, msource=i, mdest=j)
        words, cnt, _existed, ovf = bag.wide_bag_put(self._words(d), d["msg_cnt"], key)
        succ = self._asm(
            d, C, n,
            pf_active=jset(d["pf_active"], i, 1),
            pf_epoch=jset(d["pf_epoch"], i, ep_i),
            pf_offset=jset(d["pf_offset"], i, ll_i),
            pf_lastepoch=jset(d["pf_lastepoch"], i, last_ep),
            pf_dest=jset(d["pf_dest"], i, j + 1),
            pf_observer=jset(d["pf_observer"], i, is_obs),
            **self._wupd(words, cnt),
        )
        return valid, succ, self._rank(C, n, KR_SENDFETCH, dev), ovf & valid

    def _start_new_server(self, d, h, j, C, dev):
        """StartNewServer — :1492-1511: mints a fresh [host, diskId] observer
        in the next free slot; its first fetch targets a current leader.
        endOffset's domain = the servers before the spawn."""
        NS = self.NS
        n = h.shape[1]
        n_used = (d["used"] > 0).sum(-1, dtype=torch.int32)  # [C, 1]
        valid = (n_used < NS) & (jtake(d["used"], j) > 0) & (jtake(d["state"], j) == LEADER)
        slot = torch.clamp(n_used, 0, NS - 1).expand(C, n)
        disk_id = d["diskIdGen"] + 1
        key = self._pack(mtype=FETCHREQ, mepoch=0, mfetchOffset=0, mlastFetchedEpoch=0,
                         mobserver=1, msource=slot, mdest=j.expand(C, n))
        words, cnt, _existed, ovf = bag.wide_bag_put(self._words(d), d["msg_cnt"], key)
        upd = dict(used=jset(d["used"], slot, 1), host=jset(d["host"], slot, h.expand(C, n)),
                   diskId=jset(d["diskId"], slot, disk_id.expand(C, n)),
                   role=jset(d["role"], slot, R_OBSERVER),
                   eo_dom=jset(d["eo_dom"], slot, self._used_mask(d).expand(C, n)),
                   endOffset=jset(d["endOffset"], slot, self._zero_row(dev)),
                   pf_active=jset(d["pf_active"], slot, 1),
                   pf_dest=jset(d["pf_dest"], slot, (j + 1).expand(C, n)),
                   pf_observer=jset(d["pf_observer"], slot, 1),
                   diskIdGen=disk_id, **self._wupd(words, cnt))
        for f in ("state", "currentEpoch", "leader", "votedFor", "votesGranted", "cfg_id",
                  "cfg_members", "cfg_committed", "log_len", "highWatermark", "pf_epoch",
                  "pf_offset", "pf_lastepoch"):
            upd[f] = jset(d[f], slot, 0)
        succ = self._asm(d, C, n, **upd)
        return valid, succ, self._rank(C, n, KR_STARTNEWSERVER, dev), ovf & valid

    def _send_join_request(self, d, i, j, C, dev):
        """SendJoinRequest — :1524-1538: an observer outside its config asks
        its known leader; send-once. The _addReconfigCtr gate (:1526) is a
        constant."""
        n = i.shape[1]
        valid = ((self.p.max_add_reconfigs > 0) & (jtake(d["used"], i) > 0)
                 & (jtake(d["used"], j) > 0) & (jtake(d["role"], i) == R_OBSERVER)
                 & ~_bit(jtake(d["cfg_members"], i), i) & (jtake(d["leader"], i) == j + 1))
        key = self._pack(mtype=JOINREQ, mepoch=jtake(d["currentEpoch"], i), mdest=j, msource=i)
        words, cnt, existed, ovf = bag.wide_bag_put(self._words(d), d["msg_cnt"], key)
        valid = valid & ~existed
        succ = self._asm(d, C, n, **self._wupd(words, cnt))
        return valid, succ, self._rank(C, n, KR_SENDJOIN, dev), ovf & valid

    def _handle_remove_request(self, d, i, r, C, dev):
        """HandleRemoveRequest — :1699-1724: an admin removal appends a
        RemoveServerCommand; a self-removing leader becomes an observer but
        stays leader."""
        p, L = self.p, self.p.max_log
        n = i.shape[1]
        members = jtake(d["cfg_members"], i)
        check_ok = ((jtake(d["state"], i) == LEADER) & _bit(members, r)
                    & (jtake(d["cfg_committed"], i) > 0)
                    & self._leader_committed_in_epoch(d, i))  # RemoveCheck (:1692-1697)
        valid = ((jtake(d["used"], i) > 0) & (jtake(d["used"], r) > 0)
                 & (d["removeCtr"] < p.max_remove_reconfigs) & check_ok
                 & (self._popcount(members) > p.min_cluster_size))
        new_members = members & ~(torch.ones_like(r) << r)
        pos = jtake(d["log_len"], i)
        ovf = valid & (pos >= L)
        posc = torch.clamp(pos, 0, L - 1)
        new_len = pos + 1
        cid = jtake(d["cfg_id"], i) + 1
        succ = self._asm(
            d, C, n,
            log_cmd=jset2(d["log_cmd"], i, posc, C_REMOVE),
            log_epoch=jset2(d["log_epoch"], i, posc, jtake(d["currentEpoch"], i)),
            log_cfgid=jset2(d["log_cfgid"], i, posc, cid),
            log_who=jset2(d["log_who"], i, posc, (r + 1).expand(C, n)),
            log_members=jset2(d["log_members"], i, posc, new_members),
            log_len=jset(d["log_len"], i, new_len),
            cfg_id=jset(d["cfg_id"], i, cid),
            cfg_members=jset(d["cfg_members"], i, new_members),
            cfg_committed=jset(d["cfg_committed"], i,
                               (jtake(d["highWatermark"], i) >= new_len).to(torch.int32)),
            role=jset(d["role"], i, torch.where(i == r, R_OBSERVER, jtake(d["role"], i))),
            removeCtr=d["removeCtr"] + 1,
        )
        return valid, succ, self._rank(C, n, KR_HANDLE_REMOVE, dev), ovf

    # -------- fused message-receipt kernel (all M slots at once) --------
    # The thirteen receipt disjuncts of Next are mutually exclusive for a
    # record (they partition on mtype, then on the error, the fetch
    # position, mresult and the join checks), so each field takes the value
    # of whichever branch fired, and the seven that reply share one put of
    # the branch's response into the bag whose slot m was discarded.

    def _handle_message(self, d, C, dev):
        p, packer, NS, L, V, M = (self.p, self.packer, self.NS, self.p.max_log,
                                  self.p.n_values, self.p.msg_slots)
        m = self._idx("iota_m", dev)
        words, cnt = self._words(d), d["msg_cnt"]  # [C, 1, M]
        key = [w[:, 0] for w in words]  # slot m = binding m

        def u(name):
            return packer.unpack(key, name)

        mtype, mepoch, src, dst = u("mtype"), u("mepoch"), u("msource"), u("mdest")
        tk = lambda name: jtake(d[name], dst)  # noqa: E731 - dst's lane of a field
        cur, st_dst, led_dst, role_dst = tk("currentEpoch"), tk("state"), tk("leader"), tk("role")
        hwm_old, ll_dst = tk("highWatermark"), tk("log_len")
        rows = {f: tk(f"log_{f}") for f in ENTRY_FIELDS}  # dst's log rows [C, M, L]
        one = torch.ones_like(src)
        # ReceivableMessage (:471-477): a count > 0 and a live destination
        recv = (key[0] != EMPTY) & (cnt[:, 0] > 0) & (tk("used") > 0) & (st_dst != DEAD)
        equal_epoch = mepoch == cur
        cnt_disc = bag.bag_discard_at(cnt, m)
        lanes = self._lanes(dev)
        used_mask = self._used_mask(d)  # [C, 1]
        mres, mhwm = u("mresult"), u("mhwm")
        branches = []  # (fired [C, M], field updates, rank, ovf)

        # --- HandleRequestVoteRequest (:967-1018)
        b_rvreq = recv & (mtype == RVREQ)
        rv_err = mepoch < cur  # FencedLeaderEpoch
        up = mepoch > cur
        s0_st, s0_ep = torch.where(up, UNATTACHED, st_dst), torch.where(up, mepoch, cur)
        s0_ld = torch.where(up, NIL, led_dst)
        last_ep = torch.where(ll_dst > 0, _at(rows["epoch"], ll_dst - 1), 0)
        mlle = u("mlastLogEpoch")
        log_ok = (mlle > last_ep) | ((mlle == last_ep) & (u("mlastLogOffset") >= ll_dst))
        grant = ((s0_st == UNATTACHED) | ((s0_st == VOTED) & (tk("votedFor") == src + 1))) & log_ok
        # TransitionToVoted (:630-637) when granting from Unattached
        take_voted = grant & (s0_st == UNATTACHED)
        f_st = torch.where(take_voted, VOTED, s0_st)
        f_ep = torch.where(take_voted, mepoch, s0_ep)
        f_ld = torch.where(take_voted, NIL, s0_ld)
        rv_key = self._pack(
            mtype=RVRESP, mepoch=torch.where(rv_err, cur, mepoch),
            mleader=torch.where(rv_err, led_dst, f_ld),
            mvoteGranted=torch.where(rv_err, 0, grant.to(torch.int32)),
            merror=torch.where(rv_err, E_FENCED, E_NONE), msource=dst, mdest=src)
        no_err = ~rv_err
        upd = {f: _sel(no_err, jset(d[f], dst, v), d[f])
               for f, v in (("state", f_st), ("currentEpoch", f_ep), ("leader", f_ld))}
        upd["votedFor"] = _sel(no_err & grant, jset(d["votedFor"], dst, src + 1), d["votedFor"])
        self._clear_pf(d, dst, upd, no_err & (f_st != st_dst))
        rv_upd = upd

        # --- HandleRequestVoteResponse (:1025-1050; the Voter gate added)
        mh_st, mh_ep, mh_ld, handled = self._mhcr(d, dst, u("mleader"), mepoch, u("merror"))
        b_rvresp = (recv & (mtype == RVRESP) & (role_dst == R_VOTER)
                    & (handled | (st_dst == CANDIDATE)))
        upd = {f: _sel(handled, jset(d[f], dst, v), d[f])
               for f, v in (("state", mh_st), ("currentEpoch", mh_ep), ("leader", mh_ld))}
        vgs = d["votesGranted"]
        upd["votesGranted"] = _sel((u("mvoteGranted") > 0) & ~handled,
                                   jset(vgs, dst, tk("votesGranted") | (one << src)), vgs)
        branches.append((b_rvresp, upd, KR_HANDLE_RVRESP, None))

        # --- AcceptBeginQuorumRequest (:1082-1102): Voter only; a stale
        # request is not answered
        b_bqreq = recv & (mtype == BQREQ) & (mepoch >= cur) & (role_dst == R_VOTER)
        bt = self._maybe_transition(d, dst, src + 1, mepoch)
        upd = {f: jset(d[f], dst, v) for f, v in zip(("state", "currentEpoch", "leader"), bt)}
        branches.append((b_bqreq, self._clear_pf(d, dst, upd), KR_ACCEPT_BQREQ, None))

        # --- the FetchRequest branches (:1195-1376)
        is_fetchreq = recv & (mtype == FETCHREQ)
        is_leader = st_dst == LEADER
        foff, flep, fobs = u("mfetchOffset"), u("mlastFetchedEpoch"), u("mobserver")
        corr_kw = dict(mtype=FETCHRESP, mepoch=cur, msource=dst, mdest=src, cepoch=mepoch,
                       cfetchOffset=foff, clastFetchedEpoch=flep, cobserver=fobs)
        ferr = torch.where(~is_leader, E_NOTLEADER, torch.where(
            mepoch < cur, E_FENCED, torch.where(mepoch > cur, E_UNKNOWN_LEADER, E_NONE)))
        eo_off, eo_ep = self._end_offset_for_epoch(rows["epoch"], ll_dst, flep)
        valid_pos = ((foff == 0) & (flep == 0)) | ((foff <= eo_off) & (flep == eo_ep))
        # RejectFetchRequest (:1195-1217)
        b_reject = is_fetchreq & (ferr != E_NONE)
        rj_key = self._pack(mresult=R_NOTOK, merror=ferr, mleader=led_dst, mhwm=hwm_old,
                            **corr_kw)
        # DivergingFetchRequest (:1225-1248)
        b_div = is_fetchreq & equal_epoch & is_leader & ~valid_pos
        dv_key = self._pack(mresult=R_DIVERGING, merror=E_NONE, mdivergingEpoch=eo_ep,
                            mdivergingEndOffset=eo_off, mleader=led_dst, mhwm=hwm_old, **corr_kw)
        # the accept branches' entry lookup
        offset = foff + 1
        have_entry = offset <= ll_dst
        ent = {f: torch.where(have_entry, _at(rows[f], offset - 1), 0) for f in ENTRY_FIELDS}
        ent_kw = dict(nentries=have_entry.to(torch.int32),
                      **{f"e_{f}": ent[f] for f in ENTRY_FIELDS})
        # AcceptFetchRequestFromVoter (:1286-1342)
        b_acc_v = is_fetchreq & equal_epoch & is_leader & valid_pos & (fobs == 0)
        new_end = _set_last(tk("endOffset"), src, foff)  # [C, M, NS]
        members = tk("cfg_members")
        msize = self._popcount(members)
        # NewHighwaterMark (:1266-1284): the leader counts itself even when
        # removed from its config
        idxs = torch.arange(1, L + 1, device=dev)
        slots = torch.arange(NS, device=dev)
        mem_bits = _bit(members.unsqueeze(-1), slots)  # [C, M, NS]
        is_self = slots == dst.unsqueeze(-1)
        agree = mem_bits.unsqueeze(-2) & (
            (new_end.unsqueeze(-2) >= idxs[:, None]) | is_self.unsqueeze(-2))  # [C, M, L, NS]
        quorum_ok = 2 * agree.sum(-1) > msize.unsqueeze(-1)
        best = torch.where(quorum_ok & (idxs <= ll_dst.unsqueeze(-1)), idxs, 0).max(-1).values
        ep_at = _at(rows["epoch"], best - 1)
        new_hwm = torch.where((best > 0) & (ep_at == cur), best, hwm_old)
        advanced = new_hwm > hwm_old
        # IsRemovedFromCluster (:1259-1264) over (hwm_old, new_hwm]
        in_range = ((lanes + 1 > hwm_old.unsqueeze(-1)) & (lanes + 1 <= new_hwm.unsqueeze(-1)))
        leaves = advanced & torch.any(
            in_range & (rows["cmd"] == C_REMOVE) & ~_bit(rows["members"], dst.unsqueeze(-1)),
            dim=-1)
        cfg_off = self._most_recent_reconfig(rows["cmd"], ll_dst)
        # acked: in-flight values committed in (hwm_old, new_hwm] (:1331-1338)
        committed = torch.any(
            in_range.unsqueeze(-2) & (rows["cmd"] == C_APPEND).unsqueeze(-2)
            & (rows["val"].unsqueeze(-2) == torch.arange(1, V + 1, device=dev)[:, None]),
            dim=-1)  # [C, M, V]
        acked = d["acked"]
        upd = dict(acked=torch.where(
            advanced.unsqueeze(-1) & (acked == ACK_FALSE) & committed, ACK_TRUE, acked))
        for f, v in (("cfg_id", _at(rows["cfgid"], cfg_off - 1)),
                     ("cfg_members", _at(rows["members"], cfg_off - 1)),
                     ("cfg_committed", (new_hwm >= cfg_off).to(torch.int32))):
            upd[f] = _sel(advanced, jset(d[f], dst, v), d[f])
        for f, v in (("role", R_OBSERVER), ("state", UNATTACHED), ("leader", NIL),
                     ("votesGranted", 0)):
            upd[f] = _sel(leaves, jset(d[f], dst, v), d[f])
        upd["eo_dom"] = jset(d["eo_dom"], dst, torch.where(
            leaves, used_mask, tk("eo_dom") | (one << src)))
        upd["endOffset"] = jset(d["endOffset"], dst, torch.where(
            leaves.unsqueeze(-1), 0, new_end))
        upd["highWatermark"] = _sel(leaves, jset(d["highWatermark"], dst, 0), _sel(
            advanced, jset(d["highWatermark"], dst, new_hwm), d["highWatermark"]))
        acc_v_upd = upd
        av_key = self._pack(mleader=torch.where(leaves, NIL, led_dst), mresult=R_OK,
                            merror=E_NONE, mhwm=torch.minimum(new_hwm, offset), **ent_kw,
                            **corr_kw)
        # AcceptFetchRequestFromObserver (:1349-1376): the response only
        b_acc_o = is_fetchreq & equal_epoch & is_leader & valid_pos & (fobs == 1)
        ao_key = self._pack(mleader=led_dst, mresult=R_OK, merror=E_NONE,
                            mhwm=torch.minimum(offset, hwm_old), **ent_kw, **corr_kw)

        # --- the FetchResponse branches (:1383-1483): the correlation match
        # pendingFetch[dst] = m.correlation (:1390), the request's msource
        # dst (implied) and its mdest the responder src
        is_fresp = recv & (mtype == FETCHRESP)
        corr = ((tk("pf_active") > 0) & (tk("pf_epoch") == u("cepoch"))
                & (tk("pf_offset") == u("cfetchOffset"))
                & (tk("pf_lastepoch") == u("clastFetchedEpoch"))
                & (tk("pf_observer") == u("cobserver")) & (tk("pf_dest") == src + 1))

        def maybe_switch(upd, new_rows, new_len, cfg_off):
            """MaybeSwitchConfigurations (:753-771) on row dst: the config
            from the log's most recent reconfig entry, the Voter <-> Observer
            flip on a membership change, endOffset's domain padded to all
            servers; leader and the default state from MaybeHandleCommonResponse."""
            cm = _at(new_rows["members"], cfg_off - 1)
            member = _bit(cm, dst)
            demote = (role_dst == R_VOTER) & ~member
            promote = (role_dst == R_OBSERVER) & member
            vals = dict(
                leader=mh_ld, cfg_id=_at(new_rows["cfgid"], cfg_off - 1), cfg_members=cm,
                cfg_committed=(mhwm >= cfg_off).to(torch.int32),
                role=torch.where(demote, R_OBSERVER, torch.where(promote, R_VOTER, role_dst)),
                state=torch.where(demote | promote, FOLLOWER, mh_st),
                eo_dom=tk("eo_dom") | used_mask, log_len=new_len,
                **{f"log_{f}": new_rows[f] for f in ENTRY_FIELDS})
            for f, v in vals.items():
                upd[f] = jset(d[f], dst, v)
            return self._clear_pf(d, dst, upd)

        # HandleSuccessFetchResponse (:1383-1409); a log at max_log overflows
        b_ok = is_fresp & ~handled & corr & (mres == R_OK)
        app = u("nentries") > 0
        ok_ovf = b_ok & app & (ll_dst >= L)
        apos = torch.clamp(ll_dst, 0, L - 1)
        nl = {f: torch.where(app.unsqueeze(-1), _set_last(rows[f], apos, u(f"e_{f}")), rows[f])
              for f in ENTRY_FIELDS}
        nl_len = ll_dst + app.to(torch.int32)
        ok_cfg_off = self._most_recent_reconfig(nl["cmd"], nl_len)
        b_ok = b_ok & (ok_cfg_off > 0)
        ok_upd = maybe_switch({}, nl, nl_len, ok_cfg_off)
        ok_upd["highWatermark"] = jset(d["highWatermark"], dst, mhwm)
        # HandleDivergingFetchResponse (:1419-1445): truncate, refresh the
        # config from the truncated log; the hwm is not updated
        b_divr = is_fresp & ~handled & corr & (mres == R_DIVERGING)
        hco = self._highest_common_offset(rows["epoch"], ll_dst, u("mdivergingEndOffset"),
                                          u("mdivergingEpoch"))
        keep = (lanes < hco.unsqueeze(-1))
        tl = {f: torch.where(keep, rows[f], 0) for f in ENTRY_FIELDS}
        dv_cfg_off = self._most_recent_reconfig(tl["cmd"], hco)
        b_divr = b_divr & (dv_cfg_off > 0)
        divr_upd = maybe_switch({}, tl, hco, dv_cfg_off)
        # HandleNonSuccessFetchResponse (:1459-1483)
        b_err = is_fresp & handled & corr
        upd = {f: jset(d[f], dst, v)
               for f, v in (("state", mh_st), ("currentEpoch", mh_ep), ("leader", mh_ld))}
        upd["role"] = _sel(u("merror") == E_UNKNOWN_MEMBER, jset(d["role"], dst, R_OBSERVER),
                           d["role"])
        err_upd = self._clear_pf(d, dst, upd)

        # --- the Join flow (:1524-1674); JoinCheck (:1551-1556)
        is_joinreq = recv & (mtype == JOINREQ)
        jc_notleader = st_dst != LEADER
        jc_already = _bit(members, src)
        jc_ok = (~jc_notleader & ~jc_already & (tk("cfg_committed") != 0)
                 & self._leader_committed_in_epoch(d, dst))
        # AcceptJoinRequest (:1558-1590)
        b_jacc = is_joinreq & (msize < p.max_cluster_size) & jc_ok
        ja_ovf = b_jacc & (ll_dst >= L)
        posc = torch.clamp(ll_dst, 0, L - 1)
        add_members = members | (one << src)
        cid = tk("cfg_id") + 1
        jacc_upd = dict(
            log_cmd=jset2(d["log_cmd"], dst, posc, C_ADD),
            log_epoch=jset2(d["log_epoch"], dst, posc, cur),
            log_cfgid=jset2(d["log_cfgid"], dst, posc, cid),
            log_who=jset2(d["log_who"], dst, posc, src + 1),
            log_members=jset2(d["log_members"], dst, posc, add_members),
            log_len=jset(d["log_len"], dst, ll_dst + 1),
            cfg_id=jset(d["cfg_id"], dst, cid),
            cfg_members=jset(d["cfg_members"], dst, add_members),
            cfg_committed=jset(d["cfg_committed"], dst, (hwm_old >= ll_dst + 1).to(torch.int32)),
            eo_dom=jset(d["eo_dom"], dst, tk("eo_dom") | (one << src)),
        )
        ja_key = self._pack(mtype=JOINRESP, mepoch=cur, mleader=led_dst, mresult=R_OK,
                            merror=E_NONE, mdest=src, msource=dst)
        # RejectJoinRequest (:1605-1623): only NotLeader/AlreadyMember are
        # answered
        b_jrej = is_joinreq & (jc_notleader | jc_already)
        jr_key = self._pack(mtype=JOINRESP, mepoch=cur, mleader=led_dst, mresult=R_NOTOK,
                            merror=torch.where(jc_notleader, E_NOTLEADER, E_ALREADY_MEMBER),
                            mdest=src, msource=dst)
        # HandleRejectJoinResponse (:1643-1674): only the Discard arm
        b_jrr = recv & (mtype == JOINRESP) & (role_dst == R_OBSERVER) & (mres == R_NOTOK)

        # --- the shared Reply: the branch's response put once into the bag
        # whose slot m was discarded (a discard changes only a count, so the
        # put's existed and overflow read the same bag); the four
        # FetchResponse replies are disabled by their response already in
        # the bag (MessagePassing.tla:72-79)
        reply = [(b_rvreq, rv_key), (b_reject, rj_key), (b_div, dv_key), (b_acc_v, av_key),
                 (b_acc_o, ao_key), (b_jacc, ja_key), (b_jrej, jr_key)]
        pick = list(reply[-1][1])
        for b, k in reversed(reply[:-1]):
            pick = [torch.where(b, a, c) for a, c in zip(k, pick)]
        pw, pcnt, ex, povf = bag.wide_bag_put(words, cnt_disc, pick)
        b_reject, b_div, b_acc_v, b_acc_o = (b & ~ex for b in (b_reject, b_div, b_acc_v, b_acc_o))
        putb = b_rvreq | b_reject | b_div | b_acc_v | b_acc_o | b_jacc | b_jrej
        dropb = b_rvresp | b_bqreq | b_ok | b_divr | b_err | b_jrr

        branches += [
            (b_rvreq, rv_upd, KR_HANDLE_RVREQ, povf),
            (b_reject, {}, KR_REJECT_FETCH, povf),
            (b_div, {}, KR_DIVERGING_FETCH, povf),
            (b_acc_v, acc_v_upd, KR_ACCEPT_FETCH_VOTER, povf),
            (b_acc_o, {}, KR_ACCEPT_FETCH_OBSERVER, povf),
            (b_ok, ok_upd, KR_HANDLE_FETCH_OK, ok_ovf),
            (b_divr, divr_upd, KR_HANDLE_FETCH_DIV, None),
            (b_err, err_upd, KR_HANDLE_FETCH_NONSUCCESS, None),
            (b_jacc, jacc_upd, KR_ACCEPT_JOIN, ja_ovf | povf),
            (b_jrej, {}, KR_REJECT_JOIN, povf),
            (b_jrr, {}, KR_HANDLE_REJECT_JOIN, None),
        ]
        out = {}
        for b, upd, _rk, _o in branches:
            for f, v in upd.items():
                out[f] = _sel(b, v, out.get(f, d[f]))
        for k, w in enumerate(words):
            out[f"msg_w{k}"] = _sel(putb, pw[k], w)
        out["msg_cnt"] = _sel(putb, pcnt, _sel(dropb, cnt_disc, cnt))
        succ = self._asm(d, C, M, **out)
        valid = torch.zeros_like(b_rvreq)
        rank = self._full(C, M, -1, torch.int32, dev)
        ovf = torch.zeros_like(b_rvreq)
        for b, _upd, rk, ob in branches:
            valid = valid | b
            rank = torch.where(b, rk, rank)
            if ob is not None:
                ovf = ovf | (b & ob)
        return valid, succ, rank, ovf

    # ---------------- full expansion ----------------

    def expand(self, states: torch.Tensor):
        """All successor candidates of a [C, W] int32 state batch, in the
        bindings' order: (succs [C, A, W] int32, valid [C, A] bool, rank
        [C, A] int32, ovf [C, A] bool) — ``jax.vmap(_expand1)`` of the
        reference (``raft_tpu/models/kraft_reconfig.py:1446``)."""
        C = states.shape[0]
        dev = states.device
        d = self._dec(states)
        I = lambda name: self._idx(name, dev)  # noqa: E731
        outs = [
            self._restart_with_state(d, I("iota_s"), C, dev),
            self._request_vote(d, I("iota_s"), C, dev),
            self._become_leader(d, I("iota_s"), C, dev),
            self._client_request(d, I("cr_i"), I("cr_v"), C, dev),
            self._send_fetch_request(d, I("pr_i"), I("pr_j"), C, dev),
            self._start_new_server(d, I("sn_h"), I("sn_j"), C, dev),
            self._send_join_request(d, I("pr_i"), I("pr_j"), C, dev),
            self._handle_remove_request(d, I("rm_i"), I("rm_r"), C, dev),
            self._handle_message(d, C, dev),
        ]
        valid = torch.cat([o[0] for o in outs], dim=1)
        succs = torch.cat([o[1] for o in outs], dim=1)
        rank = torch.cat([o[2].to(torch.int32) for o in outs], dim=1)
        ovf = torch.cat([o[3] for o in outs], dim=1)
        return succs, valid, rank, ovf

    # ---------------- the kernels' spec ----------------

    def _spec_vector(self) -> list[int]:
        """The int32 spec vector of csrc/kreconfig_actions.cuh
        (SPEC_SCALARS, then (word, shift, mask) of each of MSG_FIELDS)."""
        p, lay = self.p, self.layout
        if self.NS > MAX_SLOTS or p.max_log > MAX_LOG or self.n_words > MAX_WORDS:
            raise NotImplementedError(
                f"the kernels take at most {MAX_SLOTS} slots, {MAX_LOG} log entries and "
                f"{MAX_WORDS}-word keys (got {self.NS}, {p.max_log}, {self.n_words})")
        vals = dict(S=self.NS, V=p.n_values, L=p.max_log, M=p.msg_slots, W=lay.W, A=self.A,
                    K=len(ACTION_NAMES), NW=self.n_words, VL=lay.view_len,
                    **{n: lay.fields[n].offset for n in SPEC_OFFSETS},
                    **{n: getattr(p, n) for n in SPEC_PARAMS})
        spec = [int(vals[n]) for n in SPEC_SCALARS]
        for name in MSG_FIELDS:
            spec += list(self.packer.locate(name))
        assert len(spec) == SPEC_LEN
        return spec

    # ---------------- initial states ----------------

    def init_states(self) -> np.ndarray:
        """Init — :845-859: the pre-installed cluster of the first
        InitClusterSize hosts (identities (h, 0) in slot h), leader the
        lowest identity, one committed InitClusterCommand entry."""
        p, lay, NS, ics = self.p, self.layout, self.NS, self.p.init_cluster_size
        vec = lay.zeros((1,))
        mask = (1 << ics) - 1
        per = {n: np.zeros(NS, np.int32) for n in (
            "host", "used", "role", "state", "currentEpoch", "leader", "cfg_id", "cfg_members",
            "cfg_committed", "eo_dom", "highWatermark", "log_len")}
        logs = {n: np.zeros((NS, p.max_log), np.int32) for n in ("cmd", "epoch", "cfgid",
                                                                 "members")}
        eo = np.zeros((NS, NS), np.int32)
        for h in range(ics):
            for n, v in (("host", h), ("used", 1), ("role", R_VOTER),
                         ("state", LEADER if h == 0 else FOLLOWER), ("currentEpoch", 1),
                         ("leader", 1), ("cfg_id", 1), ("cfg_members", mask),
                         ("cfg_committed", 1), ("eo_dom", mask), ("highWatermark", 1),
                         ("log_len", 1)):
                per[n][h] = v
            for n, v in (("cmd", C_INIT), ("epoch", 1), ("cfgid", 1), ("members", mask)):
                logs[n][h, 0] = v
            eo[h, :ics] = 1
        for n, v in per.items():
            vec[0, lay.sl(n)] = v
        for n, v in logs.items():
            vec[0, lay.sl(f"log_{n}")] = v.reshape(-1)
        vec[0, lay.sl("endOffset")] = eo.reshape(-1)
        for k in range(self.n_words):
            vec[0, lay.sl(f"msg_w{k}")] = EMPTY
        return vec

    # ---------------- invariants (:1848-1912) ----------------

    def _inv_no_illegal(self, states):
        """NoIllegalState — :1848-1850."""
        return torch.all(self.layout.get(states, "state") != ILLEGAL, dim=1)

    def _inv_no_log_divergence(self, states):
        """NoLogDivergence — :1860-1868: committed prefixes (to the
        pairwise-min hwm) agree on whole entries."""
        lay = self.layout
        used = lay.get(states, "used") > 0
        hwm = lay.get(states, "highWatermark")
        mh = torch.minimum(hwm[:, :, None], hwm[:, None, :])
        in_common = torch.arange(1, self.p.max_log + 1, device=states.device) <= mh[..., None]
        eq = torch.ones_like(in_common)
        for f in ENTRY_FIELDS:
            v = lay.get(states, f"log_{f}")
            eq = eq & (v[:, :, None, :] == v[:, None, :, :])
        both = used[:, :, None] & used[:, None, :]
        return torch.all((~(both[..., None] & in_common) | eq).flatten(1), dim=1)

    def _inv_states_match_roles(self, states):
        """StatesMatchRoles — :1876-1881."""
        lay = self.layout
        used = lay.get(states, "used") > 0
        role, st, led = (lay.get(states, n) for n in ("role", "state", "leader"))
        obs_ok = (st == LEADER) | (st == FOLLOWER) | (st == UNATTACHED) | (st == VOTED)
        bad = used & (((role == R_OBSERVER) & ~obs_ok) | ((st == UNATTACHED) & (led != NIL)))
        return ~torch.any(bad, dim=1)

    def _inv_never_two_leaders(self, states):
        """NeverTwoLeadersInSameEpoch — :1886-1892."""
        lay = self.layout
        used = lay.get(states, "used") > 0
        led, ep = lay.get(states, "leader"), lay.get(states, "currentEpoch")
        both = (used[:, :, None] & used[:, None, :] & (led[:, :, None] != NIL)
                & (led[:, None, :] != NIL))
        conflict = both & (led[:, :, None] != led[:, None, :]) & (ep[:, :, None] == ep[:, None, :])
        return ~conflict.flatten(1).any(dim=1)

    def _inv_leader_has_acked(self, states):
        """LeaderHasAllAckedValues — :1896-1912 (AppendCommand entries)."""
        lay, V = self.layout, self.p.n_values
        used = lay.get(states, "used") > 0
        ep, st = lay.get(states, "currentEpoch"), lay.get(states, "state")
        cmd, lv, acked = lay.get(states, "log_cmd"), lay.get(states, "log_val"), lay.get(
            states, "acked")
        higher = used[:, None, :] & (ep[:, None, :] > ep[:, :, None])
        is_lead = used & (st == LEADER) & ~torch.any(higher, dim=2)
        vals = torch.arange(1, V + 1, device=states.device)
        has_v = torch.any((cmd[:, :, None, :] == C_APPEND)
                          & (lv[:, :, None, :] == vals[None, None, :, None]), dim=3)
        bad = (acked[:, None, :] == ACK_TRUE) & is_lead[:, :, None] & ~has_v
        return ~bad.flatten(1).any(dim=1)

    # ---------------- temporal-property predicates (:1775-1839) ----------------

    def _live_all_or_nothing(self, states, committed, in_log):
        """The shared tail of CommittedValueOrNothing / ConfigAllOrNothing
        (:1804-1808, :1829-1834): NoProgressPossible (:1775-1781, which
        reduces to electionCtr = MaxElections: its \\E j conjunct compares a
        state to the role Voter), or a current leader (:1787-1792) whose
        whole member set has the thing committed or lacks it entirely."""
        lay, NS = self.layout, self.NS
        used = lay.get(states, "used") > 0
        st, ep = lay.get(states, "state"), lay.get(states, "currentEpoch")
        higher = torch.any(used[:, None, :] & (ep[:, None, :] > ep[:, :, None]), dim=2)
        icl = used & (st == LEADER) & ~higher
        member = _bit(lay.get(states, "cfg_members")[:, :, None],
                      torch.arange(NS, device=states.device))  # [B, l, i]
        all_committed = torch.all(~member | committed[:, None, :], dim=2)
        all_absent = torch.all(~member | ~in_log[:, None, :], dim=2)
        ok = torch.any(icl & (all_committed | all_absent), dim=1)
        return (lay.get(states, "electionCtr") == self.p.max_elections) | ok

    def _live_committed_value_or_nothing(self, v, states):
        """CommittedValueOrNothing(v) — :1794-1808."""
        lay = self.layout
        lanes = torch.arange(self.p.max_log, device=states.device)
        ll, hwm = lay.get(states, "log_len"), lay.get(states, "highWatermark")
        has = ((lanes < ll[..., None]) & (lay.get(states, "log_cmd") == C_APPEND)
               & (lay.get(states, "log_val") == v + 1))
        committed = torch.any(has & (hwm[..., None] >= lanes + 1), dim=2)
        return self._live_all_or_nothing(states, committed, torch.any(has, dim=2))

    def _live_config_all_or_nothing(self, cid, states):
        """ConfigAllOrNothing(config_id) — :1817-1834."""
        lay = self.layout
        lanes = torch.arange(self.p.max_log, device=states.device)
        ll, hwm, cmd = (lay.get(states, n) for n in ("log_len", "highWatermark", "log_cmd"))
        is_cfg = (((cmd == C_INIT) | (cmd == C_ADD) | (cmd == C_REMOVE))
                  & (lanes < ll[..., None]) & (lay.get(states, "log_cfgid") == cid))
        committed = torch.any(is_cfg & (hwm[..., None] >= lanes + 1), dim=2)
        return self._live_all_or_nothing(states, committed, torch.any(is_cfg, dim=2))

    # ---------------- host-side decode/encode ----------------
    # Initial identity (h, 0) <-> slot h; spawned (h, d) <-> slot ics + d - 1.

    def decode(self, vec: np.ndarray) -> dict:
        """One packed state in the reference oracle's dict form
        (identity-keyed maps, entry tuples, a frozenset message bag)."""
        lay, p, NS, L = self.layout, self.p, self.NS, self.p.max_log
        vec = np.asarray(vec)
        g = lambda n: np.asarray(vec[lay.sl(n)])  # noqa: E731
        slots = [i for i in range(NS) if g("used")[i]]
        ids = {i: (int(g("host")[i]), int(g("diskId")[i])) for i in slots}

        def ref(v):  # slot + 1 -> identity | None
            return None if v == 0 else ids[int(v) - 1]

        def mask_set(mask):
            return frozenset(ids[i] for i in slots if (int(mask) >> i) & 1)

        lt = {f: g(f"log_{f}").reshape(NS, L) for f in ENTRY_FIELDS}

        def entry(i, k):
            cmd, ep = int(lt["cmd"][i, k]), int(lt["epoch"][i, k])
            if cmd == C_APPEND:
                return (CMD_NAMES[C_APPEND], ep, int(lt["val"][i, k]) - 1)
            members, cid = mask_set(lt["members"][i, k]), int(lt["cfgid"][i, k])
            if cmd == C_INIT:
                return (CMD_NAMES[C_INIT], ep, (cid, members))
            return (CMD_NAMES[cmd], ep, (cid, ids[int(lt["who"][i, k]) - 1], members))

        pf = {f: g(f) for f in PF_FIELDS}

        def pending(i):
            if not pf["pf_active"][i]:
                return None
            return rec(mtype="FetchRequest", mepoch=int(pf["pf_epoch"][i]),
                       mfetchOffset=int(pf["pf_offset"][i]),
                       mlastFetchedEpoch=int(pf["pf_lastepoch"][i]),
                       mobserver=bool(pf["pf_observer"][i]), msource=ids[i],
                       mdest=ref(pf["pf_dest"][i]))

        eo, eo_dom = g("endOffset").reshape(NS, NS), g("eo_dom")
        words = [g(f"msg_w{k}") for k in range(self.n_words)]
        cnts = g("msg_cnt")
        msgs = {}
        for k in range(p.msg_slots):
            if int(words[0][k]) != EMPTY:
                msgs[self.decode_msg(tuple(int(w[k]) for w in words), ids)] = int(cnts[k])
        scalar = lambda n: int(vec[lay.fields[n].offset])  # noqa: E731
        per = lambda n, fn=int: {ids[i]: fn(g(n)[i]) for i in slots}  # noqa: E731
        return {
            "servers": frozenset(ids.values()),
            "config": {ids[i]: (int(g("cfg_id")[i]), mask_set(g("cfg_members")[i]),
                                bool(g("cfg_committed")[i])) for i in slots},
            "currentEpoch": per("currentEpoch"),
            "role": per("role", lambda x: ROLE_NAMES[int(x)]),
            "state": per("state", lambda x: STATE_NAMES[int(x)]),
            "leader": per("leader", ref),
            "votedFor": per("votedFor", ref),
            "pendingFetch": {ids[i]: pending(i) for i in slots},
            "votesGranted": per("votesGranted", mask_set),
            "endOffset": {ids[i]: {ids[j]: int(eo[i, j]) for j in slots
                                   if (int(eo_dom[i]) >> j) & 1} for i in slots},
            "log": {ids[i]: tuple(entry(i, k) for k in range(int(g("log_len")[i])))
                    for i in slots},
            "highWatermark": per("highWatermark"),
            "messages": frozenset(msgs.items()),
            "_acked": tuple({ACK_NIL: None, ACK_FALSE: False, ACK_TRUE: True}[int(a)]
                            for a in g("acked")),
            "_electionCtr": scalar("electionCtr"),
            "_valueCtr": tuple(int(x) for x in g("valueCtr")),
            "_restartCtr": scalar("restartCtr"),
            "_addReconfigCtr": 0,  # never incremented (:1526)
            "_removeReconfigCtr": scalar("removeCtr"),
            "_diskIdGen": scalar("diskIdGen"),
        }

    def decode_msg(self, key: tuple, ids: dict) -> tuple:
        """Packed key -> the oracle's record tuple (``ids``: slot -> identity)."""
        u = self.packer.unpack_all(key)
        mtype = int(u["mtype"])
        src, dst = ids[int(u["msource"])], ids[int(u["mdest"])]
        kw = dict(mtype=MTYPE_NAMES[mtype], mepoch=int(u["mepoch"]), msource=src, mdest=dst)
        mlead = None if not u["mleader"] else ids[int(u["mleader"]) - 1]
        if mtype == RVREQ:
            kw.update(mlastLogEpoch=int(u["mlastLogEpoch"]),
                      mlastLogOffset=int(u["mlastLogOffset"]))
        elif mtype == RVRESP:
            kw.update(mleader=mlead, mvoteGranted=bool(u["mvoteGranted"]),
                      merror=ERROR_NAMES[int(u["merror"])])
        elif mtype == FETCHREQ:
            kw.update(mfetchOffset=int(u["mfetchOffset"]),
                      mlastFetchedEpoch=int(u["mlastFetchedEpoch"]),
                      mobserver=bool(u["mobserver"]))
        elif mtype == JOINRESP:
            kw.update(mleader=mlead, mresult=RESULT_NAMES[int(u["mresult"])],
                      merror=ERROR_NAMES[int(u["merror"])])
        elif mtype == FETCHRESP:
            res = int(u["mresult"])
            kw.update(mresult=RESULT_NAMES[res], merror=ERROR_NAMES[int(u["merror"])],
                      mleader=mlead, mhwm=int(u["mhwm"]))
            if res == R_OK:
                kw["mentries"] = ()
                if int(u["nentries"]):
                    cmd, ep = int(u["e_cmd"]), int(u["e_epoch"])
                    if cmd == C_APPEND:
                        ent = (CMD_NAMES[C_APPEND], ep, int(u["e_val"]) - 1)
                    else:
                        members = frozenset(ids[i] for i in ids if (int(u["e_members"]) >> i) & 1)
                        cid = int(u["e_cfgid"])
                        ent = ((CMD_NAMES[C_INIT], ep, (cid, members)) if cmd == C_INIT else
                               (CMD_NAMES[cmd], ep, (cid, ids[int(u["e_who"]) - 1], members)))
                    kw["mentries"] = (ent,)
            if res == R_DIVERGING:
                kw.update(mdivergingEpoch=int(u["mdivergingEpoch"]),
                          mdivergingEndOffset=int(u["mdivergingEndOffset"]))
            kw["correlation"] = rec(
                mtype="FetchRequest", mepoch=int(u["cepoch"]), mfetchOffset=int(u["cfetchOffset"]),
                mlastFetchedEpoch=int(u["clastFetchedEpoch"]), mobserver=bool(u["cobserver"]),
                msource=dst, mdest=src)
        return rec(**kw)

    def _ident_slot(self, ident: tuple[int, int]) -> int:
        h, dk = ident
        if dk == 0:
            assert h < self.p.init_cluster_size, ident
            return h
        return self.p.init_cluster_size + dk - 1

    def encode_msg(self, m: tuple, slot_of: dict) -> tuple:
        d = dict(m)
        inv = lambda names: {v: k for k, v in names.items()}  # noqa: E731
        inv_err, inv_res = inv(ERROR_NAMES), inv(RESULT_NAMES)
        mtype = inv(MTYPE_NAMES)[d["mtype"]]
        kw = dict(mtype=mtype, mepoch=d["mepoch"], msource=slot_of[d["msource"]],
                  mdest=slot_of[d["mdest"]])
        lead = lambda: 0 if d["mleader"] is None else slot_of[d["mleader"]] + 1  # noqa: E731
        if mtype == RVREQ:
            kw.update(mlastLogEpoch=d["mlastLogEpoch"], mlastLogOffset=d["mlastLogOffset"])
        elif mtype == RVRESP:
            kw.update(mleader=lead(), mvoteGranted=int(d["mvoteGranted"]),
                      merror=inv_err[d["merror"]])
        elif mtype == FETCHREQ:
            kw.update(mfetchOffset=d["mfetchOffset"], mlastFetchedEpoch=d["mlastFetchedEpoch"],
                      mobserver=int(d["mobserver"]))
        elif mtype == JOINRESP:
            kw.update(mleader=lead(), mresult=inv_res[d["mresult"]], merror=inv_err[d["merror"]])
        elif mtype == FETCHRESP:
            corr = dict(d["correlation"])
            kw.update(mresult=inv_res[d["mresult"]], merror=inv_err[d["merror"]],
                      mleader=lead(), mhwm=d["mhwm"], cepoch=corr["mepoch"],
                      cfetchOffset=corr["mfetchOffset"],
                      clastFetchedEpoch=corr["mlastFetchedEpoch"],
                      cobserver=int(corr["mobserver"]))
            if d["mresult"] == "Ok" and d.get("mentries"):
                cmd_name, ep, val = d["mentries"][0]
                cmd = inv(CMD_NAMES)[cmd_name]
                kw.update(nentries=1, e_cmd=cmd, e_epoch=ep)
                if cmd == C_APPEND:
                    kw["e_val"] = val + 1
                else:
                    if cmd == C_INIT:
                        cid, members = val
                    else:
                        cid, who, members = val
                        kw["e_who"] = slot_of[who] + 1
                    kw["e_cfgid"] = cid
                    kw["e_members"] = sum(1 << slot_of[x] for x in members)
            elif d["mresult"] == "Ok":
                kw["nentries"] = 0
            if d["mresult"] == "Diverging":
                kw.update(mdivergingEpoch=d["mdivergingEpoch"],
                          mdivergingEndOffset=d["mdivergingEndOffset"])
        return self.packer.pack(**kw)

    def encode(self, st: dict) -> np.ndarray:
        """Inverse of ``decode`` (the message bag in sorted key order)."""
        lay, p, NS = self.layout, self.p, self.NS
        vec = lay.zeros(())
        slot_of = {ident: self._ident_slot(ident) for ident in st["servers"]}
        inv_state = {v: k for k, v in STATE_NAMES.items()}
        inv_role = {v: k for k, v in ROLE_NAMES.items()}
        inv_cmd = {v: k for k, v in CMD_NAMES.items()}

        def put(name, slot, val):
            vec[lay.fields[name].offset + slot] = val

        def mask_of(idset):
            return sum(1 << slot_of[x] for x in idset)

        for ident, slot in slot_of.items():
            put("host", slot, ident[0])
            put("diskId", slot, ident[1])
            put("used", slot, 1)
            put("role", slot, inv_role[st["role"][ident]])
            put("state", slot, inv_state[st["state"][ident]])
            put("currentEpoch", slot, st["currentEpoch"][ident])
            for f in ("leader", "votedFor"):
                v = st[f][ident]
                put(f, slot, 0 if v is None else slot_of[v] + 1)
            pf = st["pendingFetch"][ident]
            if pf is not None:
                c = dict(pf)
                for f, v in (("pf_active", 1), ("pf_epoch", c["mepoch"]),
                             ("pf_offset", c["mfetchOffset"]),
                             ("pf_lastepoch", c["mlastFetchedEpoch"]),
                             ("pf_dest", slot_of[c["mdest"]] + 1),
                             ("pf_observer", int(c["mobserver"]))):
                    put(f, slot, v)
            put("votesGranted", slot, mask_of(st["votesGranted"][ident]))
            cid, members, committed = st["config"][ident]
            put("cfg_id", slot, cid)
            put("cfg_members", slot, mask_of(members))
            put("cfg_committed", slot, int(committed))
            eo = st["endOffset"][ident]
            put("eo_dom", slot, mask_of(eo.keys()))
            for j, v in eo.items():
                vec[lay.fields["endOffset"].offset + slot * NS + slot_of[j]] = v
            for k, (cmd_name, ep, val) in enumerate(st["log"][ident]):
                cmd = inv_cmd[cmd_name]
                base = slot * p.max_log + k
                vec[lay.fields["log_cmd"].offset + base] = cmd
                vec[lay.fields["log_epoch"].offset + base] = ep
                if cmd == C_APPEND:
                    vec[lay.fields["log_val"].offset + base] = val + 1
                    continue
                if cmd == C_INIT:
                    cid2, mem2 = val
                else:
                    cid2, who2, mem2 = val
                    vec[lay.fields["log_who"].offset + base] = slot_of[who2] + 1
                vec[lay.fields["log_cfgid"].offset + base] = cid2
                vec[lay.fields["log_members"].offset + base] = mask_of(mem2)
            put("log_len", slot, len(st["log"][ident]))
            put("highWatermark", slot, st["highWatermark"][ident])
        vec[lay.sl("acked")] = [{None: ACK_NIL, False: ACK_FALSE, True: ACK_TRUE}[a]
                                for a in st["_acked"]]
        keys = sorted((self.encode_msg(r, slot_of), c) for r, c in st["messages"])
        if len(keys) > p.msg_slots:
            raise OverflowError("message bag exceeds msg_slots")
        words = np.full((self.n_words, p.msg_slots), EMPTY, np.int32)
        cn = np.zeros(p.msg_slots, np.int32)
        for k, (kt, c) in enumerate(keys):
            words[:, k] = kt
            cn[k] = c
        for w in range(self.n_words):
            vec[lay.sl(f"msg_w{w}")] = words[w]
        vec[lay.sl("msg_cnt")] = cn
        for f, key in (("electionCtr", "_electionCtr"), ("restartCtr", "_restartCtr"),
                       ("removeCtr", "_removeReconfigCtr"), ("diskIdGen", "_diskIdGen")):
            vec[lay.fields[f].offset] = st[key]
        vec[lay.sl("valueCtr")] = list(st["_valueCtr"])
        return vec
