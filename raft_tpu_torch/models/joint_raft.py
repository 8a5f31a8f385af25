"""Batched PyTorch lowering of the joint-consensus reconfiguration Raft spec
(RaftWithReconfigJointConsensus.tla).

Counterpart of ``raft_tpu/models/joint_raft.py``; the TLA+ line citations
are the reference's. The shared machinery is ``models/config_common.py``;
this module holds the variant's layout, message packer and hooks. Its
deltas from the add/remove variant (``models/reconfig_raft.py``):

  - log entries carry up to three member sets (``OldNewConfigCommand``'s
    old, new and joint members, ``:837-842``): seven parallel lane arrays,
    the sets as bitmasks;
  - configs track ``jointConsensus`` and the ``old``/``new`` sets
    (``ConfigFor:279-290``);
  - dual quorums while joint: ``BecomeLeader:511-528`` and
    ``AdvanceCommitIndex:613-653`` need majorities of old and new at once;
  - the reconfigurations are the (add, remove) member-set pairs that
    ``ReconfigType`` admits (``IsValidReconfiguration:813-825``), one
    candidate each (``reconfig_shapes``);
  - ``AppendNewConfigToLog:861-876`` fires on the committed OldNew entry
    with no later config command (``CommittedOldNewWithoutNew:232-242``);
  - ``MaxOneReconfigurationAtATime:1080-1101`` is an adjacency rule over
    every server's log;
  - ``ResetWithSameIdentity:391`` is not in ``Next`` (``:988``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import torch

from .. import kernels
from ..ops.packing import bits_for
from .base import Layout, jax_set as jset, jax_set2 as jset2, jax_take as jtake
from .config_common import (
    CANDIDATE,
    LEADER,
    NOTMEMBER,
    PENDING_SNAP_REQUEST,
    R_ACCEPT_AE,
    R_APPENDENTRIES,
    R_CLIENTREQUEST,
    R_HANDLE_AERESP,
    R_HANDLE_RVREQ,
    R_HANDLE_RVRESP,
    R_HANDLE_SNAPREQ,
    R_HANDLE_SNAPRESP,
    R_REJECT_AE,
    R_REQUESTVOTE,
    R_RESTART,
    R_SENDSNAP,
    R_UPDATETERM,
    ConfigRaftCommon,
    _at,
    _bit,
    message_fields,
    wide_packer,
)

# log-entry commands (:58-60); 0 = empty lane
CMD_NONE, CMD_APPEND, CMD_OLDNEW, CMD_NEW = range(4)
CMD_NAMES = {CMD_APPEND: "AppendCommand", CMD_OLDNEW: "OldNewConfigCommand",
             CMD_NEW: "NewConfigCommand"}
ENTRY_SET_FIELDS = ("old", "new", "members")
ENTRY_FIELDS = ("term", "cmd", "val", "cid") + ENTRY_SET_FIELDS

# Next-disjunct ranks (:966-988)
(
    J_RESTART,
    J_UPDATETERM,
    J_REQUESTVOTE,
    J_BECOMELEADER,
    J_HANDLE_RVREQ,
    J_HANDLE_RVRESP,
    J_CLIENTREQUEST,
    J_ADVANCECOMMIT,
    J_APPENDENTRIES,
    J_REJECT_AE,
    J_ACCEPT_AE,
    J_HANDLE_AERESP,
    J_APPEND_OLDNEW,
    J_APPEND_NEW,
    J_SENDSNAP,
    J_HANDLE_SNAPREQ,
    J_HANDLE_SNAPRESP,
) = range(17)
# the shared kernels emit the shared ranks; this Next puts them at the
# same indices (as the reference asserts)
assert (J_RESTART, J_REQUESTVOTE, J_CLIENTREQUEST, J_APPENDENTRIES, J_SENDSNAP) == (
    R_RESTART, R_REQUESTVOTE, R_CLIENTREQUEST, R_APPENDENTRIES, R_SENDSNAP)
assert (J_UPDATETERM, J_HANDLE_RVREQ, J_HANDLE_RVRESP, J_REJECT_AE, J_ACCEPT_AE,
        J_HANDLE_AERESP, J_HANDLE_SNAPREQ, J_HANDLE_SNAPRESP) == (
    R_UPDATETERM, R_HANDLE_RVREQ, R_HANDLE_RVRESP, R_REJECT_AE, R_ACCEPT_AE, R_HANDLE_AERESP,
    R_HANDLE_SNAPREQ, R_HANDLE_SNAPRESP)

ACTION_NAMES = [
    "Restart", "UpdateTerm", "RequestVote", "BecomeLeader", "HandleRequestVoteRequest",
    "HandleRequestVoteResponse", "ClientRequest", "AdvanceCommitIndex", "AppendEntries",
    "RejectAppendEntriesRequest", "AcceptAppendEntriesRequest", "HandleAppendEntriesResponse",
    "AppendOldNewConfigToLog", "AppendNewConfigToLog", "SendSnapshot", "HandleSnapshotRequest",
    "HandleSnapshotResponse",
]
GROUP_RANKS = {
    "Restart": J_RESTART, "RequestVote": J_REQUESTVOTE, "BecomeLeader": J_BECOMELEADER,
    "ClientRequest": J_CLIENTREQUEST, "AdvanceCommitIndex": J_ADVANCECOMMIT,
    "AppendEntries": J_APPENDENTRIES, "AppendOldNewConfigToLog": J_APPEND_OLDNEW,
    "AppendNewConfigToLog": J_APPEND_NEW, "SendSnapshot": J_SENDSNAP,
    # the eight receipt disjuncts resolve their rank at run time
    "HandleMessage": J_UPDATETERM,
}


@dataclass(frozen=True)
class JointRaftParams:
    """The reference's ``JointRaftParams``, field for field."""

    n_servers: int
    n_values: int
    init_cluster_size: int
    max_elections: int
    max_restarts: int
    max_reconfigs: int
    max_values_per_term: int
    reconfig_type: int
    msg_slots: int = 112

    @property
    def max_term(self) -> int:
        return 1 + self.max_elections

    @property
    def max_cfg_id(self) -> int:
        return max(1, self.max_reconfigs)

    @property
    def max_log(self) -> int:
        appends = min(self.n_values, self.max_term * self.max_values_per_term)
        return 1 + appends + 2 * self.max_reconfigs


def reconfig_shapes(n_servers: int, reconfig_type: int) -> list[tuple[int, int]]:
    """The (addMembers, removeMembers) subset pairs IsValidReconfiguration
    (:813-825) admits, as bitmask pairs, in the reference's order."""
    subsets = [frozenset(c) for r in range(n_servers + 1)
               for c in itertools.combinations(range(n_servers), r)]

    def valid(add, remove):
        if reconfig_type == 2:
            return len(add) == 1 and len(remove) == 1
        if reconfig_type == 3:
            return len(add) > 0 and len(remove) == 0
        if reconfig_type == 4:
            return len(add) == 0 and len(remove) > 0
        return bool(add) or bool(remove)

    return [(sum(1 << x for x in add), sum(1 << x for x in remove))
            for add in subsets for remove in subsets if valid(add, remove)]


def _entry_fields(p: JointRaftParams) -> list[tuple[str, int]]:
    S = p.n_servers
    return [("term", bits_for(p.max_term)), ("cmd", 2), ("val", bits_for(p.n_values)),
            ("cid", bits_for(p.max_cfg_id)), ("old", S), ("new", S), ("members", S)]


def _build_layout(p: JointRaftParams, n_words: int) -> Layout:
    S, V, L, M = p.n_servers, p.n_values, p.max_log, p.msg_slots
    lay = Layout(S)
    # VIEW (:144): every aux variable excluded
    lay.add("config_id", "per_server", (S,))
    lay.add("config_joint", "per_server", (S,))
    lay.add("config_members", "server_bitmask", (S,))
    lay.add("config_old", "server_bitmask", (S,))
    lay.add("config_new", "server_bitmask", (S,))
    lay.add("config_committed", "per_server", (S,))
    lay.add("currentTerm", "per_server", (S,))
    lay.add("state", "per_server", (S,))
    lay.add("votedFor", "per_server_val", (S,))
    lay.add("votesGranted", "server_bitmask", (S,))
    lay.add("log_term", "per_server", (S, L))
    lay.add("log_cmd", "per_server", (S, L))
    lay.add("log_val", "per_server", (S, L))
    lay.add("log_cid", "per_server", (S, L))
    lay.add("log_old", "server_bitmask", (S, L))
    lay.add("log_new", "server_bitmask", (S, L))
    lay.add("log_members", "server_bitmask", (S, L))
    lay.add("log_len", "per_server", (S,))
    lay.add("commitIndex", "per_server", (S,))
    lay.add("nextIndex", "per_server_pair", (S, S))  # may hold -1 / -2
    lay.add("matchIndex", "per_server_pair", (S, S))
    lay.add("pendingResponse", "server_bitmask", (S,))
    for k in range(n_words):
        lay.add(f"msg_w{k}", "msg_word", (M,))
    lay.add("msg_cnt", "msg_cnt", (M,))
    lay.add("acked", "aux", (V,))
    lay.add("electionCtr", "aux")
    lay.add("restartCtr", "aux")
    lay.add("reconfigCtr", "aux")
    lay.add("valueCtr", "aux", (p.max_term,))
    return lay.finish()


class JointRaftModel(ConfigRaftCommon):
    """Batched successor/invariant kernels for one (spec, constants) pair."""

    name = "RaftWithReconfigJointConsensus"
    ENTRY_FIELDS = ENTRY_FIELDS
    CMD_SEED = CMD_NEW  # Init's seeded first entry (:341-354)
    MEMBERS_FIELD = "members"
    CMD_APPEND = CMD_APPEND
    ACTION_NAMES = ACTION_NAMES
    GROUP_RANKS = GROUP_RANKS
    KERNELS = kernels.JOINT_FAMILY
    counter_fields = ("reconfigCtr",)

    def __init__(self, params: JointRaftParams, server_names=None, value_names=None):
        self.p = params
        self.packer = wide_packer(message_fields(params, _entry_fields(params)))
        self.n_words = self.packer.n_words
        self.layout = _build_layout(params, self.n_words)
        S, V, L = params.n_servers, params.n_values, params.max_log
        self.server_names = list(server_names or [f"s{i+1}" for i in range(S)])
        self.value_names = list(value_names or [f"v{i+1}" for i in range(V)])
        spec = [("msource", "server"), ("mdest", "server"), ("mmembers", "server_bitmask")]
        spec += [(f"e_{n}", "server_bitmask") for n in ENTRY_SET_FIELDS]
        spec += [(f"l{k}_{n}", "server_bitmask") for k in range(L) for n in ENTRY_SET_FIELDS]
        self.msg_perm_spec = tuple(spec)
        self.shapes = reconfig_shapes(S, params.reconfig_type)
        self._finish_init()

    @staticmethod
    def _cand_args(name: str, row) -> list[int]:
        """AppendOldNewConfigToLog(i, add, remove) packs its two member
        sets into p1 (add in the low 16 bits, remove above them)."""
        if name == "AppendOldNewConfigToLog":
            return [int(row[0]), int(row[1]) | (int(row[2]) << 16)]
        return ConfigRaftCommon._cand_args(name, row)

    # ---------------- helpers ----------------

    def _mrce(self, d, i):
        """MostRecentReconfigEntry — :251-257: (index, cmd, cid, old, new,
        members) of the latest config command of log[i]."""
        lanes = torch.arange(self.p.max_log, device=i.device)
        cmd = jtake(d["log_cmd"], i)
        mask = (lanes < jtake(d["log_len"], i).unsqueeze(-1)) & self._is_cfg_cmd(cmd)
        idx = torch.where(mask, lanes + 1, 0).max(-1).values
        pos = (idx - 1).clamp(min=0)
        return (idx, _at(cmd, pos), *(_at(jtake(d[f"log_{n}"], i), pos)
                                     for n in ("cid", "old", "new", "members")))

    def _config_for_upd(self, d, i, idx, cmd, cid, old, new, members, ci) -> dict:
        """ConfigFor (:279-290) written to server i's config fields."""
        joint = (cmd == CMD_OLDNEW).to(torch.int32)
        return dict(
            config_id=jset(d["config_id"], i, cid),
            config_joint=jset(d["config_joint"], i, joint),
            config_members=jset(d["config_members"], i, members),
            config_old=jset(d["config_old"], i, torch.where(joint > 0, old, 0)),
            config_new=jset(d["config_new"], i, torch.where(joint > 0, new, 0)),
            config_committed=jset(d["config_committed"], i, (ci >= idx).to(torch.int32)),
        )

    def _quorum_over(self, i, mask, idxs, match_row):
        """[C, n, L]: a majority of ``mask`` has matched each index, the
        leader counting itself."""
        ks = torch.arange(self.p.n_servers, device=i.device)
        member_k = _bit(mask.unsqueeze(-1), ks)
        in_agree = member_k.unsqueeze(-2) & (
            (match_row.unsqueeze(-2) >= idxs[:, None]) | (ks == i.unsqueeze(-1)).unsqueeze(-2))
        return 2 * in_agree.sum(-1) > self._popcount(mask).unsqueeze(-1)

    # ---------------- the variant's hooks ----------------

    def _is_cfg_cmd(self, cmd):
        """OldNewConfig / NewConfig entries carry a configuration (:58-60)."""
        return (cmd == CMD_OLDNEW) | (cmd == CMD_NEW)

    def _config_updates_from_log(self, d, dst, logs, cfg_pos, cfg_idx, mci):
        """The ConfigFor projection of the installed entry (:279-290);
        in_new = dst in its member set."""
        members = _at(logs["members"], cfg_pos)
        upd = self._config_for_upd(d, dst, cfg_idx, _at(logs["cmd"], cfg_pos),
                                   _at(logs["cid"], cfg_pos), _at(logs["old"], cfg_pos),
                                   _at(logs["new"], cfg_pos), members, mci)
        return upd, _bit(members, dst)

    def _become_leader(self, d, i, C, dev):
        """BecomeLeader(i) — :511-528: dual quorums while joint."""
        S = self.p.n_servers
        n = i.shape[1]
        vg = jtake(d["votesGranted"], i)
        members, old, new = (jtake(d[f"config_{n_}"], i) for n_ in ("members", "old", "new"))
        pc = self._popcount
        q_plain = ((vg & ~members) == 0) & (2 * pc(vg) > pc(members))
        q_joint = (2 * pc(vg & old) > pc(old)) & (2 * pc(vg & new) > pc(new))
        valid = (jtake(d["state"], i) == CANDIDATE) & torch.where(
            jtake(d["config_joint"], i) > 0, q_joint, q_plain)
        succ = self._asm(
            d, C, n,
            state=jset(d["state"], i, LEADER),
            nextIndex=jset(d["nextIndex"], i,
                           (jtake(d["log_len"], i) + 1).unsqueeze(-1).expand(-1, -1, S)),
            matchIndex=jset(d["matchIndex"], i, self._row(0, dev)),
            pendingResponse=jset(d["pendingResponse"], i, 0),
        )
        return valid, succ, self._rank(C, n, J_BECOMELEADER, dev), self._no(C, n, dev)

    def _commit_quorum_ok(self, d, i, idxs, match_row):
        """The dual-quorum agreement while joint (:626-629)."""
        q = {n: self._quorum_over(i, jtake(d[f"config_{n}"], i), idxs, match_row)
             for n in ("members", "old", "new")}
        return torch.where((jtake(d["config_joint"], i) > 0).unsqueeze(-1), q["old"] & q["new"],
                           q["members"])

    def _commit_config_upd(self, d, i, new_ci) -> dict:
        return self._config_for_upd(d, i, *self._mrce(d, i), new_ci)

    def _commit_removed(self, d, i, in_range):
        """IsRemovedFromCluster (:606-611): a NewConfigCommand without i."""
        return torch.any(in_range & (jtake(d["log_cmd"], i) == CMD_NEW)
                         & ~_bit(jtake(d["log_members"], i), i.unsqueeze(-1)), dim=-1)

    # ---------------- the variant's actions ----------------

    def _append_old_new(self, d, i, add_m, rem_m, C, dev):
        """AppendOldNewConfigToLog(i) for one admitted (add, remove) pair
        of member sets — :827-856."""
        p, S, L = self.p, self.p.n_servers, self.p.max_log
        n = i.shape[1]
        members = jtake(d["config_members"], i)
        # HasPendingConfigCommand (:246-248)
        pending = (jtake(d["config_committed"], i) == 0) | (jtake(d["config_joint"], i) > 0)
        valid = ((jtake(d["state"], i) == LEADER) & (d["reconfigCtr"] < p.max_reconfigs)
                 & ~pending & ((add_m & members) == 0)  # addMembers disjoint (:834)
                 & ((rem_m & members) == rem_m))  # removeMembers a subset (:835)
        old = members
        new = (members & ~rem_m) | add_m
        joint_members = members | add_m
        new_id = (d["reconfigCtr"] + 1).expand(C, n)  # id = reconfigCtr + 1 (:839)
        pos = jtake(d["log_len"], i)
        posc = torch.clamp(pos, 0, L - 1)
        # nextIndex := PendingSnapshotRequest for the servers of new \ old (:849-853)
        ks = torch.arange(S, device=dev)
        fresh = _bit(new.unsqueeze(-1), ks) & ~_bit(old.unsqueeze(-1), ks)
        ni_row = torch.where(fresh, PENDING_SNAP_REQUEST, jtake(d["nextIndex"], i))
        succ = self._asm(
            d, C, n,
            log_term=jset2(d["log_term"], i, posc, jtake(d["currentTerm"], i)),
            log_cmd=jset2(d["log_cmd"], i, posc, CMD_OLDNEW),
            log_cid=jset2(d["log_cid"], i, posc, new_id),
            log_old=jset2(d["log_old"], i, posc, old),
            log_new=jset2(d["log_new"], i, posc, new),
            log_members=jset2(d["log_members"], i, posc, joint_members),
            log_len=jset(d["log_len"], i, pos + 1),
            config_id=jset(d["config_id"], i, new_id),
            config_joint=jset(d["config_joint"], i, 1),
            config_members=jset(d["config_members"], i, joint_members),
            config_old=jset(d["config_old"], i, old),
            config_new=jset(d["config_new"], i, new),
            config_committed=jset(d["config_committed"], i,
                                  (jtake(d["commitIndex"], i) >= pos + 1).to(torch.int32)),
            reconfigCtr=d["reconfigCtr"] + 1,
            nextIndex=jset(d["nextIndex"], i, ni_row),
        )
        return valid, succ, self._rank(C, n, J_APPEND_OLDNEW, dev), valid & (pos >= L)

    def _append_new(self, d, i, C, dev):
        """AppendNewConfigToLog(i) — :861-876: on the committed OldNew entry
        with no later config command (CommittedOldNewWithoutNew
        :232-242)."""
        L = self.p.max_log
        n = i.shape[1]
        lanes = torch.arange(L, device=dev)
        cmd = jtake(d["log_cmd"], i)
        ll_i = jtake(d["log_len"], i)
        in_log = lanes < ll_i.unsqueeze(-1)
        last_oldnew = torch.where(in_log & (cmd == CMD_OLDNEW), lanes + 1, 0).max(-1).values
        last_new = torch.where(in_log & (cmd == CMD_NEW), lanes + 1, 0).max(-1).values
        ci_i = jtake(d["commitIndex"], i)
        valid = ((jtake(d["state"], i) == LEADER) & (last_oldnew > 0) & (ci_i >= last_oldnew)
                 & (last_new < last_oldnew))
        tpos = (last_oldnew - 1).clamp(min=0)
        new_members = _at(jtake(d["log_new"], i), tpos)
        new_id = _at(jtake(d["log_cid"], i), tpos)
        posc = torch.clamp(ll_i, 0, L - 1)
        succ = self._asm(
            d, C, n,
            log_term=jset2(d["log_term"], i, posc, jtake(d["currentTerm"], i)),
            log_cmd=jset2(d["log_cmd"], i, posc, CMD_NEW),
            log_cid=jset2(d["log_cid"], i, posc, new_id),
            log_members=jset2(d["log_members"], i, posc, new_members),
            log_len=jset(d["log_len"], i, ll_i + 1),
            config_id=jset(d["config_id"], i, new_id),
            config_joint=jset(d["config_joint"], i, 0),
            config_members=jset(d["config_members"], i, new_members),
            config_old=jset(d["config_old"], i, 0),
            config_new=jset(d["config_new"], i, 0),
            config_committed=jset(d["config_committed"], i, (ci_i >= ll_i + 1).to(torch.int32)),
        )
        return valid, succ, self._rank(C, n, J_APPEND_NEW, dev), valid & (ll_i >= L)

    # ---------------- the Next table ----------------

    def _config_bindings(self) -> list:
        S = self.p.n_servers
        return ([("AppendOldNewConfigToLog", (i, a, r)) for i in range(S) for a, r in self.shapes]
                + [("AppendNewConfigToLog", (i,)) for i in range(S)])

    def _variant_tables(self) -> dict:
        S = self.p.n_servers
        return {"on_i": [i for i in range(S) for _ in self.shapes],
                "on_add": [a for _ in range(S) for a, _r in self.shapes],
                "on_rem": [r for _ in range(S) for _a, r in self.shapes]}

    def _config_outs(self, d, C, dev) -> list:
        I = lambda name: self._idx(name, dev)  # noqa: E731
        return [self._append_old_new(d, I("on_i"), I("on_add"), I("on_rem"), C, dev),
                self._append_new(d, I("iota_s"), C, dev)]

    # ---------------- invariants and liveness ----------------

    def _old_new_committed(self, states):
        """OldNewCommitted(i, index) over every (i, lane) — :1023-1025: a
        [B, S, L] mask of committed OldNewConfigCommand entries."""
        lay = self.layout
        lanes = torch.arange(self.p.max_log, device=states.device)
        return ((lay.get(states, "log_cmd") == CMD_OLDNEW)
                & (lanes < lay.get(states, "log_len")[..., None])
                & (lay.get(states, "commitIndex")[..., None] >= lanes + 1))

    def _live_reconfig_p(self, states):
        """ReconfigurationCompletes' antecedent — :1040-1043: some server
        has a committed OldNewConfigCommand."""
        return torch.any(self._old_new_committed(states).flatten(1), dim=1)

    def _live_reconfig_q(self, states):
        """ReconfigurationCompletes' consequent — :1044-1054: the last
        permissible election failed leaderless, or a majority of the new
        member set of a committed OldNew entry are self-aware members in
        Leader/Follower/Candidate holding a NewConfigCommand of its id
        (:1027-1037)."""
        lay, S, L = self.layout, self.p.n_servers, self.p.max_log
        dev = states.device
        st = lay.get(states, "state")
        cmd = lay.get(states, "log_cmd")
        cid = lay.get(states, "log_cid")
        lnew = lay.get(states, "log_new")
        lanes = torch.arange(L, device=dev)
        iota = torch.arange(S, device=dev)
        self_member = _bit(lay.get(states, "config_members"), iota)  # [B, S]
        has_new = (cmd == CMD_NEW) & (lanes < lay.get(states, "log_len")[..., None])
        # id_match[b, j, i, l]: j holds a NewConfigCommand with entry (i, l)'s id
        id_match = torch.any(has_new[:, :, None, None, :]
                             & (cid[:, :, None, None, :] == cid[:, None, :, :, None]), dim=4)
        qual = (self_member & (st != NOTMEMBER))[:, :, None, None] & id_match
        new_bit = _bit(lnew[:, None, :, :], iota[None, :, None, None])  # [B, j, i, l]
        count = (qual & new_bit).sum(1)
        size = new_bit.sum(1)
        reached = torch.any((self._old_new_committed(states) & (2 * count > size)).flatten(1),
                            dim=1)
        no_leader = ~torch.any(st == LEADER, dim=1)
        spent = lay.get(states, "electionCtr") == self.p.max_elections
        return (spent & no_leader) | reached

    def _inv_max_one_reconfig(self, states):
        """MaxOneReconfigurationAtATime — :1080-1101: two config commands of
        one type need one of the other type strictly between them."""
        lay, L = self.layout, self.p.max_log
        dev = states.device
        cmd = lay.get(states, "log_cmd")
        lanes = torch.arange(L, device=dev)
        in_log = lanes < lay.get(states, "log_len")[:, :, None]
        upper = lanes[None, :] > lanes[:, None]  # [k1, k2]: k2 > k1
        between = (lanes > lanes[:, None, None]) & (lanes < lanes[None, :, None])  # [k1, k2, k]
        ok = torch.ones(cmd.shape[:2], dtype=torch.bool, device=dev)
        for c, other in ((CMD_OLDNEW, CMD_NEW), (CMD_NEW, CMD_OLDNEW)):
            is_c = in_log & (cmd == c)
            is_o = in_log & (cmd == other)
            pair = is_c[..., :, None] & is_c[..., None, :]
            has_between = torch.any(between & is_o[:, :, None, None, :], dim=-1)
            ok = ok & ~torch.any((pair & upper & ~has_between).flatten(2), dim=2)
        return torch.all(ok, dim=1)

    # ---------------- host-side decode/encode ----------------

    def _decode_entry(self, term, cmd, val, cid, old, new, members):
        cmd_name = CMD_NAMES[int(cmd)]
        if cmd_name == "AppendCommand":
            return (cmd_name, int(term), int(val) - 1)
        if cmd_name == "NewConfigCommand":
            return (cmd_name, int(term), (int(cid), self._fs(members)))
        return (cmd_name, int(term),
                (int(cid), self._fs(old), self._fs(new), self._fs(members)))

    def _encode_entry(self, entry):
        cmd_name, term, val = entry
        cmd = {v: k for k, v in CMD_NAMES.items()}[cmd_name]
        mk = lambda fs: sum(1 << j for j in fs)  # noqa: E731
        if cmd == CMD_APPEND:
            return dict(term=term, cmd=cmd, val=val + 1, cid=0, old=0, new=0, members=0)
        if cmd == CMD_NEW:
            return dict(term=term, cmd=cmd, val=0, cid=val[0], old=0, new=0, members=mk(val[1]))
        return dict(term=term, cmd=cmd, val=0, cid=val[0], old=mk(val[1]), new=mk(val[2]),
                    members=mk(val[3]))

    def _decode_config(self, g):
        return tuple(
            (int(g("config_id")[i]), bool(g("config_joint")[i]),
             self._fs(g("config_members")[i]), self._fs(g("config_old")[i]),
             self._fs(g("config_new")[i]), bool(g("config_committed")[i]))
            for i in range(self.p.n_servers))

    def _encode_config(self, vec, st) -> None:
        lay = self.layout
        mk = lambda fs: sum(1 << j for j in fs)  # noqa: E731
        vec[lay.sl("config_id")] = [c[0] for c in st["config"]]
        vec[lay.sl("config_joint")] = [int(c[1]) for c in st["config"]]
        vec[lay.sl("config_members")] = [mk(c[2]) for c in st["config"]]
        vec[lay.sl("config_old")] = [mk(c[3]) for c in st["config"]]
        vec[lay.sl("config_new")] = [mk(c[4]) for c in st["config"]]
        vec[lay.sl("config_committed")] = [int(c[5]) for c in st["config"]]
