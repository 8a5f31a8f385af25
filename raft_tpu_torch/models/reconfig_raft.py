"""Batched PyTorch lowering of the thesis-style add/remove reconfiguration
Raft spec (RaftWithReconfigAddRemove.tla).

Counterpart of ``raft_tpu/models/reconfig_raft.py``; the TLA+ line citations
are the reference's. The shared machinery is ``models/config_common.py``;
this module holds the variant's layout, message packer and hooks:

  - log entries are (command, term, value) records whose config commands
    carry (id, new/old member, member set): six parallel per-server lane
    arrays (``ENTRY_FIELDS``), the member set a bitmask;
  - the current config is derived state (``MostRecentReconfigEntry:252``
    + ``ConfigFor:265``): a masked lane max and a gather;
  - quorums are popcount thresholds over the config's member bitmask;
  - ``ResetWithSameIdentity:385`` is enabled in ``Next:965``; its CHOOSE
    of a leader is the lowest index;
  - snapshot messages embed the sender's whole log, so records pack into
    N-word WidePacker keys with one field set per log lane; the canon
    remaps their member fields by the ``server_nil`` (``cmem``) and
    ``server_bitmask`` (``cmembers``, ``mmembers``) kinds.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
from ..ops.packing import bits_for
from .base import Layout, jax_set as jset, jax_set2 as jset2, jax_take as jtake
from .config_common import (
    CANDIDATE,
    LEADER,
    NIL,
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

# log-entry commands (RaftWithReconfigAddRemove.tla:66-69); 0 = empty lane
CMD_NONE, CMD_INIT, CMD_APPEND, CMD_ADD, CMD_REMOVE = range(5)
CMD_NAMES = {CMD_INIT: "InitClusterCommand", CMD_APPEND: "AppendCommand",
             CMD_ADD: "AddServerCommand", CMD_REMOVE: "RemoveServerCommand"}
ENTRY_FIELDS = ("term", "cmd", "val", "cid", "cmem", "cmembers")

# Next-disjunct ranks (:943-965)
(
    A_RESTART,
    A_UPDATETERM,
    A_REQUESTVOTE,
    A_BECOMELEADER,
    A_HANDLE_RVREQ,
    A_HANDLE_RVRESP,
    A_CLIENTREQUEST,
    A_ADVANCECOMMIT,
    A_APPENDENTRIES,
    A_REJECT_AE,
    A_ACCEPT_AE,
    A_HANDLE_AERESP,
    A_APPEND_ADD,
    A_APPEND_REMOVE,
    A_SENDSNAP,
    A_HANDLE_SNAPREQ,
    A_HANDLE_SNAPRESP,
    A_RESET_IDENTITY,
) = range(18)
# the shared kernels emit the shared ranks; this Next puts them at the
# same indices (as the reference asserts)
assert (A_RESTART, A_REQUESTVOTE, A_CLIENTREQUEST, A_APPENDENTRIES, A_SENDSNAP) == (
    R_RESTART, R_REQUESTVOTE, R_CLIENTREQUEST, R_APPENDENTRIES, R_SENDSNAP)
assert (A_UPDATETERM, A_HANDLE_RVREQ, A_HANDLE_RVRESP, A_REJECT_AE, A_ACCEPT_AE,
        A_HANDLE_AERESP, A_HANDLE_SNAPREQ, A_HANDLE_SNAPRESP) == (
    R_UPDATETERM, R_HANDLE_RVREQ, R_HANDLE_RVRESP, R_REJECT_AE, R_ACCEPT_AE, R_HANDLE_AERESP,
    R_HANDLE_SNAPREQ, R_HANDLE_SNAPRESP)

ACTION_NAMES = [
    "Restart", "UpdateTerm", "RequestVote", "BecomeLeader", "HandleRequestVoteRequest",
    "HandleRequestVoteResponse", "ClientRequest", "AdvanceCommitIndex", "AppendEntries",
    "RejectAppendEntriesRequest", "AcceptAppendEntriesRequest", "HandleAppendEntriesResponse",
    "AppendAddServerCommandToLog", "AppendRemoveServerCommandToLog", "SendSnapshot",
    "HandleSnapshotRequest", "HandleSnapshotResponse", "ResetWithSameIdentity",
]
GROUP_RANKS = {
    "Restart": A_RESTART, "RequestVote": A_REQUESTVOTE, "BecomeLeader": A_BECOMELEADER,
    "ClientRequest": A_CLIENTREQUEST, "AdvanceCommitIndex": A_ADVANCECOMMIT,
    "AppendEntries": A_APPENDENTRIES, "AppendAddServerCommandToLog": A_APPEND_ADD,
    "AppendRemoveServerCommandToLog": A_APPEND_REMOVE, "SendSnapshot": A_SENDSNAP,
    "ResetWithSameIdentity": A_RESET_IDENTITY,
    # the eight receipt disjuncts resolve their rank at run time
    "HandleMessage": A_UPDATETERM,
}


@dataclass(frozen=True)
class ReconfigRaftParams:
    """The reference's ``ReconfigRaftParams``, field for field."""

    n_servers: int
    n_values: int
    init_cluster_size: int
    max_elections: int
    max_restarts: int
    max_values_per_term: int
    max_add_reconfigs: int
    max_remove_reconfigs: int
    min_cluster_size: int
    max_cluster_size: int
    include_thesis_bug: bool = False
    msg_slots: int = 96

    @property
    def max_term(self) -> int:
        return 1 + self.max_elections

    @property
    def max_cfg_id(self) -> int:
        return 1 + self.max_add_reconfigs + self.max_remove_reconfigs

    @property
    def max_log(self) -> int:
        appends = min(self.n_values, self.max_term * self.max_values_per_term)
        return 1 + appends + self.max_add_reconfigs + self.max_remove_reconfigs


def _entry_fields(p: ReconfigRaftParams) -> list[tuple[str, int]]:
    return [("term", bits_for(p.max_term)), ("cmd", 3), ("val", bits_for(p.n_values)),
            ("cid", bits_for(p.max_cfg_id)),
            ("cmem", bits_for(p.n_servers)),  # new/old member, Nil-able
            ("cmembers", p.n_servers)]  # the member-set bitmask


def _build_layout(p: ReconfigRaftParams, n_words: int) -> Layout:
    S, V, L, M = p.n_servers, p.n_values, p.max_log, p.msg_slots
    lay = Layout(S)
    # VIEW (:159) = messages, serverVars, candidateVars, leaderVars,
    # logVars; every aux variable (acked and five counters) is excluded
    lay.add("config_id", "per_server", (S,))
    lay.add("config_members", "server_bitmask", (S,))
    lay.add("config_committed", "per_server", (S,))
    lay.add("currentTerm", "per_server", (S,))
    lay.add("state", "per_server", (S,))
    lay.add("votedFor", "per_server_val", (S,))
    lay.add("votesGranted", "server_bitmask", (S,))
    lay.add("log_term", "per_server", (S, L))
    lay.add("log_cmd", "per_server", (S, L))
    lay.add("log_val", "per_server", (S, L))
    lay.add("log_cid", "per_server", (S, L))
    lay.add("log_cmem", "per_server_val", (S, L))  # 0 = none, i + 1 = server i
    lay.add("log_cmembers", "server_bitmask", (S, L))
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
    lay.add("addReconfigCtr", "aux")
    lay.add("removeReconfigCtr", "aux")
    lay.add("valueCtr", "aux", (p.max_term,))
    return lay.finish()


class ReconfigRaftModel(ConfigRaftCommon):
    """Batched successor/invariant kernels for one (spec, constants) pair."""

    name = "RaftWithReconfigAddRemove"
    ENTRY_FIELDS = ENTRY_FIELDS
    CMD_SEED = CMD_INIT  # Init's seeded first entry (:324-338)
    MEMBERS_FIELD = "cmembers"
    CMD_APPEND = CMD_APPEND
    ACTION_NAMES = ACTION_NAMES
    GROUP_RANKS = GROUP_RANKS
    KERNELS = kernels.RECONFIG_FAMILY
    counter_fields = ("addReconfigCtr", "removeReconfigCtr")

    def __init__(self, params: ReconfigRaftParams, server_names=None, value_names=None):
        self.p = params
        self.packer = wide_packer(message_fields(params, _entry_fields(params)))
        self.n_words = self.packer.n_words
        self.layout = _build_layout(params, self.n_words)
        S, V, L = params.n_servers, params.n_values, params.max_log
        self.server_names = list(server_names or [f"s{i+1}" for i in range(S)])
        self.value_names = list(value_names or [f"v{i+1}" for i in range(V)])
        # the symmetry contract: packed fields that move under a permutation
        spec = [("msource", "server"), ("mdest", "server"), ("e_cmem", "server_nil"),
                ("e_cmembers", "server_bitmask"), ("mmembers", "server_bitmask")]
        for k in range(L):
            spec += [(f"l{k}_cmem", "server_nil"), (f"l{k}_cmembers", "server_bitmask")]
        self.msg_perm_spec = tuple(spec)
        self._all_pairs = [(i, j) for i in range(S) for j in range(S)]
        self._finish_init()

    # ---------------- helpers ----------------

    def _mrce(self, d, i):
        """MostRecentReconfigEntry over log[i] — :252-258: (index, cid,
        cmembers); index 0 = no config command."""
        L = self.p.max_log
        lanes = torch.arange(L, device=i.device)
        mask = (lanes < jtake(d["log_len"], i).unsqueeze(-1)) & self._is_cfg_cmd(
            jtake(d["log_cmd"], i))
        idx = torch.where(mask, lanes + 1, 0).max(-1).values
        pos = (idx - 1).clamp(min=0)
        return idx, _at(jtake(d["log_cid"], i), pos), _at(jtake(d["log_cmembers"], i), pos)

    def _has_committed_in_term(self, d, i):
        """LeaderHasCommittedEntriesInCurrentTerm — :275-278."""
        lanes = torch.arange(self.p.max_log, device=i.device)
        return torch.any(
            (lanes < jtake(d["log_len"], i).unsqueeze(-1))
            & (jtake(d["log_term"], i) == jtake(d["currentTerm"], i).unsqueeze(-1))
            & (jtake(d["commitIndex"], i).unsqueeze(-1) >= lanes + 1), dim=-1)

    # ---------------- the variant's hooks ----------------

    def _is_cfg_cmd(self, cmd):
        """InitCluster / AddServer / RemoveServer entries carry a
        configuration (:66-69)."""
        return (cmd == CMD_INIT) | (cmd == CMD_ADD) | (cmd == CMD_REMOVE)

    def _config_updates_from_log(self, d, dst, logs, cfg_pos, cfg_idx, mci):
        """The config cache from the most recent config entry (:734-739):
        id, member set, committed watermark; in_new = dst in the set."""
        cmembers = _at(logs["cmembers"], cfg_pos)
        upd = dict(
            config_id=jset(d["config_id"], dst, _at(logs["cid"], cfg_pos)),
            config_members=jset(d["config_members"], dst, cmembers),
            config_committed=jset(d["config_committed"], dst, (mci >= cfg_idx).to(torch.int32)),
        )
        return upd, _bit(cmembers, dst)

    def _become_leader(self, d, i, C, dev):
        """BecomeLeader(i) — :505-518: votesGranted a quorum OF the member
        set (a subset and a majority)."""
        S = self.p.n_servers
        n = i.shape[1]
        members = jtake(d["config_members"], i)
        vg = jtake(d["votesGranted"], i)
        valid = ((jtake(d["state"], i) == CANDIDATE) & ((vg & ~members) == 0)
                 & (2 * self._popcount(vg) > self._popcount(members)))
        succ = self._asm(
            d, C, n,
            state=jset(d["state"], i, LEADER),
            nextIndex=jset(d["nextIndex"], i,
                           (jtake(d["log_len"], i) + 1).unsqueeze(-1).expand(-1, -1, S)),
            matchIndex=jset(d["matchIndex"], i, self._row(0, dev)),
            pendingResponse=jset(d["pendingResponse"], i, 0),
        )
        return valid, succ, self._rank(C, n, A_BECOMELEADER, dev), self._no(C, n, dev)

    def _commit_quorum_ok(self, d, i, idxs, match_row):
        """The member-set quorum, the leader counting itself (:612-618):
        [C, n, L]."""
        ks = torch.arange(self.p.n_servers, device=i.device)
        members = jtake(d["config_members"], i)
        member_k = _bit(members.unsqueeze(-1), ks)  # [C, n, S]
        in_agree = member_k.unsqueeze(-2) & (
            (match_row.unsqueeze(-2) >= idxs[:, None]) | (ks == i.unsqueeze(-1)).unsqueeze(-2))
        return 2 * in_agree.sum(-1) > self._popcount(members).unsqueeze(-1)

    def _commit_config_upd(self, d, i, new_ci) -> dict:
        """The config re-derivation (:627-632)."""
        cfg_idx, cfg_id, cfg_members = self._mrce(d, i)
        return dict(
            config_id=jset(d["config_id"], i, cfg_id),
            config_members=jset(d["config_members"], i, cfg_members),
            config_committed=jset(d["config_committed"], i,
                                  (new_ci >= cfg_idx).to(torch.int32)),
        )

    def _commit_removed(self, d, i, in_range):
        """IsRemovedFromCluster (:598-603)."""
        return torch.any(in_range & (jtake(d["log_cmd"], i) == CMD_REMOVE)
                         & ~_bit(jtake(d["log_cmembers"], i), i.unsqueeze(-1)), dim=-1)

    # ---------------- the variant's actions ----------------

    def _append_member_cmd(self, d, i, s, C, dev, add: bool):
        """AppendAddServerCommandToLog(i, s) — :795-824 (add) and
        AppendRemoveServerCommandToLog(i, s) — :828-853."""
        p, L = self.p, self.p.max_log
        n = i.shape[1]
        members = jtake(d["config_members"], i)
        ctr = "addReconfigCtr" if add else "removeReconfigCtr"
        size = self._popcount(members)
        valid = ((jtake(d["state"], i) == LEADER)
                 & (d[ctr] < (p.max_add_reconfigs if add else p.max_remove_reconfigs))
                 & ((size < p.max_cluster_size) if add else (size > p.min_cluster_size))
                 & (jtake(d["config_committed"], i) > 0)  # ~HasPendingConfigCommand (:248)
                 & (_bit(members, s) != add))
        if not p.include_thesis_bug:
            valid = valid & self._has_committed_in_term(d, i)
        bit = torch.ones_like(s) << s
        new_members = (members | bit) if add else (members & ~bit)
        new_id = jtake(d["config_id"], i) + 1
        pos = jtake(d["log_len"], i)
        posc = torch.clamp(pos, 0, L - 1)
        upd = dict(
            log_term=jset2(d["log_term"], i, posc, jtake(d["currentTerm"], i)),
            log_cmd=jset2(d["log_cmd"], i, posc, CMD_ADD if add else CMD_REMOVE),
            log_cid=jset2(d["log_cid"], i, posc, new_id),
            log_cmem=jset2(d["log_cmem"], i, posc, (s + 1).expand(C, n)),
            log_cmembers=jset2(d["log_cmembers"], i, posc, new_members),
            log_len=jset(d["log_len"], i, pos + 1),
            config_id=jset(d["config_id"], i, new_id),
            config_members=jset(d["config_members"], i, new_members),
            # committed = ci >= Len(newLog): always FALSE here (:814-816)
            config_committed=jset(d["config_committed"], i,
                                  (jtake(d["commitIndex"], i) >= pos + 1).to(torch.int32)),
        )
        upd[ctr] = d[ctr] + 1
        if add:
            upd["nextIndex"] = jset2(d["nextIndex"], i, s, PENDING_SNAP_REQUEST)
        succ = self._asm(d, C, n, **upd)
        return (valid, succ, self._rank(C, n, A_APPEND_ADD if add else A_APPEND_REMOVE, dev),
                valid & (pos >= L))

    def _reset_with_same_identity(self, d, i, C, dev):
        """ResetWithSameIdentity(i) — :385-400; the CHOOSE of a leader is
        the lowest index with IsCurrentLeader (:367-373)."""
        L = self.p.max_log
        n = i.shape[1]
        ct = d["currentTerm"]  # [C, 1, S]
        is_cur_leader = (d["state"] == LEADER) & torch.all(
            ct.unsqueeze(-1) >= ct.unsqueeze(-2), dim=-1)
        exists = is_cur_leader.any(-1)  # [C, 1]
        leader = is_cur_leader.to(torch.int32).argmax(-1)  # the lowest index (0 if none)
        valid = ((jtake(ct, i) > 0) & exists & (leader != i)
                 & ~_bit(jtake(d["config_members"], leader), i)
                 & (jtake(d["config_committed"], leader) > 0))
        zrow = torch.zeros((1, 1, L), dtype=torch.int32, device=dev)
        upd = {f"log_{name}": jset(d[f"log_{name}"], i, zrow) for name in ENTRY_FIELDS}
        for f in ("config_id", "config_members", "config_committed", "currentTerm",
                  "votesGranted", "pendingResponse", "commitIndex", "log_len"):
            upd[f] = jset(d[f], i, 0)
        succ = self._asm(
            d, C, n, **upd,
            state=jset(d["state"], i, NOTMEMBER),
            votedFor=jset(d["votedFor"], i, NIL),
            nextIndex=jset(d["nextIndex"], i, self._row(1, dev)),
            matchIndex=jset(d["matchIndex"], i, self._row(0, dev)),
        )
        return valid, succ, self._rank(C, n, A_RESET_IDENTITY, dev), self._no(C, n, dev)

    # ---------------- the Next table ----------------

    def _config_bindings(self) -> list:
        return ([("AppendAddServerCommandToLog", ij) for ij in self._all_pairs]
                + [("AppendRemoveServerCommandToLog", ij) for ij in self._all_pairs])

    def _pre_msg_bindings(self) -> list:
        return [("ResetWithSameIdentity", (i,)) for i in range(self.p.n_servers)]

    def _variant_tables(self) -> dict:
        return {"ap_i": [ij[0] for ij in self._all_pairs],
                "ap_j": [ij[1] for ij in self._all_pairs]}

    def _config_outs(self, d, C, dev) -> list:
        i, s = self._idx("ap_i", dev), self._idx("ap_j", dev)
        return [self._append_member_cmd(d, i, s, C, dev, add=True),
                self._append_member_cmd(d, i, s, C, dev, add=False)]

    def _pre_msg_outs(self, d, C, dev) -> list:
        return [self._reset_with_same_identity(d, self._idx("iota_s", dev), C, dev)]

    # ---------------- invariants and liveness ----------------

    def _cfg_entries(self, states):
        """[B, S, L] mask of config commands inside each log."""
        lay = self.layout
        lanes = torch.arange(self.p.max_log, device=states.device)
        return self._is_cfg_cmd(lay.get(states, "log_cmd")) & (
            lanes < lay.get(states, "log_len")[..., None])

    def _live_reconfig_p(self, states):
        """ReconfigurationCompletes' antecedent — :992-996: some leader has
        a config command in its log."""
        st = self.layout.get(states, "state")
        return torch.any(((st == LEADER)[..., None] & self._cfg_entries(states)).flatten(1), dim=1)

    def _live_reconfig_q(self, states):
        """ReconfigurationCompletes' consequent — :998-1005: some leader has
        a config command that every member of that entry's member set holds
        identically at the same index."""
        lay, S, L = self.layout, self.p.n_servers, self.p.max_log
        dev = states.device
        st = lay.get(states, "state")
        ll = lay.get(states, "log_len")
        lanes = torch.arange(L, device=dev)
        eq = torch.ones((states.shape[0], S, S, L), dtype=torch.bool, device=dev)
        for name in ENTRY_FIELDS:
            f = lay.get(states, f"log_{name}")
            eq = eq & (f[:, :, None, :] == f[:, None, :, :])
        in_log_j = lanes < ll[:, None, :, None]  # [B, 1, S, L]
        member_j = _bit(lay.get(states, "log_cmembers")[:, :, None, :],
                        torch.arange(S, device=dev)[None, None, :, None])  # [B, i, j, L]
        complete = torch.all(~member_j | (in_log_j & eq), dim=2)  # [B, S, L]
        return torch.any(((st == LEADER)[..., None] & self._cfg_entries(states)
                          & complete).flatten(1), dim=1)

    def _inv_max_one_reconfig(self, states):
        """MaxOneReconfigurationAtATime — :1031-1039: no leader with two
        uncommitted config commands."""
        lay, L = self.layout, self.p.max_log
        lanes = torch.arange(1, L + 1, device=states.device)
        uncommitted = self._cfg_entries(states) & (
            lanes > lay.get(states, "commitIndex")[:, :, None])
        bad = (lay.get(states, "state") == LEADER) & (uncommitted.sum(2) >= 2)
        return ~torch.any(bad, dim=1)

    # ---------------- host-side decode/encode ----------------

    def _decode_entry(self, term, cmd, val, cid, cmem, cmembers):
        cmd_name = CMD_NAMES[int(cmd)]
        members = self._fs(cmembers)
        if cmd_name == "AppendCommand":
            return (cmd_name, int(term), int(val) - 1)
        if cmd_name == "InitClusterCommand":
            return (cmd_name, int(term), (int(cid), members))
        return (cmd_name, int(term), (int(cid), int(cmem) - 1, members))

    def _encode_entry(self, entry):
        cmd_name, term, val = entry
        cmd = {v: k for k, v in CMD_NAMES.items()}[cmd_name]
        if cmd == CMD_APPEND:
            return dict(term=term, cmd=cmd, val=val + 1, cid=0, cmem=0, cmembers=0)
        if cmd == CMD_INIT:
            return dict(term=term, cmd=cmd, val=0, cid=val[0], cmem=0,
                        cmembers=sum(1 << j for j in val[1]))
        return dict(term=term, cmd=cmd, val=0, cid=val[0], cmem=val[1] + 1,
                    cmembers=sum(1 << j for j in val[2]))

    def _decode_config(self, g):
        return tuple((int(g("config_id")[i]), self._fs(g("config_members")[i]),
                      bool(g("config_committed")[i])) for i in range(self.p.n_servers))

    def _encode_config(self, vec, st) -> None:
        lay = self.layout
        vec[lay.sl("config_id")] = [c[0] for c in st["config"]]
        vec[lay.sl("config_members")] = [sum(1 << j for j in c[1]) for c in st["config"]]
        vec[lay.sl("config_committed")] = [int(c[2]) for c in st["config"]]

