"""Batched PyTorch lowering of the machinery both reconfiguration Raft specs
share.

Counterpart of ``raft_tpu/models/config_common.py`` (the ``ConfigRaftCommon``
mixin); the TLA+ line citations are the reference's. As in
``models/kraft.py``, each action is one batched computation over a
``[C, n]`` grid (chunk states x the action's bindings), so every value —
the successor rows of disabled candidates included — is bit-identical to
``jax.vmap(_expand1)``. The reference indexes with traced server indices,
which JAX clamps on a read and drops on an out-of-range write; the
``jax_take``/``jax_set`` helpers of ``models/base.py`` keep those
semantics (a record's 2-bit ``mdest`` may name no server of three).

What the two specs share: the core Raft actions (Restart, RequestVote to
the member set, ClientRequest with the per-term value counter,
AppendEntries gated by membership and the snapshot sentinels, the fused
receipt of the eight message-triggered actions, AdvanceCommitIndex), the
snapshot pair (SendSnapshot embeds the sender's whole log in an N-word
WidePacker key), the invariants NoLogDivergence and
LeaderHasAllAckedValues over whole log entries, and the host
encode/decode. The variants (``models/reconfig_raft.py``,
``models/joint_raft.py``) supply their layouts, packers and hooks:

  ``_is_cfg_cmd``               which log commands carry a configuration;
  ``_config_updates_from_log``  the config fields an installed entry writes;
  ``_become_leader``            the quorum test of BecomeLeader;
  ``_commit_quorum_ok``, ``_commit_config_upd``, ``_commit_removed``
                                AdvanceCommitIndex's quorum, config
                                re-derivation and IsRemovedFromCluster;
  ``_config_bindings``/``_config_outs`` and ``_pre_msg_bindings``/
  ``_pre_msg_outs``             the variant's own actions in Next order.

``nextIndex`` carries the snapshot sentinels PENDING_SNAP_REQUEST = -1 and
PENDING_SNAP_RESPONSE = -2 in its lanes. Message keys are N int32 words
(``msg_w0`` .. ``msg_w{N-1}``, the ``msg_word`` layout kind), the bag
sorted lexicographically from word 0 (``ops/bag.py wide_bag_put``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bag
from ..ops.packing import EMPTY, WidePacker, bits_for
from .base import (
    ACK_FALSE,
    ACK_NIL,
    ACK_TRUE,
    INVARIANT_IDS,
    ActionLabelMixin,
    KernelModel,
    SparseExpandMixin,
    jax_set as jset,
    jax_set2 as jset2,
    jax_take as jtake,
    messages_are_valid_kernel,
    popcount,
    select as _sel,
)

# enums shared by both variants (the reference's config_common.py)
FOLLOWER, CANDIDATE, LEADER, NOTMEMBER = range(4)
NIL = 0
RVREQ, RVRESP, AEREQ, AERESP, SNAPREQ, SNAPRESP = 1, 2, 3, 4, 5, 6
MTYPE_NAMES = {
    RVREQ: "RequestVoteRequest",
    RVRESP: "RequestVoteResponse",
    AEREQ: "AppendEntriesRequest",
    AERESP: "AppendEntriesResponse",
    SNAPREQ: "SnapshotRequest",
    SNAPRESP: "SnapshotResponse",
}
# AppendEntries result codes (AddRemove :75; Ok = 1 so 0 = "field absent")
RC_OK, RC_STALE, RC_MISMATCH, RC_NEEDSNAP = 1, 2, 3, 4
RC_NAMES = {RC_OK: "Ok", RC_STALE: "StaleTerm", RC_MISMATCH: "EntryMismatch",
            RC_NEEDSNAP: "NeedSnapshot"}
PENDING_SNAP_REQUEST = -1  # JointConsensus :293 / AddRemove :271
PENDING_SNAP_RESPONSE = -2

# the Next-disjunct ranks both variants share (their Next orders put these
# at the same indices; asserted in the variant modules)
(
    R_RESTART,
    R_UPDATETERM,
    R_REQUESTVOTE,
    R_BECOMELEADER,
    R_HANDLE_RVREQ,
    R_HANDLE_RVRESP,
    R_CLIENTREQUEST,
    R_ADVANCECOMMIT,
    R_APPENDENTRIES,
    R_REJECT_AE,
    R_ACCEPT_AE,
    R_HANDLE_AERESP,
) = range(12)
R_SENDSNAP, R_HANDLE_SNAPREQ, R_HANDLE_SNAPRESP = 14, 15, 16

# ---- the kernels' view of a model (csrc/config_actions.cuh) ----
# The layout fields the kernels read, in the order of the CS_* enum of
# config_actions.cuh; "log_x0".."log_x2" are a variant's entry fields past
# (term, cmd, val, cid) and a field a variant lacks has offset -1.
SPEC_OFFSETS = (
    "config_id", "config_joint", "config_members", "config_old", "config_new",
    "config_committed", "currentTerm", "state", "votedFor", "votesGranted", "log_term",
    "log_cmd", "log_val", "log_cid", "log_x0", "log_x1", "log_x2", "log_len", "commitIndex",
    "nextIndex", "matchIndex", "pendingResponse", "msg_w0", "msg_cnt", "acked", "electionCtr",
    "restartCtr", "addReconfigCtr", "removeReconfigCtr", "reconfigCtr", "valueCtr",
)
SPEC_PARAMS = (
    "max_elections", "max_restarts", "max_values_per_term", "max_term", "max_add_reconfigs",
    "max_remove_reconfigs", "min_cluster_size", "max_cluster_size", "include_thesis_bug",
    "max_reconfigs",
)
SPEC_SCALARS = ("S", "V", "L", "M", "W", "A", "K", "NW", "NE") + SPEC_OFFSETS + SPEC_PARAMS
# message fields, each as (word, shift, mask) after the scalars (CF_*):
# the record fields, then the <= 1 entry e_* and the embedded log l{k}_*
# by entry slot (ENTRY_SLOTS slots per entry, MAX_LOG lanes; absent
# slots and lanes are (0, 0, 0) and never packed)
MSG_FIELDS = (
    "mtype", "mterm", "msource", "mdest", "mlastLogTerm", "mlastLogIndex", "mvoteGranted",
    "mprevLogIndex", "mprevLogTerm", "nentries", "mcommitIndex", "mresult", "mmatchIndex",
    "msuccess", "mloglen", "mmembers",
)
ENTRY_SLOTS = 7  # term, cmd, val, cid and up to three variant fields
MAX_LOG = 8  # csrc/config_actions.cuh CR_MAX_L
MAX_WORDS = 8  # csrc/config_actions.cuh CR_MAX_WORDS
SPEC_LEN = len(SPEC_SCALARS) + 3 * (len(MSG_FIELDS) + ENTRY_SLOTS * (1 + MAX_LOG))
# action groups (CG_* enum); a candidate row is (group, p0, p1, rank)
GROUP_IDS = {
    "Restart": 0, "RequestVote": 1, "BecomeLeader": 2, "ClientRequest": 3,
    "AdvanceCommitIndex": 4, "AppendEntries": 5, "SendSnapshot": 6, "HandleMessage": 7,
    "AppendAddServerCommandToLog": 8, "AppendRemoveServerCommandToLog": 9,
    "ResetWithSameIdentity": 10, "AppendOldNewConfigToLog": 11, "AppendNewConfigToLog": 12,
}
# the family's own predicates by kernel id after the shared invariants
# (the CR_* ids of config_actions.cuh): MaxOneReconfigurationAtATime and
# the antecedent and consequent of ReconfigurationCompletes
CONFIG_PRED_IDS = {"MaxOneReconfigurationAtATime": 5,
                   "ReconfigurationCompletes.P": 16, "ReconfigurationCompletes.Q": 17}


def _at(row, idx):
    """``row[..., idx]`` as JAX gathers on the last axis (clamped); the
    leading axes of ``row`` and ``idx`` broadcast."""
    lead = torch.broadcast_shapes(row.shape[:-1], idx.shape)
    idx = idx.clamp(0, row.shape[-1] - 1).to(torch.int64).expand(lead)
    return row.expand(lead + row.shape[-1:]).gather(-1, idx.unsqueeze(-1)).squeeze(-1)


def _set_at(row, idx, val):
    """``row.at[..., idx].set(val)`` on the last axis, idx in range."""
    lanes = torch.arange(row.shape[-1], device=row.device)
    return torch.where(lanes == idx.unsqueeze(-1), val.unsqueeze(-1), row)


def _bit(mask, j):
    """Bit j of a member-set bitmask, as a bool."""
    return ((mask >> j) & 1) > 0


def message_fields(p, entry_fields) -> list[tuple[str, int]]:
    """The record schema both variants pack (the entry fields differ)."""
    tb = bits_for(p.max_term)
    lb = bits_for(p.max_log + 1)
    return [
        ("mtype", 3), ("mterm", tb), ("msource", bits_for(p.n_servers - 1)),
        ("mdest", bits_for(p.n_servers - 1)),
        ("mlastLogTerm", tb), ("mlastLogIndex", lb),  # RequestVoteRequest (:437-442)
        ("mvoteGranted", 1),  # RequestVoteResponse (:465-470)
        ("mprevLogIndex", lb), ("mprevLogTerm", tb), ("nentries", 1),  # AppendEntries (:563-570)
        *[(f"e_{n}", w) for n, w in entry_fields],  # the <= 1 entry
        ("mcommitIndex", lb),  # also SnapshotRequest (:873)
        ("mresult", 3),  # AppendEntriesResponse (:685-691)
        ("mmatchIndex", lb),  # also SnapshotResponse (:900)
        ("msuccess", 1),  # SnapshotResponse (:897-902)
        ("mloglen", lb),  # SnapshotRequest's embedded log (:872)
        ("mmembers", p.n_servers),
        *[(f"l{k}_{n}", w) for k in range(p.max_log) for n, w in entry_fields],
    ]


def wide_packer(fields) -> WidePacker:
    """The narrowest WidePacker that holds ``fields`` (the reference's
    search from two words up)."""
    for n_words in range(2, 16):
        try:
            return WidePacker(fields, n_words)
        except ValueError:
            continue
    raise ValueError("message schema too wide")


class ConfigRaftCommon(KernelModel, SparseExpandMixin, ActionLabelMixin):
    """The batched shared actions, invariants and encode/decode of the two
    reconfiguration lowerings. Subclass contract: ``p``, ``layout``,
    ``packer`` (a WidePacker), ``n_words``, ``ENTRY_FIELDS``,
    ``CMD_APPEND``, ``CMD_SEED``, ``MEMBERS_FIELD``, ``ACTION_NAMES``,
    ``KERNELS``, ``counter_fields`` and the hooks of the module docstring;
    ``_finish_init`` at the end of the variant's ``__init__``."""

    ACTIONS_HEADER = "config_actions.cuh"
    GROUP_IDS = GROUP_IDS
    ENTRY_FIELDS: tuple[str, ...]
    CMD_APPEND: int
    CMD_SEED: int
    MEMBERS_FIELD: str
    counter_fields: tuple = ()
    _pack = KernelModel.pack_i32

    # ---------------- helpers ----------------

    def _words(self, d):
        return [d[f"msg_w{k}"] for k in range(self.n_words)]

    def _word_upd(self, words, cnt):
        upd = {f"msg_w{k}": w for k, w in enumerate(words)}
        upd["msg_cnt"] = cnt
        return upd

    def _last_term(self, d, i):
        """LastTerm — JointConsensus :252 / AddRemove :173."""
        ll = jtake(d["log_len"], i)
        return torch.where(ll > 0, _at(jtake(d["log_term"], i), ll - 1), 0)

    def _popcount(self, x):
        return popcount(x, self.p.n_servers)

    def _rank(self, C, n, r, dev):
        return self._full(C, n, r, torch.int32, dev)

    def _no(self, C, n, dev):
        return self._full(C, n, False, torch.bool, dev)

    def _row(self, val, dev):
        """A [1, 1, S] row of a constant (a whole per-server row written)."""
        return torch.full((1, 1, self.p.n_servers), val, dtype=torch.int32, device=dev)

    # ---------------- shared action kernels ----------------
    # Each returns (valid [C, n], succ [C, n, W], rank [C, n], ovf [C, n]).

    def _restart(self, d, i, C, dev):
        """Restart(i) — JointConsensus :362-374 / AddRemove :346-358: keeps
        config, currentTerm, votedFor and the log."""
        n = i.shape[1]
        valid = (d["restartCtr"] < self.p.max_restarts).expand(C, n)
        succ = self._asm(
            d, C, n,
            state=jset(d["state"], i, FOLLOWER),
            votesGranted=jset(d["votesGranted"], i, 0),
            nextIndex=jset(d["nextIndex"], i, self._row(1, dev)),
            matchIndex=jset(d["matchIndex"], i, self._row(0, dev)),
            pendingResponse=jset(d["pendingResponse"], i, 0),
            commitIndex=jset(d["commitIndex"], i, 0),
            restartCtr=d["restartCtr"] + 1,
        )
        return valid, succ, self._rank(C, n, R_RESTART, dev), self._no(C, n, dev)

    def _request_vote(self, d, i, C, dev):
        """RequestVote(i) — JointConsensus :431-450 / AddRemove :425-444:
        member-only; a RequestVoteRequest to each member via
        SendMultipleOnce."""
        p, S = self.p, self.p.n_servers
        n = i.shape[1]
        st_i = jtake(d["state"], i)
        members = jtake(d["config_members"], i)
        valid = ((d["electionCtr"] < p.max_elections) & ((st_i == FOLLOWER) | (st_i == CANDIDATE))
                 & _bit(members, i))
        new_term = jtake(d["currentTerm"], i) + 1
        last_t = self._last_term(d, i)
        ll_i = jtake(d["log_len"], i)
        words, cnt = self._words(d), d["msg_cnt"]
        ovf = self._no(C, n, dev)
        for delta in range(1, S):
            j = torch.remainder(i + delta, S)
            is_member = _bit(members, j)
            key = self._pack(mtype=RVREQ, mterm=new_term, mlastLogTerm=last_t,
                             mlastLogIndex=ll_i, msource=i, mdest=j)
            w2, c2, existed, o = bag.wide_bag_put(words, cnt, key)
            valid = valid & (~is_member | ~existed)
            ovf = ovf | (is_member & o)
            m = is_member.unsqueeze(-1)
            words = [torch.where(m, a, b) for a, b in zip(w2, words)]
            cnt = torch.where(m, c2, cnt)
        succ = self._asm(
            d, C, n,
            state=jset(d["state"], i, CANDIDATE),
            currentTerm=jset(d["currentTerm"], i, new_term),
            votedFor=jset(d["votedFor"], i, i + 1),
            votesGranted=jset(d["votesGranted"], i, torch.ones_like(i) << i),
            electionCtr=d["electionCtr"] + 1,
            **self._word_upd(words, cnt),
        )
        return valid, succ, self._rank(C, n, R_REQUESTVOTE, dev), ovf & valid

    def _client_request(self, d, i, v, C, dev):
        """ClientRequest(i, v) — JointConsensus :535-550 / AddRemove
        :525-540 (the acked gate and the per-term value counter)."""
        p, L = self.p, self.p.max_log
        n = i.shape[1]
        term = jtake(d["currentTerm"], i)
        tpos = torch.clamp(term - 1, 0, p.max_term - 1)
        valid = ((jtake(d["state"], i) == LEADER) & (jtake(d["acked"], v) == ACK_NIL)
                 & (jtake(d["valueCtr"], tpos) < p.max_values_per_term))
        pos = jtake(d["log_len"], i)
        ovf = valid & (pos >= L)
        posc = torch.clamp(pos, 0, L - 1)
        succ = self._asm(
            d, C, n,
            log_term=jset2(d["log_term"], i, posc, term),
            log_cmd=jset2(d["log_cmd"], i, posc, self.CMD_APPEND),
            log_val=jset2(d["log_val"], i, posc, (v + 1).expand(C, n)),
            log_len=jset(d["log_len"], i, pos + 1),
            acked=jset(d["acked"], v, ACK_FALSE),
            valueCtr=jset(d["valueCtr"], tpos, jtake(d["valueCtr"], tpos) + 1),
        )
        return valid, succ, self._rank(C, n, R_CLIENTREQUEST, dev), ovf

    def _append_entries(self, d, i, j, C, dev):
        """AppendEntries(i, j) — JointConsensus :556-582 / AddRemove
        :546-572: member- and snapshot-sentinel-gated; an empty request
        is send-once."""
        L = self.p.max_log
        n = i.shape[1]
        ni_ij = _at(jtake(d["nextIndex"], i), j)
        pr_i = jtake(d["pendingResponse"], i)
        valid = ((jtake(d["state"], i) == LEADER) & _bit(jtake(d["config_members"], i), j)
                 & (ni_ij >= 0) & ~_bit(pr_i, j))
        prev_idx = ni_ij - 1
        lt_i = jtake(d["log_term"], i)
        prev_term = torch.where(prev_idx > 0, _at(lt_i, torch.clamp(prev_idx - 1, 0, L - 1)), 0)
        last_entry = torch.minimum(jtake(d["log_len"], i), ni_ij)
        nent = (last_entry >= ni_ij).to(torch.int32)
        epos = torch.clamp(ni_ij - 1, 0, L - 1)
        kw = dict(
            mtype=AEREQ, mterm=jtake(d["currentTerm"], i), mprevLogIndex=prev_idx.clamp(min=0),
            mprevLogTerm=prev_term, nentries=nent,
            mcommitIndex=torch.minimum(jtake(d["commitIndex"], i), last_entry).clamp(min=0),
            msource=i, mdest=j)
        for name in self.ENTRY_FIELDS:
            kw[f"e_{name}"] = torch.where(nent > 0, _at(jtake(d[f"log_{name}"], i), epos), 0)
        words, cnt, existed, ovf = bag.wide_bag_put(self._words(d), d["msg_cnt"],
                                                    self._pack(**kw))
        valid = valid & ((nent > 0) | ~existed)
        succ = self._asm(
            d, C, n,
            pendingResponse=jset(d["pendingResponse"], i, pr_i | (torch.ones_like(j) << j)),
            **self._word_upd(words, cnt),
        )
        return valid, succ, self._rank(C, n, R_APPENDENTRIES, dev), ovf & valid

    def _send_snapshot(self, d, i, j, C, dev):
        """SendSnapshot(i, j) — JointConsensus :885-901 / AddRemove
        :862-878: embeds the whole log in the request, lanes past the
        log's length zeroed."""
        L = self.p.max_log
        n = i.shape[1]
        members = jtake(d["config_members"], i)
        valid = ((jtake(d["state"], i) == LEADER) & _bit(members, j)
                 & (_at(jtake(d["nextIndex"], i), j) == PENDING_SNAP_REQUEST))
        ll_i = jtake(d["log_len"], i)
        kw = dict(mtype=SNAPREQ, mterm=jtake(d["currentTerm"], i),
                  mcommitIndex=jtake(d["commitIndex"], i), mmembers=members, mloglen=ll_i,
                  msource=i, mdest=j)
        live = torch.arange(L, device=dev) < ll_i.unsqueeze(-1)
        for name in self.ENTRY_FIELDS:
            row = torch.where(live, jtake(d[f"log_{name}"], i), 0)
            for k in range(L):
                kw[f"l{k}_{name}"] = row[..., k]
        words, cnt, _existed, ovf = bag.wide_bag_put(self._words(d), d["msg_cnt"],
                                                     self._pack(**kw))
        succ = self._asm(
            d, C, n,
            nextIndex=jset2(d["nextIndex"], i, j, PENDING_SNAP_RESPONSE),
            **self._word_upd(words, cnt),
        )
        return valid, succ, self._rank(C, n, R_SENDSNAP, dev), ovf & valid

    def _advance_commit_index(self, d, i, C, dev):
        """AdvanceCommitIndex(i) — JointConsensus :613-653 (dual quorum) /
        AddRemove :605-642 (member quorum): the quorum, the config
        re-derivation and IsRemovedFromCluster are the variant's hooks."""
        L, V = self.p.max_log, self.p.n_values
        n = i.shape[1]
        ll_i = jtake(d["log_len"], i)
        ci_i = jtake(d["commitIndex"], i)
        idxs = torch.arange(1, L + 1, device=dev)
        quorum_ok = self._commit_quorum_ok(d, i, idxs, jtake(d["matchIndex"], i))
        is_agree = quorum_ok & (idxs <= ll_i.unsqueeze(-1))
        max_agree = torch.where(is_agree, idxs, 0).max(-1).values
        term_at = _at(jtake(d["log_term"], i), max_agree - 1)
        new_ci = torch.where((max_agree > 0) & (term_at == jtake(d["currentTerm"], i)),
                             max_agree, ci_i)
        valid = (jtake(d["state"], i) == LEADER) & (ci_i < new_ci)
        lanes = torch.arange(1, L + 1, device=dev)
        in_range = (lanes > ci_i.unsqueeze(-1)) & (lanes <= new_ci.unsqueeze(-1))
        # MayBeAckClient: only AppendCommand entries can ack a value
        vals_row = torch.where(jtake(d["log_cmd"], i) == self.CMD_APPEND,
                               jtake(d["log_val"], i), 0)
        committed = torch.any(
            in_range.unsqueeze(-2)
            & (vals_row.unsqueeze(-2) == torch.arange(1, V + 1, device=dev)[:, None]), dim=-1)
        upd = self._commit_config_upd(d, i, new_ci)
        upd["acked"] = torch.where((d["acked"] == ACK_FALSE) & committed, ACK_TRUE, d["acked"])
        removed = self._commit_removed(d, i, in_range)
        upd["state"] = _sel(removed, jset(d["state"], i, NOTMEMBER), d["state"])
        upd["votesGranted"] = _sel(removed, jset(d["votesGranted"], i, 0), d["votesGranted"])
        upd["nextIndex"] = _sel(removed, jset(d["nextIndex"], i, self._row(1, dev)),
                                d["nextIndex"])
        upd["matchIndex"] = _sel(removed, jset(d["matchIndex"], i, self._row(0, dev)),
                                 d["matchIndex"])
        upd["commitIndex"] = _sel(removed, jset(d["commitIndex"], i, 0),
                                  jset(d["commitIndex"], i, new_ci))
        succ = self._asm(d, C, n, **upd)
        return valid, succ, self._rank(C, n, R_ADVANCECOMMIT, dev), self._no(C, n, dev)

    # -------- the fused receipt kernel (all M slots at once) --------
    # The eight message-triggered actions (UpdateTerm, Handle{RequestVote,
    # AppendEntries,Snapshot}{Request,Response}, Reject/Accept
    # AppendEntries; JointConsensus :410-944 / AddRemove :404-921) are
    # pairwise disjoint for a record (mtype, term, state and result-code
    # guards), so the incoming Discard and the response's Send collapse
    # into one put of the branch's response, and each field takes the
    # value of whichever branch fired.

    def _handle_message(self, d, C, dev):
        p, packer = self.p, self.packer
        L, M = p.max_log, p.msg_slots
        m = self._idx("iota_m", dev)
        words, cnt = self._words(d), d["msg_cnt"]  # [C, 1, M]
        key = [w[:, 0] for w in words]  # slot m = binding m
        kcnt = cnt[:, 0]

        def u(name):
            return packer.unpack(key, name)

        mtype, mterm = u("mtype"), u("mterm")
        src, dst = u("msource"), u("mdest")
        cur = jtake(d["currentTerm"], dst)
        st_dst = jtake(d["state"], dst)
        member_dst = _bit(jtake(d["config_members"], dst), dst)
        occupied = key[0] != EMPTY
        recv = occupied & (kcnt > 0)
        le_term = mterm <= cur
        eq_term = mterm == cur
        cnt_disc = bag.bag_discard_at(cnt, m)
        lanes = torch.arange(L, device=dev)

        # --- UpdateTerm (the count may be 0)
        b_upd = occupied & (mterm > cur)

        # --- HandleRequestVoteRequest
        last_t = self._last_term(d, dst)
        ll_dst = jtake(d["log_len"], dst)
        mllt = u("mlastLogTerm")
        rv_logok = (mllt > last_t) | ((mllt == last_t) & (u("mlastLogIndex") >= ll_dst))
        vf_dst = jtake(d["votedFor"], dst)
        grant = eq_term & rv_logok & ((vf_dst == NIL) | (vf_dst == src + 1))
        b_rvreq = recv & (mtype == RVREQ) & le_term
        rv_key = self._pack(mtype=RVRESP, mterm=cur, mvoteGranted=grant.to(torch.int32),
                            msource=dst, mdest=src)

        # --- HandleRequestVoteResponse
        b_rvresp = recv & (mtype == RVRESP) & eq_term & (st_dst == CANDIDATE)
        vgs = d["votesGranted"]
        vg = _sel(u("mvoteGranted") > 0,
                  jset(vgs, dst, jtake(vgs, dst) | (torch.ones_like(src) << src)), vgs)

        # --- AppendEntries request handling: LogOk (strict empty-entries
        # arm) and the result-code CASE
        prev_idx, prev_term, nent = u("mprevLogIndex"), u("mprevLogTerm"), u("nentries")
        at_prev = _at(jtake(d["log_term"], dst), torch.clamp(prev_idx - 1, 0, L - 1))
        ae_logok = torch.where(
            nent > 0,
            (prev_idx > 0) & (prev_idx <= ll_dst) & (prev_term == at_prev),
            (prev_idx == ll_dst) & (prev_idx > 0) & (prev_term == at_prev))
        rc = torch.where(mterm < cur, RC_STALE, torch.where(
            ~member_dst, RC_NEEDSNAP,
            torch.where(eq_term & (st_dst == FOLLOWER) & ~ae_logok, RC_MISMATCH, RC_OK)))
        # RejectAppendEntriesRequest
        b_reject = recv & (mtype == AEREQ) & le_term & (rc != RC_OK)
        rj_key = self._pack(mtype=AERESP, mterm=cur, mresult=rc, mmatchIndex=0, msource=dst,
                            mdest=src)
        # AcceptAppendEntriesRequest
        b_accept = (recv & (mtype == AEREQ) & eq_term
                    & ((st_dst == FOLLOWER) | (st_dst == CANDIDATE)) & ae_logok & member_dst)
        appending = (nent != 0) & ((ll_dst == prev_idx) | (ll_dst >= prev_idx + 1))
        new_ll = torch.where(appending, prev_idx + 1, ll_dst)
        keep = lanes < prev_idx.unsqueeze(-1)
        app_pos = torch.clamp(prev_idx, 0, L - 1)
        new_logs = {}
        for name in self.ENTRY_FIELDS:
            row = jtake(d[f"log_{name}"], dst)
            nrow = _set_at(torch.where(keep, row, 0), app_pos,
                           torch.where(appending, u(f"e_{name}"), 0))
            new_logs[name] = torch.where(appending.unsqueeze(-1), nrow, row)
        cfg_mask = (lanes < new_ll.unsqueeze(-1)) & self._is_cfg_cmd(new_logs["cmd"])
        cfg_idx = torch.where(cfg_mask, lanes + 1, 0).max(-1).values
        mci = u("mcommitIndex")
        cfg_upd, in_new = self._config_updates_from_log(
            d, dst, new_logs, (cfg_idx - 1).clamp(min=0), cfg_idx, mci)
        ac_ovf = b_accept & appending & (prev_idx >= L)
        ac_key = self._pack(mtype=AERESP, mterm=cur, mresult=RC_OK, mmatchIndex=prev_idx + nent,
                            msource=dst, mdest=src)

        # --- HandleAppendEntriesResponse
        b_aeresp = recv & (mtype == AERESP) & eq_term & (st_dst == LEADER)
        res, mmatch = u("mresult"), u("mmatchIndex")
        ni_cur = _at(jtake(d["nextIndex"], dst), src)
        ni_new = torch.where(res == RC_OK, mmatch + 1, torch.where(
            res == RC_MISMATCH, torch.clamp(ni_cur - 1, min=1),
            torch.where(res == RC_NEEDSNAP, PENDING_SNAP_REQUEST, ni_cur)))

        # --- HandleSnapshotRequest
        b_snapreq = recv & (mtype == SNAPREQ) & eq_term & (st_dst == FOLLOWER)
        sn_ll = u("mloglen")
        sn_logs = {name: torch.stack([u(f"l{k}_{name}") for k in range(L)], dim=-1)
                   for name in self.ENTRY_FIELDS}
        sn_mask = (lanes < sn_ll.unsqueeze(-1)) & self._is_cfg_cmd(sn_logs["cmd"])
        sn_idx = torch.where(sn_mask, lanes + 1, 0).max(-1).values
        sn_cfg_upd, _sn_in_new = self._config_updates_from_log(
            d, dst, sn_logs, (sn_idx - 1).clamp(min=0), sn_idx, mci)
        sq_key = self._pack(mtype=SNAPRESP, mterm=cur, msuccess=1, mmatchIndex=sn_ll,
                            msource=dst, mdest=src)

        # --- HandleSnapshotResponse
        b_snapresp = recv & (mtype == SNAPRESP) & eq_term & (ni_cur == PENDING_SNAP_RESPONSE)

        # --- the shared Reply: the branch's response put once
        resp = [torch.where(b_rvreq, kr, torch.where(b_reject, kj, torch.where(b_accept, ka, kq)))
                for kr, kj, ka, kq in zip(rv_key, rj_key, ac_key, sq_key)]
        pw, pc, _ex, povf = bag.wide_bag_put(words, cnt_disc, resp)
        putb = b_rvreq | b_reject | b_accept | b_snapreq
        dropb = b_rvresp | b_aeresp | b_snapresp  # Discard only

        # --- the per-field combination (disjoint branches)
        ct, st, vf = d["currentTerm"], d["state"], d["votedFor"]
        ci, ll, ni, mi = d["commitIndex"], d["log_len"], d["nextIndex"], d["matchIndex"]
        pr = d["pendingResponse"]
        mm = u("mmatchIndex")
        upd = dict(
            currentTerm=_sel(b_upd, jset(ct, dst, mterm), ct),
            state=_sel(b_upd, jset(st, dst, FOLLOWER), _sel(
                b_accept, jset(st, dst, torch.where(in_new, FOLLOWER, NOTMEMBER)), st)),
            votedFor=_sel(b_upd, jset(vf, dst, NIL),
                          _sel(b_rvreq & grant, jset(vf, dst, src + 1), vf)),
            votesGranted=_sel(b_rvresp, vg, vgs),
            commitIndex=_sel(b_accept, jset(ci, dst, mci),
                             _sel(b_snapreq, jset(ci, dst, mci), ci)),
            log_len=_sel(b_accept, jset(ll, dst, new_ll), _sel(b_snapreq, jset(ll, dst, sn_ll), ll)),
            nextIndex=_sel(b_aeresp, jset2(ni, dst, src, ni_new),
                           _sel(b_snapresp, jset2(ni, dst, src, mm + 1), ni)),
            matchIndex=_sel(b_aeresp & (res == RC_OK), jset2(mi, dst, src, mmatch),
                            _sel(b_snapresp, jset2(mi, dst, src, mm), mi)),
            pendingResponse=_sel(
                b_aeresp, jset(pr, dst, jtake(pr, dst) & ~(torch.ones_like(src) << src)), pr),
            msg_cnt=_sel(putb, pc, _sel(dropb, cnt_disc, cnt)),
        )
        for k, w in enumerate(pw):
            upd[f"msg_w{k}"] = _sel(putb, w, words[k])
        for name in self.ENTRY_FIELDS:
            f = d[f"log_{name}"]
            upd[f"log_{name}"] = _sel(b_accept, jset(f, dst, new_logs[name]),
                                      _sel(b_snapreq, jset(f, dst, sn_logs[name]), f))
        for k in cfg_upd:
            upd[k] = _sel(b_accept, cfg_upd[k], _sel(b_snapreq, sn_cfg_upd[k], d[k]))
        succ = self._asm(d, C, M, **upd)

        false = torch.zeros_like(b_upd)
        branches = [
            (b_upd, R_UPDATETERM, false),
            (b_rvreq, R_HANDLE_RVREQ, povf),
            (b_rvresp, R_HANDLE_RVRESP, false),
            (b_reject, R_REJECT_AE, povf),
            (b_accept, R_ACCEPT_AE, povf | ac_ovf),
            (b_aeresp, R_HANDLE_AERESP, false),
            (b_snapreq, R_HANDLE_SNAPREQ, povf),
            (b_snapresp, R_HANDLE_SNAPRESP, false),
        ]
        valid = false
        rank = self._full(C, M, -1, torch.int32, dev)
        ovf = false
        for b, rk, ob in branches:
            valid = valid | b
            rank = torch.where(b, rk, rank)
            ovf = ovf | (b & ob)
        return valid, succ, rank, ovf

    # ---------------- the Next table and the expansion ----------------

    def _finish_init(self) -> None:
        """Bindings, invariants and liveness (the end of the variant's
        ``__init__``, after its layout, packer and hook state exist). The
        bindings follow the reference's order: Restart, RequestVote,
        BecomeLeader, ClientRequest, AdvanceCommitIndex, AppendEntries,
        the variant's config actions, SendSnapshot, the variant's
        pre-message actions, HandleMessage."""
        p = self.p
        S, V, M = p.n_servers, p.n_values, p.msg_slots
        self._pairs = [(i, j) for i in range(S) for j in range(S) if i != j]
        b: list = []
        for name in ("Restart", "RequestVote", "BecomeLeader"):
            b += [(name, (i,)) for i in range(S)]
        b += [("ClientRequest", (i, v)) for i in range(S) for v in range(V)]
        b += [("AdvanceCommitIndex", (i,)) for i in range(S)]
        b += [("AppendEntries", ij) for ij in self._pairs]
        b += self._config_bindings()
        b += [("SendSnapshot", ij) for ij in self._pairs]
        b += self._pre_msg_bindings()
        b += [("HandleMessage", (m,)) for m in range(M)]
        self.bindings = b
        self.A = len(b)
        self._consts: dict = {}
        self.invariants = {
            "MessagesAreValid": messages_are_valid_kernel(self.layout, self.packer),
            "NoLogDivergence": self._inv_no_log_divergence,
            "MaxOneReconfigurationAtATime": self._inv_max_one_reconfig,
            "LeaderHasAllAckedValues": self._inv_leader_has_acked,
            "CommittedEntriesReachMajority": self._inv_committed_majority,
            "TestInv": lambda s: torch.ones(s.shape[:-1], dtype=torch.bool, device=s.device),
        }
        self._pred_ids = dict(INVARIANT_IDS) | CONFIG_PRED_IDS
        # ReconfigurationCompletes (JointConsensus :1039-1054 with the
        # last-election-failed carve-out; AddRemove :990-1005, run with
        # MaxElections = 0 as the spec says): P ~> Q under WF_vars(Next)
        self.predicates = {"ReconfigurationCompletes.P": self._live_reconfig_p,
                           "ReconfigurationCompletes.Q": self._live_reconfig_q}
        self.liveness = {"ReconfigurationCompletes": [
            ("", "ReconfigurationCompletes.P", "ReconfigurationCompletes.Q")]}

    def _bind_tables(self) -> dict:
        S, V, M = self.p.n_servers, self.p.n_values, self.p.msg_slots
        return {
            "iota_s": list(range(S)),
            "pr_i": [ij[0] for ij in self._pairs],
            "pr_j": [ij[1] for ij in self._pairs],
            "cr_i": [i for i in range(S) for _ in range(V)],
            "cr_v": [v for _ in range(S) for v in range(V)],
            "iota_m": list(range(M)),
            **self._variant_tables(),
        }

    def _config_bindings(self) -> list:
        raise NotImplementedError

    def _pre_msg_bindings(self) -> list:
        return []

    def _config_outs(self, d, C, dev) -> list:
        raise NotImplementedError

    def _pre_msg_outs(self, d, C, dev) -> list:
        return []

    def _variant_tables(self) -> dict:
        return {}

    def expand(self, states: torch.Tensor):
        """All successor candidates of a [C, W] int32 state batch, in the
        bindings' order: (succs [C, A, W] int32, valid [C, A] bool, rank
        [C, A] int32, ovf [C, A] bool) — ``jax.vmap(_expand1)`` of the
        reference (``raft_tpu/models/config_common.py:702``)."""
        C = states.shape[0]
        dev = states.device
        d = self._dec(states)
        I = lambda name: self._idx(name, dev)  # noqa: E731
        outs = [
            self._restart(d, I("iota_s"), C, dev),
            self._request_vote(d, I("iota_s"), C, dev),
            self._become_leader(d, I("iota_s"), C, dev),
            self._client_request(d, I("cr_i"), I("cr_v"), C, dev),
            self._advance_commit_index(d, I("iota_s"), C, dev),
            self._append_entries(d, I("pr_i"), I("pr_j"), C, dev),
            *self._config_outs(d, C, dev),
            self._send_snapshot(d, I("pr_i"), I("pr_j"), C, dev),
            *self._pre_msg_outs(d, C, dev),
            self._handle_message(d, C, dev),
        ]
        valid = torch.cat([o[0] for o in outs], dim=1)
        succs = torch.cat([o[1] for o in outs], dim=1)
        rank = torch.cat([o[2].to(torch.int32) for o in outs], dim=1)
        ovf = torch.cat([o[3] for o in outs], dim=1)
        return succs, valid, rank, ovf

    # ---------------- shared invariants ----------------

    def _inv_no_log_divergence(self, states):
        """NoLogDivergence — JointConsensus :1066-1074 / AddRemove
        :1017-1025 (whole-entry equality over every entry lane)."""
        lay, L = self.layout, self.p.max_log
        ci = lay.get(states, "commitIndex")
        mci = torch.minimum(ci[:, :, None], ci[:, None, :])
        lanes = torch.arange(1, L + 1, device=states.device)
        in_common = lanes <= mci[..., None]
        eq = torch.ones_like(in_common)
        for name in self.ENTRY_FIELDS:
            f = lay.get(states, f"log_{name}")
            eq = eq & (f[:, :, None, :] == f[:, None, :, :])
        return torch.all((~in_common | eq).flatten(1), dim=1)

    def _inv_leader_has_acked(self, states):
        """LeaderHasAllAckedValues — JointConsensus :1109-1125 / AddRemove
        :1047-1063 (AppendCommand entries only)."""
        lay, V = self.layout, self.p.n_values
        ct = lay.get(states, "currentTerm")
        st = lay.get(states, "state")
        lv = torch.where(lay.get(states, "log_cmd") == self.CMD_APPEND,
                         lay.get(states, "log_val"), 0)
        acked = lay.get(states, "acked")
        not_stale = torch.all(ct[:, :, None] >= ct[:, None, :], dim=2)
        is_lead = (st == LEADER) & not_stale
        vals = torch.arange(1, V + 1, device=states.device)
        has_v = torch.any(lv[:, :, None, :] == vals[None, None, :, None], dim=3)
        bad = (acked[:, None, :] == ACK_TRUE) & is_lead[:, :, None] & ~has_v
        return ~bad.flatten(1).any(dim=1)

    def _inv_committed_majority(self, states):
        """CommittedEntriesReachMajority — AddRemove :1067-1078 /
        JointConsensus :1129-1140: the quorum drawn from config[i].members,
        of the exact majority size, with i in it."""
        lay, S, L = self.layout, self.p.n_servers, self.p.max_log
        st = lay.get(states, "state")
        ci = lay.get(states, "commitIndex")
        ll = lay.get(states, "log_len")
        members = lay.get(states, "config_members")
        B = states.shape[0]
        lead = (st == LEADER) & (ci > 0)
        pos = torch.clamp(ci - 1, 0, L - 1).to(torch.int64)
        match = torch.ones((B, S, S), dtype=torch.bool, device=states.device)
        for name in self.ENTRY_FIELDS:
            f = lay.get(states, f"log_{name}")  # [B, S, L]
            fi = torch.gather(f, 2, pos[:, :, None])[:, :, 0]
            fj = torch.gather(f[:, None].expand(B, S, S, L), 3,
                              pos[:, :, None, None].expand(B, S, S, 1))[..., 0]
            match = match & (fj == fi[..., None])
        match = match & (ll[:, None, :] >= ci[:, :, None])
        ks = torch.arange(S, device=states.device)
        member_j = _bit(members[:, :, None], ks)  # [B, i, j]
        agree = match & member_j
        n_members = member_j.sum(2)
        self_in = torch.any(agree & torch.eye(S, dtype=torch.bool, device=states.device), dim=2)
        enough = (agree.sum(2) >= n_members // 2 + 1) & self_in
        return ~torch.any(lead, dim=1) | torch.any(lead & enough, dim=1)

    # ---------------- the kernels' spec ----------------

    def _spec_vector(self) -> list[int]:
        """The int32 spec vector of csrc/config_actions.cuh: SPEC_SCALARS,
        then (word, shift, mask) of each of MSG_FIELDS, of the entry
        fields e_* by slot and of the embedded log's l{k}_* by lane and
        slot."""
        p, lay = self.p, self.layout
        if p.max_log > MAX_LOG or self.n_words > MAX_WORDS:
            raise NotImplementedError(
                f"the kernels take logs of at most {MAX_LOG} entries and keys of at most "
                f"{MAX_WORDS} words (got {p.max_log} and {self.n_words})")
        xs = {f"log_x{k}": f"log_{name}" for k, name in enumerate(self.ENTRY_FIELDS[4:])}
        off = {n: lay.fields[xs.get(n, n)].offset if xs.get(n, n) in lay.fields else -1
               for n in SPEC_OFFSETS}
        params = {n: int(getattr(p, n, 0)) for n in SPEC_PARAMS}
        vals = dict(S=p.n_servers, V=p.n_values, L=p.max_log, M=p.msg_slots, W=lay.W,
                    A=self.A, K=len(self.ACTION_NAMES), NW=self.n_words,
                    NE=len(self.ENTRY_FIELDS), **off, **params)
        spec = [int(vals[n]) for n in SPEC_SCALARS]
        for name in MSG_FIELDS:
            spec += list(self.packer.locate(name))
        for prefix in ["e_"] + [f"l{k}_" for k in range(MAX_LOG)]:
            for slot in range(ENTRY_SLOTS):
                name = (prefix + self.ENTRY_FIELDS[slot]
                        if slot < len(self.ENTRY_FIELDS) else None)
                spec += list(self.packer.locate(name)) if name in self.packer.fields else [0] * 3
        assert len(spec) == SPEC_LEN
        return spec

    # ---------------- initial states ----------------

    def init_states(self) -> np.ndarray:
        """Init — the pre-installed cluster seeded with its configuration
        command (JointConsensus :341-354 / AddRemove :324-338); CHOOSE
        realized as the lowest indices."""
        p = self.p
        S = p.n_servers
        lay = self.layout
        vec = lay.zeros((1,))
        members = list(range(p.init_cluster_size))
        mask = sum(1 << i for i in members)
        leader = 0
        vec[0, lay.sl("config_id")] = [1 if i in members else 0 for i in range(S)]
        vec[0, lay.sl("config_members")] = [mask if i in members else 0 for i in range(S)]
        vec[0, lay.sl("config_committed")] = [1 if i in members else 0 for i in range(S)]
        vec[0, lay.sl("currentTerm")] = [1 if i in members else 0 for i in range(S)]
        vec[0, lay.sl("state")] = [
            LEADER if i == leader else FOLLOWER if i in members else NOTMEMBER for i in range(S)]
        ni = np.ones((S, S), np.int32)
        mi = np.zeros((S, S), np.int32)
        for j in members:
            ni[leader, j] = 2
            mi[leader, j] = 1
        vec[0, lay.sl("nextIndex")] = ni.reshape(-1)
        vec[0, lay.sl("matchIndex")] = mi.reshape(-1)
        rows = {n: np.zeros((S, p.max_log), np.int32)
                for n in ("term", "cmd", "cid", self.MEMBERS_FIELD)}
        for i in members:
            rows["term"][i, 0] = 1
            rows["cmd"][i, 0] = self.CMD_SEED
            rows["cid"][i, 0] = 1
            rows[self.MEMBERS_FIELD][i, 0] = mask
        for n, r in rows.items():
            vec[0, lay.sl(f"log_{n}")] = r.reshape(-1)
        vec[0, lay.sl("log_len")] = [1 if i in members else 0 for i in range(S)]
        vec[0, lay.sl("commitIndex")] = [1 if i in members else 0 for i in range(S)]
        for k in range(self.n_words):
            vec[0, lay.sl(f"msg_w{k}")] = EMPTY
        vec[0, lay.sl("acked")] = ACK_NIL
        return vec

    # ---------------- host-side decode/encode ----------------

    def _fs(self, mask) -> frozenset:
        return frozenset(j for j in range(self.p.n_servers) if (int(mask) >> j) & 1)

    def decode(self, vec: np.ndarray) -> dict:
        """One packed state in the canonical python form of the reference's
        oracles."""
        lay, p = self.layout, self.p
        vec = np.asarray(vec)
        g = lambda n: vec[lay.sl(n)]  # noqa: E731
        S, L = p.n_servers, p.max_log
        EF = self.ENTRY_FIELDS
        rows = {n: g(f"log_{n}").reshape(S, L) for n in EF}
        ll = g("log_len")
        log = tuple(
            tuple(self._decode_entry(*(rows[n][i, k] for n in EF)) for k in range(int(ll[i])))
            for i in range(S))
        vg = g("votesGranted")
        pr = g("pendingResponse")
        msgs = {}
        word_arrs = [g(f"msg_w{k}") for k in range(self.n_words)]
        cnt = g("msg_cnt")
        for k in range(p.msg_slots):
            if int(word_arrs[0][k]) == EMPTY:
                continue
            msgs[self.decode_msg(tuple(int(w[k]) for w in word_arrs))] = int(cnt[k])
        out = {
            "config": self._decode_config(g),
            "currentTerm": tuple(int(x) for x in g("currentTerm")),
            "state": tuple(int(x) for x in g("state")),
            "votedFor": tuple(int(x) - 1 if x > 0 else None for x in g("votedFor")),
            "votesGranted": tuple(self._fs(vg[i]) for i in range(S)),
            "nextIndex": tuple(tuple(int(x) for x in row)
                               for row in g("nextIndex").reshape(S, S)),
            "matchIndex": tuple(tuple(int(x) for x in row)
                                for row in g("matchIndex").reshape(S, S)),
            "pendingResponse": tuple(tuple(bool((int(pr[i]) >> j) & 1) for j in range(S))
                                     for i in range(S)),
            "log": log,
            "commitIndex": tuple(int(x) for x in g("commitIndex")),
            "messages": frozenset(msgs.items()),
            "acked": tuple({ACK_NIL: None, ACK_FALSE: False, ACK_TRUE: True}[int(x)]
                           for x in g("acked")),
            "electionCtr": int(vec[lay.fields["electionCtr"].offset]),
            "restartCtr": int(vec[lay.fields["restartCtr"].offset]),
        }
        for cname in self.counter_fields:
            out[cname] = int(vec[lay.fields[cname].offset])
        out["valueCtr"] = tuple(int(x) for x in g("valueCtr"))
        return out

    def decode_msg(self, key: tuple) -> tuple:
        """Packed key words -> canonical record tuple (sorted (field,
        value))."""
        u = self.packer.unpack_all(key)
        EF = self.ENTRY_FIELDS
        mtype = int(u["mtype"])
        rec = {"mtype": MTYPE_NAMES[mtype], "mterm": int(u["mterm"]),
               "msource": int(u["msource"]), "mdest": int(u["mdest"])}
        if mtype == RVREQ:
            rec["mlastLogTerm"] = int(u["mlastLogTerm"])
            rec["mlastLogIndex"] = int(u["mlastLogIndex"])
        elif mtype == RVRESP:
            rec["mvoteGranted"] = bool(u["mvoteGranted"])
        elif mtype == AEREQ:
            rec["mprevLogIndex"] = int(u["mprevLogIndex"])
            rec["mprevLogTerm"] = int(u["mprevLogTerm"])
            rec["mentries"] = ((self._decode_entry(*(u[f"e_{n}"] for n in EF)),)
                               if u["nentries"] else ())
            rec["mcommitIndex"] = int(u["mcommitIndex"])
        elif mtype == AERESP:
            rec["mresult"] = RC_NAMES[int(u["mresult"])]
            rec["mmatchIndex"] = int(u["mmatchIndex"])
        elif mtype == SNAPREQ:
            rec["mlog"] = tuple(self._decode_entry(*(u[f"l{k}_{n}"] for n in EF))
                                for k in range(int(u["mloglen"])))
            rec["mcommitIndex"] = int(u["mcommitIndex"])
            rec["mmembers"] = self._fs(u["mmembers"])
        elif mtype == SNAPRESP:
            rec["msuccess"] = bool(u["msuccess"])
            rec["mmatchIndex"] = int(u["mmatchIndex"])
        return tuple(sorted(rec.items()))

    def encode_msg(self, rec: tuple) -> tuple:
        d = dict(rec)
        mtype = {v: k for k, v in MTYPE_NAMES.items()}[d["mtype"]]
        kw = dict(mtype=mtype, mterm=d["mterm"], msource=d["msource"], mdest=d["mdest"])
        if mtype == RVREQ:
            kw.update(mlastLogTerm=d["mlastLogTerm"], mlastLogIndex=d["mlastLogIndex"])
        elif mtype == RVRESP:
            kw.update(mvoteGranted=int(d["mvoteGranted"]))
        elif mtype == AEREQ:
            kw.update(mprevLogIndex=d["mprevLogIndex"], mprevLogTerm=d["mprevLogTerm"],
                      nentries=len(d["mentries"]), mcommitIndex=d["mcommitIndex"])
            if d["mentries"]:
                kw.update({f"e_{n}": v for n, v in self._encode_entry(d["mentries"][0]).items()})
        elif mtype == AERESP:
            inv_rc = {v: k for k, v in RC_NAMES.items()}
            kw.update(mresult=inv_rc[d["mresult"]], mmatchIndex=d["mmatchIndex"])
        elif mtype == SNAPREQ:
            kw.update(mloglen=len(d["mlog"]), mcommitIndex=d["mcommitIndex"],
                      mmembers=sum(1 << j for j in d["mmembers"]))
            for k, e in enumerate(d["mlog"]):
                kw.update({f"l{k}_{n}": v for n, v in self._encode_entry(e).items()})
        elif mtype == SNAPRESP:
            kw.update(msuccess=int(d["msuccess"]), mmatchIndex=d["mmatchIndex"])
        return self.packer.pack(**kw)

    def encode(self, st: dict) -> np.ndarray:
        """Inverse of decode (the bag's slots in canonical order)."""
        lay, p = self.layout, self.p
        S, L = p.n_servers, p.max_log
        vec = lay.zeros(())
        self._encode_config(vec, st)
        vec[lay.sl("currentTerm")] = st["currentTerm"]
        vec[lay.sl("state")] = st["state"]
        vec[lay.sl("votedFor")] = [0 if v is None else v + 1 for v in st["votedFor"]]
        vec[lay.sl("votesGranted")] = [sum(1 << j for j in vs) for vs in st["votesGranted"]]
        rows = {n: np.zeros((S, L), np.int32) for n in self.ENTRY_FIELDS}
        for i, lg in enumerate(st["log"]):
            for k, e in enumerate(lg):
                for n, v in self._encode_entry(e).items():
                    rows[n][i, k] = v
        for n in rows:
            vec[lay.sl(f"log_{n}")] = rows[n].reshape(-1)
        vec[lay.sl("log_len")] = [len(lg) for lg in st["log"]]
        vec[lay.sl("commitIndex")] = st["commitIndex"]
        vec[lay.sl("nextIndex")] = np.asarray(st["nextIndex"]).reshape(-1)
        vec[lay.sl("matchIndex")] = np.asarray(st["matchIndex"]).reshape(-1)
        vec[lay.sl("pendingResponse")] = [sum(1 << j for j, b in enumerate(row) if b)
                                          for row in st["pendingResponse"]]
        keys = sorted((self.encode_msg(rec), c) for rec, c in st["messages"])
        if len(keys) > p.msg_slots:
            raise OverflowError("message bag exceeds msg_slots")
        word_arrs = [np.full(p.msg_slots, EMPTY, np.int32) for _ in range(self.n_words)]
        cn = np.zeros(p.msg_slots, np.int32)
        for k, (key, c) in enumerate(keys):
            for w, arr in zip(key, word_arrs):
                arr[k] = w
            cn[k] = c
        for k, arr in enumerate(word_arrs):
            vec[lay.sl(f"msg_w{k}")] = arr
        vec[lay.sl("msg_cnt")] = cn
        vec[lay.sl("acked")] = [{None: ACK_NIL, False: ACK_FALSE, True: ACK_TRUE}[a]
                                for a in st["acked"]]
        vec[lay.fields["electionCtr"].offset] = st["electionCtr"]
        vec[lay.fields["restartCtr"].offset] = st["restartCtr"]
        for cname in self.counter_fields:
            vec[lay.fields[cname].offset] = st[cname]
        vec[lay.sl("valueCtr")] = st["valueCtr"]
        return vec
