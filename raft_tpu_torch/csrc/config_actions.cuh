// config_actions.cuh — the two reconfiguration Raft specs' action groups,
// invariants and liveness predicates as device code.
//
// Replaces raft_tpu/models/config_common.py:132-798 (ConfigRaftCommon: the
// shared actions behind _expand1 :702, the fused receipt :356-636, the
// shared invariants :285-334) with ops/bag.py:33 wide_bag_put and
// ops/packing.py's WidePacker, and both variants' hooks, actions,
// invariants and ReconfigurationCompletes: raft_tpu/models/reconfig_raft.py
// (RaftWithReconfigAddRemove, :303-597) and joint_raft.py
// (RaftWithReconfigJointConsensus, :343-700). It mirrors the port's batched
// plain versions, raft_tpu_torch/models/config_common.py, reconfig_raft.py
// and joint_raft.py, one (state, candidate) pair at a time: the layout,
// the message packing and the bounds come from the model's int32 spec
// vector (ConfigRaftCommon.kernel_spec). ConfigFamily<false> is the
// AddRemove family (reconfig_* kernels), ConfigFamily<true> the
// JointConsensus one (joint_*); the variant's hooks are `if (J)` arms.
//
// Every action group is one function templated on WRITE, as in
// kraft_actions.cuh: with WRITE false it computes only (valid, rank, ovf)
// and writes no successor lane; with WRITE true it also writes the
// successor row `o`, a copy of the state `s` made by the caller, lane by
// changed lane. Each also takes a group of threads (actions_common.cuh: a
// warp tile for the apply, GrpSerial in the host tests): every member
// computes the scalar part on the same inputs, the lead member makes the
// scalar writes, and the bag put and the log installs are split over the
// members. The guard runs a lane with a GrpRecord, a group of one that
// keeps the lane's put (nw_put) for the group guard (actions_common.cuh
// guard_state), which runs it split over its tile. RequestVote(i) puts a
// chain of up to S - 1 messages (one per member), each put acting on the
// bag the previous one left, a put that finds its message disabling the
// action (SendMultipleOnce); the group guard replays a lane's chain on its
// tile's one copy of the bag's key words (ConfigFamily::chain). Keys, key
// words and logs are read and built with compile-time indices only (IKey,
// cr_unpack, CrInstall), so they stay in registers.
//
// Message keys are N int32 words (N = the spec's NW, at most CR_MAX_WORDS):
// a key is the SUM of (value << shift) into its word, computed in int32;
// the bag keeps word w of slot m at msg_w0 + w * M + m, its slots in
// lexicographic order of the words from word 0, unused slots EMPTY in
// every word and count 0 last. A SnapshotRequest packs the sender's whole
// log (the l{k}_* fields, lanes past its length zeroed).
//
// Bit-identity rules the code keeps (properties of the reference, which
// indexes with traced values, and of the plain version):
//   - a read x[i] with a record's out-of-range server index reads the
//     clamped index and a write to one writes nothing (jx_get / jx_set):
//     a record's 2-bit mdest may name no server of three;
//   - nextIndex holds the snapshot sentinels -1 and -2 as values;
//   - the receipt's eight branches are disjoint; the incoming Discard and
//     the branch's response collapse into one put whose existed is
//     ignored; existed and overflow are read on the bag before the put.
#pragma once

#include "actions_common.cuh"

#define CR_MAX_WORDS NW_MAX_WORDS  // key words (models/config_common.py MAX_WORDS)
#define CR_MAX_L 8      // log lanes (models/config_common.py MAX_LOG)
#define CR_SLOTS 7      // entry fields: term, cmd, val, cid, x0, x1, x2

// state[i] (both specs) and mtype, the AppendEntries result codes
enum { CR_FOLLOWER, CR_CANDIDATE, CR_LEADER, CR_NOTMEMBER };
enum { CR_RVREQ = 1, CR_RVRESP, CR_AEREQ, CR_AERESP, CR_SNAPREQ, CR_SNAPRESP };
enum { CR_RC_OK = 1, CR_RC_STALE, CR_RC_MISMATCH, CR_RC_NEEDSNAP };
#define CR_PENDING_SNAP_REQUEST (-1)
#define CR_PENDING_SNAP_RESPONSE (-2)

// Next-disjunct ranks (models/config_common.py R_*; 12 and 13 are the
// variant's config actions, 17 AddRemove's ResetWithSameIdentity)
enum {
  CK_RESTART, CK_UPDATETERM, CK_REQUESTVOTE, CK_BECOMELEADER, CK_HANDLE_RVREQ,
  CK_HANDLE_RVRESP, CK_CLIENTREQUEST, CK_ADVANCECOMMIT, CK_APPENDENTRIES, CK_REJECT_AE,
  CK_ACCEPT_AE, CK_HANDLE_AERESP, CK_CONFIG_1, CK_CONFIG_2, CK_SENDSNAP, CK_HANDLE_SNAPREQ,
  CK_HANDLE_SNAPRESP, CK_RESET_IDENTITY
};

// log-entry commands: AddRemove (reconfig_raft.py CMD_*) and JointConsensus
// (joint_raft.py CMD_*)
enum { AR_INIT = 1, AR_APPEND = 2, AR_ADD = 3, AR_REMOVE = 4 };
enum { JC_APPEND = 1, JC_OLDNEW = 2, JC_NEW = 3 };

// The spec vector (models/config_common.py SPEC_SCALARS, then the message
// fields' (word, shift, mask) triples).
enum {
  CS_S, CS_V, CS_L, CS_M, CS_W, CS_A, CS_K, CS_NW, CS_NE,
  CS_CID, CS_CJOINT, CS_CMEM, CS_COLD, CS_CNEW, CS_CCOMM, CS_CT, CS_ST, CS_VF, CS_VG,
  CS_LOG,  // log_term, log_cmd, log_val, log_cid, log_x0, log_x1, log_x2: CS_LOG + slot
  CS_LL = CS_LOG + CR_SLOTS, CS_CI, CS_NI, CS_MI, CS_PR, CS_W0, CS_CNT, CS_ACK, CS_ECTR,
  CS_RCTR, CS_ADDCTR, CS_REMCTR, CS_RECCTR, CS_VALCTR,
  CS_MAX_ELECTIONS, CS_MAX_RESTARTS, CS_MAX_VPT, CS_MAX_TERM, CS_MAX_ADD, CS_MAX_REMOVE,
  CS_MIN_CLUSTER, CS_MAX_CLUSTER, CS_THESIS_BUG, CS_MAX_RECONFIGS,
  CS_MSG
};
enum {
  CF_MTYPE, CF_MTERM, CF_MSOURCE, CF_MDEST, CF_MLASTLOGTERM, CF_MLASTLOGINDEX,
  CF_MVOTEGRANTED, CF_MPREVLOGINDEX, CF_MPREVLOGTERM, CF_NENTRIES, CF_MCOMMITINDEX,
  CF_MRESULT, CF_MMATCHINDEX, CF_MSUCCESS, CF_MLOGLEN, CF_MMEMBERS,
  CF_E,                    // the entry e_*: CF_E + slot
  CF_LOG = CF_E + CR_SLOTS,  // lane k of the embedded log: CF_LOG + k * CR_SLOTS + slot
  CF_N = CF_LOG + CR_MAX_L * CR_SLOTS
};
#define CS_LEN (CS_MSG + 3 * CF_N)
// entry slots; AddRemove's x0, x1 are cmem, cmembers, JointConsensus' x0,
// x1, x2 old, new, members
enum { E_TERM, E_CMD, E_VAL, E_CID, E_X0, E_X1, E_X2 };

// Action groups (models/config_common.py GROUP_IDS).
enum {
  CG_RESTART, CG_REQUEST_VOTE, CG_BECOME_LEADER, CG_CLIENT_REQUEST, CG_ADVANCE_COMMIT,
  CG_APPEND_ENTRIES, CG_SEND_SNAPSHOT, CG_HANDLE_MESSAGE, CG_APPEND_ADD, CG_APPEND_REMOVE,
  CG_RESET_IDENTITY, CG_APPEND_OLDNEW, CG_APPEND_NEW
};
// the family's own predicates (models/config_common.py CONFIG_PRED_IDS)
enum { CR_INV_MAX_ONE_RECONFIG = 5, CR_PRED_RECONFIG_P = 16, CR_PRED_RECONFIG_Q = 17 };

#define CFLD(o) (sp[CS_##o])

// ---- small helpers ----

__device__ __forceinline__ int cr_pop(int x, int S) {
  int n = 0;
  for (int k = 0; k < S; ++k) n += (x >> k) & 1;
  return n;
}
__device__ __forceinline__ bool cr_bit(int mask, int j) { return ((mask >> j) & 1) > 0; }
// a server's log row of an entry slot
__device__ __forceinline__ const int* cr_log(const int* sp, const int* s, int slot, int i) {
  return s + sp[CS_LOG + slot] + i * sp[CS_L];
}
__device__ __forceinline__ int cr_lane(const int* row, int L, int l) {  // clamped lane read
  return row[ra_clamp(l, 0, L - 1)];
}

// ---- message keys (ops/packing.py WidePacker) ----

// add v << shift into the key's word at the triple of field f
__device__ __forceinline__ void cr_pack(const int* sp, IKey& k, int f, int v) {
  nw_pack_q<CR_MAX_WORDS>(sp + CS_MSG + 3 * f, k, v);
}

// slot m's key words (an array: the first NW; IKey: 0 past NW)
__device__ __forceinline__ void cr_key_words(const int* sp, const int* s, int m, int* kw) {
  const int M = CFLD(M), NW = CFLD(NW);
  for (int w = 0; w < NW; ++w) kw[w] = s[CFLD(W0) + w * M + m];
}
__device__ __forceinline__ void cr_key_words(const int* sp, const int* s, int m, IKey& kw) {
  const int M = CFLD(M), NW = CFLD(NW);
#pragma unroll
  for (int w = 0; w < CR_MAX_WORDS; ++w) kw.w[w] = w < NW ? s[CFLD(W0) + w * M + m] : 0;
}

// a field of a key given as its words
__device__ __forceinline__ int cr_unpack(const int* sp, const int* kw, int f) {
  return nw_unpack_q(sp + CS_MSG + 3 * f, kw);
}
__device__ __forceinline__ int cr_unpack(const int* sp, const IKey& kw, int f) {
  return nw_unpack_q<CR_MAX_WORDS>(sp + CS_MSG + 3 * f, kw);
}

// ---- the variants' config hooks ----

template <bool J>
__device__ __forceinline__ bool cr_is_cfg(int cmd) {
  return J ? (cmd == JC_OLDNEW || cmd == JC_NEW)
           : (cmd == AR_INIT || cmd == AR_ADD || cmd == AR_REMOVE);
}
template <bool J>
__device__ __forceinline__ int cr_append_cmd() {
  return J ? JC_APPEND : AR_APPEND;
}

// the member set an entry at a lane gives its server: AddRemove cmembers,
// JointConsensus members
template <bool J>
__device__ __forceinline__ int cr_members_slot() {
  return J ? E_X2 : E_X1;
}

// A log as the receipt and AdvanceCommitIndex see it: row(slot, lane) is
// an entry field (0 for a slot past NE), computed where it is read, with no
// array (a [slot][lane] array indexed at run time sits on the stack).

// server i's own log in the state
struct CrLogOf {
  const int* sp;
  const int* s;
  int i;
  __device__ __forceinline__ int operator()(int e, int l) const {
    return e < sp[CS_NE] ? cr_log(sp, s, e, i)[l] : 0;
  }
};

// The config fields of server `dst` from the entry at lane `pos` of the
// log `row` (index `idx` = pos + 1, or 0 when no config entry): ConfigFor
// (JointConsensus :279-290) or the add/remove config cache (AddRemove
// :734-739); committed = ci >= idx. Returns in_new: dst in the entry's
// member set. Writes only with `write`.
template <bool J, class Row>
__device__ __forceinline__ bool cr_config_from(const int* sp, int* o, int dst, const Row& row,
                                               int idx, int ci, bool write) {
  const int S = CFLD(S), L = CFLD(L);
  const int pos = ra_clamp(idx - 1, 0, L - 1);
  const int members = row(cr_members_slot<J>(), pos);
  if (write) {
    jx_set(o + CFLD(CID), S, dst, row(E_CID, pos));
    jx_set(o + CFLD(CMEM), S, dst, members);
    jx_set(o + CFLD(CCOMM), S, dst, ci >= idx);
    if (J) {
      const bool joint = row(E_CMD, pos) == JC_OLDNEW;
      jx_set(o + CFLD(CJOINT), S, dst, joint);
      jx_set(o + CFLD(COLD), S, dst, joint ? row(E_X0, pos) : 0);
      jx_set(o + CFLD(CNEW), S, dst, joint ? row(E_X1, pos) : 0);
    }
  }
  return cr_bit(members, dst);
}

// the most recent config entry's index (lane + 1, 0 when none) among the
// first `len` lanes of a log
template <bool J, class Row>
__device__ __forceinline__ int cr_last_cfg(const Row& row, int L, int len) {
  int idx = 0;
  for (int l = 0; l < L; ++l)
    if (l < len && cr_is_cfg<J>(row(E_CMD, l))) idx = l + 1;
  return idx;
}

// ---- shared action groups ----
//
// Each takes the group of threads that shares the lane (GrpOne for a guard
// lane): every member runs the scalar part on the same inputs, the lead
// member makes the scalar writes, and the bag put and the log installs are
// split over the group.

// Restart(i) — JointConsensus :362-374 / AddRemove :346-358: keeps
// config, currentTerm, votedFor and the log
template <bool WRITE, class Gp>
__device__ bool cr_restart(Gp g, const int* sp, const int* s, int* o, int i) {
  if (WRITE && g.lead()) {
    const int S = CFLD(S);
    o[CFLD(ST) + i] = CR_FOLLOWER;
    o[CFLD(VG) + i] = 0;
    for (int k = 0; k < S; ++k) {
      o[CFLD(NI) + i * S + k] = 1;
      o[CFLD(MI) + i * S + k] = 0;
    }
    o[CFLD(PR) + i] = 0;
    o[CFLD(CI) + i] = 0;
    o[CFLD(RCTR)] = s[CFLD(RCTR)] + 1;
  }
  return s[CFLD(RCTR)] < CFLD(MAX_RESTARTS);
}

// RequestVote(i) — JointConsensus :431-450 / AddRemove :425-444:
// member-only; a RequestVoteRequest to each member, SendMultipleOnce
__device__ __forceinline__ Guard cr_rv_gate(const int* sp, const int* s, int i) {
  const int st = s[CFLD(ST) + i];
  return Guard{s[CFLD(ECTR)] < CFLD(MAX_ELECTIONS) && (st == CR_FOLLOWER || st == CR_CANDIDATE) &&
                   cr_bit(s[CFLD(CMEM) + i], i),
               CK_REQUESTVOTE, false};
}

// RequestVote(i)'s chain of puts, one a member j != i in turn, each on the
// bag the one before left: in place in the successor's `words` and `cnt`
// (the apply), or, with CNT false, in a guard tile's copy of the state's
// key words (cnt unused), where it stops at the first message that exists.
// gd.valid falls when a put finds its message; gd.ovf: a put overflowed.
template <bool CNT, class Gp>
__device__ __forceinline__ void cr_rv_chain(Gp g, const int* sp, const int* s, int i, int* words,
                                            int* cnt, Guard& gd) {
  const int S = CFLD(S), L = CFLD(L), M = CFLD(M), NW = CFLD(NW);
  const int members = s[CFLD(CMEM) + i];
  const int new_term = s[CFLD(CT) + i] + 1;
  const int ll = s[CFLD(LL) + i];
  const int last_t = ll > 0 ? cr_lane(cr_log(sp, s, E_TERM, i), L, ll - 1) : 0;
  bool ovf = false;
  for (int d = 1; d < S; ++d) {
    const int j = (i + d) % S;
    if (!cr_bit(members, j)) continue;
    IKey k = nw_ikey();
    cr_pack(sp, k, CF_MTYPE, CR_RVREQ);
    cr_pack(sp, k, CF_MTERM, new_term);
    cr_pack(sp, k, CF_MLASTLOGTERM, last_t);
    cr_pack(sp, k, CF_MLASTLOGINDEX, ll);
    cr_pack(sp, k, CF_MSOURCE, i);
    cr_pack(sp, k, CF_MDEST, j);
    const Put p = nw_bag_probe_g<CR_MAX_WORDS>(g, words, M, NW, k);  // on the bag the last put left
    gd.valid = gd.valid && !p.existed;
    ovf = ovf || p.overflow;
    if (!CNT && !gd.valid) break;
    nw_bag_insert_g<CR_MAX_WORDS, CNT>(g, words, cnt, M, NW, k, p);
  }
  gd.ovf = ovf && gd.valid;
}

// RequestVote(i) as an action: the apply runs the gate and the chain; the
// guard (a GrpRecord lane) the gate alone, and leaves the chain to its group
template <bool WRITE, class Gp>
__device__ Guard cr_request_vote(Gp g, const int* sp, const int* s, int* o, int i) {
  Guard gd = cr_rv_gate(sp, s, i);
  if constexpr (!WRITE) {
    g.rq->chain = gd.valid;
  } else {
    cr_rv_chain<true>(g, sp, s, i, o + CFLD(W0), o + CFLD(CNT), gd);
    if (g.lead()) {
      o[CFLD(ST) + i] = CR_CANDIDATE;
      o[CFLD(CT) + i] = s[CFLD(CT) + i] + 1;
      o[CFLD(VF) + i] = i + 1;
      o[CFLD(VG) + i] = 1 << i;
      o[CFLD(ECTR)] = s[CFLD(ECTR)] + 1;
    }
  }
  return gd;
}

// BecomeLeader(i) — AddRemove :505-518 (votesGranted a quorum of the
// member set) / JointConsensus :511-528 (majorities of old and new while
// joint)
template <bool J, bool WRITE, class Gp>
__device__ bool cr_become_leader(Gp g, const int* sp, const int* s, int* o, int i) {
  const int S = CFLD(S);
  const int vg = s[CFLD(VG) + i], members = s[CFLD(CMEM) + i];
  bool q = (vg & ~members) == 0 && 2 * cr_pop(vg, S) > cr_pop(members, S);
  if (J && s[CFLD(CJOINT) + i] > 0) {
    const int old = s[CFLD(COLD) + i], nw = s[CFLD(CNEW) + i];
    q = 2 * cr_pop(vg & old, S) > cr_pop(old, S) && 2 * cr_pop(vg & nw, S) > cr_pop(nw, S);
  }
  if (WRITE && g.lead()) {
    o[CFLD(ST) + i] = CR_LEADER;
    for (int k = 0; k < S; ++k) {
      o[CFLD(NI) + i * S + k] = s[CFLD(LL) + i] + 1;
      o[CFLD(MI) + i * S + k] = 0;
    }
    o[CFLD(PR) + i] = 0;
  }
  return s[CFLD(ST) + i] == CR_CANDIDATE && q;
}

// ClientRequest(i, v) — JointConsensus :535-550 / AddRemove :525-540 (the
// acked gate and the per-term value counter); a log at max_log overflows
template <bool J, bool WRITE, class Gp>
__device__ Guard cr_client_request(Gp g, const int* sp, const int* s, int* o, int i, int v) {
  const int L = CFLD(L);
  const int term = s[CFLD(CT) + i];
  const int tpos = ra_clamp(term - 1, 0, CFLD(MAX_TERM) - 1);
  Guard gd{s[CFLD(ST) + i] == CR_LEADER && s[CFLD(ACK) + v] == RA_ACK_NIL &&
               s[CFLD(VALCTR) + tpos] < CFLD(MAX_VPT),
           CK_CLIENTREQUEST, false};
  const int pos = s[CFLD(LL) + i];
  gd.ovf = gd.valid && pos >= L;
  if (WRITE && g.lead()) {
    const int posc = ra_clamp(pos, 0, L - 1);
    o[sp[CS_LOG + E_TERM] + i * L + posc] = term;
    o[sp[CS_LOG + E_CMD] + i * L + posc] = cr_append_cmd<J>();
    o[sp[CS_LOG + E_VAL] + i * L + posc] = v + 1;
    o[CFLD(LL) + i] = pos + 1;
    o[CFLD(ACK) + v] = RA_ACK_FALSE;
    o[CFLD(VALCTR) + tpos] = s[CFLD(VALCTR) + tpos] + 1;
  }
  return gd;
}

// AppendEntries(i, j) — JointConsensus :556-582 / AddRemove :546-572:
// member- and snapshot-sentinel-gated; an empty request is send-once
template <bool WRITE, class Gp>
__device__ Guard cr_append_entries(Gp g, const int* sp, const int* s, int* o, int i, int j) {
  const int S = CFLD(S), L = CFLD(L), M = CFLD(M), NW = CFLD(NW), NE = CFLD(NE);
  const int ni = s[CFLD(NI) + i * S + j];
  const int pr = s[CFLD(PR) + i];
  Guard gd{s[CFLD(ST) + i] == CR_LEADER && cr_bit(s[CFLD(CMEM) + i], j) && ni >= 0 &&
               !cr_bit(pr, j),
           CK_APPENDENTRIES, false};
  if (!WRITE && !gd.valid) return gd;
  const int prev_idx = ni - 1;
  const int prev_term =
      prev_idx > 0 ? cr_log(sp, s, E_TERM, i)[ra_clamp(prev_idx - 1, 0, L - 1)] : 0;
  const int ll = s[CFLD(LL) + i];
  const int last_entry = ll < ni ? ll : ni;
  const int nent = last_entry >= ni;
  const int epos = ra_clamp(ni - 1, 0, L - 1);
  const int ci = s[CFLD(CI) + i];
  const int mci = ci < last_entry ? ci : last_entry;
  IKey k = nw_ikey();
  cr_pack(sp, k, CF_MTYPE, CR_AEREQ);
  cr_pack(sp, k, CF_MTERM, s[CFLD(CT) + i]);
  cr_pack(sp, k, CF_MPREVLOGINDEX, prev_idx > 0 ? prev_idx : 0);
  cr_pack(sp, k, CF_MPREVLOGTERM, prev_term);
  cr_pack(sp, k, CF_NENTRIES, nent);
  cr_pack(sp, k, CF_MCOMMITINDEX, mci > 0 ? mci : 0);
  cr_pack(sp, k, CF_MSOURCE, i);
  cr_pack(sp, k, CF_MDEST, j);
  for (int e = 0; e < NE; ++e) cr_pack(sp, k, CF_E + e, nent ? cr_log(sp, s, e, i)[epos] : 0);
  const Put p = nw_put<CR_MAX_WORDS>(g, s + CFLD(W0), M, NW, k, gd, nent == 0, false);
  if (WRITE) {
    if (g.lead()) o[CFLD(PR) + i] = pr | (1 << j);
    nw_insert<CR_MAX_WORDS>(g, o + CFLD(W0), o + CFLD(CNT), M, NW, k, p);
  }
  return gd;
}

// SendSnapshot(i, j) — JointConsensus :885-901 / AddRemove :862-878: the
// whole log in the request, lanes past its length zeroed; the put ignores
// existed
template <bool WRITE, class Gp>
__device__ Guard cr_send_snapshot(Gp g, const int* sp, const int* s, int* o, int i, int j) {
  const int S = CFLD(S), L = CFLD(L), M = CFLD(M), NW = CFLD(NW), NE = CFLD(NE);
  const int members = s[CFLD(CMEM) + i];
  Guard gd{s[CFLD(ST) + i] == CR_LEADER && cr_bit(members, j) &&
               s[CFLD(NI) + i * S + j] == CR_PENDING_SNAP_REQUEST,
           CK_SENDSNAP, false};
  if (!WRITE && !gd.valid) return gd;
  const int ll = s[CFLD(LL) + i];
  IKey k = nw_ikey();
  cr_pack(sp, k, CF_MTYPE, CR_SNAPREQ);
  cr_pack(sp, k, CF_MTERM, s[CFLD(CT) + i]);
  cr_pack(sp, k, CF_MCOMMITINDEX, s[CFLD(CI) + i]);
  cr_pack(sp, k, CF_MMEMBERS, members);
  cr_pack(sp, k, CF_MLOGLEN, ll);
  cr_pack(sp, k, CF_MSOURCE, i);
  cr_pack(sp, k, CF_MDEST, j);
  for (int l = 0; l < L; ++l)
    for (int e = 0; e < NE; ++e)
      cr_pack(sp, k, CF_LOG + l * CR_SLOTS + e, l < ll ? cr_log(sp, s, e, i)[l] : 0);
  const Put p = nw_put<CR_MAX_WORDS>(g, s + CFLD(W0), M, NW, k, gd, false, false);
  if (WRITE) {
    if (g.lead()) o[CFLD(NI) + i * S + j] = CR_PENDING_SNAP_RESPONSE;
    nw_insert<CR_MAX_WORDS>(g, o + CFLD(W0), o + CFLD(CNT), M, NW, k, p);
  }
  return gd;
}

// the commit quorum at log index idx (the leader counting itself): a
// majority of `mask`'s members have matchIndex >= idx
__device__ __forceinline__ bool cr_quorum(const int* match, int S, int i, int mask, int idx) {
  int n = 0;
  for (int k = 0; k < S; ++k) n += cr_bit(mask, k) && (match[k] >= idx || k == i);
  return 2 * n > cr_pop(mask, S);
}

// AdvanceCommitIndex(i) — AddRemove :605-642 (member quorum) /
// JointConsensus :613-653 (dual quorum while joint): the config
// re-derived from the most recent config entry, acked values committed,
// and IsRemovedFromCluster (AddRemove :598-603: a RemoveServerCommand
// without i; JointConsensus :606-611: a NewConfigCommand without i)
template <bool J, bool WRITE, class Gp>
__device__ bool cr_advance_commit(Gp g, const int* sp, const int* s, int* o, int i) {
  const int S = CFLD(S), L = CFLD(L), V = CFLD(V);
  const int ll = s[CFLD(LL) + i], ci = s[CFLD(CI) + i];
  const int* match = s + CFLD(MI) + i * S;
  const bool joint = J && s[CFLD(CJOINT) + i] > 0;
  int max_agree = 0;
  for (int idx = 1; idx <= L; ++idx) {
    const bool q = joint ? cr_quorum(match, S, i, s[CFLD(COLD) + i], idx) &&
                               cr_quorum(match, S, i, s[CFLD(CNEW) + i], idx)
                         : cr_quorum(match, S, i, s[CFLD(CMEM) + i], idx);
    if (q && idx <= ll) max_agree = idx;
  }
  const int* lt = cr_log(sp, s, E_TERM, i);
  const int new_ci =
      max_agree > 0 && cr_lane(lt, L, max_agree - 1) == s[CFLD(CT) + i] ? max_agree : ci;
  const bool valid = s[CFLD(ST) + i] == CR_LEADER && ci < new_ci;
  if (WRITE && g.lead()) {
    const int* cmd = cr_log(sp, s, E_CMD, i);
    const int* val = cr_log(sp, s, E_VAL, i);
    const int* mem = cr_log(sp, s, cr_members_slot<J>(), i);
    bool removed = false;
    for (int v = 0; v < V; ++v) {
      bool committed = false;
      for (int l = 0; l < L; ++l)
        committed |= l + 1 > ci && l + 1 <= new_ci &&
                     (cmd[l] == cr_append_cmd<J>() ? val[l] : 0) == v + 1;
      if (s[CFLD(ACK) + v] == RA_ACK_FALSE && committed) o[CFLD(ACK) + v] = RA_ACK_TRUE;
    }
    for (int l = 0; l < L; ++l)
      removed |= l + 1 > ci && l + 1 <= new_ci && cmd[l] == (J ? JC_NEW : AR_REMOVE) &&
                 !cr_bit(mem[l], i);
    const CrLogOf row{sp, s, i};
    cr_config_from<J>(sp, o, i, row, cr_last_cfg<J>(row, L, ll), new_ci, true);
    if (removed) {
      o[CFLD(ST) + i] = CR_NOTMEMBER;
      o[CFLD(VG) + i] = 0;
      for (int k = 0; k < S; ++k) {
        o[CFLD(NI) + i * S + k] = 1;
        o[CFLD(MI) + i * S + k] = 0;
      }
    }
    o[CFLD(CI) + i] = removed ? 0 : new_ci;
  }
  return valid;
}

// ---- AddRemove's own actions ----

// LeaderHasCommittedEntriesInCurrentTerm — AddRemove :275-278
__device__ __forceinline__ bool cr_committed_in_term(const int* sp, const int* s, int i) {
  const int L = CFLD(L);
  const int* lt = cr_log(sp, s, E_TERM, i);
  bool any = false;
  for (int l = 0; l < L; ++l)
    any |= l < s[CFLD(LL) + i] && lt[l] == s[CFLD(CT) + i] && s[CFLD(CI) + i] >= l + 1;
  return any;
}

// AppendAddServerCommandToLog(i, a) — :795-824 and
// AppendRemoveServerCommandToLog(i, a) — :828-853
template <bool WRITE, class Gp>
__device__ Guard ar_append_member(Gp g, const int* sp, const int* s, int* o, int i, int a,
                                  bool add) {
  const int S = CFLD(S), L = CFLD(L);
  const int members = s[CFLD(CMEM) + i];
  const int size = cr_pop(members, S);
  const int ctr = add ? CFLD(ADDCTR) : CFLD(REMCTR);
  Guard gd{s[CFLD(ST) + i] == CR_LEADER &&
               s[ctr] < (add ? CFLD(MAX_ADD) : CFLD(MAX_REMOVE)) &&
               (add ? size < CFLD(MAX_CLUSTER) : size > CFLD(MIN_CLUSTER)) &&
               s[CFLD(CCOMM) + i] > 0 && cr_bit(members, a) != add,
           add ? CK_CONFIG_1 : CK_CONFIG_2, false};
  if (!CFLD(THESIS_BUG)) gd.valid = gd.valid && cr_committed_in_term(sp, s, i);
  const int pos = s[CFLD(LL) + i];
  gd.ovf = gd.valid && pos >= L;
  if (WRITE && g.lead()) {
    const int nm = add ? (members | (1 << a)) : (members & ~(1 << a));
    const int new_id = s[CFLD(CID) + i] + 1;
    const int at = i * L + ra_clamp(pos, 0, L - 1);
    o[sp[CS_LOG + E_TERM] + at] = s[CFLD(CT) + i];
    o[sp[CS_LOG + E_CMD] + at] = add ? AR_ADD : AR_REMOVE;
    o[sp[CS_LOG + E_CID] + at] = new_id;
    o[sp[CS_LOG + E_X0] + at] = a + 1;  // cmem
    o[sp[CS_LOG + E_X1] + at] = nm;     // cmembers
    o[CFLD(LL) + i] = pos + 1;
    o[CFLD(CID) + i] = new_id;
    o[CFLD(CMEM) + i] = nm;
    // committed = ci >= Len(newLog): always FALSE here (:814-816)
    o[CFLD(CCOMM) + i] = s[CFLD(CI) + i] >= pos + 1;
    o[ctr] = s[ctr] + 1;
    if (add) o[CFLD(NI) + i * S + a] = CR_PENDING_SNAP_REQUEST;
  }
  return gd;
}

// ResetWithSameIdentity(i) — :385-400; the CHOOSE of a leader is the
// lowest index with IsCurrentLeader (:367-373)
template <bool WRITE, class Gp>
__device__ bool ar_reset_identity(Gp g, const int* sp, const int* s, int* o, int i) {
  const int S = CFLD(S), L = CFLD(L), NE = CFLD(NE);
  const int* ct = s + CFLD(CT);
  int leader = -1;
  for (int k = S - 1; k >= 0; --k) {
    bool cur = s[CFLD(ST) + k] == CR_LEADER;
    for (int q = 0; q < S; ++q) cur = cur && ct[k] >= ct[q];
    if (cur) leader = k;
  }
  const int ld = leader < 0 ? 0 : leader;
  if (WRITE) {
    if (g.lead()) {
      o[CFLD(ST) + i] = CR_NOTMEMBER;
      const int zero[] = {CFLD(CID), CFLD(CMEM), CFLD(CCOMM), CFLD(CT), CFLD(VF), CFLD(VG),
                          CFLD(PR), CFLD(CI), CFLD(LL)};
      for (int z : zero) o[z + i] = 0;
      for (int k = 0; k < S; ++k) {
        o[CFLD(NI) + i * S + k] = 1;
        o[CFLD(MI) + i * S + k] = 0;
      }
    }
    for (int t = g.lo(); t < g.hi(); ++t)  // the log, (slot, lane) pairs split over the group
      for (int u = t; u < NE * L; u += g.size()) o[sp[CS_LOG + u / L] + i * L + u % L] = 0;
  }
  return ct[i] > 0 && leader >= 0 && ld != i && !cr_bit(s[CFLD(CMEM) + ld], i) &&
         s[CFLD(CCOMM) + ld] > 0;
}

// ---- JointConsensus' own actions ----

// AppendOldNewConfigToLog(i) for the (add, remove) member sets packed in
// p1 (add in the low 16 bits) — :827-856
template <bool WRITE, class Gp>
__device__ Guard jc_append_old_new(Gp g, const int* sp, const int* s, int* o, int i, int p1) {
  const int S = CFLD(S), L = CFLD(L);
  const int add = p1 & 0xFFFF, rem = p1 >> 16;
  const int members = s[CFLD(CMEM) + i];
  // HasPendingConfigCommand (:246-248)
  const bool pending = s[CFLD(CCOMM) + i] == 0 || s[CFLD(CJOINT) + i] > 0;
  Guard gd{s[CFLD(ST) + i] == CR_LEADER && s[CFLD(RECCTR)] < CFLD(MAX_RECONFIGS) && !pending &&
               (add & members) == 0 && (rem & members) == rem,
           CK_CONFIG_1, false};
  const int pos = s[CFLD(LL) + i];
  gd.ovf = gd.valid && pos >= L;
  if (WRITE && g.lead()) {
    const int old = members, nw = (members & ~rem) | add, jm = members | add;
    const int new_id = s[CFLD(RECCTR)] + 1;  // id = reconfigCtr + 1 (:839)
    const int at = i * L + ra_clamp(pos, 0, L - 1);
    o[sp[CS_LOG + E_TERM] + at] = s[CFLD(CT) + i];
    o[sp[CS_LOG + E_CMD] + at] = JC_OLDNEW;
    o[sp[CS_LOG + E_CID] + at] = new_id;
    o[sp[CS_LOG + E_X0] + at] = old;
    o[sp[CS_LOG + E_X1] + at] = nw;
    o[sp[CS_LOG + E_X2] + at] = jm;
    o[CFLD(LL) + i] = pos + 1;
    o[CFLD(CID) + i] = new_id;
    o[CFLD(CJOINT) + i] = 1;
    o[CFLD(CMEM) + i] = jm;
    o[CFLD(COLD) + i] = old;
    o[CFLD(CNEW) + i] = nw;
    o[CFLD(CCOMM) + i] = s[CFLD(CI) + i] >= pos + 1;
    o[CFLD(RECCTR)] = new_id;
    // nextIndex := PendingSnapshotRequest for the servers of new \ old (:849-853)
    for (int k = 0; k < S; ++k)
      if (cr_bit(nw, k) && !cr_bit(old, k)) o[CFLD(NI) + i * S + k] = CR_PENDING_SNAP_REQUEST;
  }
  return gd;
}

// AppendNewConfigToLog(i) — :861-876: on the committed OldNew entry with no
// later config command (CommittedOldNewWithoutNew :232-242)
template <bool WRITE, class Gp>
__device__ Guard jc_append_new(Gp g, const int* sp, const int* s, int* o, int i) {
  const int L = CFLD(L);
  const int* cmd = cr_log(sp, s, E_CMD, i);
  const int ll = s[CFLD(LL) + i], ci = s[CFLD(CI) + i];
  int last_oldnew = 0, last_new = 0;
  for (int l = 0; l < L; ++l) {
    if (l < ll && cmd[l] == JC_OLDNEW) last_oldnew = l + 1;
    if (l < ll && cmd[l] == JC_NEW) last_new = l + 1;
  }
  Guard gd{s[CFLD(ST) + i] == CR_LEADER && last_oldnew > 0 && ci >= last_oldnew &&
               last_new < last_oldnew,
           CK_CONFIG_2, false};
  gd.ovf = gd.valid && ll >= L;
  if (WRITE && g.lead()) {
    const int tpos = ra_clamp(last_oldnew - 1, 0, L - 1);
    const int nm = cr_log(sp, s, E_X1, i)[tpos];  // the entry's new set
    const int new_id = cr_log(sp, s, E_CID, i)[tpos];
    const int at = i * L + ra_clamp(ll, 0, L - 1);
    o[sp[CS_LOG + E_TERM] + at] = s[CFLD(CT) + i];
    o[sp[CS_LOG + E_CMD] + at] = JC_NEW;
    o[sp[CS_LOG + E_CID] + at] = new_id;
    o[sp[CS_LOG + E_X2] + at] = nm;
    o[CFLD(LL) + i] = ll + 1;
    o[CFLD(CID) + i] = new_id;
    o[CFLD(CJOINT) + i] = 0;
    o[CFLD(CMEM) + i] = nm;
    o[CFLD(COLD) + i] = 0;
    o[CFLD(CNEW) + i] = 0;
    o[CFLD(CCOMM) + i] = ci >= ll + 1;
  }
  return gd;
}

// ---- the fused receipt ----

// The log a receipt installs at its destination: an accepted
// AppendEntries' (the destination's log, and when appending its lanes from
// prev_idx on zeroed and the entry at lane app) or a SnapshotRequest's
// (the sender's log packed in the key). The apply's alone: the guard
// computes no successor.
struct CrInstall {
  const int* sp;
  const int* s;
  IKey kw;  // a copy: a pointer to the words would put them on the stack
  int dst, prev_idx, app;
  bool snapshot, appending;
  __device__ __forceinline__ int operator()(int e, int l) const {
    if (e >= sp[CS_NE]) return 0;
    if (snapshot) return cr_unpack(sp, kw, CF_LOG + l * CR_SLOTS + e);
    if (appending && l == app) return cr_unpack(sp, kw, CF_E + e);
    if (appending && l >= prev_idx) return 0;
    return cr_log(sp, s, e, dst)[l];
  }
};

// HandleMessage(slot m): UpdateTerm, Handle{RequestVote,AppendEntries,
// Snapshot}{Request,Response} and Reject/AcceptAppendEntriesRequest —
// JointConsensus :410-944 / AddRemove :404-921, pairwise disjoint for a
// record; rank says which fired, -1 when none did.
template <bool J, bool WRITE, class Gp>
__device__ Guard cr_handle_message(Gp g, const int* sp, const int* s, int* o, int m) {
  const int S = CFLD(S), L = CFLD(L), M = CFLD(M), NW = CFLD(NW), NE = CFLD(NE);
  const bool lw = WRITE && g.lead();
  Guard gd{false, -1, false};
  IKey kw;
  cr_key_words(sp, s, m, kw);
  if (kw[0] == RA_EMPTY) return gd;
  const int mtype = cr_unpack(sp, kw, CF_MTYPE), mterm = cr_unpack(sp, kw, CF_MTERM);
  const int src = cr_unpack(sp, kw, CF_MSOURCE), dst = cr_unpack(sp, kw, CF_MDEST);
  const int cur = jx_get(s + CFLD(CT), S, dst), st = jx_get(s + CFLD(ST), S, dst);
  if (mterm > cur) {  // UpdateTerm (the count may be 0)
    gd.valid = true;
    gd.rank = CK_UPDATETERM;
    if (lw) {
      jx_set(o + CFLD(CT), S, dst, mterm);
      jx_set(o + CFLD(ST), S, dst, CR_FOLLOWER);
      jx_set(o + CFLD(VF), S, dst, RA_NIL);
    }
    return gd;
  }
  if (s[CFLD(CNT) + m] <= 0) return gd;  // the rest need a receivable record
  const bool eq_term = mterm == cur;
  const int dclamp = jx_index(dst, S);
  const int ll = s[CFLD(LL) + dclamp];
  const int mci = cr_unpack(sp, kw, CF_MCOMMITINDEX);

  bool putb = false, dropb = false, ovf_extra = false;
  IKey k = nw_ikey();
  // the log the receipt installs (accept or snapshot): its length, and
  // how it differs from the destination's (CrInstall)
  bool install = false, snapshot = false, appending = false;
  int new_len = 0, install_prev = 0;
  bool grant = false;

  if (mtype == CR_RVREQ) {  // HandleRequestVoteRequest
    const int* lt = s + sp[CS_LOG + E_TERM] + dclamp * L;
    const int last_t = ll > 0 ? cr_lane(lt, L, ll - 1) : 0;
    const int mllt = cr_unpack(sp, kw, CF_MLASTLOGTERM);
    const bool logok =
        mllt > last_t || (mllt == last_t && cr_unpack(sp, kw, CF_MLASTLOGINDEX) >= ll);
    const int vf = jx_get(s + CFLD(VF), S, dst);
    grant = eq_term && logok && (vf == RA_NIL || vf == src + 1);
    putb = true;
    gd.rank = CK_HANDLE_RVREQ;
    cr_pack(sp, k, CF_MTYPE, CR_RVRESP);
    cr_pack(sp, k, CF_MTERM, cur);
    cr_pack(sp, k, CF_MVOTEGRANTED, grant);
    cr_pack(sp, k, CF_MSOURCE, dst);
    cr_pack(sp, k, CF_MDEST, src);
  } else if (mtype == CR_RVRESP) {  // HandleRequestVoteResponse
    dropb = eq_term && st == CR_CANDIDATE;
    gd.rank = CK_HANDLE_RVRESP;
  } else if (mtype == CR_AEREQ) {  // Reject / AcceptAppendEntriesRequest
    const int prev_idx = cr_unpack(sp, kw, CF_MPREVLOGINDEX);
    const int prev_term = cr_unpack(sp, kw, CF_MPREVLOGTERM);
    const int nent = cr_unpack(sp, kw, CF_NENTRIES);
    const int at_prev = s[sp[CS_LOG + E_TERM] + dclamp * L + ra_clamp(prev_idx - 1, 0, L - 1)];
    const bool logok = nent > 0 ? prev_idx > 0 && prev_idx <= ll && prev_term == at_prev
                                : prev_idx == ll && prev_idx > 0 && prev_term == at_prev;
    const bool member = cr_bit(jx_get(s + CFLD(CMEM), S, dst), dst);
    const int rc = mterm < cur ? CR_RC_STALE
                               : (!member ? CR_RC_NEEDSNAP
                                          : (eq_term && st == CR_FOLLOWER && !logok
                                                 ? CR_RC_MISMATCH
                                                 : CR_RC_OK));
    if (rc != CR_RC_OK) {
      putb = true;
      gd.rank = CK_REJECT_AE;
      cr_pack(sp, k, CF_MTYPE, CR_AERESP);
      cr_pack(sp, k, CF_MTERM, cur);
      cr_pack(sp, k, CF_MRESULT, rc);
      cr_pack(sp, k, CF_MMATCHINDEX, 0);
      cr_pack(sp, k, CF_MSOURCE, dst);
      cr_pack(sp, k, CF_MDEST, src);
    } else if (eq_term && (st == CR_FOLLOWER || st == CR_CANDIDATE) && logok && member) {
      putb = install = true;
      gd.rank = CK_ACCEPT_AE;
      appending = nent != 0 && (ll == prev_idx || ll >= prev_idx + 1);
      new_len = appending ? prev_idx + 1 : ll;
      install_prev = prev_idx;
      ovf_extra = appending && prev_idx >= L;
      cr_pack(sp, k, CF_MTYPE, CR_AERESP);
      cr_pack(sp, k, CF_MTERM, cur);
      cr_pack(sp, k, CF_MRESULT, CR_RC_OK);
      cr_pack(sp, k, CF_MMATCHINDEX, prev_idx + nent);
      cr_pack(sp, k, CF_MSOURCE, dst);
      cr_pack(sp, k, CF_MDEST, src);
    }
  } else if (mtype == CR_AERESP) {  // HandleAppendEntriesResponse
    dropb = eq_term && st == CR_LEADER;
    gd.rank = CK_HANDLE_AERESP;
  } else if (mtype == CR_SNAPREQ) {  // HandleSnapshotRequest
    if (eq_term && st == CR_FOLLOWER) {
      putb = install = true;
      gd.rank = CK_HANDLE_SNAPREQ;
      new_len = cr_unpack(sp, kw, CF_MLOGLEN);
      snapshot = true;
      cr_pack(sp, k, CF_MTYPE, CR_SNAPRESP);
      cr_pack(sp, k, CF_MTERM, cur);
      cr_pack(sp, k, CF_MSUCCESS, 1);
      cr_pack(sp, k, CF_MMATCHINDEX, new_len);
      cr_pack(sp, k, CF_MSOURCE, dst);
      cr_pack(sp, k, CF_MDEST, src);
    }
  } else if (mtype == CR_SNAPRESP) {  // HandleSnapshotResponse
    dropb = eq_term && jx_get2(s + CFLD(NI), S, S, dst, src) == CR_PENDING_SNAP_RESPONSE;
    gd.rank = CK_HANDLE_SNAPRESP;
  }
  gd.valid = putb || dropb;
  if (!gd.valid) {
    gd.rank = -1;
    return gd;
  }
  gd.ovf = ovf_extra;
  Put p{false, false, 0};
  if (putb) p = nw_put<CR_MAX_WORDS>(g, s + CFLD(W0), M, NW, k, gd, false, ovf_extra);

  if constexpr (WRITE) {  // the apply's successor (its key words an IKey)
    if (lw) {
      if (mtype == CR_RVREQ && grant) jx_set(o + CFLD(VF), S, dst, src + 1);
      if (mtype == CR_RVRESP && cr_unpack(sp, kw, CF_MVOTEGRANTED) > 0)
        jx_set(o + CFLD(VG), S, dst, jx_get(s + CFLD(VG), S, dst) | (1 << src));
      if (mtype == CR_AERESP) {
        const int res = cr_unpack(sp, kw, CF_MRESULT), mm = cr_unpack(sp, kw, CF_MMATCHINDEX);
        const int ni = jx_get2(s + CFLD(NI), S, S, dst, src);
        const int ni_new = res == CR_RC_OK ? mm + 1
                           : res == CR_RC_MISMATCH ? (ni - 1 > 1 ? ni - 1 : 1)
                           : res == CR_RC_NEEDSNAP ? CR_PENDING_SNAP_REQUEST
                                                   : ni;
        jx_set2(o + CFLD(NI), S, S, dst, src, ni_new);
        if (res == CR_RC_OK) jx_set2(o + CFLD(MI), S, S, dst, src, mm);
        jx_set(o + CFLD(PR), S, dst, jx_get(s + CFLD(PR), S, dst) & ~(1 << src));
      }
      if (mtype == CR_SNAPRESP) {
        const int mm = cr_unpack(sp, kw, CF_MMATCHINDEX);
        jx_set2(o + CFLD(NI), S, S, dst, src, mm + 1);
        jx_set2(o + CFLD(MI), S, S, dst, src, mm);
      }
    }
    if (install) {
      const CrInstall row{sp, s, kw, dclamp, install_prev, ra_clamp(install_prev, 0, L - 1),
                          snapshot, appending};
      const int cfg_idx = cr_last_cfg<J>(row, L, new_len);
      if (lw) {
        jx_set(o + CFLD(CI), S, dst, mci);
        jx_set(o + CFLD(LL), S, dst, new_len);
        const bool in_new = cr_config_from<J>(sp, o, dst, row, cfg_idx, mci, true);
        if (mtype == CR_AEREQ)
          jx_set(o + CFLD(ST), S, dst, in_new ? CR_FOLLOWER : CR_NOTMEMBER);
      }
      for (int t = g.lo(); t < g.hi(); ++t)  // the log, (slot, lane) pairs split over the group
        for (int u = t; u < NE * L; u += g.size())
          jx_set2(o + sp[CS_LOG + u / L], S, L, dst, u % L, row(u / L, u % L));
    }
    if (lw) o[CFLD(CNT) + m] -= 1;  // the incoming Discard
    if (putb) nw_insert<CR_MAX_WORDS>(g, o + CFLD(W0), o + CFLD(CNT), M, NW, k, p);
  }
  return gd;
}

// One candidate (a row of the model's candidate table) of one state, by
// the group g (a GrpRecord for the guard).
template <bool J, bool WRITE, class Gp>
__device__ Guard cr_action(Gp g, const int* sp, const int* s, int* o, const int* cd) {
  const int p0 = cd[1], p1 = cd[2];
  switch (cd[0]) {
    case CG_RESTART: return Guard{cr_restart<WRITE>(g, sp, s, o, p0), cd[3], false};
    case CG_REQUEST_VOTE: return cr_request_vote<WRITE>(g, sp, s, o, p0);
    case CG_BECOME_LEADER:
      return Guard{cr_become_leader<J, WRITE>(g, sp, s, o, p0), cd[3], false};
    case CG_CLIENT_REQUEST: return cr_client_request<J, WRITE>(g, sp, s, o, p0, p1);
    case CG_ADVANCE_COMMIT:
      return Guard{cr_advance_commit<J, WRITE>(g, sp, s, o, p0), cd[3], false};
    case CG_APPEND_ENTRIES: return cr_append_entries<WRITE>(g, sp, s, o, p0, p1);
    case CG_SEND_SNAPSHOT: return cr_send_snapshot<WRITE>(g, sp, s, o, p0, p1);
    case CG_HANDLE_MESSAGE: return cr_handle_message<J, WRITE>(g, sp, s, o, p0);
    case CG_APPEND_ADD: return ar_append_member<WRITE>(g, sp, s, o, p0, p1, true);
    case CG_APPEND_REMOVE: return ar_append_member<WRITE>(g, sp, s, o, p0, p1, false);
    case CG_RESET_IDENTITY:
      return Guard{ar_reset_identity<WRITE>(g, sp, s, o, p0), cd[3], false};
    case CG_APPEND_OLDNEW: return jc_append_old_new<WRITE>(g, sp, s, o, p0, p1);
    case CG_APPEND_NEW: return jc_append_new<WRITE>(g, sp, s, o, p0);
  }
  return Guard{false, cd[3], false};
}

// ---- invariants and the liveness predicates (true = holds) ----

// whole-entry equality of servers i and j at lane l
__device__ __forceinline__ bool cr_entry_eq(const int* sp, const int* s, int i, int j, int l) {
  const int L = CFLD(L), NE = CFLD(NE);
  for (int e = 0; e < NE; ++e)
    if (s[sp[CS_LOG + e] + i * L + l] != s[sp[CS_LOG + e] + j * L + l]) return false;
  return true;
}

// MessagesAreValid — MessagePassing.tla:81-83
__device__ bool cr_messages_are_valid(const int* sp, const int* s) {
  const int M = CFLD(M);
  for (int m = 0; m < M; ++m) {
    int kw[CR_MAX_WORDS];
    cr_key_words(sp, s, m, kw);
    if (kw[0] != RA_EMPTY && cr_unpack(sp, kw, CF_MSOURCE) == cr_unpack(sp, kw, CF_MDEST))
      return false;
  }
  return true;
}

// NoLogDivergence — JointConsensus :1066-1074 / AddRemove :1017-1025
__device__ bool cr_no_log_divergence(const int* sp, const int* s) {
  const int S = CFLD(S), L = CFLD(L);
  const int* ci = s + CFLD(CI);
  for (int i = 0; i < S; ++i)
    for (int j = 0; j < S; ++j) {
      const int mci = ci[i] < ci[j] ? ci[i] : ci[j];
      for (int l = 0; l < L; ++l)
        if (l + 1 <= mci && !cr_entry_eq(sp, s, i, j, l)) return false;
    }
  return true;
}

// LeaderHasAllAckedValues — JointConsensus :1109-1125 / AddRemove
// :1047-1063 (AppendCommand entries only)
template <bool J>
__device__ bool cr_leader_has_acked(const int* sp, const int* s) {
  const int S = CFLD(S), L = CFLD(L), V = CFLD(V);
  const int* ct = s + CFLD(CT);
  for (int i = 0; i < S; ++i) {
    bool not_stale = true;
    for (int j = 0; j < S; ++j) not_stale = not_stale && ct[i] >= ct[j];
    if (!(s[CFLD(ST) + i] == CR_LEADER && not_stale)) continue;
    const int* cmd = cr_log(sp, s, E_CMD, i);
    const int* val = cr_log(sp, s, E_VAL, i);
    for (int v = 0; v < V; ++v) {
      if (s[CFLD(ACK) + v] != RA_ACK_TRUE) continue;
      bool has = false;
      for (int l = 0; l < L; ++l) has |= (cmd[l] == cr_append_cmd<J>() ? val[l] : 0) == v + 1;
      if (!has) return false;
    }
  }
  return true;
}

// CommittedEntriesReachMajority — AddRemove :1067-1078 / JointConsensus
// :1129-1140: a quorum of config[i].members, of the exact majority size,
// with i in it
__device__ bool cr_committed_majority(const int* sp, const int* s) {
  const int S = CFLD(S), L = CFLD(L);
  bool any_lead = false, ok_exists = false;
  for (int i = 0; i < S; ++i) {
    const int ci = s[CFLD(CI) + i];
    if (!(s[CFLD(ST) + i] == CR_LEADER && ci > 0)) continue;
    any_lead = true;
    const int pos = ra_clamp(ci - 1, 0, L - 1);
    const int members = s[CFLD(CMEM) + i];
    int agree = 0;
    bool self_in = false;
    for (int j = 0; j < S; ++j) {
      const bool a = cr_bit(members, j) && s[CFLD(LL) + j] >= ci && cr_entry_eq(sp, s, i, j, pos);
      agree += a;
      self_in |= a && j == i;
    }
    ok_exists |= agree >= cr_pop(members, S) / 2 + 1 && self_in;
  }
  return !any_lead || ok_exists;
}

// MaxOneReconfigurationAtATime — AddRemove :1031-1039 (no leader with two
// uncommitted config commands) / JointConsensus :1080-1101 (two config
// commands of one type have one of the other type strictly between them)
template <bool J>
__device__ bool cr_max_one_reconfig(const int* sp, const int* s) {
  const int S = CFLD(S), L = CFLD(L);
  for (int i = 0; i < S; ++i) {
    const int* cmd = cr_log(sp, s, E_CMD, i);
    const int ll = s[CFLD(LL) + i];
    if (!J) {
      if (s[CFLD(ST) + i] != CR_LEADER) continue;
      int n = 0;
      for (int l = 0; l < L; ++l)
        n += cr_is_cfg<J>(cmd[l]) && l + 1 <= ll && l + 1 > s[CFLD(CI) + i];
      if (n >= 2) return false;
      continue;
    }
    for (int k1 = 0; k1 < L; ++k1)
      for (int k2 = k1 + 1; k2 < L; ++k2) {
        if (k2 >= ll || cmd[k1] != cmd[k2] || (cmd[k1] != JC_OLDNEW && cmd[k1] != JC_NEW))
          continue;
        const int other = cmd[k1] == JC_OLDNEW ? JC_NEW : JC_OLDNEW;
        bool between = false;
        for (int k = k1 + 1; k < k2; ++k) between |= cmd[k] == other;
        if (!between) return false;
      }
  }
  return true;
}

// ReconfigurationCompletes' antecedent P and consequent Q: AddRemove
// :992-1005 (P: a leader with a config command in its log; Q: a leader
// with a config command every member of whose set holds it identically at
// the same index), JointConsensus :1027-1054 (P: a committed
// OldNewConfigCommand; Q: the last permissible election failed leaderless,
// or a majority of a committed OldNew entry's new set are self-aware
// members not NotMember holding a NewConfigCommand of its id)
template <bool J>
__device__ bool cr_reconfig_pq(const int* sp, const int* s, bool q) {
  const int S = CFLD(S), L = CFLD(L);
  if (J && q) {
    bool leader = false;
    for (int i = 0; i < S; ++i) leader |= s[CFLD(ST) + i] == CR_LEADER;
    if (s[CFLD(ECTR)] == CFLD(MAX_ELECTIONS) && !leader) return true;
  }
  for (int i = 0; i < S; ++i) {
    const int* cmd = cr_log(sp, s, E_CMD, i);
    const int ll = s[CFLD(LL) + i];
    for (int l = 0; l < L; ++l) {
      if (l >= ll) continue;
      if (!J) {
        if (s[CFLD(ST) + i] != CR_LEADER || !cr_is_cfg<J>(cmd[l])) continue;
        if (!q) return true;
        const int members = cr_log(sp, s, E_X1, i)[l];
        bool complete = true;
        for (int j = 0; j < S; ++j)
          complete = complete && (!cr_bit(members, j) ||
                                  (l < s[CFLD(LL) + j] && cr_entry_eq(sp, s, i, j, l)));
        if (complete) return true;
        continue;
      }
      if (cmd[l] != JC_OLDNEW || s[CFLD(CI) + i] < l + 1) continue;  // OldNewCommitted
      if (!q) return true;
      const int nset = cr_log(sp, s, E_X1, i)[l], id = cr_log(sp, s, E_CID, i)[l];
      int count = 0;
      for (int j = 0; j < S; ++j) {
        if (!cr_bit(nset, j) || !cr_bit(s[CFLD(CMEM) + j], j) ||
            s[CFLD(ST) + j] == CR_NOTMEMBER)
          continue;
        bool has = false;
        const int* cj = cr_log(sp, s, E_CMD, j);
        const int* idj = cr_log(sp, s, E_CID, j);
        for (int l2 = 0; l2 < L; ++l2)
          has |= l2 < s[CFLD(LL) + j] && cj[l2] == JC_NEW && idj[l2] == id;
        count += has;
      }
      if (2 * count > cr_pop(nset, S)) return true;
    }
  }
  return false;
}

template <bool J>
__device__ bool cr_predicate(const int* sp, const int* s, int id) {
  switch (id) {
    case INV_MESSAGES_ARE_VALID: return cr_messages_are_valid(sp, s);
    case INV_NO_LOG_DIVERGENCE: return cr_no_log_divergence(sp, s);
    case INV_LEADER_HAS_ALL_ACKED: return cr_leader_has_acked<J>(sp, s);
    case INV_COMMITTED_REACH_MAJORITY: return cr_committed_majority(sp, s);
    case CR_INV_MAX_ONE_RECONFIG: return cr_max_one_reconfig<J>(sp, s);
    case CR_PRED_RECONFIG_P: return cr_reconfig_pq<J>(sp, s, false);
    case CR_PRED_RECONFIG_Q: return cr_reconfig_pq<J>(sp, s, true);
  }
  return true;  // INV_TEST
}

// A reconfiguration spec as the kernel drivers see it (J: JointConsensus):
// where its spec keeps the sizes and the bag, its guard lanes and chains
// (the group guard, expand_driver.cuh guard_group_body over
// actions_common.cuh guard_state), its actions (the group apply) and its
// predicates.
template <bool J>
struct ConfigFamily {
  static constexpr int SPEC_LEN = CS_LEN;
  static constexpr int MAX_WORDS = CR_MAX_WORDS;  // the most key words of a bag
  static constexpr int I_M = CS_M, I_W = CS_W, I_A = CS_A, I_K = CS_K;
  static constexpr int I_NW = CS_NW, I_BAG = CS_W0;
  // the group apply's threads a worklist lane and resident blocks an SM
  // (expand_driver.cuh; PERF.md's tile tables)
  static constexpr int APPLY_G = 32, APPLY_BLOCKS = 3;
  // one candidate's guard, run by its member alone: (valid, rank, ovf) but
  // for its put, kept in rq
  __device__ __forceinline__ static Guard lane(const int* sp, const int* s, const int* cd,
                                               PutReq& rq) {
    return cr_action<J, false>(GrpRecord(&rq), sp, s, nullptr, cd);
  }
  // RequestVote's chain of the lane cd by the group g, on its copy of the
  // state's key words in `scratch` (NW * M ints): gd.valid and gd.ovf
  template <class Gp>
  __device__ __forceinline__ static void chain(Gp g, const int* sp, const int* s, const int* cd,
                                               int* scratch, Guard& gd) {
    g.sync();  // the group's reads of the last chain's copy before this one
    grp_for(g, CFLD(NW) * CFLD(M), [&](int u) { scratch[u] = s[CFLD(W0) + u]; });
    g.sync();
    cr_rv_chain<false>(g, sp, s, cd[1], scratch, nullptr, gd);
  }
  // the successor row `o` (a copy of `s`) of one candidate, by the group g
  // of threads that shares the lane (expand_driver.cuh's group apply)
  template <class Gp>
  __device__ __forceinline__ static void apply(Gp g, const int* sp, const int* s, int* o,
                                               const int* cd) {
    cr_action<J, true>(g, sp, s, o, cd);
  }
  __device__ __forceinline__ static bool invariant(const int* sp, const int* s, int id) {
    return cr_predicate<J>(sp, s, id);
  }
  __device__ __forceinline__ static bool predicate(const int* sp, const int* s, int id) {
    return cr_predicate<J>(sp, s, id);
  }
};
typedef ConfigFamily<false> ReconfigFamily;
typedef ConfigFamily<true> JointFamily;

#undef CFLD
