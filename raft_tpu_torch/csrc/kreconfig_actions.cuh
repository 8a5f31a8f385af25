// kreconfig_actions.cuh — the KRaftWithReconfig action groups, invariants
// and liveness predicates as device code.
//
// Replaces raft_tpu/models/kraft_reconfig.py:394-1485 (the transition
// machine, the log-position and config math, the action kernels :754-1065
// and the fused receipt :1067-1366 behind _expand1 :1446, with
// ops/bag.py:33 wide_bag_put and ops/packing.py's WidePacker), its
// invariants :1555-1654 and its liveness predicates :1367-1444. It mirrors
// the port's batched plain version, raft_tpu_torch/models/kraft_reconfig.py,
// one (state, candidate) pair at a time: the layout, the message packing
// and the bounds come from the model's int32 spec vector
// (KRaftReconfigModel.kernel_spec).
//
// Every action group is one function templated on WRITE, as in
// kraft_actions.cuh: with WRITE false it computes only (valid, rank, ovf)
// and writes no successor lane; with WRITE true it also writes the
// successor row `o`, a copy of the state `s` made by the caller, lane by
// changed lane, whether the candidate is enabled or not (a receipt lane
// where no branch fires writes nothing). Each also takes a group of threads
// (actions_common.cuh, as config_actions.cuh's do: GrpOne for a guard lane,
// a warp tile for the apply, GrpSerial in the host tests): every member
// computes the scalar part on the same inputs, the lead member makes the
// scalar writes, and the bag puts and the multi-lane writes are split over
// the members. RequestVote(i) and BecomeLeader(i) each put a chain of up to
// NS - 1 messages (one per config member), each put acting on the bag the
// previous one left, a put that finds its message disabling the action
// (SendMultipleOnce); a guard lane of either replays its chain on its own
// copy of the bag's key words (KReconfigFamily gives each of the 2 * NS
// chain lanes of a state a slot). The apply's keys, key words and logs are
// read and built with compile-time indices only (IKey, KcFetchLog), so they
// stay in registers; the guard keeps its int64 keys, key-word array and
// materialized log (actions_common.cuh NwForm).
//
// The state is a row of NS identity slots (a `used` mask): leader,
// votedFor, pf_dest, log_who, mleader and e_who hold slot + 1 (0 = Nil),
// msource and mdest the raw slot; member sets, votesGranted and eo_dom (the
// domain of endOffset) are slot bitmasks; a log entry spans six lanes
// (cmd, epoch, val, cfgid, who, members). Message keys are NW <= 3 int32
// words, word w of slot m at msg_w0 + w * M + m, the slots in lexicographic
// order of the words from word 0, unused slots EMPTY in every word and
// count 0 last.
//
// Bit-identity rules the code keeps (properties of the reference, which
// indexes with traced values, and of the plain version):
//   - a read x[i] with an out-of-range index reads the clamped index and a
//     write to one writes nothing (jx_get / jx_set): a record's 3-bit mdest
//     may name no slot of five;
//   - every key is computed in int32 (the reference's _pack casts);
//   - the thirteen receipt branches are disjoint; the incoming Discard and
//     the branch's reply collapse into one put, whose existed (read on the
//     state's bag: the discard changes only a count) disables only the four
//     FetchRequest replies, so their writes wait for it;
//   - the two CASE chains (MaybeTransition, MaybeHandleCommonResponse)
//     take their first matching arm.
#pragma once

#include "actions_common.cuh"

#define KC_MAX_WORDS 3  // key words (models/kraft_reconfig.py MAX_WORDS)
#define KC_MAX_L 8      // log lanes (MAX_LOG)
#define KC_MAX_S 8      // identity slots (MAX_SLOTS)

// server states (:354-360), roles (:349-351), mtype, merror, mresult, log
// commands (models/kraft_reconfig.py)
enum { KC_UNATTACHED, KC_VOTED, KC_FOLLOWER, KC_CANDIDATE, KC_LEADER, KC_RESIGNED, KC_DEAD,
       KC_ILLEGAL };
enum { KC_R_NONE, KC_R_VOTER, KC_R_OBSERVER, KC_R_DEAD };
enum { KC_RVREQ = 1, KC_RVRESP, KC_BQREQ, KC_FETCHREQ, KC_FETCHRESP, KC_JOINREQ, KC_JOINRESP };
enum { KC_E_NONE, KC_E_FENCED, KC_E_NOTLEADER, KC_E_UNKNOWN_LEADER, KC_E_UNKNOWN_MEMBER,
       KC_E_ALREADY_MEMBER };
enum { KC_RES_NONE, KC_RES_OK, KC_RES_NOTOK, KC_RES_DIVERGING };
enum { KC_C_NONE, KC_C_INIT, KC_C_APPEND, KC_C_ADD, KC_C_REMOVE };

// Next-disjunct ranks (models/kraft_reconfig.py KR_*, :1730-1756)
enum {
  KQ_RESTART, KQ_REQUESTVOTE, KQ_HANDLE_RVREQ, KQ_HANDLE_RVRESP, KQ_BECOMELEADER,
  KQ_CLIENTREQUEST, KQ_REJECT_FETCH, KQ_DIVERGING_FETCH, KQ_ACCEPT_FETCH_VOTER,
  KQ_ACCEPT_FETCH_OBSERVER, KQ_ACCEPT_BQREQ, KQ_SENDFETCH, KQ_HANDLE_FETCH_OK,
  KQ_HANDLE_FETCH_DIV, KQ_HANDLE_FETCH_NONSUCCESS, KQ_STARTNEWSERVER, KQ_SENDJOIN,
  KQ_ACCEPT_JOIN, KQ_REJECT_JOIN, KQ_HANDLE_REJECT_JOIN, KQ_HANDLE_REMOVE
};

// The spec vector (models/kraft_reconfig.py SPEC_SCALARS, then MSG_FIELDS x 3).
enum {
  KC_S, KC_V, KC_L, KC_M, KC_W, KC_A, KC_K, KC_NW, KC_VL,
  KC_HOST, KC_DISK, KC_USED, KC_ROLE, KC_ST, KC_EP, KC_LED, KC_VF,
  KC_PF_ACT, KC_PF_EP, KC_PF_OFF, KC_PF_LE, KC_PF_DEST, KC_PF_OBS,
  KC_VG, KC_CID, KC_CM, KC_CCOMM, KC_EODOM, KC_EO,
  KC_LOG,  // log_cmd, log_epoch, log_val, log_cfgid, log_who, log_members: KC_LOG + slot
  KC_LL = KC_LOG + 6, KC_HWM, KC_ACK, KC_W0, KC_CNT, KC_ECTR, KC_RCTR, KC_RMCTR, KC_DIG,
  KC_VALCTR,
  KC_N_HOSTS, KC_ICS, KC_MIN_CLUSTER, KC_MAX_CLUSTER, KC_MAX_ELECTIONS, KC_MAX_RESTARTS,
  KC_MAX_VPE, KC_MAX_ADD, KC_MAX_REMOVE, KC_MAX_EPOCH,
  KC_MSG
};
// log entry slots
enum { KE_CMD, KE_EPOCH, KE_VAL, KE_CFGID, KE_WHO, KE_MEMBERS, KE_N };
enum {
  KM_MTYPE, KM_MEPOCH, KM_MSOURCE, KM_MDEST, KM_MLASTLOGEPOCH, KM_MLASTLOGOFFSET, KM_MLEADER,
  KM_MVOTEGRANTED, KM_MERROR, KM_MRESULT, KM_MFETCHOFFSET, KM_MLASTFETCHEDEPOCH, KM_MOBSERVER,
  KM_MHWM, KM_NENTRIES,
  KM_E,  // e_cmd, e_epoch, e_val, e_cfgid, e_who, e_members: KM_E + entry slot
  KM_MDIVEPOCH = KM_E + KE_N, KM_MDIVENDOFFSET, KM_CEPOCH, KM_CFETCHOFFSET,
  KM_CLASTFETCHEDEPOCH, KM_COBSERVER, KM_N
};
#define KC_LEN (KC_MSG + 3 * KM_N)

// Action groups (models/kraft_reconfig.py GROUP_IDS).
enum {
  KG2_RESTART, KG2_REQUEST_VOTE, KG2_BECOME_LEADER, KG2_CLIENT_REQUEST, KG2_SEND_FETCH,
  KG2_START_NEW_SERVER, KG2_SEND_JOIN, KG2_HANDLE_REMOVE, KG2_HANDLE_MESSAGE
};
// the family's own invariants and liveness predicates
// (KRECONFIG_INVARIANT_IDS, PRED_VALUE, PRED_CONFIG)
enum { KC_INV_NO_ILLEGAL = 5, KC_INV_NEVER_TWO_LEADERS = 6, KC_INV_STATES_MATCH_ROLES = 7 };
#define KC_PRED_VALUE 16
#define KC_PRED_CONFIG 24

#define KFD(o) (sp[KC_##o])

// ---- field access (a slot's lane of a per-slot field, clamped) ----

__device__ __forceinline__ int kc_get(const int* sp, const int* s, int f, int i) {
  return jx_get(s + sp[f], sp[KC_S], i);
}
__device__ __forceinline__ void kc_set(const int* sp, int* o, int f, int i, int v) {
  jx_set(o + sp[f], sp[KC_S], i, v);
}
// slot i's row of a log field (entry slot e), clamped
__device__ __forceinline__ const int* kc_log(const int* sp, const int* s, int e, int i) {
  return s + sp[KC_LOG + e] + jx_index(i, sp[KC_S]) * sp[KC_L];
}
__device__ __forceinline__ bool kc_bit(int mask, int j) { return ((mask >> j) & 1) > 0; }
__device__ __forceinline__ int kc_pop(int x, int S) {
  int n = 0;
  for (int k = 0; k < S; ++k) n += (x >> k) & 1;
  return n;
}
__device__ __forceinline__ int kc_used_mask(const int* sp, const int* s) {
  int mask = 0;
  for (int k = 0; k < KFD(S); ++k) mask |= (s[KFD(USED) + k] > 0) << k;
  return mask;
}

// ---- message keys (actions_common.cuh: the N-word bag, NwForm) ----
//
// In the guard's form or the apply's, picked by the action's WRITE: the
// apply's keys and key words are IKey, every word picked by masks over
// KC_MAX_WORDS, so they stay in registers.

template <bool WRITE>
using KcForm = NwForm<WRITE, KC_MAX_WORDS>;

__device__ __forceinline__ void kc_pack(const int* sp, WKey& k, int f, long long v) {
  nw_pack_q(sp + KC_MSG + 3 * f, k, v);
}
__device__ __forceinline__ void kc_pack(const int* sp, IKey& k, int f, int v) {
  nw_pack_q<KC_MAX_WORDS>(sp + KC_MSG + 3 * f, k, v);
}
// a field of a key given as its words
__device__ __forceinline__ int kc_unpack(const int* sp, const int* kw, int f) {
  return nw_unpack_q(sp + KC_MSG + 3 * f, kw);
}
__device__ __forceinline__ int kc_unpack(const int* sp, const IKey& kw, int f) {
  return nw_unpack_q<KC_MAX_WORDS>(sp + KC_MSG + 3 * f, kw);
}
// slot m's key words (the slot clamped; 0 past NW)
__device__ __forceinline__ void kc_key_words(const int* sp, const int* s, int m, int* kw) {
  const int M = KFD(M);
  for (int w = 0; w < KC_MAX_WORDS; ++w) kw[w] = 0;
  for (int w = 0; w < KFD(NW); ++w) kw[w] = jx_get(s + KFD(W0) + w * M, M, m);
}
__device__ __forceinline__ void kc_key_words(const int* sp, const int* s, int m, IKey& kw) {
  const int M = KFD(M), NW = KFD(NW);
  kw = nw_ikey();
#pragma unroll
  for (int w = 0; w < KC_MAX_WORDS; ++w)
    kw.w[w] = w < NW ? jx_get(s + KFD(W0) + w * M, M, m) : 0;
}

// ---- the transition machine (:599-715) ----

struct KSle {
  int st, ep, ld;  // state, epoch, leader (slot + 1, 0 = Nil)
};

// HasConsistentLeader — :599-616 (resigned/observer carve-outs)
__device__ __forceinline__ bool kc_consistent_leader(const int* sp, const int* s, int i,
                                                     int leader, int epoch) {
  const int cur = kc_get(sp, s, KC_EP, i), st = kc_get(sp, s, KC_ST, i);
  const int led = kc_get(sp, s, KC_LED, i);
  if (leader == i + 1)
    return (cur == epoch && (kc_get(sp, s, KC_ROLE, i) == KC_R_OBSERVER || st == KC_RESIGNED))
               ? true
               : st == KC_LEADER;
  return epoch != cur || leader == RA_NIL || led == RA_NIL || led == leader;
}

// MaybeTransition — :656-675: the first matching arm of illegal (no
// consistent leader), unattached or follower (a newer epoch), follower (a
// leader learned that is not i), no-op; TransitionToFollower (:645-653)
// turns illegal when i already follows or leads that epoch.
__device__ __forceinline__ KSle kc_maybe_transition(const int* sp, const int* s, int i,
                                                    int leader, int epoch) {
  const int cur = kc_get(sp, s, KC_EP, i), st = kc_get(sp, s, KC_ST, i);
  const int led = kc_get(sp, s, KC_LED, i);
  if (!kc_consistent_leader(sp, s, i, leader, epoch)) return KSle{KC_ILLEGAL, 0, RA_NIL};
  bool follow;
  if (epoch > cur) {
    if (leader == RA_NIL) return KSle{KC_UNATTACHED, epoch, RA_NIL};
    follow = true;
  } else {
    follow = leader != RA_NIL && led == RA_NIL && leader != i + 1;
  }
  if (!follow) return KSle{st, cur, led};
  const bool ill = cur == epoch && (st == KC_FOLLOWER || st == KC_LEADER);
  return ill ? KSle{KC_ILLEGAL, 0, 0} : KSle{KC_FOLLOWER, epoch, leader};
}

// MaybeHandleCommonResponse — :683-715: a stale epoch is handled as a
// no-op; a newer epoch, FencedLeaderEpoch or NotLeader transitions; the
// current epoch with a leader learned follows it (handled only with an
// error); else not handled.
__device__ __forceinline__ KSle kc_mhcr(const int* sp, const int* s, int i, int leader,
                                        int epoch, int err, bool* handled) {
  const int cur = kc_get(sp, s, KC_EP, i), st = kc_get(sp, s, KC_ST, i);
  const int led = kc_get(sp, s, KC_LED, i);
  *handled = true;
  if (epoch < cur) return KSle{st, cur, led};
  if (epoch > cur || err == KC_E_FENCED || err == KC_E_NOTLEADER)
    return kc_maybe_transition(sp, s, i, leader, epoch);
  if (epoch == cur && leader != RA_NIL && led == RA_NIL) {
    *handled = err != KC_E_NONE;
    return KSle{KC_FOLLOWER, cur, leader};
  }
  *handled = false;
  return KSle{st, cur, led};
}

__device__ __forceinline__ void kc_set_sle(const int* sp, int* o, int i, KSle v) {
  kc_set(sp, o, KC_ST, i, v.st);
  kc_set(sp, o, KC_EP, i, v.ep);
  kc_set(sp, o, KC_LED, i, v.ld);
}

// pendingFetch[i] := Nil (its six lanes), split over the group
template <class Gp>
__device__ __forceinline__ void kc_clear_pf(Gp g, const int* sp, int* o, int i) {
  grp_for(g, KC_PF_OBS - KC_PF_ACT + 1, [&](int u) { kc_set(sp, o, KC_PF_ACT + u, i, 0); });
}

// endOffset[i][q] := v(q) for every slot q, split over the group
template <class Gp, class Fn>
__device__ __forceinline__ void kc_set_eo_row(Gp g, const int* sp, int* o, int i, Fn v) {
  const int S = KFD(S);
  grp_for(g, S, [&](int q) { jx_set2(o + KFD(EO), S, S, i, q, v(q)); });
}

// slot i's log entry at lane pos := a config command's (cmd, epoch, cfgid,
// who, members; its value lane untouched), the lanes split over the group
template <class Gp>
__device__ __forceinline__ void kc_put_cfg_entry(Gp g, const int* sp, int* o, int i, int pos,
                                                 int cmd, int epoch, int cfgid, int who,
                                                 int members) {
  const int S = KFD(S), L = KFD(L);
  grp_for(g, KE_N, [&](int e) {
    if (e == KE_VAL) return;
    const int v = e == KE_CMD     ? cmd
                  : e == KE_EPOCH ? epoch
                  : e == KE_CFGID ? cfgid
                  : e == KE_WHO   ? who
                                  : members;
    jx_set2(o + sp[KC_LOG + e], S, L, i, pos, v);
  });
}

// ---- log-position and config math (:498-777) over log rows of L lanes ----

__device__ __forceinline__ int kc_last_epoch(const int* ep, int L, int ll) {
  return ll > 0 ? ep[ra_clamp(ll - 1, 0, L - 1)] : 0;
}

// EndOffsetForEpoch — :551-567
__device__ __forceinline__ void kc_end_offset_for_epoch(const int* ep, int L, int ll, int lfe,
                                                        int* off, int* e) {
  int best = 0;
  for (int l = 0; l < L; ++l)
    if (l < ll && ep[l] <= lfe) best = l + 1;
  *off = best;
  *e = best > 0 ? ep[ra_clamp(best - 1, 0, L - 1)] : 0;
}

// HighestCommonOffset — :521-539
__device__ __forceinline__ int kc_highest_common_offset(const int* ep, int L, int ll, int end_off,
                                                        int epoch) {
  int best = 0;
  for (int l = 0; l < L; ++l)
    if (l < ll && (ep[l] < epoch || (ep[l] == epoch && l + 1 <= end_off))) best = l + 1;
  return best;
}

// MostRecentReconfigEntry — :729-735: the offset of the last config
// command among the first len lanes, 0 if none
__device__ __forceinline__ int kc_most_recent_reconfig(const int* cmd, int L, int len) {
  int best = 0;
  for (int l = 0; l < L; ++l)
    if (l < len && (cmd[l] == KC_C_INIT || cmd[l] == KC_C_ADD || cmd[l] == KC_C_REMOVE))
      best = l + 1;
  return best;
}
// the same over a log given as row(e, l)
template <class Row>
__device__ __forceinline__ int kc_last_reconfig(const Row& row, int L, int len) {
  int best = 0;
  for (int l = 0; l < L; ++l) {
    const int c = row(KE_CMD, l);
    if (l < len && (c == KC_C_INIT || c == KC_C_ADD || c == KC_C_REMOVE)) best = l + 1;
  }
  return best;
}

// LeaderHasCommittedOffsetsInCurrentEpoch — :774-777
__device__ __forceinline__ bool kc_committed_in_epoch(const int* sp, const int* s, int i) {
  const int L = KFD(L), ll = kc_get(sp, s, KC_LL, i), cur = kc_get(sp, s, KC_EP, i);
  const int hwm = kc_get(sp, s, KC_HWM, i);
  const int* ep = kc_log(sp, s, KE_EPOCH, i);
  for (int l = 0; l < L; ++l)
    if (l < ll && ep[l] == cur && hwm >= l + 1) return true;
  return false;
}


// ---- action groups ----
//
// Each takes the group of threads that shares the lane (GrpOne for a guard
// lane): every member runs the scalar part on the same inputs, the lead
// member makes the scalar writes, and the bag puts and the multi-lane
// writes (a log install, a config entry, an endOffset row, pendingFetch)
// are split over the group.

// RestartWithState — :873-896: a leader restarts as Resigned (voter) or
// Unattached (observer); keeps epoch, role, votedFor and the log
template <bool WRITE, class Gp>
__device__ bool kc_restart(Gp g, const int* sp, const int* s, int* o, int i) {
  const int st = kc_get(sp, s, KC_ST, i);
  if (WRITE) {
    if (g.lead()) {
      const bool was_leader = st == KC_LEADER;
      kc_set(sp, o, KC_ST, i,
             was_leader ? (kc_get(sp, s, KC_ROLE, i) == KC_R_VOTER ? KC_RESIGNED : KC_UNATTACHED)
                        : st);
      kc_set(sp, o, KC_LED, i, was_leader ? RA_NIL : kc_get(sp, s, KC_LED, i));
      kc_set(sp, o, KC_VG, i, 0);
      kc_set(sp, o, KC_EODOM, i, kc_used_mask(sp, s));
      kc_set(sp, o, KC_HWM, i, 0);
      o[KFD(RCTR)] = s[KFD(RCTR)] + 1;
    }
    kc_set_eo_row(g, sp, o, i, [](int) { return 0; });
    kc_clear_pf(g, sp, o, i);
  }
  return s[KFD(RCTR)] < KFD(MAX_RESTARTS) && kc_get(sp, s, KC_USED, i) > 0 && st != KC_DEAD;
}

// the bag a chain of puts acts on: the successor's, or a guard lane's copy
// of the state's key words (no counts)
__device__ __forceinline__ int* kc_chain_words(const int* sp, const int* s, int* o, int* bag,
                                               bool write) {
  if (write) return o + KFD(W0);
  for (int t = 0; t < KFD(NW) * KFD(M); ++t) bag[t] = s[KFD(W0) + t];
  return bag;
}

// RequestVote — :932-955: a Voter of its own config; a RequestVoteRequest
// to each config member, SendMultipleOnce
template <bool WRITE, class Gp>
__device__ Guard kc_request_vote(Gp g, const int* sp, const int* s, int* o, int i, int* bag) {
  const int S = KFD(S), L = KFD(L), M = KFD(M), NW = KFD(NW);
  const int st = kc_get(sp, s, KC_ST, i), members = kc_get(sp, s, KC_CM, i);
  Guard gd{s[KFD(ECTR)] < KFD(MAX_ELECTIONS) && kc_get(sp, s, KC_USED, i) > 0 &&
               kc_get(sp, s, KC_ROLE, i) == KC_R_VOTER &&
               (st == KC_FOLLOWER || st == KC_CANDIDATE || st == KC_UNATTACHED) &&
               kc_bit(members, i),
           KQ_REQUESTVOTE, false};
  if (!WRITE && !gd.valid) return gd;  // ovf is masked by valid
  const int new_ep = kc_get(sp, s, KC_EP, i) + 1;
  const int ll = kc_get(sp, s, KC_LL, i);
  const int last_ep = kc_last_epoch(kc_log(sp, s, KE_EPOCH, i), L, ll);
  int* words = kc_chain_words(sp, s, o, bag, WRITE);
  int* cnt = WRITE ? o + KFD(CNT) : nullptr;
  bool ovf = false;
  for (int d = 1; d < S; ++d) {
    const int j = (i + d) % S;
    if (!kc_bit(members, j)) continue;
    typename KcForm<WRITE>::Key k;
    nw_key_init(k);
    kc_pack(sp, k, KM_MTYPE, KC_RVREQ);
    kc_pack(sp, k, KM_MEPOCH, new_ep);
    kc_pack(sp, k, KM_MLASTLOGEPOCH, last_ep);
    kc_pack(sp, k, KM_MLASTLOGOFFSET, ll);
    kc_pack(sp, k, KM_MSOURCE, i);
    kc_pack(sp, k, KM_MDEST, j);
    const Put p = nw_probe<KC_MAX_WORDS>(g, words, M, NW, k);  // on the bag the last put left
    gd.valid = gd.valid && !p.existed;
    ovf = ovf || p.overflow;
    nw_insert<KC_MAX_WORDS>(g, words, cnt, M, NW, k, p);
  }
  gd.ovf = ovf && gd.valid;
  if (WRITE) {
    if (g.lead()) {
      kc_set(sp, o, KC_ST, i, KC_CANDIDATE);
      kc_set(sp, o, KC_EP, i, new_ep);
      kc_set(sp, o, KC_LED, i, RA_NIL);
      kc_set(sp, o, KC_VF, i, i + 1);
      kc_set(sp, o, KC_VG, i, 1 << i);
      o[KFD(ECTR)] = s[KFD(ECTR)] + 1;
    }
    kc_clear_pf(g, sp, o, i);
  }
  return gd;
}

// BecomeLeader — :1056-1071: a quorum of the candidate's own config;
// BeginQuorumRequests to its members, SendMultipleOnce; endOffset reset
template <bool WRITE, class Gp>
__device__ Guard kc_become_leader(Gp g, const int* sp, const int* s, int* o, int i, int* bag) {
  const int S = KFD(S), M = KFD(M), NW = KFD(NW);
  const int members = kc_get(sp, s, KC_CM, i), vg = kc_get(sp, s, KC_VG, i);
  Guard gd{kc_get(sp, s, KC_USED, i) > 0 && kc_get(sp, s, KC_ST, i) == KC_CANDIDATE &&
               (vg & ~members) == 0 && 2 * kc_pop(vg, S) > kc_pop(members, S),
           KQ_BECOMELEADER, false};
  if (!WRITE && !gd.valid) return gd;
  const int ep = kc_get(sp, s, KC_EP, i);
  int* words = kc_chain_words(sp, s, o, bag, WRITE);
  int* cnt = WRITE ? o + KFD(CNT) : nullptr;
  bool ovf = false;
  for (int d = 1; d < S; ++d) {
    const int j = (i + d) % S;
    if (!kc_bit(members, j)) continue;
    typename KcForm<WRITE>::Key k;
    nw_key_init(k);
    kc_pack(sp, k, KM_MTYPE, KC_BQREQ);
    kc_pack(sp, k, KM_MEPOCH, ep);
    kc_pack(sp, k, KM_MSOURCE, i);
    kc_pack(sp, k, KM_MDEST, j);
    const Put p = nw_probe<KC_MAX_WORDS>(g, words, M, NW, k);
    gd.valid = gd.valid && !p.existed;
    ovf = ovf || p.overflow;
    nw_insert<KC_MAX_WORDS>(g, words, cnt, M, NW, k, p);
  }
  gd.ovf = ovf && gd.valid;
  if (WRITE) {
    if (g.lead()) {
      kc_set(sp, o, KC_ST, i, KC_LEADER);
      kc_set(sp, o, KC_LED, i, i + 1);
      kc_set(sp, o, KC_EODOM, i, kc_used_mask(sp, s));
    }
    kc_set_eo_row(g, sp, o, i, [](int) { return 0; });
  }
  return gd;
}

// ClientRequest — :1110-1126: bounded per epoch by valueCtr; a log at
// max_log overflows
template <bool WRITE, class Gp>
__device__ Guard kc_client_request(Gp g, const int* sp, const int* s, int* o, int i, int v) {
  const int S = KFD(S), L = KFD(L), V = KFD(V);
  const int ep = kc_get(sp, s, KC_EP, i);
  const int epc = ra_clamp(ep - 1, 0, KFD(MAX_EPOCH) - 1);
  Guard gd{kc_get(sp, s, KC_USED, i) > 0 && kc_get(sp, s, KC_ST, i) == KC_LEADER &&
               jx_get(s + KFD(ACK), V, v) == RA_ACK_NIL &&
               s[KFD(VALCTR) + epc] < KFD(MAX_VPE),
           KQ_CLIENTREQUEST, false};
  const int pos = kc_get(sp, s, KC_LL, i);
  gd.ovf = gd.valid && pos >= L;
  if (WRITE && g.lead()) {
    const int posc = ra_clamp(pos, 0, L - 1);
    jx_set2(o + sp[KC_LOG + KE_CMD], S, L, i, posc, KC_C_APPEND);
    jx_set2(o + sp[KC_LOG + KE_EPOCH], S, L, i, posc, ep);
    jx_set2(o + sp[KC_LOG + KE_VAL], S, L, i, posc, v + 1);
    kc_set(sp, o, KC_LL, i, pos + 1);
    jx_set(o + KFD(ACK), V, v, RA_ACK_FALSE);
    o[KFD(VALCTR) + epc] = s[KFD(VALCTR) + epc] + 1;
  }
  return gd;
}

// SendFetchRequest — :1137-1169: a known-leader follower's fetch, or an
// Unattached observer probing a voter of its config; an unrestricted send
template <bool WRITE, class Gp>
__device__ Guard kc_send_fetch(Gp g, const int* sp, const int* s, int* o, int i, int j) {
  const int L = KFD(L), M = KFD(M), NW = KFD(NW);
  const int st = kc_get(sp, s, KC_ST, i), role = kc_get(sp, s, KC_ROLE, i);
  const bool path_a = kc_get(sp, s, KC_LED, i) == j + 1 && st == KC_FOLLOWER;
  const bool path_b = role == KC_R_OBSERVER && st == KC_UNATTACHED &&
                      kc_bit(kc_get(sp, s, KC_CM, i), j);
  Guard gd{kc_get(sp, s, KC_USED, i) > 0 && kc_get(sp, s, KC_USED, j) > 0 &&
               kc_get(sp, s, KC_PF_ACT, i) == 0 && (path_a || path_b),
           KQ_SENDFETCH, false};
  if (!WRITE && !gd.valid) return gd;
  const int ep = kc_get(sp, s, KC_EP, i), ll = kc_get(sp, s, KC_LL, i);
  const int last_ep = kc_last_epoch(kc_log(sp, s, KE_EPOCH, i), L, ll);
  const int obs = role == KC_R_OBSERVER;
  typename KcForm<WRITE>::Key k;
  nw_key_init(k);
  kc_pack(sp, k, KM_MTYPE, KC_FETCHREQ);
  kc_pack(sp, k, KM_MEPOCH, ep);
  kc_pack(sp, k, KM_MFETCHOFFSET, ll);
  kc_pack(sp, k, KM_MLASTFETCHEDEPOCH, last_ep);
  kc_pack(sp, k, KM_MOBSERVER, obs);
  kc_pack(sp, k, KM_MSOURCE, i);
  kc_pack(sp, k, KM_MDEST, j);
  const Put p = nw_probe<KC_MAX_WORDS>(g, s + KFD(W0), M, NW, k);
  gd.ovf = p.overflow && gd.valid;
  if (WRITE) {
    if (g.lead()) {
      kc_set(sp, o, KC_PF_ACT, i, 1);
      kc_set(sp, o, KC_PF_EP, i, ep);
      kc_set(sp, o, KC_PF_OFF, i, ll);
      kc_set(sp, o, KC_PF_LE, i, last_ep);
      kc_set(sp, o, KC_PF_DEST, i, j + 1);
      kc_set(sp, o, KC_PF_OBS, i, obs);
    }
    nw_insert<KC_MAX_WORDS>(g, o + KFD(W0), o + KFD(CNT), M, NW, k, p);
  }
  return gd;
}

// StartNewServer(h, j) — :1492-1511: a fresh [h, diskIdGen + 1] observer in
// the next free slot, its first fetch (mepoch 0) to a current leader j;
// endOffset's domain = the servers before the spawn
template <bool WRITE, class Gp>
__device__ Guard kc_start_new_server(Gp g, const int* sp, const int* s, int* o, int h, int j) {
  const int S = KFD(S), M = KFD(M), NW = KFD(NW);
  int n_used = 0;
  for (int k = 0; k < S; ++k) n_used += s[KFD(USED) + k] > 0;
  Guard gd{n_used < S && kc_get(sp, s, KC_USED, j) > 0 && kc_get(sp, s, KC_ST, j) == KC_LEADER,
           KQ_STARTNEWSERVER, false};
  if (!WRITE && !gd.valid) return gd;
  const int slot = ra_clamp(n_used, 0, S - 1);
  const int disk = s[KFD(DIG)] + 1;
  typename KcForm<WRITE>::Key k;
  nw_key_init(k);
  kc_pack(sp, k, KM_MTYPE, KC_FETCHREQ);
  kc_pack(sp, k, KM_MOBSERVER, 1);
  kc_pack(sp, k, KM_MSOURCE, slot);
  kc_pack(sp, k, KM_MDEST, j);
  const Put p = nw_probe<KC_MAX_WORDS>(g, s + KFD(W0), M, NW, k);
  gd.ovf = p.overflow && gd.valid;
  if (WRITE) {
    if (g.lead()) {
      kc_set(sp, o, KC_USED, slot, 1);
      kc_set(sp, o, KC_HOST, slot, h);
      kc_set(sp, o, KC_DISK, slot, disk);
      kc_set(sp, o, KC_ROLE, slot, KC_R_OBSERVER);
      const int zero[] = {KC_ST, KC_EP, KC_LED, KC_VF, KC_VG, KC_CID, KC_CM, KC_CCOMM, KC_LL,
                          KC_HWM, KC_PF_EP, KC_PF_OFF, KC_PF_LE};
      for (int f : zero) kc_set(sp, o, f, slot, 0);
      kc_set(sp, o, KC_EODOM, slot, kc_used_mask(sp, s));
      kc_set(sp, o, KC_PF_ACT, slot, 1);
      kc_set(sp, o, KC_PF_DEST, slot, j + 1);
      kc_set(sp, o, KC_PF_OBS, slot, 1);
      o[KFD(DIG)] = disk;
    }
    kc_set_eo_row(g, sp, o, slot, [](int) { return 0; });
    nw_insert<KC_MAX_WORDS>(g, o + KFD(W0), o + KFD(CNT), M, NW, k, p);
  }
  return gd;
}

// SendJoinRequest — :1524-1538: an observer outside its config asks its
// known leader; send-once (the constant _addReconfigCtr gate, :1526)
template <bool WRITE, class Gp>
__device__ Guard kc_send_join(Gp g, const int* sp, const int* s, int* o, int i, int j) {
  const int M = KFD(M), NW = KFD(NW);
  Guard gd{KFD(MAX_ADD) > 0 && kc_get(sp, s, KC_USED, i) > 0 && kc_get(sp, s, KC_USED, j) > 0 &&
               kc_get(sp, s, KC_ROLE, i) == KC_R_OBSERVER &&
               !kc_bit(kc_get(sp, s, KC_CM, i), i) && kc_get(sp, s, KC_LED, i) == j + 1,
           KQ_SENDJOIN, false};
  if (!WRITE && !gd.valid) return gd;
  typename KcForm<WRITE>::Key k;
  nw_key_init(k);
  kc_pack(sp, k, KM_MTYPE, KC_JOINREQ);
  kc_pack(sp, k, KM_MEPOCH, kc_get(sp, s, KC_EP, i));
  kc_pack(sp, k, KM_MDEST, j);
  kc_pack(sp, k, KM_MSOURCE, i);
  const Put p = nw_probe<KC_MAX_WORDS>(g, s + KFD(W0), M, NW, k);
  gd.valid = gd.valid && !p.existed;
  gd.ovf = p.overflow && gd.valid;
  if (WRITE) nw_insert<KC_MAX_WORDS>(g, o + KFD(W0), o + KFD(CNT), M, NW, k, p);
  return gd;
}

// HandleRemoveRequest(i, r) — :1699-1724: an admin removal appends a
// RemoveServerCommand; a self-removing leader becomes an observer and
// stays leader
template <bool WRITE, class Gp>
__device__ Guard kc_handle_remove(Gp g, const int* sp, const int* s, int* o, int i, int r) {
  const int S = KFD(S), L = KFD(L);
  const int members = kc_get(sp, s, KC_CM, i);
  const bool check_ok = kc_get(sp, s, KC_ST, i) == KC_LEADER && kc_bit(members, r) &&
                        kc_get(sp, s, KC_CCOMM, i) > 0 && kc_committed_in_epoch(sp, s, i);
  Guard gd{kc_get(sp, s, KC_USED, i) > 0 && kc_get(sp, s, KC_USED, r) > 0 &&
               s[KFD(RMCTR)] < KFD(MAX_REMOVE) && check_ok &&
               kc_pop(members, S) > KFD(MIN_CLUSTER),
           KQ_HANDLE_REMOVE, false};
  const int pos = kc_get(sp, s, KC_LL, i);
  gd.ovf = gd.valid && pos >= L;
  if (WRITE) {
    const int nm = members & ~(1 << r), cid = kc_get(sp, s, KC_CID, i) + 1;
    kc_put_cfg_entry(g, sp, o, i, ra_clamp(pos, 0, L - 1), KC_C_REMOVE, kc_get(sp, s, KC_EP, i),
                     cid, r + 1, nm);
    if (g.lead()) {
      kc_set(sp, o, KC_LL, i, pos + 1);
      kc_set(sp, o, KC_CID, i, cid);
      kc_set(sp, o, KC_CM, i, nm);
      kc_set(sp, o, KC_CCOMM, i, kc_get(sp, s, KC_HWM, i) >= pos + 1);
      kc_set(sp, o, KC_ROLE, i, i == r ? KC_R_OBSERVER : kc_get(sp, s, KC_ROLE, i));
      o[KFD(RMCTR)] = s[KFD(RMCTR)] + 1;
    }
  }
  return gd;
}

// The log a FetchResponse leaves at its destination dst, as row(e, l) (the
// apply's): dst's log with, on success, the message's entry at lane `app`
// (-1: none appended), or, diverging, only its first `cut` lanes kept (the
// rest 0). Computed where it is read: an array of it indexed at run time
// would sit on the stack.
struct KcFetchLog {
  const int* sp;
  const int* s;
  IKey kw;  // a copy: a pointer to the words would put them on the stack
  int dst, app, cut;
  __device__ __forceinline__ int operator()(int e, int l) const {
    if (l == app) return kc_unpack(sp, kw, KM_E + e);
    return l < cut ? kc_log(sp, s, e, dst)[l] : 0;
  }
};

// MaybeSwitchConfigurations (:753-771) on slot dst after a fetch response:
// the config from the log's most recent reconfig entry (row(e, l), len
// lanes, that entry at offset cfg_off), the Voter <-> Observer flip on a
// membership change, endOffset's domain padded to every used slot; leader
// and the default state from MaybeHandleCommonResponse (mh)
template <class Gp, class Row>
__device__ void kc_maybe_switch(Gp g, const int* sp, const int* s, int* o, int dst,
                                const Row& row, int len, int cfg_off, int mhwm, KSle mh) {
  const int S = KFD(S), L = KFD(L);
  if (g.lead()) {
    const int lane = ra_clamp(cfg_off - 1, 0, L - 1);
    const int cm = row(KE_MEMBERS, lane);
    const bool member = kc_bit(cm, dst);
    const int role = kc_get(sp, s, KC_ROLE, dst);
    const bool demote = role == KC_R_VOTER && !member, promote = role == KC_R_OBSERVER && member;
    kc_set(sp, o, KC_LED, dst, mh.ld);
    kc_set(sp, o, KC_CID, dst, row(KE_CFGID, lane));
    kc_set(sp, o, KC_CM, dst, cm);
    kc_set(sp, o, KC_CCOMM, dst, mhwm >= cfg_off);
    kc_set(sp, o, KC_ROLE, dst, demote ? KC_R_OBSERVER : (promote ? KC_R_VOTER : role));
    kc_set(sp, o, KC_ST, dst, (demote || promote) ? KC_FOLLOWER : mh.st);
    kc_set(sp, o, KC_EODOM, dst, kc_get(sp, s, KC_EODOM, dst) | kc_used_mask(sp, s));
    kc_set(sp, o, KC_LL, dst, len);
  }
  grp_for(g, KE_N * L, [&](int u) {  // the log, (entry field, lane) pairs
    const int e = u / L, l = u - e * L;
    jx_set2(o + sp[KC_LOG + e], S, L, dst, l, row(e, l));
  });
  kc_clear_pf(g, sp, o, dst);
}

// AcceptFetchRequestFromVoter's successor (:1286-1342) at the leader dst,
// made once its reply is known to be new: the acked values committed by the
// new hwm, the config re-derived when it advanced, IsRemovedFromCluster's
// step down (`leaves`), endOffset's row with [dst][src] := foff
template <class Gp>
__device__ void kc_accept_voter(Gp g, const int* sp, const int* s, int* o, int dst, int src,
                                int foff, int new_hwm, bool leaves) {
  const int S = KFD(S), L = KFD(L), V = KFD(V);
  const int hwm = kc_get(sp, s, KC_HWM, dst);
  const bool advanced = new_hwm > hwm;
  if (g.lead()) {
    const int* cmd = kc_log(sp, s, KE_CMD, dst);
    const int* val = kc_log(sp, s, KE_VAL, dst);
    for (int v = 0; v < V; ++v) {
      bool committed = false;
      for (int l = 0; l < L; ++l)
        committed |=
            l + 1 > hwm && l + 1 <= new_hwm && cmd[l] == KC_C_APPEND && val[l] == v + 1;
      if (advanced && s[KFD(ACK) + v] == RA_ACK_FALSE && committed) o[KFD(ACK) + v] = RA_ACK_TRUE;
    }
    if (advanced) {
      const int cfg_off = kc_most_recent_reconfig(cmd, L, kc_get(sp, s, KC_LL, dst));
      const int lane = ra_clamp(cfg_off - 1, 0, L - 1);
      kc_set(sp, o, KC_CID, dst, kc_log(sp, s, KE_CFGID, dst)[lane]);
      kc_set(sp, o, KC_CM, dst, kc_log(sp, s, KE_MEMBERS, dst)[lane]);
      kc_set(sp, o, KC_CCOMM, dst, new_hwm >= cfg_off);
    }
    if (leaves) {
      kc_set(sp, o, KC_ROLE, dst, KC_R_OBSERVER);
      kc_set(sp, o, KC_ST, dst, KC_UNATTACHED);
      kc_set(sp, o, KC_LED, dst, RA_NIL);
      kc_set(sp, o, KC_VG, dst, 0);
    }
    kc_set(sp, o, KC_EODOM, dst,
           leaves ? kc_used_mask(sp, s) : (kc_get(sp, s, KC_EODOM, dst) | (1 << src)));
    kc_set(sp, o, KC_HWM, dst, leaves ? 0 : (advanced ? new_hwm : hwm));
  }
  const int* eo = s + KFD(EO) + jx_index(dst, S) * S;
  kc_set_eo_row(g, sp, o, dst, [&](int q) { return leaves ? 0 : (q == src ? foff : eo[q]); });
}

// the fields a FetchResponse shares (:1203): the responder's epoch, leader
// and endpoints, and the request it answers as the correlation (its
// source and dest implied, swapped)
template <class Key, class Words>
__device__ __forceinline__ void kc_pack_fetch_resp(const int* sp, Key& k, int cur, int leader,
                                                   int hwm, int dst, int src, const Words& kw) {
  kc_pack(sp, k, KM_MTYPE, KC_FETCHRESP);
  kc_pack(sp, k, KM_MEPOCH, cur);
  kc_pack(sp, k, KM_MLEADER, leader);
  kc_pack(sp, k, KM_MHWM, hwm);
  kc_pack(sp, k, KM_MSOURCE, dst);
  kc_pack(sp, k, KM_MDEST, src);
  kc_pack(sp, k, KM_CEPOCH, kc_unpack(sp, kw, KM_MEPOCH));
  kc_pack(sp, k, KM_CFETCHOFFSET, kc_unpack(sp, kw, KM_MFETCHOFFSET));
  kc_pack(sp, k, KM_CLASTFETCHEDEPOCH, kc_unpack(sp, kw, KM_MLASTFETCHEDEPOCH));
  kc_pack(sp, k, KM_COBSERVER, kc_unpack(sp, kw, KM_MOBSERVER));
}

// HandleMessage(slot m): the thirteen receipt disjuncts (HandleRequestVote
// Request/Response, AcceptBeginQuorumRequest, the FetchRequest quartet
// Reject/Diverging/AcceptFromVoter/AcceptFromObserver, the FetchResponse
// trio Success/Diverging/NonSuccess, Accept/RejectJoinRequest and
// HandleRejectJoinResponse's Discard arm); rank says which one fired, -1
// when none did.
template <bool WRITE, class Gp>
__device__ Guard kc_handle_message(Gp g, const int* sp, const int* s, int* o, int m) {
  const int S = KFD(S), L = KFD(L), M = KFD(M), NW = KFD(NW);
  const bool lw = WRITE && g.lead();
  Guard gd{false, -1, false};
  typename KcForm<WRITE>::Words kw;
  kc_key_words(sp, s, m, kw);
  // ReceivableMessage (:471-477): occupied, a count > 0, a live dest
  if (kw[0] == RA_EMPTY || jx_get(s + KFD(CNT), M, m) <= 0) return gd;
  const int mtype = kc_unpack(sp, kw, KM_MTYPE), mepoch = kc_unpack(sp, kw, KM_MEPOCH);
  const int src = kc_unpack(sp, kw, KM_MSOURCE), dst = kc_unpack(sp, kw, KM_MDEST);
  const int st = kc_get(sp, s, KC_ST, dst);
  if (kc_get(sp, s, KC_USED, dst) <= 0 || st == KC_DEAD) return gd;
  const int cur = kc_get(sp, s, KC_EP, dst), led = kc_get(sp, s, KC_LED, dst);
  const int role = kc_get(sp, s, KC_ROLE, dst), hwm = kc_get(sp, s, KC_HWM, dst);
  const int ll = kc_get(sp, s, KC_LL, dst), members = kc_get(sp, s, KC_CM, dst);
  const int* ep_row = kc_log(sp, s, KE_EPOCH, dst);
  const int mres = kc_unpack(sp, kw, KM_MRESULT);

  // the branch flags; put_branch: a branch that replies with key k
  bool b_rvreq = false, b_rvresp = false, b_bqreq = false, b_reject = false, b_div = false;
  bool b_acc_v = false, b_acc_o = false, b_ok = false, b_divr = false, b_err = false;
  bool b_jacc = false, b_jrej = false, b_jrr = false;
  bool put_branch = false, extra_ovf = false;
  typename KcForm<WRITE>::Key k;
  nw_key_init(k);
  KSle mh{st, cur, led};
  bool handled = false;
  // AcceptFetchRequestFromVoter's successor, written after the put's probe
  int foff = 0, new_hwm = hwm;
  bool leaves = false;

  if (mtype == KC_RVREQ) {
    // HandleRequestVoteRequest (:967-1018)
    b_rvreq = put_branch = true;
    const bool rv_err = mepoch < cur;  // FencedLeaderEpoch
    const bool up = mepoch > cur;
    const int s0_st = up ? KC_UNATTACHED : st, s0_ep = up ? mepoch : cur;
    const int s0_ld = up ? RA_NIL : led;
    const int last_ep = kc_last_epoch(ep_row, L, ll);
    const int mlle = kc_unpack(sp, kw, KM_MLASTLOGEPOCH);
    const bool log_ok = mlle > last_ep ||
                        (mlle == last_ep && kc_unpack(sp, kw, KM_MLASTLOGOFFSET) >= ll);
    const bool grant = (s0_st == KC_UNATTACHED ||
                        (s0_st == KC_VOTED && kc_get(sp, s, KC_VF, dst) == src + 1)) && log_ok;
    // TransitionToVoted (:630-637) when granting from Unattached
    const bool take = grant && s0_st == KC_UNATTACHED;
    const KSle f{take ? KC_VOTED : s0_st, take ? mepoch : s0_ep, take ? RA_NIL : s0_ld};
    kc_pack(sp, k, KM_MTYPE, KC_RVRESP);
    kc_pack(sp, k, KM_MEPOCH, rv_err ? cur : mepoch);
    kc_pack(sp, k, KM_MLEADER, rv_err ? led : f.ld);
    kc_pack(sp, k, KM_MVOTEGRANTED, rv_err ? 0 : grant);
    kc_pack(sp, k, KM_MERROR, rv_err ? KC_E_FENCED : KC_E_NONE);
    kc_pack(sp, k, KM_MSOURCE, dst);
    kc_pack(sp, k, KM_MDEST, src);
    if (WRITE && !rv_err) {
      if (lw) {
        kc_set_sle(sp, o, dst, f);
        if (grant) kc_set(sp, o, KC_VF, dst, src + 1);
      }
      if (f.st != st) kc_clear_pf(g, sp, o, dst);
    }
  } else if (mtype == KC_RVRESP) {
    // HandleRequestVoteResponse (:1025-1050; the Voter gate added)
    mh = kc_mhcr(sp, s, dst, kc_unpack(sp, kw, KM_MLEADER), mepoch,
                 kc_unpack(sp, kw, KM_MERROR), &handled);
    b_rvresp = role == KC_R_VOTER && (handled || st == KC_CANDIDATE);
    if (lw && b_rvresp) {
      if (handled) kc_set_sle(sp, o, dst, mh);
      if (kc_unpack(sp, kw, KM_MVOTEGRANTED) > 0 && !handled)
        kc_set(sp, o, KC_VG, dst, kc_get(sp, s, KC_VG, dst) | (1 << src));
    }
  } else if (mtype == KC_BQREQ) {
    // AcceptBeginQuorumRequest (:1082-1102): Voter only; a stale request
    // is not answered
    b_bqreq = mepoch >= cur && role == KC_R_VOTER;
    if (WRITE && b_bqreq) {
      if (lw) kc_set_sle(sp, o, dst, kc_maybe_transition(sp, s, dst, src + 1, mepoch));
      kc_clear_pf(g, sp, o, dst);
    }
  } else if (mtype == KC_FETCHREQ) {
    // the FetchRequest branches (:1195-1376)
    const bool is_leader = st == KC_LEADER;
    const int ferr = !is_leader ? KC_E_NOTLEADER
                                : (mepoch < cur ? KC_E_FENCED
                                                : (mepoch > cur ? KC_E_UNKNOWN_LEADER : KC_E_NONE));
    foff = kc_unpack(sp, kw, KM_MFETCHOFFSET);
    const int flep = kc_unpack(sp, kw, KM_MLASTFETCHEDEPOCH);
    int eo_off, eo_ep;
    kc_end_offset_for_epoch(ep_row, L, ll, flep, &eo_off, &eo_ep);
    const bool valid_pos = (foff == 0 && flep == 0) || (foff <= eo_off && flep == eo_ep);
    put_branch = true;
    if (ferr != KC_E_NONE) {
      // RejectFetchRequest (:1195-1217)
      b_reject = true;
      kc_pack_fetch_resp(sp, k, cur, led, hwm, dst, src, kw);
      kc_pack(sp, k, KM_MRESULT, KC_RES_NOTOK);
      kc_pack(sp, k, KM_MERROR, ferr);
    } else if (!valid_pos) {
      // DivergingFetchRequest (:1225-1248)
      b_div = true;
      kc_pack_fetch_resp(sp, k, cur, led, hwm, dst, src, kw);
      kc_pack(sp, k, KM_MRESULT, KC_RES_DIVERGING);
      kc_pack(sp, k, KM_MDIVEPOCH, eo_ep);
      kc_pack(sp, k, KM_MDIVENDOFFSET, eo_off);
    } else {
      const int offset = foff + 1;
      const bool have = offset <= ll;
      const int epos = ra_clamp(offset - 1, 0, L - 1);
      const bool voter = kc_unpack(sp, kw, KM_MOBSERVER) == 0;
      if (voter) {
        // AcceptFetchRequestFromVoter (:1286-1342). NewHighwaterMark
        // (:1266-1284): the largest offset in the log that a quorum of the
        // config's members reaches in the new endOffset row (with
        // [dst][src] := foff; the leader counts itself even when removed)
        const int* eo = s + KFD(EO) + jx_index(dst, S) * S;
        const int msize = kc_pop(members, S);
        int best = 0;
        for (int idx = 1; idx <= L; ++idx) {
          int n = 0;
          for (int q = 0; q < S; ++q)
            n += kc_bit(members, q) && ((q == src ? foff : eo[q]) >= idx || q == dst);
          if (2 * n > msize && idx <= ll) best = idx;
        }
        if (best > 0 && ep_row[ra_clamp(best - 1, 0, L - 1)] == cur) new_hwm = best;
        // IsRemovedFromCluster (:1259-1264) over (hwm, new_hwm]
        const int* cmd = kc_log(sp, s, KE_CMD, dst);
        const int* mem = kc_log(sp, s, KE_MEMBERS, dst);
        for (int l = 0; l < L; ++l)
          leaves |= new_hwm > hwm && l + 1 > hwm && l + 1 <= new_hwm && cmd[l] == KC_C_REMOVE &&
                    !kc_bit(mem[l], dst);
        b_acc_v = true;
      } else {
        b_acc_o = true;  // AcceptFetchRequestFromObserver (:1349-1376)
      }
      kc_pack_fetch_resp(sp, k, cur, voter && leaves ? RA_NIL : led,
                         voter ? (new_hwm < offset ? new_hwm : offset)
                               : (offset < hwm ? offset : hwm),
                         dst, src, kw);
      kc_pack(sp, k, KM_MRESULT, KC_RES_OK);
      kc_pack(sp, k, KM_NENTRIES, have);
      for (int e = 0; e < KE_N; ++e)
        kc_pack(sp, k, KM_E + e, have ? kc_log(sp, s, e, dst)[epos] : 0);
    }
  } else if (mtype == KC_FETCHRESP) {
    // the FetchResponse branches (:1383-1483): the correlation match
    // pendingFetch[dst] = m.correlation (:1390), the request's msource dst
    // (implied) and its mdest the responder src
    mh = kc_mhcr(sp, s, dst, kc_unpack(sp, kw, KM_MLEADER), mepoch,
                 kc_unpack(sp, kw, KM_MERROR), &handled);
    const bool corr = kc_get(sp, s, KC_PF_ACT, dst) > 0 &&
                      kc_get(sp, s, KC_PF_EP, dst) == kc_unpack(sp, kw, KM_CEPOCH) &&
                      kc_get(sp, s, KC_PF_OFF, dst) == kc_unpack(sp, kw, KM_CFETCHOFFSET) &&
                      kc_get(sp, s, KC_PF_LE, dst) == kc_unpack(sp, kw, KM_CLASTFETCHEDEPOCH) &&
                      kc_get(sp, s, KC_PF_OBS, dst) == kc_unpack(sp, kw, KM_COBSERVER) &&
                      kc_get(sp, s, KC_PF_DEST, dst) == src + 1;
    const int mhwm = kc_unpack(sp, kw, KM_MHWM);
    if constexpr (WRITE) {  // the log the response leaves, computed where read
      if (!handled && corr && mres == KC_RES_OK) {
        // HandleSuccessFetchResponse (:1383-1409); a log at max_log overflows
        const bool app = kc_unpack(sp, kw, KM_NENTRIES) > 0;
        const KcFetchLog row{sp, s, kw, dst, app ? ra_clamp(ll, 0, L - 1) : -1, L};
        const int len = ll + app;
        const int cfg_off = kc_last_reconfig(row, L, len);
        b_ok = cfg_off > 0;
        extra_ovf = b_ok && app && ll >= L;
        if (b_ok) {
          kc_maybe_switch(g, sp, s, o, dst, row, len, cfg_off, mhwm, mh);
          if (lw) kc_set(sp, o, KC_HWM, dst, mhwm);
        }
      } else if (!handled && corr && mres == KC_RES_DIVERGING) {
        // HandleDivergingFetchResponse (:1419-1445): truncate, refresh the
        // config from the truncated log; the hwm is not updated
        const int hco = kc_highest_common_offset(ep_row, L, ll,
                                                 kc_unpack(sp, kw, KM_MDIVENDOFFSET),
                                                 kc_unpack(sp, kw, KM_MDIVEPOCH));
        const KcFetchLog row{sp, s, kw, dst, -1, hco};
        const int cfg_off = kc_last_reconfig(row, L, hco);
        b_divr = cfg_off > 0;
        if (b_divr) kc_maybe_switch(g, sp, s, o, dst, row, hco, cfg_off, mhwm, mh);
      } else if (handled && corr) {
        // HandleNonSuccessFetchResponse (:1459-1483)
        b_err = true;
        if (lw) {
          kc_set_sle(sp, o, dst, mh);
          if (kc_unpack(sp, kw, KM_MERROR) == KC_E_UNKNOWN_MEMBER)
            kc_set(sp, o, KC_ROLE, dst, KC_R_OBSERVER);
        }
        kc_clear_pf(g, sp, o, dst);
      }
    } else {  // the guard's form: the log as an array, read for its commands
      int rows[KE_N][KC_MAX_L];
      for (int e = 0; e < KE_N; ++e)
        for (int l = 0; l < L; ++l) rows[e][l] = kc_log(sp, s, e, dst)[l];
      if (!handled && corr && mres == KC_RES_OK) {
        const bool app = kc_unpack(sp, kw, KM_NENTRIES) > 0;
        if (app)
          for (int e = 0; e < KE_N; ++e)
            rows[e][ra_clamp(ll, 0, L - 1)] = kc_unpack(sp, kw, KM_E + e);
        const int cfg_off = kc_most_recent_reconfig(rows[KE_CMD], L, ll + app);
        b_ok = cfg_off > 0;
        extra_ovf = b_ok && app && ll >= L;
      } else if (!handled && corr && mres == KC_RES_DIVERGING) {
        const int hco = kc_highest_common_offset(ep_row, L, ll,
                                                 kc_unpack(sp, kw, KM_MDIVENDOFFSET),
                                                 kc_unpack(sp, kw, KM_MDIVEPOCH));
        for (int e = 0; e < KE_N; ++e)
          for (int l = 0; l < L; ++l) rows[e][l] = l < hco ? rows[e][l] : 0;
        b_divr = kc_most_recent_reconfig(rows[KE_CMD], L, hco) > 0;
      } else if (handled && corr) {
        b_err = true;
      }
    }
  } else if (mtype == KC_JOINREQ) {
    // the Join flow (:1524-1674); JoinCheck (:1551-1556)
    const bool notleader = st != KC_LEADER, already = kc_bit(members, src);
    const bool ok = !notleader && !already && kc_get(sp, s, KC_CCOMM, dst) != 0 &&
                    kc_committed_in_epoch(sp, s, dst);
    if (kc_pop(members, S) < KFD(MAX_CLUSTER) && ok) {
      // AcceptJoinRequest (:1558-1590)
      b_jacc = put_branch = true;
      extra_ovf = ll >= L;
      kc_pack(sp, k, KM_MRESULT, KC_RES_OK);
      kc_pack(sp, k, KM_MERROR, KC_E_NONE);
      if (WRITE) {
        const int cid = kc_get(sp, s, KC_CID, dst) + 1, add = members | (1 << src);
        kc_put_cfg_entry(g, sp, o, dst, ra_clamp(ll, 0, L - 1), KC_C_ADD, cur, cid, src + 1,
                         add);
        if (lw) {
          kc_set(sp, o, KC_LL, dst, ll + 1);
          kc_set(sp, o, KC_CID, dst, cid);
          kc_set(sp, o, KC_CM, dst, add);
          kc_set(sp, o, KC_CCOMM, dst, hwm >= ll + 1);
          kc_set(sp, o, KC_EODOM, dst, kc_get(sp, s, KC_EODOM, dst) | (1 << src));
        }
      }
    } else if (notleader || already) {
      // RejectJoinRequest (:1605-1623): only NotLeader/AlreadyMember are
      // answered
      b_jrej = put_branch = true;
      kc_pack(sp, k, KM_MRESULT, KC_RES_NOTOK);
      kc_pack(sp, k, KM_MERROR, notleader ? KC_E_NOTLEADER : KC_E_ALREADY_MEMBER);
    }
    if (put_branch) {
      kc_pack(sp, k, KM_MTYPE, KC_JOINRESP);
      kc_pack(sp, k, KM_MEPOCH, cur);
      kc_pack(sp, k, KM_MLEADER, led);
      kc_pack(sp, k, KM_MDEST, src);
      kc_pack(sp, k, KM_MSOURCE, dst);
    }
  } else if (mtype == KC_JOINRESP) {
    // HandleRejectJoinResponse (:1643-1674): only the Discard arm
    b_jrr = role == KC_R_OBSERVER && mres == KC_RES_NOTOK;
  }

  // the shared Reply: the response put once into the bag whose slot m is
  // discarded; a FetchRequest reply already in the bag disables its branch
  // (MessagePassing.tla:72-79). The probe reads the state's bag, so the
  // voter's successor is written only once its reply is known new.
  Put p{false, false, 0};
  if (put_branch) {
    p = nw_probe<KC_MAX_WORDS>(g, s + KFD(W0), M, NW, k);
    if (p.existed && (b_reject || b_div || b_acc_v || b_acc_o))
      b_reject = b_div = b_acc_v = b_acc_o = false;
  }
  if (WRITE && b_acc_v) kc_accept_voter(g, sp, s, o, dst, src, foff, new_hwm, leaves);
  const bool putb = b_rvreq || b_reject || b_div || b_acc_v || b_acc_o || b_jacc || b_jrej;
  const bool dropb = b_rvresp || b_bqreq || b_ok || b_divr || b_err || b_jrr;
  gd.valid = putb || dropb;
  const bool flags[] = {b_rvreq, b_rvresp, b_bqreq, b_reject, b_div, b_acc_v, b_acc_o,
                        b_ok, b_divr, b_err, b_jacc, b_jrej, b_jrr};
  const int ranks[] = {KQ_HANDLE_RVREQ, KQ_HANDLE_RVRESP, KQ_ACCEPT_BQREQ, KQ_REJECT_FETCH,
                       KQ_DIVERGING_FETCH, KQ_ACCEPT_FETCH_VOTER, KQ_ACCEPT_FETCH_OBSERVER,
                       KQ_HANDLE_FETCH_OK, KQ_HANDLE_FETCH_DIV, KQ_HANDLE_FETCH_NONSUCCESS,
                       KQ_ACCEPT_JOIN, KQ_REJECT_JOIN, KQ_HANDLE_REJECT_JOIN};
  for (int b = 0; b < 13; ++b)
    if (flags[b]) gd.rank = ranks[b];
  gd.ovf = (putb && p.overflow) || ((b_ok || b_jacc) && extra_ovf);
  if (WRITE && gd.valid) {
    if (lw) o[KFD(CNT) + m] -= 1;  // the incoming Discard
    if (putb) nw_insert<KC_MAX_WORDS>(g, o + KFD(W0), o + KFD(CNT), M, NW, k, p);
  }
  return gd;
}

// One candidate (a row of the model's candidate table) of one state, by
// the group g; `bag` is a chain lane's guard scratch (NW * M ints), unused
// otherwise.
template <bool WRITE, class Gp>
__device__ Guard kc_action(Gp g, const int* sp, const int* s, int* o, const int* cd, int* bag) {
  const int p0 = cd[1], p1 = cd[2];
  switch (cd[0]) {
    case KG2_RESTART: return Guard{kc_restart<WRITE>(g, sp, s, o, p0), cd[3], false};
    case KG2_REQUEST_VOTE: return kc_request_vote<WRITE>(g, sp, s, o, p0, bag);
    case KG2_BECOME_LEADER: return kc_become_leader<WRITE>(g, sp, s, o, p0, bag);
    case KG2_CLIENT_REQUEST: return kc_client_request<WRITE>(g, sp, s, o, p0, p1);
    case KG2_SEND_FETCH: return kc_send_fetch<WRITE>(g, sp, s, o, p0, p1);
    case KG2_START_NEW_SERVER: return kc_start_new_server<WRITE>(g, sp, s, o, p0, p1);
    case KG2_SEND_JOIN: return kc_send_join<WRITE>(g, sp, s, o, p0, p1);
    case KG2_HANDLE_REMOVE: return kc_handle_remove<WRITE>(g, sp, s, o, p0, p1);
    case KG2_HANDLE_MESSAGE: return kc_handle_message<WRITE>(g, sp, s, o, p0);
  }
  return Guard{false, cd[3], false};
}

// ---- invariants (:1848-1912) and liveness predicates (:1775-1839) ----

__device__ bool kc_invariant(const int* sp, const int* s, int id) {
  const int S = KFD(S), L = KFD(L), V = KFD(V), M = KFD(M);
  const int *used = s + KFD(USED), *st = s + KFD(ST), *led = s + KFD(LED);
  const int *ep = s + KFD(EP), *role = s + KFD(ROLE);
  switch (id) {
    case KC_INV_NO_ILLEGAL:  // NoIllegalState — :1848-1850
      for (int i = 0; i < S; ++i)
        if (st[i] == KC_ILLEGAL) return false;
      return true;
    case INV_NO_LOG_DIVERGENCE: {  // NoLogDivergence — :1860-1868 (whole entries)
      const int* hwm = s + KFD(HWM);
      for (int i = 0; i < S; ++i)
        for (int j = 0; j < S; ++j) {
          if (!(used[i] > 0 && used[j] > 0)) continue;
          const int mh = hwm[i] < hwm[j] ? hwm[i] : hwm[j];
          for (int l = 0; l < L && l + 1 <= mh; ++l)
            for (int e = 0; e < KE_N; ++e)
              if (s[sp[KC_LOG + e] + i * L + l] != s[sp[KC_LOG + e] + j * L + l]) return false;
        }
      return true;
    }
    case KC_INV_STATES_MATCH_ROLES:  // StatesMatchRoles — :1876-1881
      for (int i = 0; i < S; ++i) {
        const bool obs_ok = st[i] == KC_LEADER || st[i] == KC_FOLLOWER ||
                            st[i] == KC_UNATTACHED || st[i] == KC_VOTED;
        if (used[i] > 0 && ((role[i] == KC_R_OBSERVER && !obs_ok) ||
                            (st[i] == KC_UNATTACHED && led[i] != RA_NIL)))
          return false;
      }
      return true;
    case KC_INV_NEVER_TWO_LEADERS:  // NeverTwoLeadersInSameEpoch — :1886-1892
      for (int i = 0; i < S; ++i)
        for (int j = 0; j < S; ++j)
          if (used[i] > 0 && used[j] > 0 && led[i] != RA_NIL && led[j] != RA_NIL &&
              led[i] != led[j] && ep[i] == ep[j])
            return false;
      return true;
    case INV_LEADER_HAS_ALL_ACKED:  // LeaderHasAllAckedValues — :1896-1912
      for (int i = 0; i < S; ++i) {
        bool lead = used[i] > 0 && st[i] == KC_LEADER;
        for (int j = 0; j < S; ++j) lead = lead && !(used[j] > 0 && ep[j] > ep[i]);
        if (!lead) continue;
        const int* cmd = s + sp[KC_LOG + KE_CMD] + i * L;
        const int* val = s + sp[KC_LOG + KE_VAL] + i * L;
        for (int v = 0; v < V; ++v) {
          if (s[KFD(ACK) + v] != RA_ACK_TRUE) continue;
          bool has = false;
          for (int l = 0; l < L; ++l) has |= cmd[l] == KC_C_APPEND && val[l] == v + 1;
          if (!has) return false;
        }
      }
      return true;
    case INV_MESSAGES_ARE_VALID:  // MessagePassing.tla:81-83
      for (int m = 0; m < M; ++m) {
        int kw[KC_MAX_WORDS] = {0, 0, 0};
        for (int w = 0; w < KFD(NW); ++w) kw[w] = s[KFD(W0) + w * M + m];
        if (kw[0] != RA_EMPTY && kc_unpack(sp, kw, KM_MSOURCE) == kc_unpack(sp, kw, KM_MDEST))
          return false;
      }
      return true;
  }
  return true;  // INV_TEST
}

// CommittedValueOrNothing(v) (:1794-1808, id KC_PRED_VALUE + v) and
// ConfigAllOrNothing(cid) (:1817-1834, id KC_PRED_CONFIG + cid):
// NoProgressPossible (electionCtr = MaxElections, :1775-1781) or a current
// leader (:1787-1792) whose whole member set has the thing committed or
// lacks it entirely
__device__ bool kc_live_all_or_nothing(const int* sp, const int* s, int id) {
  const int S = KFD(S), L = KFD(L);
  if (s[KFD(ECTR)] == KFD(MAX_ELECTIONS)) return true;
  const bool cfg = id >= KC_PRED_CONFIG;
  const int x = cfg ? id - KC_PRED_CONFIG : id - KC_PRED_VALUE;
  const int *used = s + KFD(USED), *st = s + KFD(ST), *ep = s + KFD(EP);
  bool committed[KC_MAX_S], in_log[KC_MAX_S];
  for (int i = 0; i < S; ++i) {
    const int* cmd = s + sp[KC_LOG + KE_CMD] + i * L;
    const int* val = s + sp[KC_LOG + (cfg ? KE_CFGID : KE_VAL)] + i * L;
    committed[i] = in_log[i] = false;
    for (int l = 0; l < L; ++l) {
      const bool kind = cfg ? (cmd[l] == KC_C_INIT || cmd[l] == KC_C_ADD || cmd[l] == KC_C_REMOVE)
                            : cmd[l] == KC_C_APPEND;
      const bool has = l < s[KFD(LL) + i] && kind && val[l] == (cfg ? x : x + 1);
      in_log[i] |= has;
      committed[i] |= has && s[KFD(HWM) + i] >= l + 1;
    }
  }
  for (int l = 0; l < S; ++l) {
    bool icl = used[l] > 0 && st[l] == KC_LEADER;
    for (int j = 0; j < S; ++j) icl = icl && !(used[j] > 0 && ep[j] > ep[l]);
    if (!icl) continue;
    const int members = s[KFD(CM) + l];
    bool all_c = true, all_a = true;
    for (int i = 0; i < S; ++i) {
      all_c = all_c && (!kc_bit(members, i) || committed[i]);
      all_a = all_a && (!kc_bit(members, i) || !in_log[i]);
    }
    if (all_c || all_a) return true;
  }
  return false;
}

__device__ __forceinline__ bool kc_predicate(const int* sp, const int* s, int id) {
  if (id >= KC_PRED_VALUE) return kc_live_all_or_nothing(sp, s, id);
  return kc_invariant(sp, s, id);
}

// KRaftWithReconfig as the kernel drivers see it: where its spec keeps the
// sizes, the guard scratch of a state (a slot of 3 * M ints for each of its
// 2 * NS chain lanes, RequestVote(i) and BecomeLeader(i)), its actions and
// its predicates.
struct KReconfigFamily {
  static constexpr int SPEC_LEN = KC_LEN;
  static constexpr int BAG_WORDS = KC_MAX_WORDS;
  static constexpr int I_S = KC_S, I_M = KC_M, I_W = KC_W, I_A = KC_A, I_K = KC_K;
  // the group apply's threads a worklist lane and resident blocks an SM
  // (expand_driver.cuh; PERF.md's tile tables)
  static constexpr int APPLY_G = 32, APPLY_BLOCKS = 3;
  __host__ __device__ __forceinline__ static int scratch_slots(int S) { return 2 * S; }
  __device__ __forceinline__ static int scratch_slot(const int* cd) {
    if (cd[0] == KG2_REQUEST_VOTE) return 2 * cd[1];
    if (cd[0] == KG2_BECOME_LEADER) return 2 * cd[1] + 1;
    return -1;
  }
  template <bool WRITE>
  __device__ __forceinline__ static Guard action(const int* sp, const int* s, int* o,
                                                 const int* cd, int* bag) {
    return kc_action<WRITE>(GrpOne{}, sp, s, o, cd, bag);
  }
  // the successor row `o` (a copy of `s`) of one candidate, by the group g
  // of threads that shares the lane (expand_driver.cuh's group apply)
  template <class Gp>
  __device__ __forceinline__ static void apply(Gp g, const int* sp, const int* s, int* o,
                                               const int* cd) {
    kc_action<true>(g, sp, s, o, cd, nullptr);
  }
  __device__ __forceinline__ static bool invariant(const int* sp, const int* s, int id) {
    return kc_invariant(sp, s, id);
  }
  __device__ __forceinline__ static bool predicate(const int* sp, const int* s, int id) {
    return kc_predicate(sp, s, id);
  }
};

#undef KFD
