// kraft_actions.cuh — the KRaft action groups, invariants and liveness
// predicate as device code.
//
// Replaces raft_tpu/models/kraft.py:284-853 (the transition machine, the
// log-position math and the action kernels behind _expand1 :857, with
// ops/bag.py and ops/packing.py), its invariants :887-1000 (four of them
// the shared formulas of actions_common.cuh over KRaft's fields, with
// KRaft's Leader code) and ValueAllOrNothing :867. It mirrors the port's
// batched plain version, raft_tpu_torch/models/kraft.py, one (state,
// candidate) pair at a time: the layout, message packing and bounds come
// from the model's int32 spec vector (KRaftModel.kernel_spec).
//
// Every action group is one function templated on WRITE and on the group
// type Gp of actions_common.cuh (as raft_actions.cuh's): with WRITE false
// it computes only (valid, rank, ovf) and writes no successor lane; with
// WRITE true it also writes the successor row `o`, a copy of the state `s`
// made by the caller, lane by changed lane, whether the candidate is
// enabled or not. The guard runs an action as a group of one (GrpOne); the
// group apply on G threads that share the lane, the lead making the scalar
// writes, the members splitting a server's endOffset row, a log's lanes and
// each bag put (ra_probe, ra_insert). RequestVote(i) and BecomeLeader(i)
// each put a chain of S - 1 messages, each put acting on the bag the
// previous one left, and a put that finds its message in the bag disables
// the action (SendMultipleOnce, KRaft.tla:199-201); a guard lane of either
// replays its chain on its own copy of the bag's keys (KRaftFamily gives
// each of the 2 * S chain lanes of a state a slot), the apply on the
// successor's own bag.
//
// Bit-identity rules the code keeps (properties of the reference, which
// indexes with traced values, and of the plain version):
//   - a read x[i] with an out-of-range index reads the clamped index and a
//     write x.at[i].set(v) to one writes nothing (jx_get / jx_set): a
//     record's 2-bit mdest may name no server of three;
//   - every key is computed in int32 (the reference's _pack casts);
//   - Reply (KRaft.tla:220-227) discards the request, then puts the
//     response; only a FetchResponse already in the bag (count 0 included)
//     disables its branch (reject, diverging, accept); RequestVote and
//     BeginQuorum responses count up an existing record. existed and
//     overflow are read on the bag before the put: the discard changed
//     only a count. SendFetchRequest's put ignores existed.
//   - the two CASE chains (MaybeTransition, MaybeHandleCommonResponse)
//     take their first matching arm.
#pragma once

#include "actions_common.cuh"

// state[i] (KRaft.tla:69,87)
enum { KR_UNATTACHED, KR_VOTED, KR_FOLLOWER, KR_CANDIDATE, KR_LEADER, KR_ILLEGAL };
// mtype (KRaft.tla:75-78), merror (:84), mresult (:81)
enum { KR_RVREQ = 1, KR_RVRESP, KR_BQREQ, KR_BQRESP, KR_FETCHREQ, KR_FETCHRESP };
enum { KR_E_NONE, KR_E_FENCED, KR_E_NOTLEADER, KR_E_UNKNOWN };
enum { KR_R_NONE, KR_R_OK, KR_R_NOTOK, KR_R_DIVERGING };

// Next-disjunct ranks (models/kraft.py K_*, KRaft.tla:823-840).
enum {
  KK_RESTART, KK_REQUESTVOTE, KK_HANDLE_RVREQ, KK_HANDLE_RVRESP, KK_BECOMELEADER,
  KK_CLIENTREQUEST, KK_REJECT_FETCH, KK_DIVERGING_FETCH, KK_ACCEPT_FETCH, KK_HANDLE_BQREQ,
  KK_SENDFETCH, KK_HANDLE_FETCH_OK, KK_HANDLE_FETCH_DIV, KK_HANDLE_FETCH_ERR
};

// The spec vector (models/kraft.py SPEC_SCALARS, then MSG_FIELDS x 3).
enum {
  KS_S, KS_V, KS_L, KS_M, KS_W, KS_A, KS_K,
  KS_EP, KS_ST, KS_VF, KS_LEADER, KS_PF_EP, KS_PF_OFF, KS_PF_LE, KS_PF_DEST, KS_LT, KS_LV,
  KS_LL, KS_HWM, KS_VG, KS_EO, KS_ACK, KS_HI, KS_LO, KS_CNT, KS_ECTR, KS_RCTR,
  KS_MAX_ELECTIONS, KS_MAX_RESTARTS,
  KS_MSG
};
enum {
  KF_MTYPE, KF_MEPOCH, KF_MSOURCE, KF_MDEST, KF_MLASTLOGEPOCH, KF_MLASTLOGOFFSET, KF_MLEADER,
  KF_MVOTEGRANTED, KF_MERROR, KF_MRESULT, KF_MFETCHOFFSET, KF_MLASTFETCHEDEPOCH, KF_MHWM,
  KF_NENTRIES, KF_EEPOCH, KF_EVALUE, KF_MDIVEPOCH, KF_MDIVENDOFFSET, KF_CEPOCH,
  KF_CFETCHOFFSET, KF_CLASTFETCHEDEPOCH, KF_N
};
#define KS_LEN (KS_MSG + 3 * KF_N)

// Action groups (models/kraft.py GROUP_IDS); a candidate row of the
// model's candidate table is (group, p0, p1, rank).
enum {
  KG_RESTART, KG_REQUEST_VOTE, KG_BECOME_LEADER, KG_CLIENT_REQUEST, KG_SEND_FETCH,
  KG_HANDLE_MESSAGE
};
// KRaft's own invariants, after the shared INV_* (models/kraft.py
// KRAFT_INVARIANT_IDS)
enum { KR_INV_NO_ILLEGAL = 5, KR_INV_NEVER_TWO_LEADERS = 6 };

#define KFLD(o) (sp[KS_##o])

// ---- message words ----

__device__ __forceinline__ int kr_unpack(const int* sp, int hi, int lo, int f) {
  return ra_unpack_q(sp + KS_MSG + 3 * f, hi, lo);
}
__device__ __forceinline__ void kr_pack(const int* sp, Key& k, int f, long long v) {
  ra_pack_q(sp + KS_MSG + 3 * f, k, v);
}

// ---- the transition machine (KRaft.tla:312-392) ----

// (state, epoch, leader) of a server, leader 0 = Nil or i + 1 = server i
struct Sle {
  int st, ep, ld;
};

// MaybeTransition — KRaft.tla:351-367: the first matching arm of
// illegal (no consistent leader), unattached or follower (a newer epoch),
// follower (a leader learned), no-op. TransitionToFollower turns illegal
// when i is already a Follower or Leader of that epoch (:344-349).
__device__ __forceinline__ Sle kr_maybe_transition(const int* sp, const int* s, int i,
                                                   int leader, int epoch) {
  const int S = KFLD(S);
  const int st = jx_get(s + KFLD(ST), S, i), cur = jx_get(s + KFLD(EP), S, i);
  const int led = jx_get(s + KFLD(LEADER), S, i);
  // HasConsistentLeader (KRaft.tla:316-327)
  const bool hcl = leader == i + 1 ? st == KR_LEADER
                                   : (epoch != cur || leader == RA_NIL || led == RA_NIL ||
                                      led == leader);
  if (!hcl) return Sle{KR_ILLEGAL, 0, RA_NIL};
  bool follow;
  if (epoch > cur) {
    if (leader == RA_NIL) return Sle{KR_UNATTACHED, epoch, RA_NIL};
    follow = true;
  } else {
    follow = leader != RA_NIL && led == RA_NIL;
  }
  if (!follow) return Sle{st, cur, led};
  const bool ill = cur == epoch && (st == KR_FOLLOWER || st == KR_LEADER);
  return ill ? Sle{KR_ILLEGAL, 0, 0} : Sle{KR_FOLLOWER, epoch, leader};
}

// MaybeHandleCommonResponse — KRaft.tla:369-392: a stale epoch is handled
// as a no-op; a newer epoch or an error transitions; the current epoch
// with a leader learned follows it; else the response is not handled.
__device__ __forceinline__ Sle kr_maybe_handle_common(const int* sp, const int* s, int i,
                                                      int leader, int epoch, int err,
                                                      bool* handled) {
  const int S = KFLD(S);
  const int st = jx_get(s + KFLD(ST), S, i), cur = jx_get(s + KFLD(EP), S, i);
  const int led = jx_get(s + KFLD(LEADER), S, i);
  *handled = true;
  if (epoch < cur) return Sle{st, cur, led};
  if (epoch > cur || err != KR_E_NONE) return kr_maybe_transition(sp, s, i, leader, epoch);
  if (leader != RA_NIL && led == RA_NIL) return Sle{KR_FOLLOWER, cur, leader};
  *handled = false;
  return Sle{st, cur, led};
}

__device__ __forceinline__ void kr_set_sle(const int* sp, int* o, int i, Sle v) {
  const int S = KFLD(S);
  jx_set(o + KFLD(ST), S, i, v.st);
  jx_set(o + KFLD(EP), S, i, v.ep);
  jx_set(o + KFLD(LEADER), S, i, v.ld);
}

// pendingFetch[i] := Nil
__device__ __forceinline__ void kr_clear_pf(const int* sp, int* o, int i) {
  const int S = KFLD(S);
  jx_set(o + KFLD(PF_EP), S, i, 0);
  jx_set(o + KFLD(PF_OFF), S, i, 0);
  jx_set(o + KFLD(PF_LE), S, i, 0);
  jx_set(o + KFLD(PF_DEST), S, i, 0);
}

// ---- log-position math (KRaft.tla:247-310), over a log row lt of L lanes ----

// LastEpoch — KRaft.tla:165
__device__ __forceinline__ int kr_last_epoch(const int* lt, int L, int ll) {
  return ll > 0 ? lt[ra_clamp(ll - 1, 0, L - 1)] : 0;
}

// EndOffsetForEpoch — KRaft.tla:285-301: (offset, epoch) of the highest
// entry with epoch <= lfe; (0, 0) if none
__device__ __forceinline__ void kr_end_offset_for_epoch(const int* lt, int L, int ll, int lfe,
                                                        int* off, int* ep) {
  int best = 0;
  for (int l = 0; l < L; ++l)
    if (l < ll && lt[l] <= lfe) best = l + 1;
  *off = best;
  *ep = best > 0 ? lt[ra_clamp(best - 1, 0, L - 1)] : 0;
}

// HighestCommonOffset — KRaft.tla:255-273
__device__ __forceinline__ int kr_highest_common_offset(const int* lt, int L, int ll,
                                                        int end_off, int epoch) {
  int best = 0;
  for (int l = 0; l < L; ++l)
    if (l < ll && (lt[l] < epoch || (lt[l] == epoch && l + 1 <= end_off))) best = l + 1;
  return best;
}

// ---- action groups ----

// Restart(i) — KRaft.tla:423-432: keeps currentEpoch, votedFor and the log;
// loses leader belief, votes, endOffset, hwm and pendingFetch
template <bool WRITE, class Gp>
__device__ bool kr_restart(Gp g, const int* sp, const int* s, int* o, int i) {
  if (WRITE) {
    const int S = KFLD(S);
    if (g.lead()) {
      jx_set(o + KFLD(ST), S, i, KR_FOLLOWER);
      jx_set(o + KFLD(LEADER), S, i, RA_NIL);
      jx_set(o + KFLD(VG), S, i, 0);
      jx_set(o + KFLD(HWM), S, i, 0);
      kr_clear_pf(sp, o, i);
      o[KFLD(RCTR)] = s[KFLD(RCTR)] + 1;
    }
    grp_for(g, S, [&](int k) { jx_set2(o + KFLD(EO), S, S, i, k, 0); });
  }
  return s[KFLD(RCTR)] < KFLD(MAX_RESTARTS);
}

// RequestVote(i) — KRaft.tla:439-456 (fused Timeout + RequestVote, from
// Follower, Candidate or Unattached): a request to each peer, send-once
template <bool WRITE, class Gp>
__device__ Guard kr_request_vote(Gp g, const int* sp, const int* s, int* o, int i, int* bag) {
  const int S = KFLD(S), L = KFLD(L), M = KFLD(M);
  const int st = jx_get(s + KFLD(ST), S, i);
  Guard gd{s[KFLD(ECTR)] < KFLD(MAX_ELECTIONS) &&
               (st == KR_FOLLOWER || st == KR_CANDIDATE || st == KR_UNATTACHED),
           KK_REQUESTVOTE, false};
  if (!WRITE && !gd.valid) return gd;  // ovf is masked by valid
  const int new_ep = jx_get(s + KFLD(EP), S, i) + 1;
  const int ll = jx_get(s + KFLD(LL), S, i);
  const int last_ep = kr_last_epoch(s + KFLD(LT) + jx_index(i, S) * L, L, ll);
  const ChainBag b = ra_chain_bag(s, o, bag, KFLD(HI), KFLD(LO), KFLD(CNT), M, WRITE);
  bool ovf = false;
  for (int d = 1; d < S; ++d) {
    const int j = (i + d) % S;
    Key k{{0, 0}};
    kr_pack(sp, k, KF_MTYPE, KR_RVREQ);
    kr_pack(sp, k, KF_MEPOCH, new_ep);
    kr_pack(sp, k, KF_MLASTLOGEPOCH, last_ep);
    kr_pack(sp, k, KF_MLASTLOGOFFSET, ll);
    kr_pack(sp, k, KF_MSOURCE, i);
    kr_pack(sp, k, KF_MDEST, j);
    k = ra_wrap32(k);
    const Put p = ra_probe(g, b.hi, b.lo, M, k);
    gd.valid = gd.valid && !p.existed;
    ovf = ovf || p.overflow;
    ra_insert(g, b.hi, b.lo, b.cnt, M, k, p);
  }
  gd.ovf = ovf && gd.valid;
  if (WRITE && g.lead()) {
    jx_set(o + KFLD(ST), S, i, KR_CANDIDATE);
    jx_set(o + KFLD(EP), S, i, new_ep);
    jx_set(o + KFLD(LEADER), S, i, RA_NIL);
    jx_set(o + KFLD(VF), S, i, i + 1);
    jx_set(o + KFLD(VG), S, i, 1 << i);
    kr_clear_pf(sp, o, i);
    o[KFLD(ECTR)] = s[KFLD(ECTR)] + 1;
  }
  return gd;
}

// BecomeLeader(i) — KRaft.tla:546-558: a BeginQuorumRequest to each peer,
// send-once
template <bool WRITE, class Gp>
__device__ Guard kr_become_leader(Gp g, const int* sp, const int* s, int* o, int i, int* bag) {
  const int S = KFLD(S), M = KFLD(M);
  const int vg = jx_get(s + KFLD(VG), S, i);
  int votes = 0;
  for (int k = 0; k < S; ++k) votes += (vg >> k) & 1;
  Guard gd{jx_get(s + KFLD(ST), S, i) == KR_CANDIDATE && 2 * votes > S, KK_BECOMELEADER, false};
  if (!WRITE && !gd.valid) return gd;
  const int ep = jx_get(s + KFLD(EP), S, i);
  const ChainBag b = ra_chain_bag(s, o, bag, KFLD(HI), KFLD(LO), KFLD(CNT), M, WRITE);
  bool ovf = false;
  for (int d = 1; d < S; ++d) {
    const int j = (i + d) % S;
    Key k{{0, 0}};
    kr_pack(sp, k, KF_MTYPE, KR_BQREQ);
    kr_pack(sp, k, KF_MEPOCH, ep);
    kr_pack(sp, k, KF_MSOURCE, i);
    kr_pack(sp, k, KF_MDEST, j);
    k = ra_wrap32(k);
    const Put p = ra_probe(g, b.hi, b.lo, M, k);
    gd.valid = gd.valid && !p.existed;
    ovf = ovf || p.overflow;
    ra_insert(g, b.hi, b.lo, b.cnt, M, k, p);
  }
  gd.ovf = ovf && gd.valid;
  if (WRITE) {
    if (g.lead()) {
      jx_set(o + KFLD(ST), S, i, KR_LEADER);
      jx_set(o + KFLD(LEADER), S, i, i + 1);
    }
    grp_for(g, S, [&](int k) { jx_set2(o + KFLD(EO), S, S, i, k, 0); });
  }
  return gd;
}

// ClientRequest(i, v) — KRaft.tla:594-603; a log at max_log overflows
template <bool WRITE, class Gp>
__device__ Guard kr_client_request(Gp g, const int* sp, const int* s, int* o, int i, int v) {
  const int S = KFLD(S), L = KFLD(L), V = KFLD(V);
  Guard gd{jx_get(s + KFLD(ST), S, i) == KR_LEADER && jx_get(s + KFLD(ACK), V, v) == RA_ACK_NIL,
           KK_CLIENTREQUEST, false};
  const int pos = jx_get(s + KFLD(LL), S, i);
  gd.ovf = gd.valid && pos >= L;
  if (WRITE && g.lead()) {
    const int posc = ra_clamp(pos, 0, L - 1);
    jx_set2(o + KFLD(LT), S, L, i, posc, jx_get(s + KFLD(EP), S, i));
    jx_set2(o + KFLD(LV), S, L, i, posc, v + 1);
    jx_set(o + KFLD(LL), S, i, pos + 1);
    jx_set(o + KFLD(ACK), V, v, RA_ACK_FALSE);
  }
  return gd;
}

// SendFetchRequest(i, j) — KRaft.tla:607-624: an unrestricted send (its
// put ignores existed); the pendingFetch[i] = Nil gate is the flow control
template <bool WRITE, class Gp>
__device__ Guard kr_send_fetch(Gp g, const int* sp, const int* s, int* o, int i, int j) {
  const int S = KFLD(S), L = KFLD(L), M = KFLD(M);
  Guard gd{jx_get(s + KFLD(ST), S, i) == KR_FOLLOWER &&
               jx_get(s + KFLD(LEADER), S, i) == j + 1 && jx_get(s + KFLD(PF_EP), S, i) == 0,
           KK_SENDFETCH, false};
  if (!WRITE && !gd.valid) return gd;
  const int ep = jx_get(s + KFLD(EP), S, i), ll = jx_get(s + KFLD(LL), S, i);
  const int last_ep = kr_last_epoch(s + KFLD(LT) + jx_index(i, S) * L, L, ll);
  Key k{{0, 0}};
  kr_pack(sp, k, KF_MTYPE, KR_FETCHREQ);
  kr_pack(sp, k, KF_MEPOCH, ep);
  kr_pack(sp, k, KF_MFETCHOFFSET, ll);
  kr_pack(sp, k, KF_MLASTFETCHEDEPOCH, last_ep);
  kr_pack(sp, k, KF_MSOURCE, i);
  kr_pack(sp, k, KF_MDEST, j);
  k = ra_wrap32(k);
  const Put p = ra_probe(g, s + KFLD(HI), s + KFLD(LO), M, k);
  gd.ovf = p.overflow && gd.valid;
  if (WRITE) {
    if (g.lead()) {
      jx_set(o + KFLD(PF_EP), S, i, ep);
      jx_set(o + KFLD(PF_OFF), S, i, ll);
      jx_set(o + KFLD(PF_LE), S, i, last_ep);
      jx_set(o + KFLD(PF_DEST), S, i, j + 1);
    }
    ra_insert(g, o + KFLD(HI), o + KFLD(LO), o + KFLD(CNT), M, k, p);
  }
  return gd;
}

// the correlation-carrying fields of a FetchResponse (KRaft.tla:649): the
// request's epoch, offset and last fetched epoch; its endpoints are the
// response's, swapped
__device__ __forceinline__ void kr_pack_fetch_resp(const int* sp, Key& k, int epoch, int leader,
                                                   int hwm, int dst, int src, int c_ep,
                                                   int c_off, int c_lfe) {
  kr_pack(sp, k, KF_MTYPE, KR_FETCHRESP);
  kr_pack(sp, k, KF_MEPOCH, epoch);
  kr_pack(sp, k, KF_MLEADER, leader);
  kr_pack(sp, k, KF_MHWM, hwm);
  kr_pack(sp, k, KF_MSOURCE, dst);
  kr_pack(sp, k, KF_MDEST, src);
  kr_pack(sp, k, KF_CEPOCH, c_ep);
  kr_pack(sp, k, KF_CFETCHOFFSET, c_off);
  kr_pack(sp, k, KF_CLASTFETCHEDEPOCH, c_lfe);
}

// HandleMessage(slot m): the nine receipt disjuncts (HandleRVReq,
// HandleRVResp, RejectFetch, DivergingFetch, AcceptFetch, HandleBQReq,
// HandleSuccess/Diverging/ErrorFetchResponse), mutually exclusive for a
// record (they partition on mtype, then on the error, the fetch position
// and mresult); rank says which one fired, -1 when none did.
template <bool WRITE, class Gp>
__device__ Guard kr_handle_message(Gp g, const int* sp, const int* s, int* o, int m) {
  const int S = KFLD(S), L = KFLD(L), M = KFLD(M), V = KFLD(V);
  Guard gd{false, -1, false};
  const int khi = jx_get(s + KFLD(HI), M, m), klo = jx_get(s + KFLD(LO), M, m);
  // every branch needs a receivable record (KRaft.tla:230-235)
  if (khi == RA_EMPTY || jx_get(s + KFLD(CNT), M, m) <= 0) return gd;
  const int mtype = kr_unpack(sp, khi, klo, KF_MTYPE);
  const int mepoch = kr_unpack(sp, khi, klo, KF_MEPOCH);
  const int src = kr_unpack(sp, khi, klo, KF_MSOURCE);
  const int dst = kr_unpack(sp, khi, klo, KF_MDEST);
  const int cur = jx_get(s + KFLD(EP), S, dst), st = jx_get(s + KFLD(ST), S, dst);
  const int led = jx_get(s + KFLD(LEADER), S, dst), hwm = jx_get(s + KFLD(HWM), S, dst);
  const int ll = jx_get(s + KFLD(LL), S, dst);
  const int* lt = s + KFLD(LT) + jx_index(dst, S) * L;  // log rows of dst (clamped)
  const int* lv = s + KFLD(LV) + jx_index(dst, S) * L;

  bool b_rvreq = false, b_rvresp = false, b_bqreq = false, b_reject = false, b_div = false;
  bool b_accept = false, b_ok = false, b_divr = false, b_err = false;
  bool put_branch = false;  // a branch that replies
  Key k{{0, 0}};
  Sle nxt{st, cur, led};  // dst's (state, epoch, leader) where a branch writes it
  bool w_sle = false, clear_pf = false;
  bool rv_grant = false, granted_bit = false;
  int new_hwm = hwm, foff = 0;

  if (mtype == KR_RVREQ) {
    // HandleRequestVoteRequest (KRaft.tla:464-513)
    b_rvreq = put_branch = true;
    const bool rv_err = mepoch < cur;  // FencedLeaderEpoch
    const bool up = mepoch > cur;      // state0 (KRaft.tla:472-474)
    const int s0_st = up ? KR_UNATTACHED : st, s0_ep = up ? mepoch : cur;
    const int s0_ld = up ? RA_NIL : led;
    const int last_ep = kr_last_epoch(lt, L, ll);
    const int mlle = kr_unpack(sp, khi, klo, KF_MLASTLOGEPOCH);
    const bool log_ok = mlle > last_ep ||
                        (mlle == last_ep && kr_unpack(sp, khi, klo, KF_MLASTLOGOFFSET) >= ll);
    const bool grant = (s0_st == KR_UNATTACHED ||
                        (s0_st == KR_VOTED && jx_get(s + KFLD(VF), S, dst) == src + 1)) && log_ok;
    // TransitionToVoted from Unattached (KRaft.tla:483-485)
    const bool take_voted = grant && s0_st == KR_UNATTACHED;
    const Sle f{take_voted ? KR_VOTED : s0_st, take_voted ? mepoch : s0_ep,
                take_voted ? RA_NIL : s0_ld};
    kr_pack(sp, k, KF_MTYPE, KR_RVRESP);
    kr_pack(sp, k, KF_MEPOCH, rv_err ? cur : mepoch);
    kr_pack(sp, k, KF_MLEADER, rv_err ? led : f.ld);
    kr_pack(sp, k, KF_MVOTEGRANTED, rv_err ? 0 : grant);
    kr_pack(sp, k, KF_MERROR, rv_err ? KR_E_FENCED : KR_E_NONE);
    kr_pack(sp, k, KF_MSOURCE, dst);
    kr_pack(sp, k, KF_MDEST, src);
    w_sle = !rv_err;
    nxt = f;
    rv_grant = !rv_err && grant;
    clear_pf = !rv_err && f.st != st;  // IF state # state' (KRaft.tla:495-497)
  } else if (mtype == KR_RVRESP) {
    // HandleRequestVoteResponse (KRaft.tla:519-541)
    bool handled;
    const Sle mh = kr_maybe_handle_common(sp, s, dst, kr_unpack(sp, khi, klo, KF_MLEADER),
                                          mepoch, kr_unpack(sp, khi, klo, KF_MERROR), &handled);
    b_rvresp = handled || st == KR_CANDIDATE;
    w_sle = handled;
    nxt = mh;
    granted_bit = kr_unpack(sp, khi, klo, KF_MVOTEGRANTED) > 0 && !handled;
  } else if (mtype == KR_BQREQ) {
    // HandleBeginQuorumRequest (KRaft.tla:563-590)
    b_bqreq = put_branch = true;
    const bool ok = mepoch >= cur;
    kr_pack(sp, k, KF_MTYPE, KR_BQRESP);
    kr_pack(sp, k, KF_MEPOCH, ok ? mepoch : cur);
    kr_pack(sp, k, KF_MSOURCE, dst);
    kr_pack(sp, k, KF_MDEST, src);
    kr_pack(sp, k, KF_MERROR, ok ? KR_E_NONE : KR_E_FENCED);
    w_sle = clear_pf = ok;
    if (ok) nxt = kr_maybe_transition(sp, s, dst, src + 1, mepoch);
  } else if (mtype == KR_FETCHREQ) {
    // the FetchRequest branches (KRaft.tla:631-736)
    const bool is_leader = st == KR_LEADER;
    const int ferr = !is_leader ? KR_E_NOTLEADER
                                : (mepoch < cur ? KR_E_FENCED
                                                : (mepoch > cur ? KR_E_UNKNOWN : KR_E_NONE));
    foff = kr_unpack(sp, khi, klo, KF_MFETCHOFFSET);
    const int flep = kr_unpack(sp, khi, klo, KF_MLASTFETCHEDEPOCH);
    int eo_off, eo_ep;
    kr_end_offset_for_epoch(lt, L, ll, flep, &eo_off, &eo_ep);
    // ValidFetchPosition (KRaft.tla:305-310)
    const bool valid_pos = (foff == 0 && flep == 0) || (foff <= eo_off && flep == eo_ep);
    put_branch = true;
    if (ferr != KR_E_NONE) {
      // RejectFetchRequest (KRaft.tla:631-651)
      b_reject = true;
      kr_pack_fetch_resp(sp, k, cur, led, hwm, dst, src, mepoch, foff, flep);
      kr_pack(sp, k, KF_MRESULT, KR_R_NOTOK);
      kr_pack(sp, k, KF_MERROR, ferr);
    } else if (!valid_pos) {
      // DivergingFetchRequest (KRaft.tla:658-679)
      b_div = true;
      kr_pack_fetch_resp(sp, k, cur, led, hwm, dst, src, mepoch, foff, flep);
      kr_pack(sp, k, KF_MRESULT, KR_R_DIVERGING);
      kr_pack(sp, k, KF_MDIVEPOCH, eo_ep);
      kr_pack(sp, k, KF_MDIVENDOFFSET, eo_off);
    } else {
      // AcceptFetchRequest (KRaft.tla:703-736). NewHighwaterMark
      // (:689-701): the largest index in the log that a quorum of the new
      // endOffset row (with [dst][src] := foff; the leader counted itself)
      // reaches, if its entry is of the current epoch
      b_accept = true;
      const int* eo = s + KFLD(EO) + jx_index(dst, S) * S;
      int s_w = src;
      const bool wrote = jx_in(s_w, S);
      int max_agree = 0;
      for (int idx = 1; idx <= L; ++idx) {
        int n = 0;
        for (int q = 0; q < S; ++q) n += q == dst || ((wrote && q == s_w) ? foff : eo[q]) >= idx;
        if (2 * n > S && idx <= ll) max_agree = idx;
      }
      if (max_agree > 0 && lt[ra_clamp(max_agree - 1, 0, L - 1)] == cur) new_hwm = max_agree;
      const int offset = foff + 1;
      const bool have = offset <= ll;
      const int epos = ra_clamp(offset - 1, 0, L - 1);
      kr_pack_fetch_resp(sp, k, cur, led, new_hwm < offset ? new_hwm : offset, dst, src, mepoch,
                         foff, flep);
      kr_pack(sp, k, KF_MRESULT, KR_R_OK);
      kr_pack(sp, k, KF_NENTRIES, have);
      kr_pack(sp, k, KF_EEPOCH, have ? lt[epos] : 0);
      kr_pack(sp, k, KF_EVALUE, have ? lv[epos] : 0);
    }
  } else if (mtype == KR_FETCHRESP) {
    // the FetchResponse branches (KRaft.tla:742-801): the correlation
    // match pendingFetch[dst] = m.correlation (:749), the request's msource
    // dst (implied) and its mdest the responder src
    bool handled;
    const Sle mh = kr_maybe_handle_common(sp, s, dst, kr_unpack(sp, khi, klo, KF_MLEADER),
                                          mepoch, kr_unpack(sp, khi, klo, KF_MERROR), &handled);
    const int pf_ep = jx_get(s + KFLD(PF_EP), S, dst);
    const bool corr = pf_ep > 0 && pf_ep == kr_unpack(sp, khi, klo, KF_CEPOCH) &&
                      jx_get(s + KFLD(PF_OFF), S, dst) == kr_unpack(sp, khi, klo, KF_CFETCHOFFSET) &&
                      jx_get(s + KFLD(PF_LE), S, dst) ==
                          kr_unpack(sp, khi, klo, KF_CLASTFETCHEDEPOCH) &&
                      jx_get(s + KFLD(PF_DEST), S, dst) == src + 1;
    const int mres = kr_unpack(sp, khi, klo, KF_MRESULT);
    b_ok = !handled && corr && mres == KR_R_OK;
    b_divr = !handled && corr && mres == KR_R_DIVERGING;
    b_err = handled && corr;
    w_sle = b_err;
    clear_pf = b_ok || b_divr || b_err;
    nxt = mh;
  }

  // the shared Reply: the response put once into the bag whose slot m was
  // discarded; only the FetchResponse replies are disabled by their
  // response already in the bag (KRaft.tla:224-227)
  Put p{false, false, 0};
  if (put_branch) {
    k = ra_wrap32(k);
    p = ra_probe(g, s + KFLD(HI), s + KFLD(LO), M, k);
    b_reject = b_reject && !p.existed;
    b_div = b_div && !p.existed;
    b_accept = b_accept && !p.existed;
  }
  const bool putb = b_rvreq || b_bqreq || b_reject || b_div || b_accept;
  const bool dropb = b_rvresp || b_ok || b_divr || b_err;  // Discard only
  const bool app = b_ok && kr_unpack(sp, khi, klo, KF_NENTRIES) > 0;

  gd.valid = putb || dropb;
  if (b_rvreq) gd.rank = KK_HANDLE_RVREQ;
  if (b_rvresp) gd.rank = KK_HANDLE_RVRESP;
  if (b_reject) gd.rank = KK_REJECT_FETCH;
  if (b_div) gd.rank = KK_DIVERGING_FETCH;
  if (b_accept) gd.rank = KK_ACCEPT_FETCH;
  if (b_bqreq) gd.rank = KK_HANDLE_BQREQ;
  if (b_ok) gd.rank = KK_HANDLE_FETCH_OK;
  if (b_divr) gd.rank = KK_HANDLE_FETCH_DIV;
  if (b_err) gd.rank = KK_HANDLE_FETCH_ERR;
  gd.ovf = (putb && p.overflow) || (app && ll >= L);

  if (WRITE && gd.valid) {
    const bool lw = g.lead();
    if (lw) {
      if (w_sle) kr_set_sle(sp, o, dst, nxt);
      if (b_rvreq && rv_grant) jx_set(o + KFLD(VF), S, dst, src + 1);
      if (b_rvresp && granted_bit)
        jx_set(o + KFLD(VG), S, dst, jx_get(s + KFLD(VG), S, dst) | (1 << src));
      if (clear_pf) kr_clear_pf(sp, o, dst);
    }
    if (b_accept) {
      const int* eo = s + KFLD(EO) + jx_index(dst, S) * S;
      int s_w = src;
      const bool wrote = jx_in(s_w, S);
      grp_for(g, S, [&](int q) {
        jx_set2(o + KFLD(EO), S, S, dst, q, (wrote && q == s_w) ? foff : eo[q]);
      });
      if (lw) jx_set(o + KFLD(HWM), S, dst, new_hwm);
      // acked: FALSE -> TRUE for values committed in (hwm, new_hwm]
      // (KRaft.tla:721-724)
      grp_for(g, V, [&](int v) {
        bool committed = false;
        for (int l = 0; l < L; ++l) committed |= l + 1 > hwm && l + 1 <= new_hwm && lv[l] == v + 1;
        if (s[KFLD(ACK) + v] == RA_ACK_FALSE && committed) o[KFLD(ACK) + v] = RA_ACK_TRUE;
      });
    }
    if (b_ok && lw) {  // HandleSuccessFetchResponse (KRaft.tla:742-757)
      jx_set(o + KFLD(HWM), S, dst, kr_unpack(sp, khi, klo, KF_MHWM));
      if (app) {
        const int apos = ra_clamp(ll, 0, L - 1);
        jx_set2(o + KFLD(LT), S, L, dst, apos, kr_unpack(sp, khi, klo, KF_EEPOCH));
        jx_set2(o + KFLD(LV), S, L, dst, apos, kr_unpack(sp, khi, klo, KF_EVALUE));
        jx_set(o + KFLD(LL), S, dst, ll + 1);
      }
    }
    if (b_divr) {  // HandleDivergingFetchResponse (KRaft.tla:766-780)
      const int hco = kr_highest_common_offset(
          lt, L, ll, kr_unpack(sp, khi, klo, KF_MDIVENDOFFSET),
          kr_unpack(sp, khi, klo, KF_MDIVEPOCH));
      grp_for(g, L, [&](int l) {
        jx_set2(o + KFLD(LT), S, L, dst, l, l < hco ? lt[l] : 0);
        jx_set2(o + KFLD(LV), S, L, dst, l, l < hco ? lv[l] : 0);
      });
      if (lw) jx_set(o + KFLD(LL), S, dst, hco);
    }
    if (lw) o[KFLD(CNT) + m] -= 1;  // the incoming Discard
    if (putb) ra_insert(g, o + KFLD(HI), o + KFLD(LO), o + KFLD(CNT), M, k, p);
  }
  return gd;
}

// One candidate (a row of the model's candidate table) of one state, by the
// group g; `bag` is a chain lane's guard scratch (2 * M ints), unused
// otherwise.
template <bool WRITE, class Gp>
__device__ Guard kr_action(Gp g, const int* sp, const int* s, int* o, const int* cd, int* bag) {
  const int p0 = cd[1], p1 = cd[2];
  switch (cd[0]) {
    case KG_RESTART: return Guard{kr_restart<WRITE>(g, sp, s, o, p0), cd[3], false};
    case KG_REQUEST_VOTE: return kr_request_vote<WRITE>(g, sp, s, o, p0, bag);
    case KG_BECOME_LEADER: return kr_become_leader<WRITE>(g, sp, s, o, p0, bag);
    case KG_CLIENT_REQUEST: return kr_client_request<WRITE>(g, sp, s, o, p0, p1);
    case KG_SEND_FETCH: return kr_send_fetch<WRITE>(g, sp, s, o, p0, p1);
    case KG_HANDLE_MESSAGE: return kr_handle_message<WRITE>(g, sp, s, o, p0);
  }
  return Guard{false, cd[3], false};
}

// ---- invariants and the liveness predicate (true = holds) ----

// the shared formulas' view of KRaft: currentEpoch, highWatermark and
// log_epoch in the roles of Raft's currentTerm, commitIndex and log_term
__device__ __forceinline__ InvFields kr_inv_fields(const int* sp) {
  return InvFields{KFLD(S),  KFLD(L),  KFLD(V),   KFLD(M),   KFLD(EP), KFLD(ST),
                   KFLD(LT), KFLD(LV), KFLD(LL),  KFLD(HWM), KFLD(ACK), KFLD(HI),
                   KFLD(LO), sp + KS_MSG + 3 * KF_MSOURCE, sp + KS_MSG + 3 * KF_MDEST,
                   KR_LEADER};
}

__device__ __forceinline__ bool kr_invariant(const int* sp, const int* s, int id) {
  const int S = KFLD(S);
  const int *st = s + KFLD(ST), *led = s + KFLD(LEADER), *ep = s + KFLD(EP);
  if (id == KR_INV_NO_ILLEGAL) {  // NoIllegalState — KRaft.tla:887-889
    for (int i = 0; i < S; ++i)
      if (st[i] == KR_ILLEGAL) return false;
    return true;
  }
  if (id == KR_INV_NEVER_TWO_LEADERS) {  // NeverTwoLeadersInSameEpoch — KRaft.tla:916-921
    for (int i = 0; i < S; ++i)
      for (int j = 0; j < S; ++j)
        if (led[i] != RA_NIL && led[j] != RA_NIL && led[i] != led[j] && ep[i] == ep[j])
          return false;
    return true;
  }
  return inv_eval(kr_inv_fields(sp), s, id);
}

// An invariant id or a liveness predicate id (PRED_VALUE_AON + v:
// ValueAllOrNothing(v), KRaft.tla:867-875).
__device__ __forceinline__ bool kr_predicate(const int* sp, const int* s, int id) {
  if (id >= PRED_VALUE_AON)
    return inv_value_all_or_nothing(kr_inv_fields(sp), s, s[KFLD(ECTR)], KFLD(MAX_ELECTIONS),
                                    id - PRED_VALUE_AON);
  return kr_invariant(sp, s, id);
}

// KRaft as the kernel drivers see it: where its spec keeps the sizes, the
// guard scratch of a state (a slot of 2 * M ints for each of its 2 * S
// chain lanes, RequestVote(i) and BecomeLeader(i)), its actions, the group
// apply's tile and its predicates.
struct KRaftFamily {
  static constexpr int SPEC_LEN = KS_LEN;
  static constexpr int BAG_WORDS = 2;  // (hi, lo) keys
  static constexpr int I_S = KS_S, I_M = KS_M, I_W = KS_W, I_A = KS_A, I_K = KS_K;
  // the group apply's threads a worklist lane and resident blocks an SM
  // (expand_driver.cuh): 32 and 4, the fastest of G 4-32 at 2-4 blocks on
  // KRaft.cfg's chunk and move (PERF.md's tile table)
  static constexpr int APPLY_G = 32, APPLY_BLOCKS = 4;
  __host__ __device__ __forceinline__ static int scratch_slots(int S) { return 2 * S; }
  __device__ __forceinline__ static int scratch_slot(const int* cd) {
    if (cd[0] == KG_REQUEST_VOTE) return 2 * cd[1];
    if (cd[0] == KG_BECOME_LEADER) return 2 * cd[1] + 1;
    return -1;
  }
  template <bool WRITE>
  __device__ __forceinline__ static Guard action(const int* sp, const int* s, int* o, const int* cd, int* bag) {
    return kr_action<WRITE>(GrpOne{}, sp, s, o, cd, bag);
  }
  // the successor row `o` (a copy of `s`) of one candidate, by the group g
  // of threads that shares the lane (expand_driver.cuh's group apply)
  template <class Gp>
  __device__ __forceinline__ static void apply(Gp g, const int* sp, const int* s, int* o,
                                               const int* cd) {
    kr_action<true>(g, sp, s, o, cd, nullptr);
  }
  __device__ __forceinline__ static bool invariant(const int* sp, const int* s, int id) {
    return kr_invariant(sp, s, id);
  }
  __device__ __forceinline__ static bool predicate(const int* sp, const int* s, int id) {
    return kr_predicate(sp, s, id);
  }
};

#undef KFLD
