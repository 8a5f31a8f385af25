// pull_actions.cuh — the PullRaft / PullRaftVariant2 action groups and
// invariants as device code.
//
// Replaces raft_tpu/models/pull_raft.py:263-660 (the action kernels behind
// _expand1 :667, with ops/bag.py and ops/packing.py) and the invariants of
// pull_raft.py:703-760 plus models/base.py:143 messages_are_valid_kernel
// (the formulas of actions_common.cuh), with the fleet lanes of
// models/base.py:130-232 (Restart and RequestVote read MaxRestarts and
// MaxElections from the state's c_<name> lane where the spec gives the
// lane's offset, the static value where it gives -1). It mirrors the port's batched
// plain version, raft_tpu_torch/models/pull_raft.py, one (state, candidate)
// pair at a time, for both specs: the layout, message packing and flags
// come from the model's int32 spec vector (PullRaftModel.kernel_spec).
//
// Every action group is one function templated on WRITE, as in
// raft_actions.cuh: with WRITE false it computes only (valid, rank, ovf)
// and writes no successor lane; with WRITE true it also writes the
// successor row `o`, a copy of the state `s` made by the caller, lane by
// changed lane. RequestVote(i) and BecomeLeader(i) each put a chain of
// S - 1 messages, each put acting on the bag the previous one left; a
// guard lane of either replays its chain on its own copy of the bag's keys
// (`bag`, 2 * M ints of scratch: PullFamily gives each of the 2 * S chain
// lanes of a state its own slot).
//
// Bit-identity rules the code keeps (each is a property of the reference,
// which indexes with traced values, and of the plain version):
//   - a read x[i] with an out-of-range index i reads the clamped index and
//     a write x.at[i].set(v) to one writes nothing (JAX's gather and
//     scatter; a negative index first counts from the end): a record's
//     msource or mdest may exceed the last server;
//   - every key is computed in int32 (the reference's _pack casts), so a
//     too-wide field value wraps and bleeds into the next field;
//   - Reply (PullRaft.tla:158-161) discards the request, then puts the
//     response, and a response already in the bag (count 0 included)
//     disables the action: existed and overflow are read on the bag
//     before the put, where the discard changed only a count.
#pragma once

#include "actions_common.cuh"

enum { PU_RVREQ = 1, PU_RVRESP = 2, PU_PULLREQ = 3, PU_PULLRESP = 4, PU_NOTIFY = 5 };

// Next-disjunct ranks (models/pull_raft.py R_*, PullRaft.tla:542-558).
enum {
  PR_RESTART, PR_UPDATETERM, PR_REQUESTVOTE, PR_HANDLE_RVREQ, PR_HANDLE_RVRESP,
  PR_BECOMELEADER, PR_CLIENTREQUEST, PR_REJECT_PULL, PR_ACCEPT_PULL, PR_LEARNOFLEADER,
  PR_SENDPULL, PR_HANDLE_SUCCESS_PULL, PR_HANDLE_FAIL_PULL
};

// The spec vector (models/pull_raft.py SPEC_SCALARS, then MSG_FIELDS x 3).
enum {
  PS_S, PS_V, PS_L, PS_M, PS_W, PS_A, PS_K,
  PS_CT, PS_ST, PS_LEADER, PS_VF, PS_VLE_HAS, PS_VLE_IDX, PS_VLE_TERM, PS_VG, PS_LT, PS_LV,
  PS_LL, PS_CI, PS_MI, PS_HI, PS_LO, PS_CNT, PS_ACK, PS_ECTR, PS_RCTR,
  PS_VARIANT2, PS_MAX_ELECTIONS, PS_MAX_RESTARTS, PS_C_MAX_ELECTIONS, PS_C_MAX_RESTARTS,
  PS_MSG
};
enum {
  PF_MTYPE, PF_MTERM, PF_MSOURCE, PF_MDEST, PF_MLASTLOGTERM, PF_MLASTLOGINDEX,
  PF_MVOTEGRANTED, PF_MSUCCESS, PF_NENTRIES, PF_ETERM, PF_EVALUE, PF_MCOMMITINDEX,
  PF_MLCHAS, PF_MLCINDEX, PF_MLCTERM, PF_N
};
#define PS_LEN (PS_MSG + 3 * PF_N)

// Action groups (models/pull_raft.py GROUP_IDS); a candidate row of the
// model's candidate table is (group, p0, p1, rank).
enum {
  PG_RESTART, PG_REQUEST_VOTE, PG_BECOME_LEADER, PG_CLIENT_REQUEST, PG_SEND_PULL,
  PG_HANDLE_MESSAGE
};

#define PFLD(o) (sp[PS_##o])
// a dynamic constant of a state: its fleet lane where the spec names one
#define PCONST(o) (PFLD(C_##o) >= 0 ? s[PFLD(C_##o)] : PFLD(o))

// ---- message words ----

__device__ __forceinline__ int pu_unpack(const int* sp, int hi, int lo, int f) {
  return ra_unpack_q(sp + PS_MSG + 3 * f, hi, lo);
}
__device__ __forceinline__ void pu_pack(const int* sp, Key& k, int f, long long v) {
  ra_pack_q(sp + PS_MSG + 3 * f, k, v);
}

// ---- state helpers ----

// LastTerm(log[i]) — PullRaft.tla:134
__device__ __forceinline__ int pu_last_term(const int* sp, const int* s, int i) {
  const int S = PFLD(S), L = PFLD(L);
  const int ll = jx_get(s + PFLD(LL), S, i);
  return ll > 0 ? jx_get2(s + PFLD(LT), S, L, i, ll - 1) : 0;
}

// LastCommonEntry — PullRaft.tla:211-226: the highest index k in 1..ll of
// the log row `lt` whose entry (k, lt[k]) is at or below (last_idx,
// last_term) in CompareEntries' term-precedence order (:203-207); (0, 0)
// if none.
__device__ __forceinline__ void pu_last_common(const int* lt, int L, int ll, int last_idx,
                                               int last_term, int* idx, int* term) {
  int best = 0;
  for (int k = 1; k <= L; ++k) {
    const int t = lt[k - 1];
    if (k <= ll && (t < last_term || (t == last_term && k <= last_idx))) best = k;
  }
  *idx = best;
  *term = best > 0 ? lt[ra_clamp(best - 1, 0, L - 1)] : 0;
}

// ---- action groups ----

// Restart(i) — PullRaft.tla:258-265 (keeps currentTerm, leader, log);
// Variant2 (PullRaftVariant2.tla:251-260) clears leader and votesLastEntry
template <bool WRITE>
__device__ bool pu_restart(const int* sp, const int* s, int* o, int i) {
  if (WRITE) {
    const int S = PFLD(S);
    jx_set(o + PFLD(ST), S, i, RA_FOLLOWER);
    jx_set(o + PFLD(VG), S, i, 0);
    for (int k = 0; k < S; ++k) jx_set2(o + PFLD(MI), S, S, i, k, 0);
    jx_set(o + PFLD(CI), S, i, 0);
    o[PFLD(RCTR)] = s[PFLD(RCTR)] + 1;
    if (PFLD(VARIANT2)) {
      jx_set(o + PFLD(LEADER), S, i, RA_NIL);
      for (int k = 0; k < S; ++k) {
        jx_set2(o + PFLD(VLE_HAS), S, S, i, k, 0);
        jx_set2(o + PFLD(VLE_IDX), S, S, i, k, 0);
        jx_set2(o + PFLD(VLE_TERM), S, S, i, k, 0);
      }
    }
  }
  return s[PFLD(RCTR)] < PCONST(MAX_RESTARTS);
}

// RequestVote(i) — PullRaft.tla:283-298 (leader[i] := i); Variant2
// (PullRaftVariant2.tla:279-295): votedFor := i, leader := Nil. A
// RequestVoteRequest to each peer, each send-once (SendMultiple :141-143).
template <bool WRITE>
__device__ Guard pu_request_vote(const int* sp, const int* s, int* o, int i, int* bag) {
  const int S = PFLD(S), M = PFLD(M);
  const int st = jx_get(s + PFLD(ST), S, i);
  Guard g{s[PFLD(ECTR)] < PCONST(MAX_ELECTIONS) && (st == RA_FOLLOWER || st == RA_CANDIDATE),
          PR_REQUESTVOTE, false};
  if (!WRITE && !g.valid) return g;  // ovf is masked by valid
  const int new_term = jx_get(s + PFLD(CT), S, i) + 1;
  const int last_t = pu_last_term(sp, s, i), ll = jx_get(s + PFLD(LL), S, i);
  const ChainBag b = ra_chain_bag(s, o, bag, PFLD(HI), PFLD(LO), PFLD(CNT), M, WRITE);
  bool ovf = false;
  for (int d = 1; d < S; ++d) {
    const int j = (i + d) % S;
    Key k{{0, 0}};
    pu_pack(sp, k, PF_MTYPE, PU_RVREQ);
    pu_pack(sp, k, PF_MTERM, new_term);
    pu_pack(sp, k, PF_MLASTLOGTERM, last_t);
    pu_pack(sp, k, PF_MLASTLOGINDEX, ll);
    pu_pack(sp, k, PF_MSOURCE, i);
    pu_pack(sp, k, PF_MDEST, j);
    k = ra_wrap32(k);
    const Put p = ra_bag_probe(b.hi, b.lo, M, k);
    g.valid = g.valid && !p.existed;
    ovf = ovf || p.overflow;
    ra_bag_insert(b.hi, b.lo, b.cnt, M, k, p);
  }
  g.ovf = ovf && g.valid;
  if (WRITE) {
    jx_set(o + PFLD(ST), S, i, RA_CANDIDATE);
    jx_set(o + PFLD(CT), S, i, new_term);
    jx_set(o + PFLD(VG), S, i, 1 << i);
    o[PFLD(ECTR)] = s[PFLD(ECTR)] + 1;
    if (PFLD(VARIANT2)) {
      jx_set(o + PFLD(VF), S, i, i + 1);
      jx_set(o + PFLD(LEADER), S, i, RA_NIL);
    } else {
      jx_set(o + PFLD(LEADER), S, i, i + 1);
    }
  }
  return g;
}

// BecomeLeader(i) — PullRaft.tla:354-366: a LeaderNotifyRequest to each
// peer that did not vote for i; Variant2 (PullRaftVariant2.tla:361-379):
// to every peer, each with its own mlastCommonEntry, and leader[i] := i
template <bool WRITE>
__device__ Guard pu_become_leader(const int* sp, const int* s, int* o, int i, int* bag) {
  const int S = PFLD(S), L = PFLD(L), M = PFLD(M);
  const int vg = jx_get(s + PFLD(VG), S, i);
  int votes = 0;
  for (int k = 0; k < S; ++k) votes += (vg >> k) & 1;
  Guard g{jx_get(s + PFLD(ST), S, i) == RA_CANDIDATE && 2 * votes > S, PR_BECOMELEADER, false};
  if (!WRITE && !g.valid) return g;
  const bool v2 = PFLD(VARIANT2);
  const int ct = jx_get(s + PFLD(CT), S, i);
  const int* lt_i = s + PFLD(LT) + jx_index(i, S) * L;
  const int ll_i = jx_get(s + PFLD(LL), S, i);
  const ChainBag b = ra_chain_bag(s, o, bag, PFLD(HI), PFLD(LO), PFLD(CNT), M, WRITE);
  bool ovf = false;
  for (int d = 1; d < S; ++d) {
    const int j = (i + d) % S;
    Key k{{0, 0}};
    pu_pack(sp, k, PF_MTYPE, PU_NOTIFY);
    pu_pack(sp, k, PF_MTERM, ct);
    bool send = true;
    if (v2) {
      const bool has = jx_get2(s + PFLD(VLE_HAS), S, S, i, j) > 0;
      int lce_i, lce_t;
      pu_last_common(lt_i, L, ll_i, jx_get2(s + PFLD(VLE_IDX), S, S, i, j),
                     jx_get2(s + PFLD(VLE_TERM), S, S, i, j), &lce_i, &lce_t);
      pu_pack(sp, k, PF_MLCHAS, has);
      pu_pack(sp, k, PF_MLCINDEX, has ? lce_i : 0);
      pu_pack(sp, k, PF_MLCTERM, has ? lce_t : 0);
    } else {
      send = ((vg >> j) & 1) == 0;  // only peers that did not vote for i (PullRaft.tla:364)
    }
    pu_pack(sp, k, PF_MSOURCE, i);
    pu_pack(sp, k, PF_MDEST, j);
    if (!send) continue;
    k = ra_wrap32(k);
    const Put p = ra_bag_probe(b.hi, b.lo, M, k);
    g.valid = g.valid && !p.existed;
    ovf = ovf || p.overflow;
    ra_bag_insert(b.hi, b.lo, b.cnt, M, k, p);
  }
  g.ovf = ovf && g.valid;
  if (WRITE) {
    jx_set(o + PFLD(ST), S, i, RA_LEADER);
    for (int k = 0; k < S; ++k) jx_set2(o + PFLD(MI), S, S, i, k, 0);
    if (v2) jx_set(o + PFLD(LEADER), S, i, i + 1);
  }
  return g;
}

// ClientRequest(i, v) — PullRaft.tla:370-379; a log at max_log overflows
template <bool WRITE>
__device__ Guard pu_client_request(const int* sp, const int* s, int* o, int i, int v) {
  const int S = PFLD(S), L = PFLD(L), V = PFLD(V);
  Guard g{jx_get(s + PFLD(ST), S, i) == RA_LEADER && jx_get(s + PFLD(ACK), V, v) == RA_ACK_NIL,
          PR_CLIENTREQUEST, false};
  const int pos = jx_get(s + PFLD(LL), S, i);
  g.ovf = g.valid && pos >= L;
  if (WRITE) {
    const int posc = ra_clamp(pos, 0, L - 1);
    jx_set2(o + PFLD(LT), S, L, i, posc, jx_get(s + PFLD(CT), S, i));
    jx_set2(o + PFLD(LV), S, L, i, posc, v + 1);
    jx_set(o + PFLD(LL), S, i, pos + 1);
    jx_set(o + PFLD(ACK), V, v, RA_ACK_FALSE);
  }
  return g;
}

// SendPullEntriesRequest(i, j) — PullRaft.tla:396-411 (send-once)
template <bool WRITE>
__device__ Guard pu_send_pull(const int* sp, const int* s, int* o, int i, int j) {
  const int S = PFLD(S), M = PFLD(M);
  Guard g{jx_get(s + PFLD(ST), S, i) == RA_FOLLOWER && jx_get(s + PFLD(LEADER), S, i) == j + 1,
          PR_SENDPULL, false};
  if (!WRITE && !g.valid) return g;
  Key k{{0, 0}};
  pu_pack(sp, k, PF_MTYPE, PU_PULLREQ);
  pu_pack(sp, k, PF_MTERM, jx_get(s + PFLD(CT), S, i));
  pu_pack(sp, k, PF_MLASTLOGINDEX, jx_get(s + PFLD(LL), S, i));
  pu_pack(sp, k, PF_MLASTLOGTERM, pu_last_term(sp, s, i));
  pu_pack(sp, k, PF_MSOURCE, i);
  pu_pack(sp, k, PF_MDEST, j);
  k = ra_wrap32(k);
  const Put p = ra_bag_probe(s + PFLD(HI), s + PFLD(LO), M, k);
  g.valid = g.valid && !p.existed;
  g.ovf = p.overflow && g.valid;
  if (WRITE) ra_bag_insert(o + PFLD(HI), o + PFLD(LO), o + PFLD(CNT), M, k, p);
  return g;
}

// NewCommitIndex — PullRaft.tla:446-458, inside AcceptPullEntriesRequest:
// the largest index a quorum of matchIndex[dst] (with [dst][src] := pidx,
// dropped where either is out of range) and dst itself agree on, if its
// entry is of the current term; else the commit index stays.
__device__ __forceinline__ int pu_new_commit(const int* sp, const int* s, int dst, int src,
                                             int pidx, int ct, int ll, const int* lt) {
  const int S = PFLD(S), L = PFLD(L);
  const int* mrow = s + PFLD(MI) + jx_index(dst, S) * S;
  int d_w = dst, s_w = src;
  const bool wrote = jx_in(d_w, S) && jx_in(s_w, S);
  int max_agree = 0;
  for (int idx = 1; idx <= L; ++idx) {
    int cnt = 0;
    for (int k = 0; k < S; ++k) {
      const int mk = (wrote && k == s_w) ? pidx : mrow[k];
      cnt += k == dst || mk >= idx;
    }
    if (2 * cnt > S && idx <= ll) max_agree = idx;
  }
  const int term_at = lt[ra_clamp(max_agree - 1, 0, L - 1)];
  return (max_agree > 0 && term_at == ct) ? max_agree : jx_get(s + PFLD(CI), S, dst);
}

// HandleMessage(slot m): the eight receipt disjuncts (UpdateTerm,
// HandleRVReq, HandleRVResp, RejectPull, AcceptPull, LearnOfLeader,
// HandleSuccessPull, HandleFailPull), mutually exclusive for a record
// (they partition on mtype, the term comparison, ValidPullPosition and
// msuccess); rank says which one fired, -1 when none did.
template <bool WRITE>
__device__ Guard pu_handle_message(const int* sp, const int* s, int* o, int m) {
  const int S = PFLD(S), L = PFLD(L), M = PFLD(M), V = PFLD(V);
  const bool v2 = PFLD(VARIANT2);
  Guard g{false, -1, false};
  const int khi = jx_get(s + PFLD(HI), M, m), klo = jx_get(s + PFLD(LO), M, m);
  const int kcnt = jx_get(s + PFLD(CNT), M, m);
  if (khi == RA_EMPTY) return g;  // every branch needs a record in the domain
  const int mtype = pu_unpack(sp, khi, klo, PF_MTYPE);
  const int mterm = pu_unpack(sp, khi, klo, PF_MTERM);
  const int src = pu_unpack(sp, khi, klo, PF_MSOURCE);
  const int dst = pu_unpack(sp, khi, klo, PF_MDEST);
  const int ct = jx_get(s + PFLD(CT), S, dst), st = jx_get(s + PFLD(ST), S, dst);
  const int ll = jx_get(s + PFLD(LL), S, dst);
  const int* lt = s + PFLD(LT) + jx_index(dst, S) * L;  // log rows of dst (clamped)
  const int* lv = s + PFLD(LV) + jx_index(dst, S) * L;
  const bool recv = kcnt > 0;  // ReceivableMessage (PullRaft.tla:166-172)
  const int mlli = pu_unpack(sp, khi, klo, PF_MLASTLOGINDEX);
  const int mllt = pu_unpack(sp, khi, klo, PF_MLASTLOGTERM);

  // UpdateTerm (PullRaft.tla:269-276): count-0 records included
  const bool b_upd = mterm > ct;

  // HandleRequestVoteRequest (PullRaft.tla:306-330; PullRaftVariant2.tla:303-326)
  const int last_t = ll > 0 ? lt[ra_clamp(ll - 1, 0, L - 1)] : 0;
  const bool rv_logok = mllt > last_t || (mllt == last_t && mlli >= ll);
  const int vote_off = v2 ? PFLD(VF) : PFLD(LEADER);
  const int vote = jx_get(s + vote_off, S, dst);
  const bool grant = mterm == ct && rv_logok && (vote == RA_NIL || vote == src + 1);
  bool b_rvreq = recv && mtype == PU_RVREQ && mterm <= ct;

  // HandleRequestVoteResponse (PullRaft.tla:335-350)
  const bool b_rvresp = recv && mtype == PU_RVRESP && mterm == ct;

  // ValidPullPosition (PullRaft.tla:192-196) of a pull request
  const bool valid_pos =
      mlli == 0 || (mlli > 0 && mlli <= ll && mllt == lt[ra_clamp(mlli - 1, 0, L - 1)]);
  const bool is_pullreq = recv && mtype == PU_PULLREQ && mterm == ct && st == RA_LEADER;
  // RejectPullEntriesRequest (PullRaft.tla:418-436)
  bool b_reject = is_pullreq && !valid_pos;
  // AcceptPullEntriesRequest (PullRaft.tla:460-488)
  const int index = mlli + 1;
  bool b_accept = is_pullreq && valid_pos && index <= ll;
  // LearnOfLeader (PullRaft.tla:383-391)
  const bool b_learn = recv && mtype == PU_NOTIFY && mterm == ct;
  // HandleSuccess/FailPullEntriesResponse (PullRaft.tla:493-520)
  const bool is_pullresp = recv && mtype == PU_PULLRESP && mterm == ct;
  const int msuccess = pu_unpack(sp, khi, klo, PF_MSUCCESS);
  const bool b_succ = is_pullresp && msuccess > 0;
  const bool b_fail = is_pullresp && msuccess == 0;

  // the shared Reply: the branch's response, put once into the bag whose
  // slot m was discarded (counts change neither existed nor overflow)
  Put p{false, false, 0};
  Key k{{0, 0}};
  int new_ci = 0;
  if (b_rvreq || b_reject || b_accept) {
    pu_pack(sp, k, PF_MTERM, ct);
    if (b_rvreq) {
      pu_pack(sp, k, PF_MTYPE, PU_RVRESP);
      pu_pack(sp, k, PF_MVOTEGRANTED, grant);
      if (v2) {  // the response carries the last entry (PullRaftVariant2.tla:320-321)
        pu_pack(sp, k, PF_MLASTLOGINDEX, ll);
        pu_pack(sp, k, PF_MLASTLOGTERM, last_t);
      }
    } else if (b_reject) {
      int lce_i, lce_t;
      pu_last_common(lt, L, ll, mlli, mllt, &lce_i, &lce_t);
      pu_pack(sp, k, PF_MTYPE, PU_PULLRESP);
      pu_pack(sp, k, PF_MLCHAS, 1);
      pu_pack(sp, k, PF_MLCINDEX, lce_i);
      pu_pack(sp, k, PF_MLCTERM, lce_t);
    } else {
      new_ci = pu_new_commit(sp, s, dst, src, mlli, ct, ll, lt);
      const int epos = ra_clamp(index - 1, 0, L - 1);
      pu_pack(sp, k, PF_MTYPE, PU_PULLRESP);
      pu_pack(sp, k, PF_MSUCCESS, 1);
      pu_pack(sp, k, PF_NENTRIES, 1);
      pu_pack(sp, k, PF_ETERM, lt[epos]);
      pu_pack(sp, k, PF_EVALUE, lv[epos]);
      pu_pack(sp, k, PF_MCOMMITINDEX, new_ci < index ? new_ci : index);
    }
    pu_pack(sp, k, PF_MSOURCE, dst);
    pu_pack(sp, k, PF_MDEST, src);
    k = ra_wrap32(k);
    p = ra_bag_probe(s + PFLD(HI), s + PFLD(LO), M, k);
    b_rvreq = b_rvreq && !p.existed;  // send-once Reply (PullRaft.tla:158-161)
    b_reject = b_reject && !p.existed;
    b_accept = b_accept && !p.existed;
  }
  const bool putb = b_rvreq || b_reject || b_accept;
  const bool dropb = b_rvresp || b_learn || b_succ || b_fail;  // Discard only

  g.valid = b_upd || putb || dropb;
  if (b_upd) g.rank = PR_UPDATETERM;
  if (b_rvreq) g.rank = PR_HANDLE_RVREQ;
  if (b_rvresp) g.rank = PR_HANDLE_RVRESP;
  if (b_reject) g.rank = PR_REJECT_PULL;
  if (b_accept) g.rank = PR_ACCEPT_PULL;
  if (b_learn) g.rank = PR_LEARNOFLEADER;
  if (b_succ) g.rank = PR_HANDLE_SUCCESS_PULL;
  if (b_fail) g.rank = PR_HANDLE_FAIL_PULL;
  g.ovf = (putb && p.overflow) || (b_succ && ll >= L);

  if (WRITE) {
    if (b_upd) {
      jx_set(o + PFLD(CT), S, dst, mterm);
      jx_set(o + PFLD(ST), S, dst, RA_FOLLOWER);
      jx_set(o + PFLD(LEADER), S, dst, RA_NIL);
      if (v2) jx_set(o + PFLD(VF), S, dst, RA_NIL);
    }
    if (b_rvreq && grant) jx_set(o + vote_off, S, dst, src + 1);
    if (b_rvresp && pu_unpack(sp, khi, klo, PF_MVOTEGRANTED) > 0) {
      jx_set(o + PFLD(VG), S, dst, jx_get(s + PFLD(VG), S, dst) | (1 << src));
      if (v2) {  // votesLastEntry (PullRaftVariant2.tla:339-344)
        jx_set2(o + PFLD(VLE_HAS), S, S, dst, src, 1);
        jx_set2(o + PFLD(VLE_IDX), S, S, dst, src, mlli);
        jx_set2(o + PFLD(VLE_TERM), S, S, dst, src, mllt);
      }
    }
    if (b_accept) {
      jx_set2(o + PFLD(MI), S, S, dst, src, mlli);
      jx_set(o + PFLD(CI), S, dst, new_ci);
      // acked[v]: FALSE -> TRUE for v committed in (ci, new_ci] (PullRaft.tla:476-479)
      const int ci = jx_get(s + PFLD(CI), S, dst);
      for (int v = 0; v < V; ++v) {
        bool committed = false;
        for (int l = 0; l < L; ++l) committed |= l + 1 > ci && l + 1 <= new_ci && lv[l] == v + 1;
        if (s[PFLD(ACK) + v] == RA_ACK_FALSE && committed) o[PFLD(ACK) + v] = RA_ACK_TRUE;
      }
    }
    if (b_learn) jx_set(o + PFLD(LEADER), S, dst, src + 1);
    if (b_succ) {
      const int app_pos = ra_clamp(ll, 0, L - 1);
      jx_set(o + PFLD(CI), S, dst, pu_unpack(sp, khi, klo, PF_MCOMMITINDEX));
      jx_set2(o + PFLD(LT), S, L, dst, app_pos, pu_unpack(sp, khi, klo, PF_ETERM));
      jx_set2(o + PFLD(LV), S, L, dst, app_pos, pu_unpack(sp, khi, klo, PF_EVALUE));
      jx_set(o + PFLD(LL), S, dst, ll + 1);
    }
    // truncations keep the lanes below the new length and zero the rest:
    // HandleFailPull to mlastCommonEntry.index clamped to Len
    // (PullRaft.tla:510-520); Variant2's LearnOfLeader to the notify's
    // index where the log reaches it (PullRaftVariant2.tla:171-179,398-410)
    if (b_fail || (b_learn && v2)) {
      const int mlc_idx = pu_unpack(sp, khi, klo, PF_MLCINDEX);
      int new_ll;
      if (b_fail)
        new_ll = mlc_idx < ll ? mlc_idx : ll;
      else
        new_ll = (pu_unpack(sp, khi, klo, PF_MLCHAS) > 0 && ll >= mlc_idx) ? mlc_idx : ll;
      for (int l = 0; l < L; ++l) {
        jx_set2(o + PFLD(LT), S, L, dst, l, l < new_ll ? lt[l] : 0);
        jx_set2(o + PFLD(LV), S, L, dst, l, l < new_ll ? lv[l] : 0);
      }
      jx_set(o + PFLD(LL), S, dst, new_ll);
    }
    if (putb || dropb) o[PFLD(CNT) + m] -= 1;  // the incoming Discard
    if (putb) ra_bag_insert(o + PFLD(HI), o + PFLD(LO), o + PFLD(CNT), M, k, p);
  }
  return g;
}

// One candidate (a row of the model's candidate table) of one state; `bag`
// is a chain lane's guard scratch (2 * M ints), unused otherwise.
template <bool WRITE>
__device__ Guard pu_action(const int* sp, const int* s, int* o, const int* cd, int* bag) {
  const int p0 = cd[1], p1 = cd[2];
  switch (cd[0]) {
    case PG_RESTART: return Guard{pu_restart<WRITE>(sp, s, o, p0), cd[3], false};
    case PG_REQUEST_VOTE: return pu_request_vote<WRITE>(sp, s, o, p0, bag);
    case PG_BECOME_LEADER: return pu_become_leader<WRITE>(sp, s, o, p0, bag);
    case PG_CLIENT_REQUEST: return pu_client_request<WRITE>(sp, s, o, p0, p1);
    case PG_SEND_PULL: return pu_send_pull<WRITE>(sp, s, o, p0, p1);
    case PG_HANDLE_MESSAGE: return pu_handle_message<WRITE>(sp, s, o, p0);
  }
  return Guard{false, cd[3], false};
}

// ---- invariants (true = holds): actions_common.cuh over PullRaft's fields ----

__device__ __forceinline__ bool pu_invariant(const int* sp, const int* s, int id) {
  const InvFields f{PFLD(S),  PFLD(L),  PFLD(V),  PFLD(M),   PFLD(CT), PFLD(ST), PFLD(LT),
                    PFLD(LV), PFLD(LL), PFLD(CI), PFLD(ACK), PFLD(HI), PFLD(LO),
                    sp + PS_MSG + 3 * PF_MSOURCE, sp + PS_MSG + 3 * PF_MDEST, RA_LEADER};
  return inv_eval(f, s, id);
}

// The pull family as the kernel drivers see it: where its spec keeps the
// sizes, the guard scratch of a state (a slot of 2 * M ints for each of
// its 2 * S chain lanes, RequestVote(i) and BecomeLeader(i)), its actions
// and its predicates (the invariants: PullRaft has no liveness formula).
struct PullFamily {
  static constexpr int SPEC_LEN = PS_LEN;
  static constexpr int BAG_WORDS = 2;  // (hi, lo) keys
  static constexpr int I_S = PS_S, I_M = PS_M, I_W = PS_W, I_A = PS_A, I_K = PS_K;
  __host__ __device__ __forceinline__ static int scratch_slots(int S) { return 2 * S; }
  __device__ __forceinline__ static int scratch_slot(const int* cd) {
    if (cd[0] == PG_REQUEST_VOTE) return 2 * cd[1];
    if (cd[0] == PG_BECOME_LEADER) return 2 * cd[1] + 1;
    return -1;
  }
  template <bool WRITE>
  __device__ __forceinline__ static Guard action(const int* sp, const int* s, int* o, const int* cd, int* bag) {
    return pu_action<WRITE>(sp, s, o, cd, bag);
  }
  __device__ __forceinline__ static bool invariant(const int* sp, const int* s, int id) {
    return pu_invariant(sp, s, id);
  }
  __device__ __forceinline__ static bool predicate(const int* sp, const int* s, int id) {
    return pu_invariant(sp, s, id);
  }
};

#undef PCONST
#undef PFLD
