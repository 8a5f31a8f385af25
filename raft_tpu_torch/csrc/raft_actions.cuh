// raft_actions.cuh — the Raft action groups and invariants as device code.
//
// Replaces raft_tpu/models/raft.py:327-835 (the action kernels behind
// _expand1 :836, with ops/bag.py and ops/packing.py), the invariants of
// raft.py:894-975 plus models/base.py:143 messages_are_valid_kernel, and
// the liveness predicate ValueAllOrNothing of raft.py:925-942.
// It mirrors the port's batched plain version, raft_tpu_torch/models/
// raft.py, one (state, candidate) pair at a time, for every RaftModel
// parameter set (Raft, FlexibleRaft, RaftFsync): the layout, message
// packing and flags come from the model's int32 spec vector
// (RaftModel.kernel_spec), so one build serves all three.
//
// Every action group is one function templated on WRITE. With WRITE false
// it computes only (valid, rank, ovf) and never touches a successor lane:
// the counterpart of the reference's jaxpr dead-code elimination
// (raft_tpu/models/base.py:347-356). With WRITE true it also writes the
// successor row `o`, which the caller has filled with a copy of the state
// `s`, so an action writes only the lanes it changes. Reads always come
// from `s`. A guard of RequestVote replays its S - 1 puts on a private
// copy of the bag's keys: the caller hands it `bag`, 2 * M ints of scratch
// (sized from the model, so the message slots have no fixed cap).
//
// The one-hot helpers, message keys, the bag and the invariants it shares
// with the other families are in actions_common.cuh; RaftFamily, at the
// end, is what the kernel drivers (expand_driver.cuh, fold_driver.cuh,
// predicates_driver.cuh) instantiate for raft_expand.cu, raft_fold.cu and
// raft_predicates.cu.
//
// Bit-identity rules the code keeps (each is a property of the plain
// version):
//   - a one-hot read of an out-of-range index gives 0 and a one-hot write
//     to one writes nothing (models/base.py onehot_row/onehot_set); indices
//     are never clamped unless the plain version clamps them;
//   - a message key is the SUM of (value << shift) over its fields, with
//     no mask (ops/packing.py), so a too-wide value bleeds into the next
//     field; keys built from a binding index are int64 in the plain version
//     and compare as such, keys of HandleMessage are int32 (wrapping);
//   - bag_put (ops/bag.py): lexicographic signed (hi, lo) order, `existed`
//     and `overflow` from the bag before the insert, a shift-insert that
//     drops the last slot, and an increment of every equal slot otherwise.
#pragma once

#include "actions_common.cuh"

enum { RA_RVREQ = 1, RA_RVRESP = 2, RA_AEREQ = 3, RA_AERESP = 4 };

// The spec vector (models/raft.py SPEC_SCALARS, then MSG_FIELDS x 3).
enum {
  SP_S, SP_V, SP_L, SP_M, SP_W, SP_A, SP_K,
  SP_CT, SP_ST, SP_VF, SP_VG, SP_LT, SP_LV, SP_LL, SP_CI, SP_FS, SP_NI, SP_MI,
  SP_PR, SP_HI, SP_LO, SP_CNT, SP_ACK, SP_ECTR, SP_RCTR,
  SP_HAS_FSYNC, SP_FS_BEFORE_AE, SP_FS_QUORUM, SP_FS_REPLY, SP_STRICT,
  SP_TRUNC_TERM, SP_HAS_PENDING, SP_EQ, SP_RQ, SP_MAX_ELECTIONS, SP_MAX_RESTARTS,
  SP_MSG
};
enum {
  MF_MTYPE, MF_MTERM, MF_MSOURCE, MF_MDEST, MF_MLASTLOGTERM, MF_MLASTLOGINDEX,
  MF_MVOTEGRANTED, MF_MPREVLOGINDEX, MF_MPREVLOGTERM, MF_NENTRIES, MF_ETERM,
  MF_EVALUE, MF_MCOMMITINDEX, MF_MSUCCESS, MF_MMATCHINDEX, MF_N
};
#define SP_LEN (SP_MSG + 3 * MF_N)

// Action groups (models/raft.py GROUP_IDS); a candidate row of the model's
// candidate table is (group, p0, p1, rank).
enum {
  G_RESTART, G_TIMEOUT, G_REQUEST_VOTE_PAIR, G_REQUEST_VOTE, G_BECOME_LEADER,
  G_CLIENT_REQUEST, G_ADVANCE_COMMIT, G_APPEND_ENTRIES, G_ADVANCE_FSYNC,
  G_HANDLE_MESSAGE
};

// ---- message words ----

__device__ __forceinline__ int ra_unpack(const int* sp, int hi, int lo, int f) {
  return ra_unpack_q(sp + SP_MSG + 3 * f, hi, lo);
}

__device__ __forceinline__ void ra_pack(const int* sp, Key& k, int f, long long v) {
  ra_pack_q(sp + SP_MSG + 3 * f, k, v);
}

// ---- state helpers ----

#define FLD(o) (sp[SP_##o])

// LastTerm(log[i]) — Raft.tla:126
__device__ __forceinline__ int ra_last_term(const int* sp, const int* s, int i) {
  const int S = FLD(S), L = FLD(L);
  const int ll = ra_at(s + FLD(LL), S, i);
  return ll > 0 ? ra_at2(s + FLD(LT), S, L, i, ll - 1 < 0 ? 0 : ll - 1) : 0;
}

// ---- action groups ----

// Restart(i) — Raft.tla:226-235 (RaftFsync.tla:203-218 truncates to fsyncIndex)
template <bool WRITE>
__device__ bool ra_restart(const int* sp, const int* s, int* o, int i) {
  const bool valid = s[FLD(RCTR)] < FLD(MAX_RESTARTS);
  if (WRITE) {
    const int S = FLD(S), L = FLD(L);
    ra_set(o + FLD(ST), S, i, RA_FOLLOWER);
    ra_set(o + FLD(VG), S, i, 0);
    for (int k = 0; k < S; ++k) {
      ra_set2(o + FLD(NI), S, S, i, k, 1);
      ra_set2(o + FLD(MI), S, S, i, k, 0);
    }
    ra_set(o + FLD(CI), S, i, 0);
    o[FLD(RCTR)] = s[FLD(RCTR)] + 1;
    if (FLD(HAS_PENDING)) ra_set(o + FLD(PR), S, i, 0);
    if (FLD(HAS_FSYNC)) {
      const int ll = ra_at(s + FLD(LL), S, i), fs = ra_at(s + FLD(FS), S, i);
      const int new_ll = ll < fs ? ll : fs;
      for (int l = 0; l < L; ++l) {
        const bool keep = l < new_ll;
        ra_set2(o + FLD(LT), S, L, i, l, keep ? ra_at2(s + FLD(LT), S, L, i, l) : 0);
        ra_set2(o + FLD(LV), S, L, i, l, keep ? ra_at2(s + FLD(LV), S, L, i, l) : 0);
      }
      ra_set(o + FLD(LL), S, i, new_ll);
    }
  }
  return valid;
}

// Timeout(i) — RaftFsync.tla:222-230
template <bool WRITE>
__device__ bool ra_timeout(const int* sp, const int* s, int* o, int i) {
  const int S = FLD(S);
  const int st = ra_at(s + FLD(ST), S, i);
  const bool valid = s[FLD(ECTR)] < FLD(MAX_ELECTIONS) && (st == RA_FOLLOWER || st == RA_CANDIDATE);
  if (WRITE) {
    ra_set(o + FLD(ST), S, i, RA_CANDIDATE);
    ra_set(o + FLD(CT), S, i, ra_at(s + FLD(CT), S, i) + 1);
    ra_set(o + FLD(VF), S, i, i + 1);
    ra_set(o + FLD(VG), S, i, 1 << i);
    o[FLD(ECTR)] = s[FLD(ECTR)] + 1;
  }
  return valid;
}

// the RequestVoteRequest key of RequestVote(i[, j]) (Raft.tla:250-256)
__device__ __forceinline__ Key ra_rv_key(const int* sp, int term, int last_t, int ll, int i, int j) {
  Key k{{0, 0}};
  ra_pack(sp, k, MF_MTYPE, RA_RVREQ);
  ra_pack(sp, k, MF_MTERM, term);
  ra_pack(sp, k, MF_MLASTLOGTERM, last_t);
  ra_pack(sp, k, MF_MLASTLOGINDEX, ll);
  ra_pack(sp, k, MF_MSOURCE, i);
  ra_pack(sp, k, MF_MDEST, j);
  return k;
}

// RequestVote(i, j) — RaftFsync.tla:234-243 (send-once)
template <bool WRITE>
__device__ Guard ra_request_vote_pair(const int* sp, const int* s, int* o, int i, int j) {
  const int S = FLD(S), M = FLD(M);
  Guard g{ra_at(s + FLD(ST), S, i) == RA_CANDIDATE, 0, false};
  const Key k = ra_rv_key(sp, ra_at(s + FLD(CT), S, i), ra_last_term(sp, s, i),
                          ra_at(s + FLD(LL), S, i), i, j);
  if (g.valid || WRITE) {
    const Put p = ra_bag_probe(s + FLD(HI), s + FLD(LO), M, k);
    g.valid = g.valid && !p.existed;
    g.ovf = p.overflow && g.valid;
    if (WRITE) ra_bag_insert(o + FLD(HI), o + FLD(LO), o + FLD(CNT), M, k, p);
  }
  return g;
}

// AdvanceFsyncIndex(i) — RaftFsync.tla:339-343
template <bool WRITE>
__device__ bool ra_advance_fsync(const int* sp, const int* s, int* o, int i) {
  const int S = FLD(S);
  const int fs = ra_at(s + FLD(FS), S, i);
  if (WRITE) ra_set(o + FLD(FS), S, i, fs + 1);
  return fs < ra_at(s + FLD(LL), S, i);
}

// RequestVote(i) — Raft.tla:242-257 (Timeout fused with sends to every peer).
// The puts act one after another on the bag the previous put left, so a
// guard lane replays them on a private copy of the keys in `bag` (2 * M
// ints: hi, then lo).
template <bool WRITE>
__device__ Guard ra_request_vote(const int* sp, const int* s, int* o, int i, int* bag) {
  const int S = FLD(S), M = FLD(M);
  const int st = ra_at(s + FLD(ST), S, i);
  Guard g{s[FLD(ECTR)] < FLD(MAX_ELECTIONS) && (st == RA_FOLLOWER || st == RA_CANDIDATE), 0, false};
  const int new_term = ra_at(s + FLD(CT), S, i) + 1;
  const int last_t = ra_last_term(sp, s, i), ll = ra_at(s + FLD(LL), S, i);
  int* bh;
  int* bl;
  int* bc;
  if (WRITE) {
    bh = o + FLD(HI);
    bl = o + FLD(LO);
    bc = o + FLD(CNT);
  } else {
    if (!g.valid) return g;  // ovf is masked by valid: nothing else to learn
    bh = bag;
    bl = bag + M;
    bc = nullptr;
    for (int m = 0; m < M; ++m) {
      bh[m] = s[FLD(HI) + m];
      bl[m] = s[FLD(LO) + m];
    }
  }
  bool ovf = false;
  for (int d = 1; d < S; ++d) {
    const int j = (i + d) % S;
    const Key k = ra_rv_key(sp, new_term, last_t, ll, i, j);
    const Put p = ra_bag_probe(bh, bl, M, k);
    g.valid = g.valid && !p.existed;
    ovf = ovf || p.overflow;
    ra_bag_insert(bh, bl, bc, M, k, p);
  }
  g.ovf = ovf && g.valid;
  if (WRITE) {
    ra_set(o + FLD(ST), S, i, RA_CANDIDATE);
    ra_set(o + FLD(CT), S, i, new_term);
    ra_set(o + FLD(VF), S, i, i + 1);
    ra_set(o + FLD(VG), S, i, 1 << i);
    o[FLD(ECTR)] = s[FLD(ECTR)] + 1;
  }
  return g;
}

// BecomeLeader(i) — Raft.tla:289-300 (FlexibleRaft.tla:260-269)
template <bool WRITE>
__device__ bool ra_become_leader(const int* sp, const int* s, int* o, int i) {
  const int S = FLD(S);
  const int vg = ra_at(s + FLD(VG), S, i);
  int votes = 0;
  for (int k = 0; k < S; ++k) votes += (vg >> k) & 1;
  const bool quorum = FLD(EQ) >= 0 ? votes >= FLD(EQ) : 2 * votes > S;
  if (WRITE) {
    const int nrow = ra_at(s + FLD(LL), S, i) + 1;
    ra_set(o + FLD(ST), S, i, RA_LEADER);
    for (int k = 0; k < S; ++k) {
      ra_set2(o + FLD(NI), S, S, i, k, nrow);
      ra_set2(o + FLD(MI), S, S, i, k, 0);
    }
    if (FLD(HAS_PENDING)) ra_set(o + FLD(PR), S, i, 0);
  }
  return ra_at(s + FLD(ST), S, i) == RA_CANDIDATE && quorum;
}

// ClientRequest(i, v) — Raft.tla:304-313
template <bool WRITE>
__device__ Guard ra_client_request(const int* sp, const int* s, int* o, int i, int v) {
  const int S = FLD(S), L = FLD(L), V = FLD(V);
  Guard g{ra_at(s + FLD(ST), S, i) == RA_LEADER && ra_at(s + FLD(ACK), V, v) == RA_ACK_NIL, 0,
          false};
  const int pos = ra_at(s + FLD(LL), S, i);
  g.ovf = g.valid && pos >= L;
  if (WRITE) {
    const int posc = ra_clamp(pos, 0, L - 1);
    ra_set2(o + FLD(LT), S, L, i, posc, ra_at(s + FLD(CT), S, i));
    ra_set2(o + FLD(LV), S, L, i, posc, v + 1);
    ra_set(o + FLD(LL), S, i, pos + 1);
    ra_set(o + FLD(ACK), V, v, RA_ACK_FALSE);
  }
  return g;
}

// AdvanceCommitIndex(i) — Raft.tla:320-344 (RaftFsync.tla:313-315 drops the
// leader from Agree above its fsyncIndex under LeaderFsyncBeforeIncludeInQuorum)
template <bool WRITE>
__device__ bool ra_advance_commit(const int* sp, const int* s, int* o, int i) {
  const int S = FLD(S), L = FLD(L), V = FLD(V);
  const int ll = ra_at(s + FLD(LL), S, i), ci = ra_at(s + FLD(CI), S, i);
  const int ct = ra_at(s + FLD(CT), S, i);
  const bool fsq = FLD(HAS_FSYNC) && FLD(FS_QUORUM);
  const int fs = fsq ? ra_at(s + FLD(FS), S, i) : 0;
  int max_agree = 0;
  for (int idx = 1; idx <= L; ++idx) {
    int cnt = 0;
    for (int k = 0; k < S; ++k) {
      const bool self_in = k == i && (!fsq || idx <= fs);
      cnt += self_in || ra_at2(s + FLD(MI), S, S, i, k) >= idx;
    }
    const bool quorum_ok = FLD(RQ) >= 0 ? cnt >= FLD(RQ) : 2 * cnt > S;
    if (quorum_ok && idx <= ll) max_agree = idx;
  }
  const int term_at = ra_at2(s + FLD(LT), S, L, i, ra_clamp(max_agree - 1, 0, L - 1));
  const int new_ci = (max_agree > 0 && term_at == ct) ? max_agree : ci;
  if (WRITE) {
    ra_set(o + FLD(CI), S, i, new_ci);
    for (int v = 0; v < V; ++v) {
      bool committed = false;
      for (int l = 0; l < L; ++l)
        committed |= l + 1 > ci && l + 1 <= new_ci && ra_at2(s + FLD(LV), S, L, i, l) == v + 1;
      if (s[FLD(ACK) + v] == RA_ACK_FALSE && committed) o[FLD(ACK) + v] = RA_ACK_TRUE;
    }
  }
  return ra_at(s + FLD(ST), S, i) == RA_LEADER && ci < new_ci;
}

// AppendEntries(i, j) — Raft.tla:263-285 (FlexibleRaft.tla:236-256 has no
// pendingResponse gate; RaftFsync.tla:261-263 the fsync-before-send gate)
template <bool WRITE>
__device__ Guard ra_append_entries(const int* sp, const int* s, int* o, int i, int j) {
  const int S = FLD(S), L = FLD(L), M = FLD(M);
  Guard g{ra_at(s + FLD(ST), S, i) == RA_LEADER, 0, false};
  const int pr = FLD(HAS_PENDING) ? ra_at(s + FLD(PR), S, i) : 0;
  if (FLD(HAS_PENDING)) g.valid = g.valid && ((pr >> j) & 1) == 0;
  const int ni = ra_at2(s + FLD(NI), S, S, i, j);
  const int prev_idx = ni - 1;
  const int prev_term =
      prev_idx > 0 ? ra_at2(s + FLD(LT), S, L, i, ra_clamp(prev_idx - 1, 0, L - 1)) : 0;
  const int ll = ra_at(s + FLD(LL), S, i);
  const int last_entry = ll < ni ? ll : ni;
  if (FLD(HAS_FSYNC) && FLD(FS_BEFORE_AE))
    g.valid = g.valid && ra_at(s + FLD(FS), S, i) >= last_entry;
  const int nent = last_entry >= ni;
  const int epos = ra_clamp(ni - 1, 0, L - 1);
  const int eterm = nent ? ra_at2(s + FLD(LT), S, L, i, epos) : 0;
  const int evalue = nent ? ra_at2(s + FLD(LV), S, L, i, epos) : 0;
  const int ci = ra_at(s + FLD(CI), S, i);
  if (!g.valid && !WRITE) return g;
  Key k{{0, 0}};
  ra_pack(sp, k, MF_MTYPE, RA_AEREQ);
  ra_pack(sp, k, MF_MTERM, ra_at(s + FLD(CT), S, i));
  ra_pack(sp, k, MF_MPREVLOGINDEX, prev_idx);
  ra_pack(sp, k, MF_MPREVLOGTERM, prev_term);
  ra_pack(sp, k, MF_NENTRIES, nent);
  ra_pack(sp, k, MF_ETERM, eterm);
  ra_pack(sp, k, MF_EVALUE, evalue);
  ra_pack(sp, k, MF_MCOMMITINDEX, ci < last_entry ? ci : last_entry);
  ra_pack(sp, k, MF_MSOURCE, i);
  ra_pack(sp, k, MF_MDEST, j);
  const Put p = ra_bag_probe(s + FLD(HI), s + FLD(LO), M, k);
  if (FLD(STRICT))
    g.valid = g.valid && !p.existed;  // FlexibleRaft.tla:127-129
  else
    g.valid = g.valid && (nent > 0 || !p.existed);  // Raft.tla:145-149
  g.ovf = p.overflow && g.valid;
  if (WRITE) {
    ra_bag_insert(o + FLD(HI), o + FLD(LO), o + FLD(CNT), M, k, p);
    if (FLD(HAS_PENDING)) ra_set(o + FLD(PR), S, i, pr | (1 << j));
  }
  return g;
}

// HandleMessage(slot m): the six receipt disjuncts of Next (Raft.tla:534-539),
// mutually exclusive for a fixed record; rank says which one fired
// (rank base + 0..5 in Next order), -1 when none did.
template <bool WRITE>
__device__ Guard ra_handle_message(const int* sp, const int* s, int* o, int m, int rank0) {
  const int S = FLD(S), L = FLD(L), M = FLD(M);
  Guard g{false, -1, false};
  const int khi = ra_at(s + FLD(HI), M, m), klo = ra_at(s + FLD(LO), M, m);
  const int kcnt = ra_at(s + FLD(CNT), M, m);
  const bool occupied = khi != RA_EMPTY;
  if (!occupied) return g;  // every branch needs a record in the domain
  const int mtype = ra_unpack(sp, khi, klo, MF_MTYPE);
  const int mterm = ra_unpack(sp, khi, klo, MF_MTERM);
  const int src = ra_unpack(sp, khi, klo, MF_MSOURCE);
  const int dst = ra_unpack(sp, khi, klo, MF_MDEST);
  const int ct = ra_at(s + FLD(CT), S, dst), st = ra_at(s + FLD(ST), S, dst);
  const bool recv = kcnt > 0;  // ReceivableMessage (Raft.tla:181-187)

  // UpdateTerm (Raft.tla:348-355): any DOMAIN record
  const bool b_upd = mterm > ct;

  // HandleRequestVoteRequest (Raft.tla:360-381)
  const int last_t = ra_last_term(sp, s, dst);
  const int ll = ra_at(s + FLD(LL), S, dst), vf = ra_at(s + FLD(VF), S, dst);
  const int mllt = ra_unpack(sp, khi, klo, MF_MLASTLOGTERM);
  const bool rv_logok =
      mllt > last_t || (mllt == last_t && ra_unpack(sp, khi, klo, MF_MLASTLOGINDEX) >= ll);
  const bool grant = mterm == ct && rv_logok && (vf == RA_NIL || vf == src + 1);
  bool b_rvreq = recv && mtype == RA_RVREQ && mterm <= ct;

  // HandleRequestVoteResponse (Raft.tla:386-401)
  const bool b_rvresp = recv && mtype == RA_RVRESP && mterm == ct;

  // AppendEntries request handling: LogOk (Raft.tla:406-410)
  const int prev_idx = ra_unpack(sp, khi, klo, MF_MPREVLOGINDEX);
  const int prev_term = ra_unpack(sp, khi, klo, MF_MPREVLOGTERM);
  const int nent = ra_unpack(sp, khi, klo, MF_NENTRIES);
  const int eterm = ra_unpack(sp, khi, klo, MF_ETERM);
  const bool ae_logok =
      prev_idx == 0 ||
      (prev_idx > 0 && prev_idx <= ll &&
       prev_term == ra_at2(s + FLD(LT), S, L, dst, ra_clamp(prev_idx - 1, 0, L - 1)));

  // RejectAppendEntriesRequest (Raft.tla:412-430)
  bool b_reject = recv && mtype == RA_AEREQ && mterm <= ct &&
                  (mterm < ct || (mterm == ct && st == RA_FOLLOWER && !ae_logok));
  // AcceptAppendEntriesRequest (Raft.tla:454-485)
  bool b_accept = recv && mtype == RA_AEREQ && mterm == ct &&
                  (st == RA_FOLLOWER || st == RA_CANDIDATE) && ae_logok;
  const bool can_append = nent != 0 && ll == prev_idx;  // Raft.tla:438-440
  bool needs_trunc;
  if (FLD(TRUNC_TERM)) {  // FlexibleRaft.tla:413-416
    const int at_idx = ra_at2(s + FLD(LT), S, L, dst, ra_clamp(prev_idx, 0, L - 1));
    needs_trunc = nent != 0 && ll >= prev_idx + 1 && at_idx != eterm;
  } else {  // NeedsTruncation (Raft.tla:445-449)
    needs_trunc = (nent != 0 && ll >= prev_idx + 1) || (nent == 0 && ll > prev_idx);
  }
  const bool appending = can_append || (needs_trunc && nent != 0);
  const int new_ll = appending ? prev_idx + 1 : (needs_trunc ? prev_idx : ll);
  const bool ac_ovf = appending && prev_idx >= L;

  // HandleAppendEntriesResponse (Raft.tla:490-505)
  const bool b_aeresp = recv && mtype == RA_AERESP && mterm == ct;

  // the shared Reply: the branch-selected response, put once into the bag
  // whose slot m was already discarded (counts do not change existed/ovf)
  const bool wants_put = b_rvreq || b_reject || b_accept;
  Put p{false, false, 0};
  Key k{{0, 0}};
  if (wants_put) {
    ra_pack(sp, k, MF_MTYPE, b_rvreq ? RA_RVRESP : RA_AERESP);
    ra_pack(sp, k, MF_MTERM, ct);
    if (b_rvreq) {
      ra_pack(sp, k, MF_MVOTEGRANTED, grant);
    } else if (!b_reject) {
      ra_pack(sp, k, MF_MSUCCESS, 1);
      ra_pack(sp, k, MF_MMATCHINDEX, prev_idx + nent);
    }
    ra_pack(sp, k, MF_MSOURCE, dst);
    ra_pack(sp, k, MF_MDEST, src);
    k = ra_wrap32(k);
    p = ra_bag_probe(s + FLD(HI), s + FLD(LO), M, k);
    if (FLD(STRICT)) {  // FlexibleRaft Reply (FlexibleRaft.tla:148-151)
      b_rvreq = b_rvreq && !p.existed;
      b_reject = b_reject && !p.existed;
      b_accept = b_accept && !p.existed;
    }
  }
  const bool putb = b_rvreq || b_reject || b_accept;
  const bool dropb = b_rvresp || b_aeresp;  // Discard only, no response

  g.valid = b_upd || b_rvreq || b_rvresp || b_reject || b_accept || b_aeresp;
  if (b_upd) g.rank = rank0 + 0;
  if (b_rvreq) g.rank = rank0 + 1;
  if (b_rvresp) g.rank = rank0 + 2;
  if (b_reject) g.rank = rank0 + 3;
  if (b_accept) g.rank = rank0 + 4;
  if (b_aeresp) g.rank = rank0 + 5;
  g.ovf = (b_rvreq && p.overflow) || (b_reject && p.overflow) ||
          (b_accept && (p.overflow || ac_ovf));

  if (WRITE) {
    if (b_upd) {
      ra_set(o + FLD(CT), S, dst, mterm);
      ra_set(o + FLD(VF), S, dst, RA_NIL);
    } else if (b_rvreq && grant) {
      ra_set(o + FLD(VF), S, dst, src + 1);
    }
    if (b_upd || b_accept) ra_set(o + FLD(ST), S, dst, RA_FOLLOWER);
    if (b_rvresp && ra_unpack(sp, khi, klo, MF_MVOTEGRANTED) > 0)
      ra_set(o + FLD(VG), S, dst, ra_at(s + FLD(VG), S, dst) | (1 << src));
    if (b_accept) {
      const int evalue = ra_unpack(sp, khi, klo, MF_EVALUE);
      ra_set(o + FLD(CI), S, dst, ra_unpack(sp, khi, klo, MF_MCOMMITINDEX));
      if (appending || needs_trunc) {
        const int app_pos = ra_clamp(prev_idx, 0, L - 1);
        for (int l = 0; l < L; ++l) {
          const bool keep = l < prev_idx;
          int t = keep ? ra_at2(s + FLD(LT), S, L, dst, l) : 0;
          int v = keep ? ra_at2(s + FLD(LV), S, L, dst, l) : 0;
          if (l == app_pos) {
            t = appending ? eterm : 0;
            v = appending ? evalue : 0;
          }
          ra_set2(o + FLD(LT), S, L, dst, l, t);
          ra_set2(o + FLD(LV), S, L, dst, l, v);
        }
      }
      ra_set(o + FLD(LL), S, dst, new_ll);
      if (FLD(HAS_FSYNC) && FLD(FS_REPLY))  // FollowerFsyncBeforeReply (RaftFsync.tla:468-470)
        ra_set(o + FLD(FS), S, dst, new_ll);
    }
    if (b_aeresp) {
      const int mmatch = ra_unpack(sp, khi, klo, MF_MMATCHINDEX);
      const bool succ = ra_unpack(sp, khi, klo, MF_MSUCCESS) > 0;
      const int ni = ra_at2(s + FLD(NI), S, S, dst, src);
      ra_set2(o + FLD(NI), S, S, dst, src, succ ? mmatch + 1 : (ni - 1 < 1 ? 1 : ni - 1));
      if (succ) ra_set2(o + FLD(MI), S, S, dst, src, mmatch);
      if (FLD(HAS_PENDING))
        ra_set(o + FLD(PR), S, dst, ra_at(s + FLD(PR), S, dst) & ~(1 << src));
    }
    if (putb || dropb) o[FLD(CNT) + m] -= 1;  // the incoming Discard (Raft.tla:170-176)
    if (putb) ra_bag_insert(o + FLD(HI), o + FLD(LO), o + FLD(CNT), M, k, p);
  }
  return g;
}

// One candidate (a row of the model's candidate table) of one state; `bag`
// is the scratch of a RequestVote guard (2 * M ints), unused otherwise.
template <bool WRITE>
__device__ Guard ra_action(const int* sp, const int* s, int* o, const int* cd, int* bag) {
  const int p0 = cd[1], p1 = cd[2];
  Guard g{false, cd[3], false};
  switch (cd[0]) {
    case G_RESTART: g.valid = ra_restart<WRITE>(sp, s, o, p0); break;
    case G_TIMEOUT: g.valid = ra_timeout<WRITE>(sp, s, o, p0); break;
    case G_REQUEST_VOTE_PAIR: g = ra_request_vote_pair<WRITE>(sp, s, o, p0, p1); break;
    case G_REQUEST_VOTE: g = ra_request_vote<WRITE>(sp, s, o, p0, bag); break;
    case G_BECOME_LEADER: g.valid = ra_become_leader<WRITE>(sp, s, o, p0); break;
    case G_CLIENT_REQUEST: g = ra_client_request<WRITE>(sp, s, o, p0, p1); break;
    case G_ADVANCE_COMMIT: g.valid = ra_advance_commit<WRITE>(sp, s, o, p0); break;
    case G_APPEND_ENTRIES: g = ra_append_entries<WRITE>(sp, s, o, p0, p1); break;
    case G_ADVANCE_FSYNC: g.valid = ra_advance_fsync<WRITE>(sp, s, o, p0); break;
    case G_HANDLE_MESSAGE: return ra_handle_message<WRITE>(sp, s, o, p0, cd[3]);
  }
  if (cd[0] != G_HANDLE_MESSAGE) g.rank = cd[3];
  return g;
}

// ---- invariants (true = holds): actions_common.cuh over Raft's fields ----

__device__ __forceinline__ InvFields ra_inv_fields(const int* sp) {
  return InvFields{FLD(S),  FLD(L),  FLD(V),  FLD(M),  FLD(CT),  FLD(ST),  FLD(LT),
                   FLD(LV), FLD(LL), FLD(CI), FLD(ACK), FLD(HI), FLD(LO),
                   sp + SP_MSG + 3 * MF_MSOURCE, sp + SP_MSG + 3 * MF_MDEST, RA_LEADER};
}

__device__ __forceinline__ bool ra_invariant(const int* sp, const int* s, int id) {
  return inv_eval(ra_inv_fields(sp), s, id);
}

// An invariant id (INV_*) or a liveness predicate id (PRED_VALUE_AON + v).
__device__ __forceinline__ bool ra_predicate(const int* sp, const int* s, int id) {
  if (id >= PRED_VALUE_AON)
    return inv_value_all_or_nothing(ra_inv_fields(sp), s, s[FLD(ECTR)], FLD(MAX_ELECTIONS),
                                    id - PRED_VALUE_AON);
  return ra_invariant(sp, s, id);
}

// The Raft family as the kernel drivers see it: where its spec keeps the
// sizes, the guard scratch of a state (a slot of 2 * M ints for each
// RequestVote(i) lane's replay of its S - 1 puts), its actions and its
// predicates.
struct RaftFamily {
  static constexpr int SPEC_LEN = SP_LEN;
  static constexpr int I_S = SP_S, I_M = SP_M, I_W = SP_W, I_A = SP_A, I_K = SP_K;
  __host__ __device__ __forceinline__ static int scratch_slots(int S) { return S; }
  __device__ __forceinline__ static int scratch_slot(const int* cd) {
    return cd[0] == G_REQUEST_VOTE ? cd[1] : -1;
  }
  template <bool WRITE>
  __device__ __forceinline__ static Guard action(const int* sp, const int* s, int* o, const int* cd, int* bag) {
    return ra_action<WRITE>(sp, s, o, cd, bag);
  }
  __device__ __forceinline__ static bool invariant(const int* sp, const int* s, int id) {
    return ra_invariant(sp, s, id);
  }
  __device__ __forceinline__ static bool predicate(const int* sp, const int* s, int id) {
    return ra_predicate(sp, s, id);
  }
};

#undef FLD
