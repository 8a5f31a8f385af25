// actions_common.cuh — device code every spec family's actions share.
//
// One (state, candidate) pair at a time, over a packed int32 state row:
// one-hot reads and writes of fields, message keys (ops/packing.py: a key
// is the SUM of (value << shift) over its fields, with no mask), the
// message bag (ops/bag.py bag_put: lexicographic signed (hi, lo) order,
// `existed` and `overflow` from the bag before the insert, a shift-insert
// that drops the last slot, and an increment of every equal slot
// otherwise), and the safety invariants that the Raft and PullRaft
// families define with the same formulas (raft_tpu/models/raft.py:894-975
// and pull_raft.py:703-760, with models/base.py:143
// messages_are_valid_kernel), with the Leader code as a parameter (KRaft,
// raft_tpu/models/kraft.py:894-957, repeats them over its own fields), and
// the liveness predicate ValueAllOrNothing. Each family's *_actions.cuh holds its spec
// vector, its actions and a Family type for the drivers of
// expand_driver.cuh, fold_driver.cuh and predicates_driver.cuh.
#pragma once

#include "common.cuh"

#define RA_EMPTY (1 << 30)
#define RA_MAX_K 32  // action ranks (one bit each in the enabled mask)

enum { RA_FOLLOWER = 0, RA_CANDIDATE = 1, RA_LEADER = 2 };
enum { RA_NIL = 0 };
enum { RA_ACK_NIL = 0, RA_ACK_FALSE = 1, RA_ACK_TRUE = 2 };

// Invariants (models/base.py INVARIANT_IDS, shared by the families).
enum {
  INV_MESSAGES_ARE_VALID, INV_NO_LOG_DIVERGENCE, INV_LEADER_HAS_ALL_ACKED,
  INV_COMMITTED_REACH_MAJORITY, INV_TEST
};
// Liveness predicates: ValueAllOrNothing(v) is PRED_VALUE_AON + v
// (models/base.py PRED_VALUE_AON).
#define PRED_VALUE_AON 16

struct Guard {
  bool valid;
  int rank;
  bool ovf;
};

// ---- one-hot reads and writes (0 / no write out of range) ----

__device__ __forceinline__ int ra_at(const int* a, int n, int i) {
  return (i >= 0 && i < n) ? a[i] : 0;
}
__device__ __forceinline__ int ra_at2(const int* a, int n0, int n1, int i, int j) {
  return (i >= 0 && i < n0 && j >= 0 && j < n1) ? a[i * n1 + j] : 0;
}
__device__ __forceinline__ void ra_set(int* a, int n, int i, int v) {
  if (i >= 0 && i < n) a[i] = v;
}
__device__ __forceinline__ void ra_set2(int* a, int n0, int n1, int i, int j, int v) {
  if (i >= 0 && i < n0 && j >= 0 && j < n1) a[i * n1 + j] = v;
}
__device__ __forceinline__ int ra_clamp(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---- JAX-indexed reads and writes (a traced index: a read clamps, a
// write out of range is dropped, a negative index first counts from the
// end; the pull and KRaft families read message fields this way) ----

__device__ __forceinline__ int jx_index(int i, int n) {  // clamped, from the end if negative
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}
__device__ __forceinline__ bool jx_in(int& i, int n) {  // the write index, or no write
  if (i < 0) i += n;
  return i >= 0 && i < n;
}
__device__ __forceinline__ int jx_get(const int* a, int n, int i) { return a[jx_index(i, n)]; }
__device__ __forceinline__ int jx_get2(const int* a, int n0, int n1, int i, int j) {
  return a[jx_index(i, n0) * n1 + jx_index(j, n1)];
}
__device__ __forceinline__ void jx_set(int* a, int n, int i, int v) {
  if (jx_in(i, n)) a[i] = v;
}
__device__ __forceinline__ void jx_set2(int* a, int n0, int n1, int i, int j, int v) {
  if (jx_in(i, n0) && jx_in(j, n1)) a[i * n1 + j] = v;
}

// ---- message words ----

// a field of a key, at its (word, shift, mask) triple q of a spec vector
__device__ __forceinline__ int ra_unpack_q(const int* q, int hi, int lo) {
  return ((q[0] ? hi : lo) >> q[1]) & q[2];
}

struct Key {
  long long w[2];  // w[0] = lo, w[1] = hi
};

__device__ __forceinline__ void ra_pack_q(const int* q, Key& k, long long v) {
  k.w[q[0]] += (long long)((unsigned long long)v << q[1]);
}

// int32 wraparound of a key (a key computed in int32 by the plain version)
__device__ __forceinline__ Key ra_wrap32(Key k) {
  k.w[0] = (int)k.w[0];
  k.w[1] = (int)k.w[1];
  return k;
}

// ---- the message bag (ops/bag.py) ----

struct Put {
  bool existed, overflow;
  int pos;  // lexicographic rank of the key among the slots
};

__device__ __forceinline__ Put ra_bag_probe(const int* hi, const int* lo, int M, const Key& k) {
  Put r{false, false, 0};
  bool have_empty = false;
  const long long khi = k.w[1], klo = k.w[0];
  for (int m = 0; m < M; ++m) {
    const long long h = hi[m], l = lo[m];
    r.existed |= (h == khi) && (l == klo);
    have_empty |= h == RA_EMPTY;
    r.pos += (h < khi) || (h == khi && l < klo);
  }
  r.overflow = !r.existed && !have_empty;
  return r;
}

// the insert half of bag_put, in place; cnt may be null (a guard's copy)
__device__ __forceinline__ void ra_bag_insert(int* hi, int* lo, int* cnt, int M, const Key& k,
                                              const Put& p) {
  const long long khi = k.w[1], klo = k.w[0];
  if (p.existed) {
    if (cnt)
      for (int m = 0; m < M; ++m) cnt[m] += ((long long)hi[m] == khi && (long long)lo[m] == klo);
    return;
  }
  for (int x = M - 1; x > p.pos; --x) {
    hi[x] = hi[x - 1];
    lo[x] = lo[x - 1];
    if (cnt) cnt[x] = cnt[x - 1];
  }
  if (p.pos < M) {
    hi[p.pos] = (int)khi;
    lo[p.pos] = (int)klo;
    if (cnt) cnt[p.pos] = 1;
  }
}

// Copy the state's bag keys (hi, then lo) into a guard's scratch `bag`
// (2 * M ints), where a chain of puts replays without a successor row.
__device__ __forceinline__ void ra_bag_stage(int* bag, const int* hi, const int* lo, int M) {
  for (int m = 0; m < M; ++m) {
    bag[m] = hi[m];
    bag[M + m] = lo[m];
  }
}

// A bag a chain of puts acts on: the successor's (write) or a guard lane's
// scratch copy of the state's keys, with no counts (hi, lo, cnt: the
// bag's field offsets in a row).
struct ChainBag {
  int *hi, *lo, *cnt;
};

__device__ __forceinline__ ChainBag ra_chain_bag(const int* s, int* o, int* bag, int hi, int lo,
                                                 int cnt, int M, bool write) {
  if (write) return ChainBag{o + hi, o + lo, o + cnt};
  ra_bag_stage(bag, s + hi, s + lo, M);
  return ChainBag{bag, bag + M, nullptr};
}

// ---- invariants (true = holds) over a family's fields ----

// Where the invariants' fields sit in a row: the sizes, the offsets and
// the (word, shift, mask) triples of msource and mdest, and the family's
// Leader state code (RA_LEADER for Raft and PullRaft, KRaft's own). The
// term, commit-index and log-term offsets are the family's fields of that
// role (KRaft: currentEpoch, highWatermark, log_epoch).
struct InvFields {
  int S, L, V, M;
  int ct, st, lt, lv, ll, ci, ack, hi, lo;
  const int* msource;
  const int* mdest;
  int leader;
};

// NoLogDivergence — Raft.tla:588-596
__device__ inline bool inv_no_log_divergence(const InvFields& f, const int* s) {
  const int S = f.S, L = f.L;
  const int *ci = s + f.ci, *lt = s + f.lt, *lv = s + f.lv;
  for (int i = 0; i < S; ++i)
    for (int j = 0; j < S; ++j) {
      const int mci = ci[i] < ci[j] ? ci[i] : ci[j];
      for (int l = 0; l < L; ++l)
        if (l + 1 <= mci && (lt[i * L + l] != lt[j * L + l] || lv[i * L + l] != lv[j * L + l]))
          return false;
    }
  return true;
}

// LeaderHasAllAckedValues — Raft.tla:604-620
__device__ inline bool inv_leader_has_acked(const InvFields& f, const int* s) {
  const int S = f.S, L = f.L, V = f.V;
  const int *ct = s + f.ct, *st = s + f.st, *lv = s + f.lv, *ack = s + f.ack;
  for (int i = 0; i < S; ++i) {
    bool not_stale = true;
    for (int j = 0; j < S; ++j) not_stale &= ct[i] >= ct[j];
    if (!(st[i] == f.leader && not_stale)) continue;
    for (int v = 0; v < V; ++v) {
      if (ack[v] != RA_ACK_TRUE) continue;
      bool has = false;
      for (int l = 0; l < L; ++l) has |= lv[i * L + l] == v + 1;
      if (!has) return false;
    }
  }
  return true;
}

// CommittedEntriesReachMajority — Raft.tla:625-636
__device__ inline bool inv_committed_majority(const InvFields& f, const int* s) {
  const int S = f.S, L = f.L;
  const int *st = s + f.st, *ci = s + f.ci, *ll = s + f.ll;
  const int *lt = s + f.lt, *lv = s + f.lv;
  bool any_lead = false, ok_exists = false;
  for (int i = 0; i < S; ++i) {
    if (!(st[i] == f.leader && ci[i] > 0)) continue;
    any_lead = true;
    const int pos = ra_clamp(ci[i] - 1, 0, L - 1);
    int match = 0;
    for (int j = 0; j < S; ++j)
      match += ll[j] >= ci[i] && lt[j * L + pos] == lt[i * L + pos] &&
               lv[j * L + pos] == lv[i * L + pos];
    ok_exists |= match >= S / 2 + 1;
  }
  return !any_lead || ok_exists;
}

// MessagesAreValid — MessagePassing.tla:81-83: no self-addressed record
__device__ inline bool inv_messages_are_valid(const InvFields& f, const int* s) {
  for (int m = 0; m < f.M; ++m) {
    const int hi = s[f.hi + m], lo = s[f.lo + m];
    if (hi != RA_EMPTY && ra_unpack_q(f.msource, hi, lo) == ra_unpack_q(f.mdest, hi, lo))
      return false;
  }
  return true;
}

// ValueAllOrNothing(v) — Raft.tla:560-573 (KRaft.tla:867-875): TRUE when
// the last permissible election failed with no leader (the election
// counter `ectr` at its bound), else v is on every server's log or on none
__device__ inline bool inv_value_all_or_nothing(const InvFields& f, const int* s, int ectr,
                                                int max_elections, int v) {
  const int S = f.S, L = f.L;
  const int *st = s + f.st, *lv = s + f.lv, *ll = s + f.ll;
  int n_have = 0;
  bool leader = false;
  for (int i = 0; i < S; ++i) {
    bool has = false;
    for (int l = 0; l < L; ++l) has |= l < ll[i] && lv[i * L + l] == v + 1;
    n_have += has;
    leader |= st[i] == f.leader;
  }
  const bool spent = ectr == max_elections;
  return (spent && !leader) || n_have == S || n_have == 0;
}

__device__ inline bool inv_eval(const InvFields& f, const int* s, int id) {
  switch (id) {
    case INV_MESSAGES_ARE_VALID: return inv_messages_are_valid(f, s);
    case INV_NO_LOG_DIVERGENCE: return inv_no_log_divergence(f, s);
    case INV_LEADER_HAS_ALL_ACKED: return inv_leader_has_acked(f, s);
    case INV_COMMITTED_REACH_MAJORITY: return inv_committed_majority(f, s);
    case INV_TEST: return true;
  }
  return true;
}
