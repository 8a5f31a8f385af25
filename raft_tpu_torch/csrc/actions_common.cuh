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

// ---- N-word message keys (ops/packing.py WidePacker) and their bag
// (ops/bag.py wide_bag_put): word w of slot m at words[w * M + m], the
// slots in lexicographic order of the words from word 0; a family packs a
// key's fields at its spec's (word, shift, mask) triples ----

#define NW_MAX_WORDS 8

struct WKey {
  long long w[NW_MAX_WORDS];
};

__device__ __forceinline__ WKey nw_key() {
  WKey k;
  for (int w = 0; w < NW_MAX_WORDS; ++w) k.w[w] = 0;
  return k;
}
// int32 wraparound of every word (the plain versions pack in int32)
__device__ __forceinline__ void nw_wrap(WKey& k) {
  for (int w = 0; w < NW_MAX_WORDS; ++w) k.w[w] = (int)k.w[w];
}

__device__ Put nw_bag_probe(const int* words, int M, int nw, const WKey& k) {
  Put r{false, false, 0};
  bool have_empty = false;
  for (int m = 0; m < M; ++m) {
    bool less = false, tie = true;
    for (int w = 0; w < nw; ++w) {
      const int x = words[w * M + m], kk = (int)k.w[w];
      less = less || (tie && x < kk);
      tie = tie && x == kk;
    }
    r.existed |= tie;
    have_empty |= words[m] == RA_EMPTY;
    r.pos += less;
  }
  r.overflow = !r.existed && !have_empty;
  return r;
}

// the insert half of wide_bag_put, in place; cnt may be null (a guard's copy)
__device__ void nw_bag_insert(int* words, int* cnt, int M, int nw, const WKey& k, const Put& p) {
  if (p.existed) {
    if (cnt)
      for (int m = 0; m < M; ++m) {
        bool eq = true;
        for (int w = 0; w < nw; ++w) eq = eq && words[w * M + m] == (int)k.w[w];
        cnt[m] += eq;
      }
    return;
  }
  for (int x = M - 1; x > p.pos; --x) {
    for (int w = 0; w < nw; ++w) words[w * M + x] = words[w * M + x - 1];
    if (cnt) cnt[x] = cnt[x - 1];
  }
  if (p.pos < M) {
    for (int w = 0; w < nw; ++w) words[w * M + p.pos] = (int)k.w[w];
    if (cnt) cnt[p.pos] = 1;
  }
}

// ---- the same bag, its put split over a group of threads ----
//
// A group of G members shares one lane's put: member t takes the slots
// m = t, t + G, ... of the probe (pos combined by sum, existed and
// have_empty by OR) and of the count update, and the insert's shift moves
// G slots a round from the top, member t reading slot top - t - 1, then
// (after the group's barrier) writing it one slot up. A group type says
// which members a thread runs and supplies the combining:
//   lo(), hi()     the members [lo, hi) this thread runs: its own rank on
//                  the card (a warp tile), all G in turn on the host;
//   size()         G;
//   sum(x), any(b) the total over the members, in every member;
//   sync()         the group's barrier, which also orders the members'
//                  memory accesses (__syncwarp on the card);
//   lead()         the member that makes the lane's scalar writes.
// GrpOne is a group of one (a guard lane, whose puts take nw_bag_probe and
// nw_bag_insert above); GrpSerial runs G members on one
// thread (the host build of the tests), accumulating in place, where a
// round's read, barrier and write run member by member in rank order: that
// equals the barrier for the shift, since member t reads the slot that
// member t + 1 writes. The tile lives in expand_driver.cuh.
//
// Keys here are int32 words (IKey): the low 32 bits of WKey's int64 sum,
// so nw_wrap's result, indexed at compile time only, in registers; MAXW (a
// family's most key words, NW_MAX_WORDS unless given) bounds the unrolled
// word loops.

struct GrpOne {
  __device__ __forceinline__ int lo() const { return 0; }
  __device__ __forceinline__ int hi() const { return 1; }
  __device__ __forceinline__ int size() const { return 1; }
  __device__ __forceinline__ int sum(int x) const { return x; }
  __device__ __forceinline__ bool any(bool b) const { return b; }
  __device__ __forceinline__ void sync() const {}
  __device__ __forceinline__ bool lead() const { return true; }
};

struct GrpSerial {
  int G;
  int lo() const { return 0; }
  int hi() const { return G; }
  int size() const { return G; }
  int sum(int x) const { return x; }
  bool any(bool b) const { return b; }
  void sync() const {}
  bool lead() const { return true; }
};

struct IKey {
  int w[NW_MAX_WORDS];
  __device__ __forceinline__ int operator[](int i) const { return w[i]; }
};

__device__ __forceinline__ IKey nw_ikey() {
  IKey k;
#pragma unroll
  for (int w = 0; w < NW_MAX_WORDS; ++w) k.w[w] = 0;
  return k;
}

template <int MAXW = NW_MAX_WORDS, class Gp>
__device__ __forceinline__ Put nw_bag_probe_g(Gp g, const int* words, int M, int nw,
                                              const IKey& k) {
  const int G = g.size();
  int pos = 0;
  bool existed = false, have_empty = false;
  for (int t = g.lo(); t < g.hi(); ++t)
    for (int m = t; m < M; m += G) {
      bool less = false, tie = true;
#pragma unroll
      for (int w = 0; w < MAXW; ++w) {
        if (w < nw) {  // a predicate, not a break: the loop unrolls
          const int x = words[w * M + m];
          less = less || (tie && x < k.w[w]);
          tie = tie && x == k.w[w];
        }
      }
      existed |= tie;
      have_empty |= words[m] == RA_EMPTY;
      pos += less;
    }
  Put r;
  r.pos = g.sum(pos);
  r.existed = g.any(existed);
  r.overflow = !r.existed && !g.any(have_empty);
  return r;
}

// the insert half of wide_bag_put, in place in a successor row, by the
// whole group; ends with the group's barrier
template <int MAXW = NW_MAX_WORDS, class Gp>
__device__ __forceinline__ void nw_bag_insert_g(Gp g, int* words, int* cnt, int M, int nw,
                                                const IKey& k, const Put& p) {
  const int G = g.size();
  g.sync();  // the lane's earlier writes (the receipt's Discard) before the reads
  if (p.existed) {
    for (int t = g.lo(); t < g.hi(); ++t)
      for (int m = t; m < M; m += G) {
        bool eq = true;
#pragma unroll
        for (int w = 0; w < MAXW; ++w)
          if (w < nw) eq = eq && words[w * M + m] == k.w[w];
        cnt[m] += eq;
      }
    g.sync();
    return;
  }
  for (int top = M - 1; top > p.pos; top -= G)  // slot top - t, G a round, from the top
    for (int t = g.lo(); t < g.hi(); ++t) {
      const int x = top - t;
      int v[MAXW], c = 0;
      if (x > p.pos) {
#pragma unroll
        for (int w = 0; w < MAXW; ++w) v[w] = w < nw ? words[w * M + x - 1] : 0;
        c = cnt[x - 1];
      }
      g.sync();  // every member's read of the round before any write
      if (x > p.pos) {
#pragma unroll
        for (int w = 0; w < MAXW; ++w)
          if (w < nw) words[w * M + x] = v[w];
        cnt[x] = c;
      }
    }
  if (p.pos < M && g.lead()) {  // slot pos was read before the last round's barrier
#pragma unroll
    for (int w = 0; w < MAXW; ++w)
      if (w < nw) words[w * M + p.pos] = k.w[w];
    cnt[p.pos] = 1;
  }
  g.sync();
}

// f(u) for u in [0, n), split over the group's members (a multi-lane write)
template <class Gp, class Fn>
__device__ __forceinline__ void grp_for(Gp g, int n, Fn f) {
  for (int t = g.lo(); t < g.hi(); ++t)
    for (int u = t; u < n; u += g.size()) f(u);
}

// ---- a put in the guard's form or the apply's ----
//
// Two forms, picked by the action's WRITE. The guard (a group of one) keeps
// the forms it had before the group apply: an int64 WKey indexed by a spec
// word and wrapped to int32 before its put, key words in an int array read
// at a runtime index, the serial nw_bag_probe and nw_bag_insert; a few bytes
// of stack, and the registers (so the occupancy) of its one-thread lanes stay
// as they were. The apply takes IKey for both, int32 words in registers,
// every word picked by masks (a conditional store or a select of words lets
// the compiler index the key at run time, on the stack), and the put split
// over its group. MAXW is the family's most key words; q a field's (word,
// shift, mask) triple in a spec vector.

template <bool WRITE, int MAXW>
struct NwForm {  // the guard's
  typedef WKey Key;
  typedef int Words[MAXW];
};
template <int MAXW>
struct NwForm<true, MAXW> {  // the apply's
  typedef IKey Key;
  typedef IKey Words;
};

__device__ __forceinline__ void nw_key_init(WKey& k) { k = nw_key(); }
__device__ __forceinline__ void nw_key_init(IKey& k) { k = nw_ikey(); }

// add v << shift into the key's word
__device__ __forceinline__ void nw_pack_q(const int* q, WKey& k, long long v) {
  k.w[q[0]] += (long long)((unsigned long long)v << q[1]);
}
// the same in int32 (the low 32 bits of WKey's sum): every word takes an
// add, masked to 0 but at the field's word
template <int MAXW>
__device__ __forceinline__ void nw_pack_q(const int* q, IKey& k, int v) {
  const unsigned add = (unsigned)v << q[1];
#pragma unroll
  for (int w = 0; w < MAXW; ++w)
    k.w[w] = (int)((unsigned)k.w[w] + (add & (0u - (unsigned)(q[0] == w))));
}

// a field of a key given as its words
__device__ __forceinline__ int nw_unpack_q(const int* q, const int* kw) {
  return (kw[q[0]] >> q[1]) & q[2];
}
template <int MAXW>
__device__ __forceinline__ int nw_unpack_q(const int* q, const IKey& kw) {
  int x = 0;
#pragma unroll
  for (int w = 0; w < MAXW; ++w) x |= kw.w[w] & -(int)(q[0] == w);
  return (x >> q[1]) & q[2];
}

// a put's probe and insert: the guard's serial ones (its key wrapped to
// int32 first), the apply's split over its group
template <int MAXW, class Gp>
__device__ __forceinline__ Put nw_probe(Gp, const int* words, int M, int nw, WKey& k) {
  nw_wrap(k);
  return nw_bag_probe(words, M, nw, k);
}
template <int MAXW, class Gp>
__device__ __forceinline__ Put nw_probe(Gp g, const int* words, int M, int nw, IKey& k) {
  return nw_bag_probe_g<MAXW>(g, words, M, nw, k);
}
template <int MAXW, class Gp>
__device__ __forceinline__ void nw_insert(Gp, int* words, int* cnt, int M, int nw,
                                          const WKey& k, const Put& p) {
  nw_bag_insert(words, cnt, M, nw, k, p);
}
template <int MAXW, class Gp>
__device__ __forceinline__ void nw_insert(Gp g, int* words, int* cnt, int M, int nw,
                                          const IKey& k, const Put& p) {
  nw_bag_insert_g<MAXW>(g, words, cnt, M, nw, k, p);
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
