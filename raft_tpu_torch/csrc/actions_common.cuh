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
//   lead()         the member that makes the lane's scalar writes;
// and, for the group guard (guard_state below), where each member holds a
// lane of its own in a slot (member t in slot t - lo(); NM slots a thread):
//   ballot(bits)   the members' bits (each thread's members' bits at their
//                  ranks) ORed over the group;
//   orr(x)         x ORed over the group;
//   own(u)         the slot of member u in this thread, or -1;
//   pick_key(rq, u, nw)  member u's key, in every member.
// GrpOne is a group of one (the guard lanes of guard_body, whose puts take
// the serial probes and inserts above); GrpRecord a guard lane of the
// group guard, run by its member alone, which keeps its put for the group;
// GrpSerial runs G members on one thread (the host build of the tests),
// accumulating in place, where a round's read, barrier and write run member
// by member in rank order: that equals the barrier for the shift, since
// member t reads the slot that member t + 1 writes. The tile lives in
// expand_driver.cuh.
//
// Keys here are int32 words (IKey): the low 32 bits of WKey's int64 sum,
// so nw_wrap's result, indexed at compile time only, in registers; MAXW (a
// family's most key words, NW_MAX_WORDS unless given) bounds the unrolled
// word loops.

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

// a guard lane's one bag put, kept for its group to run (guard_state)
struct PutReq {
  IKey k;
  bool want;   // a put of key k; then valid &= !(gate && existed) and
  bool gate;   // ovf = (overflow || extra) && valid (nw_put_finish)
  bool extra;
  bool chain;  // a chain of puts, run by the group (the family's chain)
};

struct GrpOne {
  __device__ __forceinline__ int lo() const { return 0; }
  __device__ __forceinline__ int hi() const { return 1; }
  __device__ __forceinline__ int size() const { return 1; }
  __device__ __forceinline__ int sum(int x) const { return x; }
  __device__ __forceinline__ bool any(bool b) const { return b; }
  __device__ __forceinline__ void sync() const {}
  __device__ __forceinline__ bool lead() const { return true; }
};

struct GrpRecord : GrpOne {
  PutReq* rq;
  __device__ __forceinline__ explicit GrpRecord(PutReq* r) : rq(r) {}
};

struct GrpSerial {
  static constexpr int NM = 32;  // slots a thread: all G members
  int G;
  int lo() const { return 0; }
  int hi() const { return G; }
  int size() const { return G; }
  int sum(int x) const { return x; }
  bool any(bool b) const { return b; }
  void sync() const {}
  bool lead() const { return true; }
  unsigned ballot(unsigned bits) const { return bits; }
  unsigned orr(unsigned x) const { return x; }
  int own(int u) const { return u; }
  template <int MAXW>
  IKey pick_key(const PutReq* rq, int u, int) const { return rq[u].k; }
};

// lowest set bit (1-based, 0 for none) and population count
__device__ __forceinline__ int grp_ffs(unsigned x) {
#ifdef __CUDA_ARCH__
  return __ffs(x);
#else
  return __builtin_ffs(x);
#endif
}
__device__ __forceinline__ int grp_popc(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
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
// whole group; ends with the group's barrier. CNT false: keys only (a
// guard's copy of them; cnt unused, p.existed false)
template <int MAXW = NW_MAX_WORDS, bool CNT = true, class Gp>
__device__ __forceinline__ void nw_bag_insert_g(Gp g, int* words, int* cnt, int M, int nw,
                                                const IKey& k, const Put& p) {
  const int G = g.size();
  g.sync();  // the lane's earlier writes (the receipt's Discard) before the reads
  if (CNT && p.existed) {
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
        if (CNT) c = cnt[x - 1];
      }
      g.sync();  // every member's read of the round before any write
      if (x > p.pos) {
#pragma unroll
        for (int w = 0; w < MAXW; ++w)
          if (w < nw) words[w * M + x] = v[w];
        if (CNT) cnt[x] = c;
      }
    }
  if (p.pos < M && g.lead()) {  // slot pos was read before the last round's barrier
#pragma unroll
    for (int w = 0; w < MAXW; ++w)
      if (w < nw) words[w * M + p.pos] = k.w[w];
    if (CNT) cnt[p.pos] = 1;
  }
  g.sync();
}

// f(u) for u in [0, n), split over the group's members (a multi-lane write)
template <class Gp, class Fn>
__device__ __forceinline__ void grp_for(Gp g, int n, Fn f) {
  for (int t = g.lo(); t < g.hi(); ++t)
    for (int u = t; u < n; u += g.size()) f(u);
}

// ---- the 2-word (hi, lo) bag, its put split over a group ----
//
// ra_bag_probe and ra_bag_insert above with the slots split as the N-word
// put's are (member t the slots t, t + G, ...; the shift G slots a round
// from the top): the Raft and KRaft group apply's. The semantics stay
// ra_bag_probe's: the key's words compared as long long against the row's
// int32 words (a RequestVote key of Raft is int64 and may compare unequal
// to every slot), hi, lo and cnt at separate field offsets.

template <class Gp>
__device__ __forceinline__ Put ra_bag_probe_g(Gp g, const int* hi, const int* lo, int M,
                                              const Key& k) {
  const int G = g.size();
  const long long khi = k.w[1], klo = k.w[0];
  int pos = 0;
  bool existed = false, have_empty = false;
  for (int t = g.lo(); t < g.hi(); ++t)
    for (int m = t; m < M; m += G) {
      const long long h = hi[m], l = lo[m];
      existed |= (h == khi) && (l == klo);
      have_empty |= h == RA_EMPTY;
      pos += (h < khi) || (h == khi && l < klo);
    }
  Put r;
  r.pos = g.sum(pos);
  r.existed = g.any(existed);
  r.overflow = !r.existed && !g.any(have_empty);
  return r;
}

// the insert half, in place in a successor row, by the whole group; starts
// and ends with the group's barrier (the lane's earlier writes, a receipt's
// Discard or the chain's last put, before its reads)
template <class Gp>
__device__ __forceinline__ void ra_bag_insert_g(Gp g, int* hi, int* lo, int* cnt, int M,
                                                const Key& k, const Put& p) {
  const int G = g.size();
  const long long khi = k.w[1], klo = k.w[0];
  g.sync();
  if (p.existed) {
    for (int t = g.lo(); t < g.hi(); ++t)
      for (int m = t; m < M; m += G)
        cnt[m] += ((long long)hi[m] == khi && (long long)lo[m] == klo);
    g.sync();
    return;
  }
  for (int top = M - 1; top > p.pos; top -= G)  // slot top - t, G a round, from the top
    for (int t = g.lo(); t < g.hi(); ++t) {
      const int x = top - t;
      int h = 0, l = 0, c = 0;
      if (x > p.pos) {
        h = hi[x - 1];
        l = lo[x - 1];
        c = cnt[x - 1];
      }
      g.sync();  // every member's read of the round before any write
      if (x > p.pos) {
        hi[x] = h;
        lo[x] = l;
        cnt[x] = c;
      }
    }
  if (p.pos < M && g.lead()) {  // slot pos was read before the last round's barrier
    hi[p.pos] = (int)khi;
    lo[p.pos] = (int)klo;
    cnt[p.pos] = 1;
  }
  g.sync();
}

// A 2-word put's probe and insert as an action takes them: a guard lane (a
// group of one) keeps the serial ones, so its code stays as it was; the
// apply's group splits them.
__device__ __forceinline__ Put ra_probe(GrpOne, const int* hi, const int* lo, int M, const Key& k) {
  return ra_bag_probe(hi, lo, M, k);
}
template <class Gp>
__device__ __forceinline__ Put ra_probe(Gp g, const int* hi, const int* lo, int M, const Key& k) {
  return ra_bag_probe_g(g, hi, lo, M, k);
}
__device__ __forceinline__ void ra_insert(GrpOne, int* hi, int* lo, int* cnt, int M,
                                          const Key& k, const Put& p) {
  ra_bag_insert(hi, lo, cnt, M, k, p);
}
template <class Gp>
__device__ __forceinline__ void ra_insert(Gp g, int* hi, int* lo, int* cnt, int M, const Key& k,
                                          const Put& p) {
  ra_bag_insert_g(g, hi, lo, cnt, M, k, p);
}

// A lane's one bag put as its action reads it: existed and overflow on the
// bag before the put; a message that exists disables a send-once lane
// (gate), and extra is an overflow besides the bag's (a log at max_log)
__device__ __forceinline__ void nw_put_finish(Guard& gd, const Put& p, bool gate, bool extra) {
  gd.valid = gd.valid && !(gate && p.existed);
  gd.ovf = (p.overflow || extra) && gd.valid;
}
// the probe by the group of the lane (the apply), or, for a GrpRecord guard
// lane, the put kept for the group guard (the lane finishes in guard_state)
template <int MAXW, class Gp>
__device__ __forceinline__ Put nw_put(Gp g, const int* words, int M, int nw, const IKey& k,
                                      Guard& gd, bool gate, bool extra) {
  const Put p = nw_bag_probe_g<MAXW>(g, words, M, nw, k);
  nw_put_finish(gd, p, gate, extra);
  return p;
}
template <int MAXW>
__device__ __forceinline__ Put nw_put(GrpRecord g, const int*, int, int, const IKey& k, Guard&,
                                      bool gate, bool extra) {
  g.rq->k = k;
  g.rq->want = true;
  g.rq->gate = gate;
  g.rq->extra = extra;
  return Put{false, false, 0};
}

// ---- the group guard's work on one state ----
//
// A group of G members (expand_driver.cuh's tile on the card, GrpSerial on
// the host) takes one state's A candidate lanes in rounds, member t the
// lanes t, t + G, ... Each round every member runs its own lane alone
// (F::lane: the action with a GrpRecord, its scalar part, the put it makes
// kept as a PutReq); then the group runs the round's puts one after
// another in rank order (the key passed round from its member, the probe
// split over the group on the state's bag, the lane finished by its
// member: nw_put_finish), then the round's chains (F::chain, on the
// group's `scratch`). Writes lane a's valid (masked by live), rank and ovf
// at valid[a], rank[a], ovf[a], hands each rank's valid lanes of a round to
// fired(k, n) (in the lead) and returns the state's sums, the same in every
// member. F gives the spec's indices of A, K, M, NW and the bag (I_A, I_K,
// I_M, I_NW, I_BAG) and its most key words (MAX_WORDS).
struct GuardSums {
  unsigned en;  // the ranks of the valid lanes
  int n_valid;  // valid lanes
  bool ovf;     // a valid lane overflows
};

template <class F, class Gp, class Fired>
__device__ __forceinline__ GuardSums guard_state(Gp g, const int* sp, const int* s,
                                                 const int* cand, bool live, int* scratch,
                                                 bool* valid, int* rank, bool* ovf, Fired fired) {
  constexpr int NM = Gp::NM, MAXW = F::MAX_WORDS;
  const int G = g.size(), A = sp[F::I_A], K = sp[F::I_K];
  const int M = sp[F::I_M], NW = sp[F::I_NW];
  const int* words = s + sp[F::I_BAG];
  GuardSums sums{0u, 0, false};
  for (int a0 = 0; a0 < A; a0 += G) {
    Guard gd[NM];
    PutReq rq[NM];
    unsigned want = 0, chain = 0;
    for (int t = g.lo(); t < g.hi(); ++t) {  // each member's own lane, alone
      const int x = t - g.lo();
      rq[x].want = rq[x].chain = false;
      gd[x] = a0 + t < A ? F::lane(sp, s, cand + 4 * (a0 + t), rq[x]) : Guard{false, -1, false};
      want |= (unsigned)rq[x].want << t;
      chain |= (unsigned)rq[x].chain << t;
    }
    for (unsigned need = g.ballot(want); need; need &= need - 1) {  // the puts, in turn
      const int u = grp_ffs(need) - 1;
      const Put p =
          nw_bag_probe_g<MAXW>(g, words, M, NW, g.template pick_key<MAXW>(rq, u, NW));
      const int x = g.own(u);
      if (x >= 0) nw_put_finish(gd[x], p, rq[x].gate, rq[x].extra);
    }
    for (unsigned need = g.ballot(chain); need; need &= need - 1) {  // the chains, in turn
      const int u = grp_ffs(need) - 1;
      Guard c{true, 0, false};
      F::chain(g, sp, s, cand + 4 * (a0 + u), scratch, c);
      const int x = g.own(u);
      if (x >= 0) {
        gd[x].valid = gd[x].valid && c.valid;
        gd[x].ovf = c.ovf && gd[x].valid;
      }
    }
    unsigned vm = 0, en = 0;
    bool o = false;
    for (int t = g.lo(); t < g.hi(); ++t) {
      const int x = t - g.lo(), a = a0 + t;
      if (a >= A) continue;
      const bool v = gd[x].valid && live;
      valid[a] = v;
      rank[a] = gd[x].rank;
      ovf[a] = gd[x].ovf;
      if (v) {
        vm |= 1u << t;
        o = o || gd[x].ovf;
        if (gd[x].rank >= 0 && gd[x].rank < K) en |= 1u << gd[x].rank;
      }
    }
    vm = g.ballot(vm);
    en = g.orr(en);
    const bool round_ovf = g.any(o);
    sums.n_valid += grp_popc(vm);
    sums.en |= en;
    sums.ovf = sums.ovf || round_ovf;
    for (unsigned e = en; e; e &= e - 1) {  // fired: the round's valid lanes of each rank
      const int k = grp_ffs(e) - 1;
      unsigned hit = 0;
      for (int t = g.lo(); t < g.hi(); ++t) {
        const int x = t - g.lo();
        hit |= (unsigned)(a0 + t < A && gd[x].valid && live && gd[x].rank == k) << t;
      }
      const int n = grp_popc(g.ballot(hit));
      if (g.lead()) fired(k, n);
    }
  }
  return sums;
}

// ---- a put in the guard's form or the apply's ----
//
// Two forms, picked by the action's WRITE (KRaftWithReconfig's actions; the
// reconfiguration pair's take IKey in both, config_actions.cuh). The guard
// (a group of one) keeps the forms it had before the group apply: an int64
// WKey indexed by a spec
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
