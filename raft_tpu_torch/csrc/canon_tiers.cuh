// canon_tiers.cuh — device code of the canonical fingerprint of layouts with
// five or more servers: the server signatures and the min of the permuted
// view's hash over the signature-admissible permutations.
//
// Ports raft_tpu/ops/symmetry.py: _signatures (:581, with _scatter_by_server
// :747 and _gather_sig_fold :769), _hash_dyn (:944, with _dyn_outpos :914
// and _bag_streams :823), and the admissible set that _tier_pre (:1081),
// _tier3_local (:1143) and _tier3_full (:1193) reach by three routes and
// _masked_min(view, sig) (:1017) by brute force: the permutations that sort
// the S signatures ascending as unsigned u64. Here it is computed directly
// for one state: sort the signatures, split the sorted order into tie
// groups, and enumerate the products of per-group permutations composed
// with the sort (1 permutation for totally ordered signatures, S! for the
// all-tied states near Init), hashing each with positional salts computed
// from the permutation (no P x K tables).
//
// A state is canonicalized by a group of G members (canon_tiered.cu: G
// threads of one tile). Member t of G takes a share of every sum: the
// non-bag lanes j = t, t + G, ... and the bag slots m = t, t + G, ... of
// each hash (ct_hash_part), and the (signature field, server) units u = t,
// t + G, ... and the bag slots of each signature round (ct_sig_base_part,
// ct_sig_round_part). The shares are combined by XOR (the non-bag streams)
// and by addition mod 2^32 (the bag streams and the signature sums): both
// commutative and associative, so every G gives the serial order's bits.
// A group type supplies the combining: each(f) runs f(t, G) for the
// member's own share (a tile) or for all G shares in turn (CtSerial, the
// host build), sum() combines the members' partials and leaves the total
// in every member (a tile's __shfl_xor_sync butterfly, csrc/canon_tile.cuh;
// nothing for CtSerial, whose shares accumulate in place). Every member then holds the same
// signatures, the same admissible set and the same hashes, so the min
// needs no reduction of its own.
//
// Every function is templated on NW, the key words of a message bag: NW = 2
// is the path of the 2-word (hi, lo) bags, with at most CT_FAST_FIELDS plain
// or Nil-able message server fields and one lane a server in each
// server-valued or member-set field; NW = 0 is the general path (ops/
// symmetry.py Canonicalizer.tier_general): up to CT_MAX_WORDS key words read
// from the spec, up to CT_MAX_FIELDS message fields of any kind (a member-set
// bitmask among them: bit q moves to bit sigma[q], a set bit scatters to its
// server and the gather is a multiset sum over the members), and fields of r
// lanes a server signed as r one-lane fields (ops/symmetry.py split_fields).
// The 2-word path keeps the code and the speed it had before the general path
// existed (scripts/expand_timing.py times the two, parent against change).
//
// Everything is plain C++ once CUDA's qualifiers are defined away, so the
// same code also compiles for the host (tests/test_torch_canon_tiers.py
// runs it with CtSerial at several G).
//
// The layout arrives as an int32 spec vector (ops/symmetry.py
// Canonicalizer.tier_spec): the CT_* header; at CT_OFF_WORDS the key words'
// slot offsets in stream (sort) order, then the NW + 1 stream xors of the
// seeded bag hash (count last); per message server field (stream, shift,
// mask, kind: CT_MSG_*); per signature field (kind + 16 * n, salt offset,
// first lane): n is a per_server field's lanes a server, or a server-valued
// or member-set field's lane stride (its lane of server i is first + i * n);
// per non-bag view lane (lane, c0, s1, m1, s2, m2):
// that lane's hash position under a permutation sigma is c0 + sigma[s1] * m1
// + sigma[s2] * m2 (a negative s is no term), in group order: plain lanes,
// server-valued lanes, server bitmasks.
#pragma once

#include "common.cuh"

#define CT_MAX_S 8          // ops/symmetry.py MAX_TIER_SERVERS
#define CT_FAST_FIELDS 4    // the 2-word path's message fields (TIER_FAST_FIELDS)
#define CT_MAX_FIELDS 32    // the general path's (MAX_MSG_FIELDS)
#define CT_MAX_WORDS 8      // the general path's key words (MAX_BAG_WORDS)
#define CT_EMPTY (1 << 30)
#define CT_PA 0x9E3779B9u
#define CT_PB 0x85EBCA77u

// header of the spec vector (ops/symmetry.py TIER_HEADER, in this order)
enum {
  CT_S, CT_VL, CT_K, CT_NPLAIN, CT_NVAL, CT_NBM, CT_NW, CT_GENERAL, CT_CNT, CT_M,
  CT_NF, CT_NSIG, CT_ROUNDS, CT_KA, CT_KB, CT_SEEDED, CT_SEEDA, CT_SEEDB,
  CT_OFF_WORDS, CT_OFF_FIELDS, CT_OFF_SIG, CT_OFF_LANES, CT_LEN, CT_HDR
};
// signature field kinds (SIG_KINDS)
enum { CT_PER_SERVER, CT_PER_SERVER_VAL, CT_BITMASK, CT_PAIR };
// message server field kinds (MSG_KINDS): a plain index; 0 = Nil and u =
// server u - 1 (KRaft's mleader, raft_tpu/ops/symmetry.py:337); a member set
// (the reconfiguration specs' member sets, :338)
enum { CT_MSG_SERVER, CT_MSG_SERVER_NIL, CT_MSG_BITMASK };

struct CtPair {
  uint32_t a, b;
};

// a hash's partial streams: the non-bag pair (XOR-combined) and the bag
// pair (added mod 2^32)
struct CtHashPart {
  uint32_t na, nb, ba, bb;
};

__device__ __forceinline__ void ct_hash_add(CtHashPart& acc, const CtHashPart& p) {
  acc.na ^= p.na;
  acc.nb ^= p.nb;
  acc.ba += p.ba;
  acc.bb += p.bb;
}

// the host's group: one thread runs all G shares, accumulating in place
// (so a sum or a min over the members is already whole)
struct CtSerial {
  int G;
  template <class F>
  void each(F f) {
    for (int t = 0; t < G; ++t) f(t, G);
  }
  void sum(uint32_t*, uint32_t*, int) {}
  void sum(CtHashPart&) {}
  void xor2(uint32_t&, uint32_t&) {}
  void sync() {}
  uint64_t min64(uint64_t x) { return x; }
};

// the reference's _salt(offset, role): splitmix64 of offset * 256 + role +
// 0x5A17, split into (high, low) u32 words
__device__ __forceinline__ CtPair ct_salt(int off, int role) {
  uint64_t z = (uint64_t)(off * 0x100 + role + 0x5A17);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  z ^= z >> 31;
  return CtPair{(uint32_t)(z >> 32), (uint32_t)z};
}

__device__ __forceinline__ CtPair ct_pmix(uint32_t x, CtPair s) {
  return CtPair{rt_mix32(x * RT_KA + s.a), rt_mix32(x * RT_KB + s.b)};
}

__device__ __forceinline__ CtPair ct_xmix(uint32_t a, uint32_t b, CtPair s) {
  return CtPair{rt_mix32(a ^ s.a), rt_mix32(b ^ s.b)};
}

// the key words of a bag: NW at compile time, or the spec's
template <int NW>
__device__ __forceinline__ int ct_nw(const int* sp) {
  return NW ? NW : sp[CT_NW];
}

// a bag slot's key words in stream order; false (and w untouched past
// w[0]) for an empty slot, whose first word is CT_EMPTY
template <int NW>
__device__ __forceinline__ bool ct_words(const int* sp, const int* v, int m, uint32_t* w) {
  const int* wd = sp + sp[CT_OFF_WORDS];
  w[0] = (uint32_t)v[wd[0] + m];
  if (w[0] == (uint32_t)CT_EMPTY) return false;
  const int nw = ct_nw<NW>(sp);
#pragma unroll
  for (int k = 1; k < (NW ? NW : CT_MAX_WORDS); ++k)
    if (NW || k < nw) w[k] = (uint32_t)v[wd[k] + m];
  return true;
}

// a member set under sigma: bit q moves to bit sigma[q], bits past S drop
template <class Sig>
__device__ __forceinline__ uint32_t ct_remap_bits(int x, Sig sigma, int S) {
  uint32_t y = 0;
  for (int q = 0; q < S; ++q) y |= (uint32_t)((x >> q) & 1) << sigma[q];
  return y;
}

// share t of G of the hash of the view v under sigma (old server i -> new
// index sigma[i]; an int array, or any type indexed so, e.g. canon_memo.cuh's
// permutation packed in one register): the non-bag lanes j = t, t + G, ...
// and the bag slots m = t, t + G, ...; remap=false with the identity is the
// raw key (no value remap at all). ct_hash_final turns the combined shares
// into the hash.
template <int NW, class Sig>
__device__ CtHashPart ct_hash_part(const int* sp, const int* v, Sig sigma, bool remap, int t,
                                   int G) {
  const int S = sp[CT_S], K = sp[CT_K], n_plain = sp[CT_NPLAIN], n_val = sp[CT_NVAL];
  const int* ln = sp + sp[CT_OFF_LANES];
  const bool seeded = sp[CT_SEEDED] != 0;
  const uint32_t seed_a = (uint32_t)sp[CT_SEEDA], seed_b = (uint32_t)sp[CT_SEEDB];
  uint32_t na = 0, nb = 0;
  for (int j = t; j < K; j += G) {
    const int* d = ln + 6 * j;
    const int pos = d[1] + (d[2] >= 0 ? sigma[d[2]] * d[3] : 0) +
                    (d[4] >= 0 ? sigma[d[4]] * d[5] : 0);
    const int xi = v[d[0]];
    uint32_t x = (uint32_t)xi;
    if (remap && j >= n_plain) {
      if (j < n_plain + n_val)  // 0 = Nil, i + 1 = server i
        x = (xi >= 1 && xi <= S) ? (uint32_t)(sigma[xi - 1] + 1) : 0u;
      else  // bitmask: bit q moves to bit sigma[q]
        x = ct_remap_bits(xi, sigma, S);
    }
    const uint32_t pa = (uint32_t)pos * CT_PA, pb = (uint32_t)pos * CT_PB;
    uint32_t xa = x, xb = x;
    if (seeded) {
      xa ^= rt_mix32(pa + seed_a);
      xb ^= rt_mix32(pb + seed_b);
    }
    na ^= rt_mix32(xa * RT_KA + pa);
    nb ^= rt_mix32(xb * RT_KB + pb);
  }
  // the bag: occupied slots hashed position-free and ADDED (mod 2^32); a
  // slot hashes its key words in stream order, then its count, each under
  // its stream's salt and seed xor. The 2-word path holds its two words,
  // salts and xors in scalars; the general path reads the xors where used
  // (with the words' offsets and xors hoisted into arrays, or the salts
  // held in arrays, the -O3 build faulted with an illegal address on the
  // card, though a -G build and the host build did not)
  const int* fd = sp + sp[CT_OFF_FIELDS];
  const int* wd = sp + sp[CT_OFF_WORDS];  // the words' offsets, then the stream xors
  const int NF = sp[CT_NF];
  uint32_t ba = 0, bb = 0;
  if constexpr (NW == 2) {
    const int hi_off = wd[0], lo_off = wd[1];
    const CtPair w0 = ct_salt(0, 20), w1 = ct_salt(1, 20), w2 = ct_salt(2, 20);
    const uint32_t sx0 = (uint32_t)wd[2], sx1 = (uint32_t)wd[3], sx2 = (uint32_t)wd[4];
    for (int m = t; m < sp[CT_M]; m += G) {
      const int hi = v[hi_off + m];
      if (hi == CT_EMPTY) continue;
      uint32_t w[2] = {(uint32_t)hi, (uint32_t)v[lo_off + m]};  // stream order
      if (remap) {
        const uint32_t orig[2] = {w[0], w[1]};
        for (int f = 0; f < NF; ++f) {
          const int k = fd[4 * f], shift = fd[4 * f + 1];
          const uint32_t mask = (uint32_t)fd[4 * f + 2];
          const uint32_t val = (orig[k] >> shift) & mask;
          uint32_t nv;  // a value naming no server maps to 0 (the reference's one-hot sums)
          if (fd[4 * f + 3] == CT_MSG_SERVER_NIL)
            nv = (val >= 1u && val <= (uint32_t)S) ? (uint32_t)sigma[val - 1] + 1u : 0u;
          else
            nv = val < (uint32_t)S ? (uint32_t)sigma[val] : 0u;
          w[k] = (w[k] & ~(mask << shift)) | (nv << shift);
        }
      }
      const uint32_t h0 = w[0] ^ sx0, h1 = w[1] ^ sx1, c = (uint32_t)v[sp[CT_CNT] + m] ^ sx2;
      const uint32_t a = rt_mix32(h0 * RT_KA + w0.a) ^ rt_mix32(h1 * RT_KA + w1.a) ^
                         rt_mix32(c * RT_KA + w2.a);
      const uint32_t b = rt_mix32(h0 * RT_KB + w0.b) ^ rt_mix32(h1 * RT_KB + w1.b) ^
                         rt_mix32(c * RT_KB + w2.b);
      ba += rt_mix32(a + RT_KB);
      bb += rt_mix32(b + RT_KA);
    }
  } else {
    const int nw = ct_nw<NW>(sp);
    const int* sx = wd + nw;  // the stream xors, the count's last
    const CtPair wc = ct_salt(nw, 20);
    const uint32_t sxc = (uint32_t)sx[nw];
    for (int m = t; m < sp[CT_M]; m += G) {
      uint32_t w[CT_MAX_WORDS];
      if (!ct_words<NW>(sp, v, m, w)) continue;
      if (remap) {
        uint32_t orig[CT_MAX_WORDS];
#pragma unroll
        for (int k = 0; k < CT_MAX_WORDS; ++k)
          if (k < nw) orig[k] = w[k];
        for (int f = 0; f < NF; ++f) {
          const int k = fd[4 * f], shift = fd[4 * f + 1], kind = fd[4 * f + 3];
          const uint32_t mask = (uint32_t)fd[4 * f + 2];
          const uint32_t val = (orig[k] >> shift) & mask;
          uint32_t nv;
          if (kind == CT_MSG_BITMASK)
            nv = ct_remap_bits((int)val, sigma, S);
          else if (kind == CT_MSG_SERVER_NIL)
            nv = (val >= 1u && val <= (uint32_t)S) ? (uint32_t)sigma[val - 1] + 1u : 0u;
          else
            nv = val < (uint32_t)S ? (uint32_t)sigma[val] : 0u;
          w[k] = (w[k] & ~(mask << shift)) | (nv << shift);
        }
      }
      const uint32_t c = (uint32_t)v[sp[CT_CNT] + m] ^ sxc;
      uint32_t a = rt_mix32(c * RT_KA + wc.a), b = rt_mix32(c * RT_KB + wc.b);
#pragma unroll
      for (int k = 0; k < CT_MAX_WORDS; ++k)
        if (k < nw) {
          const CtPair ws = ct_salt(k, 20);
          const uint32_t h = w[k] ^ (uint32_t)sx[k];
          a ^= rt_mix32(h * RT_KA + ws.a);
          b ^= rt_mix32(h * RT_KB + ws.b);
        }
      ba += rt_mix32(a + RT_KB);
      bb += rt_mix32(b + RT_KA);
    }
  }
  return CtHashPart{na, nb, ba, bb};
}

// the hash from the combined shares of ct_hash_part
__device__ __forceinline__ uint64_t ct_hash_final(const int* sp, const CtHashPart& h) {
  return rt_combine(h.na ^ (uint32_t)sp[CT_KA] ^ h.ba, h.nb ^ (uint32_t)sp[CT_KB] ^ h.bb);
}

// add c onto the servers a message field value names (_scatter_by_server,
// symmetry.py:747): val for a plain index, val - 1 for a Nil-able one
// (none when Nil), every set bit below S of a member set
template <int NW>
__device__ __forceinline__ void ct_scatter(uint32_t* acc_a, uint32_t* acc_b, CtPair c,
                                           uint32_t val, int kind, int S) {
  if (!NW && kind == CT_MSG_BITMASK) {
    for (int q = 0; q < S; ++q)
      if ((val >> q) & 1u) {
        acc_a[q] += c.a;
        acc_b[q] += c.b;
      }
    return;
  }
  if (kind == CT_MSG_SERVER_NIL) {
    if (val == 0u) return;
    val -= 1u;
  }
  if (val < (uint32_t)S) {
    acc_a[val] += c.a;
    acc_b[val] += c.b;
  }
}

// the signatures of the servers a message field value names, folded under
// salt (_gather_sig_fold, symmetry.py:769): the one server's (its index
// clamped into range), 0 for a Nil Nil-able field, the multiset sum over a
// member set's servers
template <int NW>
__device__ __forceinline__ CtPair ct_gather_fold(const uint32_t* sa, const uint32_t* sb,
                                                 uint32_t val, int kind, int S, CtPair salt) {
  if (!NW && kind == CT_MSG_BITMASK) {
    CtPair f{0u, 0u};
    for (int q = 0; q < S; ++q)
      if ((val >> q) & 1u) {
        const CtPair e = ct_xmix(sa[q], sb[q], salt);
        f.a += e.a;
        f.b += e.b;
      }
    return f;
  }
  if (kind == CT_MSG_SERVER_NIL) {
    if (val == 0u) return CtPair{0u, 0u};
    val -= 1u;
  }
  const int t = val < (uint32_t)S ? (int)val : S - 1;
  return ct_xmix(sa[t], sb[t], salt);
}

// the record hash of a message slot with its server fields zeroed (rec0):
// its key words in stream order, then the count
template <int NW>
__device__ __forceinline__ CtPair ct_rec0(const int* sp, const uint32_t* words, uint32_t cnt) {
  constexpr int WMAX = NW ? NW : CT_MAX_WORDS;
  const int* fd = sp + sp[CT_OFF_FIELDS];
  const int nw = ct_nw<NW>(sp);
  uint32_t w[WMAX];
#pragma unroll
  for (int k = 0; k < WMAX; ++k)
    if (NW || k < nw) w[k] = words[k];
  for (int f = 0; f < sp[CT_NF]; ++f) w[fd[4 * f]] &= ~((uint32_t)fd[4 * f + 2] << fd[4 * f + 1]);
  CtPair r = ct_pmix(cnt, ct_salt(nw, 21));
#pragma unroll
  for (int k = 0; k < WMAX; ++k)
    if (NW || k < nw) {
      const CtPair p = ct_pmix(w[k], ct_salt(k, 21));
      r.a ^= p.a;
      r.b ^= p.b;
    }
  return CtPair{rt_mix32(r.a), rt_mix32(r.b)};
}

// Signature round 0, share t of G: each (field q, server i) unit u = t,
// t + G, ... of the S * NSIG adds its server's invariant content, each bag
// slot m = t, t + G, ... its record (server fields zeroed) folded into the
// servers it references, times its count, into aa/ab (S sums each). A
// server-valued or member-set field's lane of server i is f[i * st] (st = 1
// on the 2-word path)
template <int NW>
__device__ void ct_sig_base_part(const int* sp, const int* v, int t, int G, uint32_t* aa,
                                 uint32_t* ab) {
  constexpr int WMAX = NW ? NW : CT_MAX_WORDS;
  const int S = sp[CT_S], NF = sp[CT_NF], M = sp[CT_M];
  const int* fd = sp + sp[CT_OFF_FIELDS];
  const int* sg = sp + sp[CT_OFF_SIG];
  for (int u = t; u < sp[CT_NSIG] * S; u += G) {
    const int q = u / S, i = u - q * S;
    const int* row = sg + 3 * q;
    const int kind = row[0] & 15, off = row[1];
    const int* f = v + row[2];
    const int st = NW ? 1 : row[0] >> 4;
    if (kind == CT_PER_SERVER) {
      const int rest = row[0] >> 4;
      const CtPair s = ct_salt(off, 0);
      uint32_t ha = 0, hb = 0;
      for (int c = 0; c < rest; ++c) {
        const uint32_t x = (uint32_t)f[i * rest + c];
        ha ^= rt_mix32(x * RT_KA + (uint32_t)c * CT_PA);
        hb ^= rt_mix32(x * RT_KB + (uint32_t)c * CT_PB);
      }
      ha ^= (uint32_t)rest * RT_KA;
      hb ^= (uint32_t)rest * RT_KB;
      aa[i] += rt_mix32(ha + s.a);
      ab[i] += rt_mix32(hb + s.b);
    } else if (kind == CT_PER_SERVER_VAL) {  // 0 = Nil, i + 1 = server i
      const CtPair s1 = ct_salt(off, 1), s2 = ct_salt(off, 2);
      const int x = f[i * st];
      const CtPair p = ct_pmix(x == 0 ? 0u : (x - 1 == i ? 1u : 2u), s1);
      uint32_t indeg = 0;
      for (int j = 0; j < S; ++j) indeg += (f[j * st] - 1 == i && f[j * st] > 0) ? 1u : 0u;
      const CtPair d = ct_pmix(indeg, s2);
      aa[i] += p.a + d.a;
      ab[i] += p.b + d.b;
    } else if (kind == CT_BITMASK) {
      const CtPair s3 = ct_salt(off, 3), s4 = ct_salt(off, 4);
      uint32_t pop = 0, col = 0;
      for (int j = 0; j < S; ++j) {
        pop += (uint32_t)((f[i * st] >> j) & 1);
        col += (uint32_t)((f[j * st] >> i) & 1);
      }
      const CtPair p = ct_pmix(pop * 2u + (uint32_t)((f[i * st] >> i) & 1), s3);
      const CtPair c = ct_pmix(col, s4);
      aa[i] += p.a + c.a;
      ab[i] += p.b + c.b;
    } else {  // CT_PAIR: the diagonal, then row and column multisets
      const CtPair s5 = ct_salt(off, 5), s6 = ct_salt(off, 6), s7 = ct_salt(off, 7);
      const CtPair dg = ct_pmix((uint32_t)f[i * S + i], s5);
      aa[i] += dg.a;
      ab[i] += dg.b;
      for (int j = 0; j < S; ++j) {
        if (j == i) continue;
        const CtPair r = ct_pmix((uint32_t)f[i * S + j], s6);
        const CtPair c = ct_pmix((uint32_t)f[j * S + i], s7);
        aa[i] += r.a + c.a;
        ab[i] += r.b + c.b;
      }
    }
  }
  for (int m = t; m < M; m += G) {
    uint32_t w[WMAX];
    if (!ct_words<NW>(sp, v, m, w)) continue;
    const uint32_t cnt = (uint32_t)v[sp[CT_CNT] + m];
    const CtPair rec0 = ct_rec0<NW>(sp, w, cnt);
    for (int k = 0; k < NF; ++k) {
      const CtPair s = ct_salt(k, 8);
      const CtPair c{cnt * rt_mix32(rec0.a + s.a), cnt * rt_mix32(rec0.b + s.b)};
      const uint32_t val = (w[fd[4 * k]] >> fd[4 * k + 1]) & (uint32_t)fd[4 * k + 2];
      ct_scatter<NW>(aa, ab, c, val, fd[4 * k + 3], S);
    }
  }
}

// Refinement round r (salts offset by rr = 32 r), share t of G: each unit
// folds the neighbours' signatures sa/sb into its server, and each bag slot
// gives each endpoint of its record the fold of the OTHER endpoints'
// signatures, into aa/ab
template <int NW>
__device__ void ct_sig_round_part(const int* sp, const int* v, int rr, const uint32_t* sa,
                                  const uint32_t* sb, int t, int G, uint32_t* aa,
                                  uint32_t* ab) {
  constexpr int WMAX = NW ? NW : CT_MAX_WORDS;
  const int S = sp[CT_S], NF = sp[CT_NF], M = sp[CT_M];
  const int* fd = sp + sp[CT_OFF_FIELDS];
  const int* sg = sp + sp[CT_OFF_SIG];
  for (int u = t; u < sp[CT_NSIG] * S; u += G) {
    const int q = u / S, i = u - q * S;
    const int* row = sg + 3 * q;
    const int kind = row[0] & 15, off = row[1];
    const int* f = v + row[2];
    const int st = NW ? 1 : row[0] >> 4;
    if (kind == CT_PER_SERVER_VAL) {
      const int x = f[i * st];
      if (x > 0 && x - 1 != i) {
        const int tt = x - 1 < S - 1 ? x - 1 : S - 1;
        const CtPair e = ct_xmix(sa[tt], sb[tt], ct_salt(off, 9 + rr));
        aa[i] += e.a;
        ab[i] += e.b;
      }
    } else if (kind == CT_BITMASK) {
      const CtPair s = ct_salt(off, 10 + rr);
      for (int j = 0; j < S; ++j)
        if ((f[i * st] >> j) & 1) {
          const CtPair e = ct_xmix(sa[j], sb[j], s);
          aa[i] += e.a;
          ab[i] += e.b;
        }
    } else if (kind == CT_PAIR) {
      const CtPair s1 = ct_salt(off, 11 + rr), s2 = ct_salt(off, 12 + rr);
      for (int j = 0; j < S; ++j) {
        const uint32_t x = (uint32_t)f[i * S + j], y = (uint32_t)f[j * S + i];
        aa[i] += rt_mix32(x * RT_KA + (sa[j] ^ s1.a)) + rt_mix32(y * RT_KA + (sa[j] ^ s2.a));
        ab[i] += rt_mix32(x * RT_KB + (sb[j] ^ s1.b)) + rt_mix32(y * RT_KB + (sb[j] ^ s2.b));
      }
    }
  }
  // The 2-word path holds its fields' values and folds in arrays; the
  // general path gathers each fold twice instead (with arrays of
  // CT_MAX_FIELDS folds and the salts held in arrays, the -O3 build of the
  // canon faulted with an illegal address on the card; a -G build and the
  // host build did not)
  for (int m = t; m < M; m += G) {
    uint32_t w[WMAX];
    if (!ct_words<NW>(sp, v, m, w)) continue;
    const uint32_t cnt = (uint32_t)v[sp[CT_CNT] + m];
    const CtPair rec0 = ct_rec0<NW>(sp, w, cnt);
    CtPair osum{0u, 0u};
    if constexpr (NW != 0) {
      uint32_t val[CT_FAST_FIELDS];
      CtPair fold[CT_FAST_FIELDS];
      for (int k = 0; k < NF; ++k) {
        val[k] = (w[fd[4 * k]] >> fd[4 * k + 1]) & (uint32_t)fd[4 * k + 2];
        fold[k] = ct_gather_fold<NW>(sa, sb, val[k], fd[4 * k + 3], S, ct_salt(k, 13 + rr));
        osum.a += fold[k].a;
        osum.b += fold[k].b;
      }
      for (int k = 0; k < NF; ++k) {
        const CtPair s = ct_salt(k, 14 + rr);
        const CtPair c{cnt * rt_mix32(rec0.a + (osum.a - fold[k].a) + s.a),
                       cnt * rt_mix32(rec0.b + (osum.b - fold[k].b) + s.b)};
        ct_scatter<NW>(aa, ab, c, val[k], fd[4 * k + 3], S);
      }
    } else {
      for (int k = 0; k < NF; ++k) {
        const uint32_t val = (w[fd[4 * k]] >> fd[4 * k + 1]) & (uint32_t)fd[4 * k + 2];
        const CtPair f = ct_gather_fold<NW>(sa, sb, val, fd[4 * k + 3], S, ct_salt(k, 13 + rr));
        osum.a += f.a;
        osum.b += f.b;
      }
      for (int k = 0; k < NF; ++k) {
        const uint32_t val = (w[fd[4 * k]] >> fd[4 * k + 1]) & (uint32_t)fd[4 * k + 2];
        const CtPair f = ct_gather_fold<NW>(sa, sb, val, fd[4 * k + 3], S, ct_salt(k, 13 + rr));
        const CtPair s = ct_salt(k, 14 + rr);
        const CtPair c{cnt * rt_mix32(rec0.a + (osum.a - f.a) + s.a),
                       cnt * rt_mix32(rec0.b + (osum.b - f.b) + s.b)};
        ct_scatter<NW>(aa, ab, c, val, fd[4 * k + 3], S);
      }
    }
  }
}

// the S permutation-equivariant server signatures of the view v, computed
// by the group g (every member gets all S)
template <int NW, class Grp>
__device__ void ct_signatures(const int* sp, const int* v, uint64_t* sig, Grp& g) {
  const int S = sp[CT_S];
  uint32_t aa[CT_MAX_S], ab[CT_MAX_S], sa[CT_MAX_S], sb[CT_MAX_S];
  for (int i = 0; i < S; ++i) aa[i] = ab[i] = 0;
  g.each([&](int t, int G) { ct_sig_base_part<NW>(sp, v, t, G, aa, ab); });
  g.sum(aa, ab, S);
  for (int i = 0; i < S; ++i) {
    sa[i] = rt_mix32(aa[i]);
    sb[i] = rt_mix32(ab[i]);
  }
  for (int r = 0; r < sp[CT_ROUNDS]; ++r) {
    for (int i = 0; i < S; ++i) aa[i] = ab[i] = 0;
    g.each([&](int t, int G) { ct_sig_round_part<NW>(sp, v, 32 * r, sa, sb, t, G, aa, ab); });
    g.sum(aa, ab, S);
    for (int i = 0; i < S; ++i) {
      sa[i] = rt_mix32(sa[i] + rt_mix32(aa[i]));
      sb[i] = rt_mix32(sb[i] + rt_mix32(ab[i]));
    }
  }
  for (int i = 0; i < S; ++i) sig[i] = rt_combine(sa[i], sb[i]);
}

// the hash of v under sigma, computed by the group g
template <int NW, class Grp>
__device__ __forceinline__ uint64_t ct_hash(const int* sp, const int* v, const int* sigma,
                                            bool remap, Grp& g) {
  CtHashPart h{0u, 0u, 0u, 0u};
  g.each([&](int t, int G) { ct_hash_add(h, ct_hash_part<NW>(sp, v, sigma, remap, t, G)); });
  g.sum(h);
  return ct_hash_final(sp, h);
}

// std::next_permutation on n ints
__device__ __forceinline__ bool ct_next_perm(int* x, int n) {
  int i = n - 2;
  while (i >= 0 && x[i] >= x[i + 1]) --i;
  if (i >= 0) {
    int j = n - 1;
    while (x[j] <= x[i]) --j;
    const int t = x[i];
    x[i] = x[j];
    x[j] = t;
  }
  for (int a = i + 1, b = n - 1; a < b; ++a, --b) {
    const int t = x[a];
    x[a] = x[b];
    x[b] = t;
  }
  return i >= 0;
}

// the canonical fingerprint: min of ct_hash over the admissible
// permutations, computed by the group g (every member gets it)
template <int NW, class Grp>
__device__ uint64_t ct_canon(const int* sp, const int* v, Grp& g) {
  const int S = sp[CT_S];
  uint64_t sig[CT_MAX_S];
  ct_signatures<NW>(sp, v, sig, g);
  int inv[CT_MAX_S], gstart[CT_MAX_S], sigma[CT_MAX_S];
  for (int i = 0; i < S; ++i) inv[i] = i;
  for (int i = 1; i < S; ++i)  // stable insertion sort of the servers by signature
    for (int j = i; j > 0 && sig[inv[j - 1]] > sig[inv[j]]; --j) {
      const int t = inv[j];
      inv[j] = inv[j - 1];
      inv[j - 1] = t;
    }
  int ng = 0;
  for (int p = 0; p < S; ++p)
    if (p == 0 || sig[inv[p]] != sig[inv[p - 1]]) gstart[ng++] = p;
  uint64_t best = ~0ull;
  for (;;) {  // each group's servers start ascending: the first permutation
    for (int k = 0; k < S; ++k) sigma[inv[k]] = k;
    const uint64_t h = ct_hash<NW>(sp, v, sigma, true, g);
    best = h < best ? h : best;
    int q = ng - 1;  // the last tie group that has a next permutation
    for (; q >= 0; --q) {
      const int a = gstart[q], b = q + 1 < ng ? gstart[q + 1] : S;
      if (ct_next_perm(inv + a, b - a)) break;
    }
    if (q < 0) break;
  }
  return best;
}

// the raw key: the hash under the identity without the value remap
template <int NW, class Grp>
__device__ __forceinline__ uint64_t ct_raw(const int* sp, const int* v, Grp& g) {
  const int ident[CT_MAX_S] = {0, 1, 2, 3, 4, 5, 6, 7};
  return ct_hash<NW>(sp, v, ident, false, g);
}
