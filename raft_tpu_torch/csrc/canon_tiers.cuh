// canon_tiers.cuh — device code of the canonical fingerprint of layouts with
// five or more servers: the server signatures and the min of the permuted
// view's hash over the signature-admissible permutations.
//
// Ports raft_tpu/ops/symmetry.py: _signatures (:581, with _scatter_by_server
// :747 and _gather_sig_fold :769), _hash_dyn (:944, with _dyn_outpos :914
// and _bag_streams :823), and the admissible set that _tier_pre (:1081),
// _tier3_local (:1143) and _tier3_full (:1193) reach by three routes and
// _masked_min(view, sig) (:1017) by brute force: the permutations that sort
// the S signatures ascending as unsigned u64. Here one thread computes it
// directly for one state: sort the signatures, split the sorted order into
// tie groups, and enumerate the products of per-group permutations composed
// with the sort (1 permutation for totally ordered signatures, S! for the
// all-tied states near Init), hashing each with positional salts computed
// from the permutation (no P x K tables).
//
// Everything is plain C++ once CUDA's qualifiers are defined away, so the
// same code also compiles for the host (tests/test_torch_canon_tiers.py).
//
// The layout arrives as an int32 spec vector (ops/symmetry.py
// Canonicalizer.tier_spec): the CT_* header, then per message server field
// (word, shift, mask), per signature field (kind, offset, size) and per
// non-bag view lane (lane, c0, s1, m1, s2, m2): that lane's hash position
// under a permutation sigma is c0 + sigma[s1] * m1 + sigma[s2] * m2 (a
// negative s is no term), in group order: plain lanes, server-valued lanes,
// server bitmasks.
#pragma once

#include "common.cuh"

#define CT_MAX_S 8  // ops/symmetry.py MAX_TIER_SERVERS
#define CT_MAX_FIELDS 4
#define CT_EMPTY (1 << 30)
#define CT_PA 0x9E3779B9u
#define CT_PB 0x85EBCA77u

// header of the spec vector (ops/symmetry.py TIER_HEADER, in this order)
enum {
  CT_S, CT_VL, CT_K, CT_NPLAIN, CT_NVAL, CT_NBM, CT_HI, CT_LO, CT_CNT, CT_M,
  CT_NF, CT_NSIG, CT_ROUNDS, CT_KA, CT_KB, CT_SEEDED, CT_SEEDA, CT_SEEDB,
  CT_SX0, CT_SX1, CT_SX2, CT_OFF_FIELDS, CT_OFF_SIG, CT_OFF_LANES, CT_LEN, CT_HDR
};
// signature field kinds (SIG_KINDS)
enum { CT_PER_SERVER, CT_PER_SERVER_VAL, CT_BITMASK, CT_PAIR };

struct CtPair {
  uint32_t a, b;
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

// hash of the view v under sigma (old server i -> new index sigma[i]);
// remap=false with the identity is the raw key (no value remap at all)
__device__ uint64_t ct_hash(const int* sp, const int* v, const int* sigma, bool remap) {
  const int S = sp[CT_S], K = sp[CT_K], n_plain = sp[CT_NPLAIN], n_val = sp[CT_NVAL];
  const int* ln = sp + sp[CT_OFF_LANES];
  const bool seeded = sp[CT_SEEDED] != 0;
  const uint32_t seed_a = (uint32_t)sp[CT_SEEDA], seed_b = (uint32_t)sp[CT_SEEDB];
  uint32_t na = 0, nb = 0;
  for (int j = 0; j < K; ++j) {
    const int* d = ln + 6 * j;
    const int pos = d[1] + (d[2] >= 0 ? sigma[d[2]] * d[3] : 0) +
                    (d[4] >= 0 ? sigma[d[4]] * d[5] : 0);
    const int xi = v[d[0]];
    uint32_t x = (uint32_t)xi;
    if (remap && j >= n_plain) {
      if (j < n_plain + n_val) {  // 0 = Nil, i + 1 = server i
        x = (xi >= 1 && xi <= S) ? (uint32_t)(sigma[xi - 1] + 1) : 0u;
      } else {  // bitmask: bit q moves to bit sigma[q]
        x = 0;
        for (int q = 0; q < S; ++q) x |= (uint32_t)((xi >> q) & 1) << sigma[q];
      }
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
  na ^= (uint32_t)sp[CT_KA];
  nb ^= (uint32_t)sp[CT_KB];
  // the bag: occupied slots hashed position-free and ADDED (mod 2^32)
  const int* fd = sp + sp[CT_OFF_FIELDS];
  const int NF = sp[CT_NF];
  const CtPair w0 = ct_salt(0, 20), w1 = ct_salt(1, 20), w2 = ct_salt(2, 20);
  const uint32_t sx0 = (uint32_t)sp[CT_SX0], sx1 = (uint32_t)sp[CT_SX1], sx2 = (uint32_t)sp[CT_SX2];
  uint32_t ba = 0, bb = 0;
  for (int m = 0; m < sp[CT_M]; ++m) {
    const int hi = v[sp[CT_HI] + m];
    if (hi == CT_EMPTY) continue;
    uint32_t w[2] = {(uint32_t)v[sp[CT_LO] + m], (uint32_t)hi};  // packer words
    if (remap) {
      const uint32_t orig[2] = {w[0], w[1]};
      for (int f = 0; f < NF; ++f) {
        const int word = fd[3 * f], shift = fd[3 * f + 1];
        const uint32_t mask = (uint32_t)fd[3 * f + 2];
        const uint32_t val = (orig[word] >> shift) & mask;
        const uint32_t nv = val < (uint32_t)S ? (uint32_t)sigma[val] : 0u;
        w[word] = (w[word] & ~(mask << shift)) | (nv << shift);
      }
    }
    const uint32_t h0 = w[1] ^ sx0, h1 = w[0] ^ sx1, c = (uint32_t)v[sp[CT_CNT] + m] ^ sx2;
    const uint32_t a = rt_mix32(h0 * RT_KA + w0.a) ^ rt_mix32(h1 * RT_KA + w1.a) ^
                       rt_mix32(c * RT_KA + w2.a);
    const uint32_t b = rt_mix32(h0 * RT_KB + w0.b) ^ rt_mix32(h1 * RT_KB + w1.b) ^
                       rt_mix32(c * RT_KB + w2.b);
    ba += rt_mix32(a + RT_KB);
    bb += rt_mix32(b + RT_KA);
  }
  return rt_combine(na ^ ba, nb ^ bb);
}

// add c onto the server a message field value names
__device__ __forceinline__ void ct_scatter(uint32_t* acc_a, uint32_t* acc_b, CtPair c,
                                           uint32_t val, int S) {
  if (val < (uint32_t)S) {
    acc_a[val] += c.a;
    acc_b[val] += c.b;
  }
}

// the signature of the server a message field value names, folded under salt
__device__ __forceinline__ CtPair ct_gather_fold(const uint32_t* sa, const uint32_t* sb,
                                                 uint32_t val, int S, CtPair salt) {
  const int t = val < (uint32_t)S ? (int)val : S - 1;
  return ct_xmix(sa[t], sb[t], salt);
}

// the record hash of a message slot with its server fields zeroed (rec0)
__device__ __forceinline__ CtPair ct_rec0(const int* sp, const int* v, int m) {
  const int* fd = sp + sp[CT_OFF_FIELDS];
  uint32_t w[2] = {(uint32_t)v[sp[CT_LO] + m], (uint32_t)v[sp[CT_HI] + m]};
  for (int f = 0; f < sp[CT_NF]; ++f)
    w[fd[3 * f]] &= ~((uint32_t)fd[3 * f + 2] << fd[3 * f + 1]);
  const uint32_t x[3] = {w[1], w[0], (uint32_t)v[sp[CT_CNT] + m]};
  uint32_t ra = 0, rb = 0;
  for (int i = 0; i < 3; ++i) {
    const CtPair p = ct_pmix(x[i], ct_salt(i, 21));
    ra ^= p.a;
    rb ^= p.b;
  }
  return CtPair{rt_mix32(ra), rt_mix32(rb)};
}

// the S permutation-equivariant server signatures of the view v
__device__ void ct_signatures(const int* sp, const int* v, uint64_t* sig) {
  const int S = sp[CT_S], NF = sp[CT_NF], M = sp[CT_M];
  const int* fd = sp + sp[CT_OFF_FIELDS];
  const int* sg = sp + sp[CT_OFF_SIG];
  uint32_t aa[CT_MAX_S], ab[CT_MAX_S], sa[CT_MAX_S], sb[CT_MAX_S];
  for (int i = 0; i < S; ++i) aa[i] = ab[i] = 0;

  // round 0: each server's invariant content
  for (int q = 0; q < sp[CT_NSIG]; ++q) {
    const int kind = sg[3 * q], off = sg[3 * q + 1], size = sg[3 * q + 2];
    const int* f = v + off;
    if (kind == CT_PER_SERVER) {
      const int rest = size / S;
      const CtPair s = ct_salt(off, 0);
      for (int i = 0; i < S; ++i) {
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
      }
    } else if (kind == CT_PER_SERVER_VAL) {  // 0 = Nil, i + 1 = server i
      const CtPair s1 = ct_salt(off, 1), s2 = ct_salt(off, 2);
      for (int i = 0; i < S; ++i) {
        const int x = f[i];
        const CtPair p = ct_pmix(x == 0 ? 0u : (x - 1 == i ? 1u : 2u), s1);
        uint32_t indeg = 0;
        for (int j = 0; j < S; ++j) indeg += (f[j] - 1 == i && f[j] > 0) ? 1u : 0u;
        const CtPair d = ct_pmix(indeg, s2);
        aa[i] += p.a + d.a;
        ab[i] += p.b + d.b;
      }
    } else if (kind == CT_BITMASK) {
      const CtPair s3 = ct_salt(off, 3), s4 = ct_salt(off, 4);
      for (int i = 0; i < S; ++i) {
        uint32_t pop = 0, col = 0;
        for (int j = 0; j < S; ++j) {
          pop += (uint32_t)((f[i] >> j) & 1);
          col += (uint32_t)((f[j] >> i) & 1);
        }
        const CtPair p = ct_pmix(pop * 2u + (uint32_t)((f[i] >> i) & 1), s3);
        const CtPair c = ct_pmix(col, s4);
        aa[i] += p.a + c.a;
        ab[i] += p.b + c.b;
      }
    } else {  // CT_PAIR: the diagonal, then row and column multisets
      const CtPair s5 = ct_salt(off, 5), s6 = ct_salt(off, 6), s7 = ct_salt(off, 7);
      for (int i = 0; i < S; ++i) {
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
  }
  // messages, round 0: each record (server fields zeroed) folded into the
  // servers it references, times its count
  for (int m = 0; m < M; ++m) {
    if (v[sp[CT_HI] + m] == CT_EMPTY) continue;
    const uint32_t w[2] = {(uint32_t)v[sp[CT_LO] + m], (uint32_t)v[sp[CT_HI] + m]};
    const uint32_t cnt = (uint32_t)v[sp[CT_CNT] + m];
    const CtPair rec0 = ct_rec0(sp, v, m);
    for (int k = 0; k < NF; ++k) {
      const CtPair s = ct_salt(k, 8);
      const CtPair c{cnt * rt_mix32(rec0.a + s.a), cnt * rt_mix32(rec0.b + s.b)};
      const uint32_t val = (w[fd[3 * k]] >> fd[3 * k + 1]) & (uint32_t)fd[3 * k + 2];
      ct_scatter(aa, ab, c, val, S);
    }
  }
  for (int i = 0; i < S; ++i) {
    sa[i] = rt_mix32(aa[i]);
    sb[i] = rt_mix32(ab[i]);
  }

  // refinement: fold the neighbours' signatures (round r's salts offset by 32 r)
  for (int r = 0; r < sp[CT_ROUNDS]; ++r) {
    const int rr = 32 * r;
    for (int i = 0; i < S; ++i) aa[i] = ab[i] = 0;
    for (int q = 0; q < sp[CT_NSIG]; ++q) {
      const int kind = sg[3 * q], off = sg[3 * q + 1];
      const int* f = v + off;
      if (kind == CT_PER_SERVER_VAL) {
        const CtPair s = ct_salt(off, 9 + rr);
        for (int i = 0; i < S; ++i) {
          const int x = f[i];
          if (x > 0 && x - 1 != i) {
            const int t = x - 1 < S - 1 ? x - 1 : S - 1;
            const CtPair e = ct_xmix(sa[t], sb[t], s);
            aa[i] += e.a;
            ab[i] += e.b;
          }
        }
      } else if (kind == CT_BITMASK) {
        const CtPair s = ct_salt(off, 10 + rr);
        for (int i = 0; i < S; ++i)
          for (int j = 0; j < S; ++j)
            if ((f[i] >> j) & 1) {
              const CtPair e = ct_xmix(sa[j], sb[j], s);
              aa[i] += e.a;
              ab[i] += e.b;
            }
      } else if (kind == CT_PAIR) {
        const CtPair s1 = ct_salt(off, 11 + rr), s2 = ct_salt(off, 12 + rr);
        for (int i = 0; i < S; ++i)
          for (int j = 0; j < S; ++j) {
            const uint32_t x = (uint32_t)f[i * S + j], y = (uint32_t)f[j * S + i];
            aa[i] += rt_mix32(x * RT_KA + (sa[j] ^ s1.a)) + rt_mix32(y * RT_KA + (sa[j] ^ s2.a));
            ab[i] += rt_mix32(x * RT_KB + (sb[j] ^ s1.b)) + rt_mix32(y * RT_KB + (sb[j] ^ s2.b));
          }
      }
    }
    // per record: each endpoint gets the fold of the OTHER endpoints' signatures
    for (int m = 0; m < M; ++m) {
      if (v[sp[CT_HI] + m] == CT_EMPTY) continue;
      const uint32_t w[2] = {(uint32_t)v[sp[CT_LO] + m], (uint32_t)v[sp[CT_HI] + m]};
      const uint32_t cnt = (uint32_t)v[sp[CT_CNT] + m];
      const CtPair rec0 = ct_rec0(sp, v, m);
      uint32_t val[CT_MAX_FIELDS];
      CtPair fold[CT_MAX_FIELDS];
      CtPair osum{0u, 0u};
      for (int k = 0; k < NF; ++k) {
        val[k] = (w[fd[3 * k]] >> fd[3 * k + 1]) & (uint32_t)fd[3 * k + 2];
        fold[k] = ct_gather_fold(sa, sb, val[k], S, ct_salt(k, 13 + rr));
        osum.a += fold[k].a;
        osum.b += fold[k].b;
      }
      for (int k = 0; k < NF; ++k) {
        const CtPair s = ct_salt(k, 14 + rr);
        const CtPair c{cnt * rt_mix32(rec0.a + (osum.a - fold[k].a) + s.a),
                       cnt * rt_mix32(rec0.b + (osum.b - fold[k].b) + s.b)};
        ct_scatter(aa, ab, c, val[k], S);
      }
    }
    for (int i = 0; i < S; ++i) {
      sa[i] = rt_mix32(sa[i] + rt_mix32(aa[i]));
      sb[i] = rt_mix32(sb[i] + rt_mix32(ab[i]));
    }
  }
  for (int i = 0; i < S; ++i) sig[i] = rt_combine(sa[i], sb[i]);
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

// the canonical fingerprint: min of ct_hash over the admissible permutations
__device__ uint64_t ct_canon(const int* sp, const int* v) {
  const int S = sp[CT_S];
  uint64_t sig[CT_MAX_S];
  ct_signatures(sp, v, sig);
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
    const uint64_t h = ct_hash(sp, v, sigma, true);
    best = h < best ? h : best;
    int g = ng - 1;
    for (; g >= 0; --g) {
      const int a = gstart[g], b = g + 1 < ng ? gstart[g + 1] : S;
      if (ct_next_perm(inv + a, b - a)) break;
    }
    if (g < 0) break;
  }
  return best;
}

__device__ __forceinline__ uint64_t ct_raw(const int* sp, const int* v) {
  const int ident[CT_MAX_S] = {0, 1, 2, 3, 4, 5, 6, 7};
  return ct_hash(sp, v, ident, false);
}
