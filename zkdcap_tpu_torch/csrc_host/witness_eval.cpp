// Witness-tape evaluator: replays the recorded big-integer dataflow DAG
// (zkdcap_tpu_torch/witness/tracer.py) natively, ~50-100 ns/node vs ~0.5 us
// in the Python evaluator (WitnessTape.replay_py). A copy of the JAX
// package's native/witness_eval.cpp, built by zkdcap_tpu_torch/_build.py
// with g++ (without -fopenmp) into build/host/ at first use; per proof, the
// circuit's witness cells are recomputed here instead of re-running the
// Python chip stack.
//
// Value model: fixed-width sign-magnitude integers, LIMBS x u64 (768
// bits) — circuit shadow values stay under ~2^510 (field products before
// reduction); any overflow aborts with an error code, which the binding
// raises. Division uses Knuth-style long division on 32-bit digits with a
// per-modulus Barrett cache for the hot `mod R` / `mod p` reductions.
//
// Python floor semantics throughout (floordiv/mod/rshift on negatives).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <unordered_map>
#include <vector>

namespace {

constexpr int LIMBS = 12;  // 768-bit magnitudes

struct Val {
  uint64_t d[LIMBS];
  int32_t n;    // significant limbs (0 => value 0)
  int32_t neg;  // sign (only meaningful when n > 0)
};

inline void set_zero(Val &v) {
  v.n = 0;
  v.neg = 0;
  std::memset(v.d, 0, sizeof(v.d));
}

inline void set_u64(Val &v, uint64_t x) {
  std::memset(v.d, 0, sizeof(v.d));
  v.d[0] = x;
  v.n = x ? 1 : 0;
  v.neg = 0;
}

inline void trim(Val &v) {
  while (v.n > 0 && v.d[v.n - 1] == 0) v.n--;
  if (v.n == 0) v.neg = 0;
}

inline int cmp_mag(const Val &a, const Val &b) {
  if (a.n != b.n) return a.n < b.n ? -1 : 1;
  for (int i = a.n - 1; i >= 0; i--)
    if (a.d[i] != b.d[i]) return a.d[i] < b.d[i] ? -1 : 1;
  return 0;
}

// |out| = |a| + |b|; returns false on overflow
inline bool add_mag(const Val &a, const Val &b, Val &out) {
  unsigned __int128 carry = 0;
  int n = a.n > b.n ? a.n : b.n;
  for (int i = 0; i < n; i++) {
    unsigned __int128 s = carry;
    if (i < a.n) s += a.d[i];
    if (i < b.n) s += b.d[i];
    out.d[i] = (uint64_t)s;
    carry = s >> 64;
  }
  if (carry) {
    if (n >= LIMBS) return false;
    out.d[n++] = (uint64_t)carry;
  }
  for (int i = n; i < LIMBS; i++) out.d[i] = 0;
  out.n = n;
  return true;
}

// |out| = |a| - |b|, requires |a| >= |b|
inline void sub_mag(const Val &a, const Val &b, Val &out) {
  int64_t borrow = 0;
  for (int i = 0; i < a.n; i++) {
    unsigned __int128 bv = (i < b.n ? b.d[i] : 0);
    unsigned __int128 av = a.d[i];
    uint64_t r;
    if (av >= bv + (borrow ? 1 : 0)) {
      r = (uint64_t)(av - bv - (borrow ? 1 : 0));
      borrow = 0;
    } else {
      r = (uint64_t)((((unsigned __int128)1 << 64) + av) - bv - (borrow ? 1 : 0));
      borrow = 1;
    }
    out.d[i] = r;
  }
  for (int i = a.n; i < LIMBS; i++) out.d[i] = 0;
  out.n = a.n;
  trim(out);
}

inline bool add_signed(const Val &a, const Val &b, Val &out) {
  if (a.neg == b.neg || a.n == 0 || b.n == 0) {
    int neg = a.n ? a.neg : b.neg;
    if (!add_mag(a, b, out)) return false;
    out.neg = out.n ? neg : 0;
    return true;
  }
  int c = cmp_mag(a, b);
  if (c == 0) {
    set_zero(out);
    return true;
  }
  if (c > 0) {
    int neg = a.neg;
    sub_mag(a, b, out);
    out.neg = out.n ? neg : 0;
  } else {
    int neg = b.neg;
    sub_mag(b, a, out);
    out.neg = out.n ? neg : 0;
  }
  return true;
}

inline bool sub_signed(const Val &a, const Val &b, Val &out) {
  Val nb = b;
  if (nb.n) nb.neg = !nb.neg;
  return add_signed(a, nb, out);
}

inline bool mul_mag(const Val &a, const Val &b, Val &out) {
  if (a.n == 0 || b.n == 0) {
    set_zero(out);
    return true;
  }
  if (a.n + b.n > LIMBS + 1) return false;
  uint64_t tmp[2 * LIMBS] = {0};
  for (int i = 0; i < a.n; i++) {
    unsigned __int128 carry = 0;
    uint64_t ai = a.d[i];
    for (int j = 0; j < b.n; j++) {
      unsigned __int128 cur = (unsigned __int128)ai * b.d[j] + tmp[i + j] + carry;
      tmp[i + j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    tmp[i + b.n] += (uint64_t)carry;
  }
  int n = a.n + b.n;
  while (n > 0 && tmp[n - 1] == 0) n--;
  if (n > LIMBS) return false;
  std::memset(out.d, 0, sizeof(out.d));
  std::memcpy(out.d, tmp, n * 8);
  out.n = n;
  out.neg = (a.neg != b.neg);
  return true;
}

inline int bitlen(const Val &a) {
  if (a.n == 0) return 0;
  uint64_t top = a.d[a.n - 1];
  return 64 * (a.n - 1) + (64 - __builtin_clzll(top));
}

inline bool shl_mag(const Val &a, uint64_t k, Val &out) {
  if (a.n == 0) {
    set_zero(out);
    return true;
  }
  uint64_t limb_sh = k / 64, bit_sh = k % 64;
  if (a.n + limb_sh + 1 > (uint64_t)LIMBS + 1) return false;
  uint64_t tmp[LIMBS + 1] = {0};
  for (int i = a.n - 1; i >= 0; i--) {
    uint64_t lo = a.d[i] << bit_sh;
    uint64_t hi = bit_sh ? (a.d[i] >> (64 - bit_sh)) : 0;
    uint64_t pos = i + limb_sh;
    if (pos + 1 <= (uint64_t)LIMBS) tmp[pos + 1] |= hi;
    else if (hi) return false;
    if (pos <= (uint64_t)LIMBS) tmp[pos] |= lo;
    else if (lo) return false;
  }
  if (tmp[LIMBS]) return false;
  std::memcpy(out.d, tmp, LIMBS * 8);
  out.n = a.n + (int)limb_sh + 1;
  if (out.n > LIMBS) out.n = LIMBS;
  out.neg = a.neg;
  trim(out);
  return true;
}

// magnitude >> k, returns whether any 1-bits were shifted out
inline bool shr_mag(const Val &a, uint64_t k, Val &out, bool &lost) {
  lost = false;
  uint64_t limb_sh = k / 64, bit_sh = k % 64;
  if (limb_sh >= (uint64_t)a.n) {
    lost = a.n > 0;
    int neg = a.neg;
    set_zero(out);
    out.neg = neg;  // caller adjusts
    return true;
  }
  for (uint64_t i = 0; i < limb_sh; i++)
    if (a.d[i]) lost = true;
  if (bit_sh && (a.d[limb_sh] & ((1ULL << bit_sh) - 1))) lost = true;
  Val tmp;
  std::memset(tmp.d, 0, sizeof(tmp.d));
  int n = a.n - (int)limb_sh;
  for (int i = 0; i < n; i++) {
    uint64_t lo = a.d[i + limb_sh] >> bit_sh;
    uint64_t hi = (bit_sh && i + 1 < n) ? (a.d[i + limb_sh + 1] << (64 - bit_sh)) : 0;
    tmp.d[i] = lo | hi;
  }
  tmp.n = n;
  tmp.neg = a.neg;
  trim(tmp);
  out = tmp;
  return true;
}

// unsigned long division on 32-bit digits: q = a / b, r = a % b
bool divmod_mag(const Val &a, const Val &b, Val &q, Val &r) {
  if (b.n == 0) return false;
  if (cmp_mag(a, b) < 0) {
    q = a;  // placeholder
    set_zero(q);
    r = a;
    r.neg = 0;
    return true;
  }
  // to 32-bit digit vectors
  auto to32 = [](const Val &v, std::vector<uint32_t> &out32) {
    out32.resize(v.n * 2);
    for (int i = 0; i < v.n; i++) {
      out32[2 * i] = (uint32_t)v.d[i];
      out32[2 * i + 1] = (uint32_t)(v.d[i] >> 32);
    }
    while (!out32.empty() && out32.back() == 0) out32.pop_back();
  };
  std::vector<uint32_t> u, v;
  to32(a, u);
  to32(b, v);
  int n = (int)v.size(), m = (int)u.size() - n;
  std::vector<uint32_t> quo(m + 1, 0);
  if (n == 1) {
    uint64_t d = v[0], rem = 0;
    for (int i = (int)u.size() - 1; i >= 0; i--) {
      uint64_t cur = (rem << 32) | u[i];
      uint64_t qd = cur / d;
      rem = cur % d;
      if (i <= m) quo[i] = (uint32_t)qd;
    }
    set_zero(q);
    for (size_t i = 0; i < quo.size(); i++)
      q.d[i / 2] |= (uint64_t)quo[i] << (32 * (i % 2));
    q.n = ((int)quo.size() + 1) / 2;
    trim(q);
    set_u64(r, rem);
    return true;
  }
  // Knuth D: normalize
  int s = __builtin_clz(v[n - 1]);
  std::vector<uint32_t> vn(n), un(u.size() + 1, 0);
  for (int i = n - 1; i > 0; i--)
    vn[i] = (v[i] << s) | (s ? (uint32_t)((uint64_t)v[i - 1] >> (32 - s)) : 0);
  vn[0] = v[0] << s;
  un[u.size()] = s ? (uint32_t)((uint64_t)u[u.size() - 1] >> (32 - s)) : 0;
  for (int i = (int)u.size() - 1; i > 0; i--)
    un[i] = (u[i] << s) | (s ? (uint32_t)((uint64_t)u[i - 1] >> (32 - s)) : 0);
  un[0] = u[0] << s;
  for (int j = m; j >= 0; j--) {
    uint64_t top = ((uint64_t)un[j + n] << 32) | un[j + n - 1];
    uint64_t qhat = top / vn[n - 1];
    uint64_t rhat = top % vn[n - 1];
    while (qhat >= (1ULL << 32) ||
           (unsigned __int128)qhat * vn[n - 2] >
               (((unsigned __int128)rhat << 32) | un[j + n - 2])) {
      qhat--;
      rhat += vn[n - 1];
      if (rhat >= (1ULL << 32)) break;
    }
    // multiply-subtract
    int64_t borrow = 0;
    uint64_t carry = 0;
    for (int i = 0; i < n; i++) {
      uint64_t p = qhat * vn[i] + carry;
      carry = p >> 32;
      int64_t t = (int64_t)un[i + j] - (int64_t)(uint32_t)p - borrow;
      un[i + j] = (uint32_t)t;
      borrow = (t < 0) ? 1 : 0;
    }
    int64_t t = (int64_t)un[j + n] - (int64_t)carry - borrow;
    un[j + n] = (uint32_t)t;
    if (t < 0) {
      // add back
      qhat--;
      uint64_t c2 = 0;
      for (int i = 0; i < n; i++) {
        uint64_t t2 = (uint64_t)un[i + j] + vn[i] + c2;
        un[i + j] = (uint32_t)t2;
        c2 = t2 >> 32;
      }
      un[j + n] = (uint32_t)((uint64_t)un[j + n] + c2);
    }
    quo[j] = (uint32_t)qhat;
  }
  set_zero(q);
  for (size_t i = 0; i < quo.size() && i / 2 < (size_t)LIMBS; i++)
    q.d[i / 2] |= (uint64_t)quo[i] << (32 * (i % 2));
  q.n = ((int)quo.size() + 1) / 2;
  if (q.n > LIMBS) return false;
  trim(q);
  // denormalize remainder
  set_zero(r);
  for (int i = 0; i < n; i++) {
    uint32_t lo = (un[i] >> s);
    uint32_t hi = (s && i + 1 < (int)un.size()) ? (uint32_t)((uint64_t)un[i + 1] << (32 - s)) : 0;
    uint32_t digit = lo | hi;
    r.d[i / 2] |= (uint64_t)digit << (32 * (i % 2));
  }
  r.n = (n + 1) / 2;
  trim(r);
  return true;
}

// python floor divmod on signed values
bool divmod_floor(const Val &a, const Val &b, Val &q, Val &r) {
  if (b.n == 0) return false;
  Val qm, rm;
  if (!divmod_mag(a, b, qm, rm)) return false;
  bool signs_differ = (a.n && b.n && a.neg != b.neg);
  if (!signs_differ) {
    q = qm;
    q.neg = 0;
    r = rm;
    r.neg = b.n ? b.neg && r.n ? 1 : 0 : 0;
    if (r.n) r.neg = b.neg;  // remainder takes divisor sign (same-sign case: 0 or b.neg)
    if (!r.n) r.neg = 0;
    return true;
  }
  if (rm.n == 0) {
    q = qm;
    q.neg = q.n ? 1 : 0;
    set_zero(r);
    return true;
  }
  // q = -(qm + 1), r = |b| - rm with divisor sign
  Val one;
  set_u64(one, 1);
  if (!add_mag(qm, one, q)) return false;
  q.neg = 1;
  Val bb = b;
  bb.neg = 0;
  sub_mag(bb, rm, r);
  r.neg = b.neg && r.n ? 1 : 0;
  if (r.n) r.neg = b.neg;
  if (!r.n) r.neg = 0;
  return true;
}

struct Barrett {
  Val m;    // modulus (positive)
  Val mu;   // floor(4^k / m)
  int k2;   // 2*k bits
};

// x mod m for 0 <= x < 4^k using Barrett; x may be any nonneg < 2^(k2) bound
inline bool barrett_mod(const Val &x, const Barrett &B, Val &r) {
  // q = (x * mu) >> k2; r = x - q*m; while (r >= m) r -= m;
  Val t, q;
  if (!mul_mag(x, B.mu, t)) return false;
  bool lost;
  Val qs;
  if (!shr_mag(t, B.k2, qs, lost)) return false;
  qs.neg = 0;
  Val qm;
  if (!mul_mag(qs, B.m, qm)) return false;
  qm.neg = 0;
  Val xr = x;
  xr.neg = 0;
  sub_mag(xr, qm, r);
  r.neg = 0;
  int guard = 0;
  while (cmp_mag(r, B.m) >= 0) {
    Val nr;
    sub_mag(r, B.m, nr);
    r = nr;
    if (++guard > 4) return false;
  }
  return true;
}

inline uint64_t small_u64(const Val &v, bool &ok) {
  if (v.n > 1 || v.neg) {
    ok = false;
    return 0;
  }
  ok = true;
  return v.n ? v.d[0] : 0;
}

}  // namespace

extern "C" {

// returns 0 on success; nonzero = error (fallback to python)
int witness_eval(int64_t n_nodes, const int64_t *op, const int64_t *aa,
                 const int64_t *bb, const int64_t *cc, int64_t n_pool,
                 const uint64_t *pool_limbs, const int32_t *pool_n,
                 const int32_t *pool_neg, int64_t n_tables,
                 const int64_t *tbl_off, const int64_t *tbl_data,
                 int64_t n_inputs, const uint64_t *in_limbs,
                 const int32_t *in_n, const int32_t *in_neg, int64_t n_cells,
                 const int64_t *cell_nodes, uint8_t *out) {
  std::vector<Val> vals((size_t)n_nodes);
  std::vector<Val> pool((size_t)n_pool);
  for (int64_t i = 0; i < n_pool; i++) {
    std::memcpy(pool[i].d, pool_limbs + i * LIMBS, LIMBS * 8);
    pool[i].n = pool_n[i];
    pool[i].neg = pool_neg[i];
  }
  std::vector<Val> inputs((size_t)n_inputs);
  for (int64_t i = 0; i < n_inputs; i++) {
    std::memcpy(inputs[i].d, in_limbs + i * LIMBS, LIMBS * 8);
    inputs[i].n = in_n[i];
    inputs[i].neg = in_neg[i];
  }
  // Barrett reducers for pooled moduli. Populated in a single-threaded
  // pre-pass over the tape so the map is READ-ONLY during evaluation and
  // the level-parallel path below can share it without locks.
  std::unordered_map<int64_t, Barrett> bcache;  // pool idx -> barrett

  auto make_barrett = [&](int64_t pool_idx) -> const Barrett * {
    auto it = bcache.find(pool_idx);
    if (it != bcache.end()) return &it->second;
    const Val &m = pool[pool_idx];
    if (m.n == 0 || m.neg) return nullptr;
    Barrett B;
    B.m = m;
    int k = bitlen(m);
    B.k2 = 2 * k;
    // mu = floor(2^(2k) / m)
    Val pow2;
    set_u64(pow2, 1);
    Val shifted;
    if (!shl_mag(pow2, B.k2, shifted)) return nullptr;
    Val q, r;
    if (!divmod_mag(shifted, m, q, r)) return nullptr;
    B.mu = q;
    auto res = bcache.emplace(pool_idx, B);
    return &res.first->second;
  };
  for (int64_t i = 0; i < n_nodes; i++) {
    if (op[i] == 5 && bb[i] < 0)
      make_barrett(-bb[i] - 1);
    else if (op[i] == 12 && cc[i] < 0)
      make_barrett(-cc[i] - 1);
  }
  auto find_barrett = [&](int64_t pool_idx) -> const Barrett * {
    auto it = bcache.find(pool_idx);
    return it == bcache.end() ? nullptr : &it->second;
  };

#define ARG(x, dst)                        \
  const Val *dst;                          \
  if ((x) >= 0)                            \
    dst = &vals[(x)];                      \
  else                                     \
    dst = &pool[-(x)-1];

  auto eval_node = [&](int64_t i) -> int {
    Val &o = vals[i];
    int64_t opc = op[i];
    switch (opc) {
      case 0: {  // INPUT
        if (aa[i] < 0 || aa[i] >= n_inputs) return 2;
        o = inputs[aa[i]];
        break;
      }
      case 19: {  // CONST
        ARG(aa[i], pa);
        o = *pa;
        break;
      }
      case 1: {  // ADD
        ARG(aa[i], pa);
        ARG(bb[i], pb);
        if (!add_signed(*pa, *pb, o)) return 3;
        break;
      }
      case 2: {  // SUB
        ARG(aa[i], pa);
        ARG(bb[i], pb);
        if (!sub_signed(*pa, *pb, o)) return 3;
        break;
      }
      case 3: {  // MUL
        ARG(aa[i], pa);
        ARG(bb[i], pb);
        if (!mul_mag(*pa, *pb, o)) return 3;
        break;
      }
      case 4:    // FLOORDIV
      case 5: {  // MOD
        ARG(aa[i], pa);
        ARG(bb[i], pb);
        // fast path: pooled positive divisor, nonneg dividend -> Barrett
        if (opc == 5 && bb[i] < 0 && !pa->neg && pb->n && !pb->neg) {
          const Barrett *B = find_barrett(-bb[i] - 1);
          if (B && bitlen(*pa) <= B->k2) {
            if (!barrett_mod(*pa, *B, o)) return 3;
            break;
          }
        }
        {
          Val q, r;
          if (!divmod_floor(*pa, *pb, q, r)) return 4;
          o = (opc == 4) ? q : r;
        }
        break;
      }
      case 6: {  // LSHIFT
        ARG(aa[i], pa);
        ARG(bb[i], pb);
        bool ok;
        uint64_t k = small_u64(*pb, ok);
        if (!ok) return 5;
        if (!shl_mag(*pa, k, o)) return 3;
        break;
      }
      case 7: {  // RSHIFT (floor)
        ARG(aa[i], pa);
        ARG(bb[i], pb);
        bool ok;
        uint64_t k = small_u64(*pb, ok);
        if (!ok) return 5;
        bool lost;
        Val t;
        if (!shr_mag(*pa, k, t, lost)) return 3;
        if (pa->neg && lost) {
          Val one;
          set_u64(one, 1);
          Val t2;
          t.neg = 0;
          if (!add_mag(t, one, t2)) return 3;
          t2.neg = 1;
          t = t2;
        }
        t.neg = t.n ? (pa->neg ? 1 : 0) * (t.neg || pa->neg) : 0;
        if (t.n && pa->neg) t.neg = 1;
        if (!t.n) t.neg = 0;
        o = t;
        break;
      }
      case 8:     // AND
      case 9:     // OR
      case 10: {  // XOR
        ARG(aa[i], pa);
        ARG(bb[i], pb);
        if (pa->neg || pb->neg) return 6;  // python two's-complement: not supported
        int n = pa->n > pb->n ? pa->n : pb->n;
        std::memset(o.d, 0, sizeof(o.d));
        for (int j = 0; j < n; j++) {
          uint64_t x = j < pa->n ? pa->d[j] : 0;
          uint64_t y = j < pb->n ? pb->d[j] : 0;
          o.d[j] = opc == 8 ? (x & y) : opc == 9 ? (x | y) : (x ^ y);
        }
        o.n = n;
        o.neg = 0;
        trim(o);
        break;
      }
      case 11: {  // NEG
        ARG(aa[i], pa);
        o = *pa;
        if (o.n) o.neg = !o.neg;
        break;
      }
      case 12: {  // POWMOD (a ^ exp mod m), exp/mod immediates or nodes
        ARG(aa[i], pa);
        ARG(bb[i], pe);
        ARG(cc[i], pm);
        if (pe->neg || pm->n == 0 || pm->neg) return 7;
        const Barrett *B = nullptr;
        Barrett local;
        if (cc[i] < 0) B = find_barrett(-cc[i] - 1);
        if (!B) {
          local.m = *pm;
          int k = bitlen(*pm);
          local.k2 = 2 * k;
          Val pow2, shifted, q, r;
          set_u64(pow2, 1);
          if (!shl_mag(pow2, local.k2, shifted)) return 3;
          if (!divmod_mag(shifted, *pm, q, r)) return 4;
          local.mu = q;
          B = &local;
        }
        Val base;
        {
          Val q0, r0;
          if (!divmod_floor(*pa, *pm, q0, r0)) return 4;
          base = r0;
          base.neg = 0;
        }
        Val acc;
        set_u64(acc, 1);
        int eb = bitlen(*pe);
        for (int bi = eb - 1; bi >= 0; bi--) {
          Val t;
          if (!mul_mag(acc, acc, t)) return 3;
          t.neg = 0;
          if (!barrett_mod(t, *B, acc)) return 3;
          if ((pe->d[bi / 64] >> (bi % 64)) & 1) {
            if (!mul_mag(acc, base, t)) return 3;
            t.neg = 0;
            if (!barrett_mod(t, *B, acc)) return 3;
          }
        }
        o = acc;
        break;
      }
      case 13: {  // INVMOD: extended euclid
        ARG(aa[i], pa);
        ARG(bb[i], pm);
        if (pm->n == 0 || pm->neg) return 7;
        // a mod m
        Val q0, r0;
        if (!divmod_floor(*pa, *pm, q0, r0)) return 4;
        Val r_prev = *pm, r_cur = r0;
        Val t_prev, t_cur;
        set_zero(t_prev);
        set_u64(t_cur, 1);
        while (r_cur.n != 0) {
          Val qq, rr;
          if (!divmod_mag(r_prev, r_cur, qq, rr)) return 4;
          // t_next = t_prev - qq * t_cur  (signed)
          Val qt, t_next;
          if (!mul_mag(qq, t_cur, qt)) return 3;
          if (!sub_signed(t_prev, qt, t_next)) return 3;
          r_prev = r_cur;
          r_cur = rr;
          r_cur.neg = 0;
          t_prev = t_cur;
          t_cur = t_next;
        }
        // gcd must be 1
        Val one;
        set_u64(one, 1);
        if (cmp_mag(r_prev, one) != 0) return 8;
        // result = t_prev mod m
        Val q1, r1;
        if (!divmod_floor(t_prev, *pm, q1, r1)) return 4;
        o = r1;
        break;
      }
      case 14:    // EQ
      case 15:    // NE
      case 16:    // LT
      case 17: {  // LE
        ARG(aa[i], pa);
        ARG(bb[i], pb);
        int c;
        if (pa->n == 0 && pb->n == 0) c = 0;
        else if ((pa->n ? pa->neg : 0) != (pb->n ? pb->neg : 0))
          c = (pa->n && pa->neg) ? -1 : 1;
        else {
          c = cmp_mag(*pa, *pb);
          if (pa->n && pa->neg) c = -c;
        }
        int res = opc == 14 ? (c == 0) : opc == 15 ? (c != 0)
                  : opc == 16 ? (c < 0) : (c <= 0);
        set_u64(o, res);
        break;
      }
      case 18: {  // TABLE
        int64_t tid = aa[i];
        if (tid < 0 || tid >= n_tables) return 9;
        ARG(bb[i], pidx);
        bool ok;
        uint64_t idx = small_u64(*pidx, ok);
        if (!ok) return 9;
        int64_t lo = tbl_off[tid], hi = tbl_off[tid + 1];
        if ((int64_t)idx >= hi - lo) return 9;
        int64_t v = tbl_data[lo + idx];
        if (v < 0) {
          set_u64(o, (uint64_t)(-v));
          o.neg = 1;
        } else {
          set_u64(o, (uint64_t)v);
        }
        break;
      }
      default:
        return 1;
    }
    return 0;
  };

  // Execution. The tape is in topological order, so the sequential walk is
  // always correct. ZKDCAP_WITNESS_THREADS=1 switches to a level-scheduled
  // OpenMP walk (level = longest operand chain, wide levels as
  // parallel-for). Measured on the DCAP k=17 tape this LOSES (637 ms ->
  // 3.1 s): 74% of the 5.2M nodes sit in 44k narrow levels (median 36
  // nodes), so the reordering trashes cache locality for a <=1.24x
  // Amdahl ceiling. Kept for DAGs with genuinely wide level profiles.
  // Determinism: soaked (12 fresh P-256 inputs x repeated threaded +
  // single-threaded replays, byte-identical) — each node writes once and
  // reads only earlier levels, so schedule order cannot change values;
  // staying sequential by default is purely the locality result above.
  bool parallel_ok = false;
  {
    const char *tenv = std::getenv("ZKDCAP_WITNESS_THREADS");
    if (tenv && tenv[0] == '1' && tenv[1] == 0) parallel_ok = true;
  }
#ifndef _OPENMP
  parallel_ok = false;
#endif
  if (!parallel_ok) {
    for (int64_t i = 0; i < n_nodes; i++) {
      int rc = eval_node(i);
      if (rc) return rc;
    }
  } else {
    std::vector<int32_t> depth((size_t)n_nodes);
    int32_t max_d = 0;
    for (int64_t i = 0; i < n_nodes; i++) {
      int32_t d = -1;
      auto upd = [&](int64_t x) {
        if (x >= 0 && x < i && depth[(size_t)x] > d) d = depth[(size_t)x];
      };
      switch (op[i]) {
        case 0:
          break;
        case 18:
          upd(bb[i]);
          break;
        case 11:
        case 19:
          upd(aa[i]);
          break;
        case 12:
          upd(aa[i]);
          upd(bb[i]);
          upd(cc[i]);
          break;
        default:
          upd(aa[i]);
          upd(bb[i]);
          break;
      }
      depth[i] = d + 1;
      if (depth[i] > max_d) max_d = depth[i];
    }
    // stable counting sort by level keeps topo order inside each level
    std::vector<int64_t> off((size_t)max_d + 2, 0);
    for (int64_t i = 0; i < n_nodes; i++) off[(size_t)depth[i] + 1]++;
    for (int64_t l = 0; l <= max_d; l++) off[(size_t)l + 1] += off[(size_t)l];
    std::vector<int64_t> order((size_t)n_nodes);
    {
      std::vector<int64_t> cur(off.begin(), off.end() - 1);
      for (int64_t i = 0; i < n_nodes; i++) order[cur[(size_t)depth[i]]++] = i;
    }
    std::atomic<int> aerr{0};
    const int64_t PAR_MIN = 1024;  // below this the fork overhead loses
    for (int64_t l = 0; l <= max_d; l++) {
      if (aerr.load(std::memory_order_relaxed)) break;
      int64_t s = off[(size_t)l], e = off[(size_t)l + 1];
      if (e - s >= PAR_MIN) {
#pragma omp parallel for schedule(static)
        for (int64_t t = s; t < e; t++) {
          if (aerr.load(std::memory_order_relaxed)) continue;
          int rc = eval_node(order[t]);
          if (rc) {
            int z = 0;
            aerr.compare_exchange_strong(z, rc);
          }
        }
      } else {
        for (int64_t t = s; t < e; t++) {
          int rc = eval_node(order[t]);
          if (rc) {
            int z = 0;
            aerr.compare_exchange_strong(z, rc);
            break;
          }
        }
      }
    }
    int rc = aerr.load();
    if (rc) return rc;
  }

  // gather cells (values must be in [0, 2^256))
  for (int64_t i = 0; i < n_cells; i++) {
    int64_t nid = cell_nodes[i];
    if (nid < 0 || nid >= n_nodes) return 10;
    const Val &v = vals[nid];
    if (v.neg || v.n > 4) return 11;
    std::memcpy(out + i * 32, v.d, 32);
  }
  return 0;
}

}  // extern "C"
