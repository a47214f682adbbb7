// BN254 Montgomery arithmetic over 8 x 32-bit limbs, R = 2^256, for sm_90a.
//
// The JAX package keeps an element as 16 limbs of 16 bits; R = 2^256 there
// too, so a 32-bit limb here is exactly two of its limbs and Montgomery form
// is unchanged. Tensors at the kernels' boundaries keep the 16-bit layout in
// int32: load_limbs16 / store_limbs16 convert. Every function returns a
// canonical value (in [0, p)) for canonical inputs, so results are
// bit-identical to the plain torch versions.
//
// fe_mul, fe_add and fe_sub use 64-bit multiply-adds and adds (a*b + t + c
// < 2^64 always holds for 32-bit a, b, t, c); nvcc lowers them to IMAD.WIDE
// plus 64-bit adds. fe_mul_cc, fe_add_cc and fe_sub_cc compute the same
// values with 32-bit carry chains in inline PTX (mad.lo.cc / madc.hi.cc /
// addc.cc). In SASS for sm_90a (chip_smoke.py's probe kernels) a product is
// 500 instructions either way or nearly (fe_mul: 120 IMAD.WIDE, 66
// IMAD.MOV, 212 IADD3; fe_mul_cc: 546, of them 136 IMAD, 128 IMAD.HI and
// 231 IADD3.X: ptxas splits each multiply-add with carry in two), but an
// addition falls from 49 to 18 instructions and a subtraction from 42 to
// 17. The point formulas (kernels B and C) use the carry-chain versions;
// kernels A, D, E and G keep the 64-bit ones (E is not faster with
// fe_mul_cc: zkdcap_tpu_torch/tools/kernel_variants.py).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace zk {

// A launcher's one-time setup (cudaFuncSetAttribute, SM counts, occupancy)
// belongs to one device: the runtime applies a function attribute in the
// current device's context. Launchers keep it in arrays indexed by the
// current device's ordinal, which the Python wrapper sets to the tensors'.
constexpr int kMaxDevices = 64;

inline cudaError_t current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices)) return cudaErrorInvalidDevice;
  return err;
}

struct Fe {
  uint32_t v[8];
};

// Base field Fq of BN254 (G1 coordinates).
struct Fq {
  __device__ __forceinline__ static uint32_t mod(int i) {
    constexpr uint32_t P[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i];
  }
  __device__ __forceinline__ static uint32_t one(int i) {  // R mod p
    constexpr uint32_t ONE[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                                 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return ONE[i];
  }
  static constexpr uint32_t INV = 0xe4866389u;  // -p^-1 mod 2^32
};

// Scalar field Fr of BN254 (polynomials, NTT).
struct Fr {
  __device__ __forceinline__ static uint32_t mod(int i) {
    constexpr uint32_t P[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i];
  }
  static constexpr uint32_t INV = 0xefffffffu;
};

template <class F>
__device__ __forceinline__ Fe fe_one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = F::one(i);
  return r;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = 0u;
  return r;
}

// t (plus a carry bit above it) < 2p -> canonical.
template <class F>
__device__ __forceinline__ Fe reduce_once(const Fe& t, uint32_t carry) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t s = (uint64_t)t.v[i] - F::mod(i) - borrow;
    d.v[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  return (carry || !borrow) ? d : t;
}

template <class F>
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    s.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return reduce_once<F>(s, (uint32_t)c);
}

template <class F>
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t s = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      c += (uint64_t)d.v[i] + F::mod(i);
      d.v[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

// Montgomery product a*b*R^-1 mod p: CIOS (Koc, Acar and Kaliski 1996).
template <class F>
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * F::INV;
    s = (uint64_t)m * F::mod(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (uint64_t)m * F::mod(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = t[i];
  return reduce_once<F>(r, t[8]);
}

// --- carry-chain versions (inline PTX) ------------------------------------
//
// Each asm statement starts and ends its own carry chain, so no carry flag
// lives across statements.

// t[0..8] += a * b (t[8] takes the carry; the caller keeps t + a*b < 2^288).
__device__ __forceinline__ void mac_row(uint32_t (&t)[9], const Fe& a, uint32_t b) {
  asm("mad.lo.cc.u32  %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "mad.hi.cc.u32  %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32    %8, %16, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b));
}

// t[0..8] += m * p with m = t[0] * (-p^-1) mod 2^32, which clears t[0].
template <class F>
__device__ __forceinline__ void redc_row(uint32_t (&t)[9]) {
  asm("{\n\t"
      ".reg .u32 m;\n\t"
      "mul.lo.u32     m, %0, %17;\n\t"
      "mad.lo.cc.u32  %0, m, %9, %0;\n\t"
      "madc.lo.cc.u32 %1, m, %10, %1;\n\t"
      "madc.lo.cc.u32 %2, m, %11, %2;\n\t"
      "madc.lo.cc.u32 %3, m, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, m, %13, %4;\n\t"
      "madc.lo.cc.u32 %5, m, %14, %5;\n\t"
      "madc.lo.cc.u32 %6, m, %15, %6;\n\t"
      "madc.lo.cc.u32 %7, m, %16, %7;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "mad.hi.cc.u32  %1, m, %9, %1;\n\t"
      "madc.hi.cc.u32 %2, m, %10, %2;\n\t"
      "madc.hi.cc.u32 %3, m, %11, %3;\n\t"
      "madc.hi.cc.u32 %4, m, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, m, %13, %5;\n\t"
      "madc.hi.cc.u32 %6, m, %14, %6;\n\t"
      "madc.hi.cc.u32 %7, m, %15, %7;\n\t"
      "madc.hi.u32    %8, m, %16, %8;\n\t"
      "}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8])
      : "r"(F::mod(0)), "r"(F::mod(1)), "r"(F::mod(2)), "r"(F::mod(3)), "r"(F::mod(4)),
        "r"(F::mod(5)), "r"(F::mod(6)), "r"(F::mod(7)), "r"(F::INV));
}

// t < 2p -> t mod p: t - p where that does not borrow.
template <class F>
__device__ __forceinline__ Fe reduce_cc(const Fe& t) {
  Fe d;
  uint32_t borrow = 0;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %8, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]), "=r"(d.v[5]),
        "=r"(d.v[6]), "=r"(d.v[7]), "+r"(borrow)
      : "r"(t.v[0]), "r"(t.v[1]), "r"(t.v[2]), "r"(t.v[3]), "r"(t.v[4]), "r"(t.v[5]),
        "r"(t.v[6]), "r"(t.v[7]), "r"(F::mod(0)), "r"(F::mod(1)), "r"(F::mod(2)),
        "r"(F::mod(3)), "r"(F::mod(4)), "r"(F::mod(5)), "r"(F::mod(6)), "r"(F::mod(7)));
  return borrow ? t : d;
}

// Montgomery product a*b*R^-1 mod p, CIOS with one carry chain per pass: the
// same value as fe_mul. Needs 4p < 2^256 (true of both BN254 moduli): then
// t < 2p between rows and t + a*b_i + m*p < 2^288 within one, so nine words
// hold t and no chain carries out of the ninth.
template <class F>
__device__ __forceinline__ Fe fe_mul_cc(const Fe& a, const Fe& b) {
  uint32_t t[9];
#pragma unroll
  for (int i = 0; i < 9; i++) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    mac_row(t, a, b.v[i]);
    redc_row<F>(t);
#pragma unroll
    for (int j = 0; j < 8; j++) t[j] = t[j + 1];  // t[0] is 0: divide by 2^32
    t[8] = 0u;
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = t[i];
  return reduce_cc<F>(r);
}

// a + b mod p (a + b < 2p < 2^256, so the sum needs no ninth word).
template <class F>
__device__ __forceinline__ Fe fe_add_cc(const Fe& a, const Fe& b) {
  Fe s;
  asm("add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(s.v[0]), "=r"(s.v[1]), "=r"(s.v[2]), "=r"(s.v[3]), "=r"(s.v[4]), "=r"(s.v[5]),
        "=r"(s.v[6]), "=r"(s.v[7])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  return reduce_cc<F>(s);
}

// a - b mod p: a - b, plus p where that borrows.
template <class F>
__device__ __forceinline__ Fe fe_sub_cc(const Fe& a, const Fe& b) {
  Fe d;
  uint32_t borrow = 0;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %8, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]), "=r"(d.v[5]),
        "=r"(d.v[6]), "=r"(d.v[7]), "+r"(borrow)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  Fe q;  // p where the difference borrowed, else 0
#pragma unroll
  for (int i = 0; i < 8; i++) q.v[i] = F::mod(i) & borrow;
  asm("add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(d.v[0]), "+r"(d.v[1]), "+r"(d.v[2]), "+r"(d.v[3]), "+r"(d.v[4]), "+r"(d.v[5]),
        "+r"(d.v[6]), "+r"(d.v[7])
      : "r"(q.v[0]), "r"(q.v[1]), "r"(q.v[2]), "r"(q.v[3]), "r"(q.v[4]), "r"(q.v[5]),
        "r"(q.v[6]), "r"(q.v[7]));
  return d;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.v[i];
  return acc == 0;
}

__device__ __forceinline__ Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// 16 int32 words, each a 16-bit limb -> 8 x 32-bit limbs. `stride` is the
// distance in words between consecutive limbs (1 row-major, B limb-major).
__device__ __forceinline__ Fe load_limbs16(const int32_t* p, long stride) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++)
    r.v[i] = ((uint32_t)p[(2 * i) * stride] & 0xffffu) |
             ((uint32_t)p[(2 * i + 1) * stride] << 16);
  return r;
}

__device__ __forceinline__ void store_limbs16(int32_t* p, long stride, const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    p[(2 * i) * stride] = (int32_t)(a.v[i] & 0xffffu);
    p[(2 * i + 1) * stride] = (int32_t)(a.v[i] >> 16);
  }
}

// Row-major variants: one element is 64 contiguous bytes, read as 4 x int4.
__device__ __forceinline__ Fe load_row16(const int32_t* p) {
  const int4* q = reinterpret_cast<const int4*>(p);
  Fe r;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    int4 w = q[k];
    r.v[2 * k] = ((uint32_t)w.x & 0xffffu) | ((uint32_t)w.y << 16);
    r.v[2 * k + 1] = ((uint32_t)w.z & 0xffffu) | ((uint32_t)w.w << 16);
  }
  return r;
}

__device__ __forceinline__ void store_row16(int32_t* p, const Fe& a) {
  int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; k++) {
    int4 w;
    w.x = (int32_t)(a.v[2 * k] & 0xffffu);
    w.y = (int32_t)(a.v[2 * k] >> 16);
    w.z = (int32_t)(a.v[2 * k + 1] & 0xffffu);
    w.w = (int32_t)(a.v[2 * k + 1] >> 16);
    q[k] = w;
  }
}

// --- G1, homogeneous projective, RCB'15 complete formulas for a = 0 --------

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Pt pt_inf() {
  return Pt{fe_zero(), fe_one<Fq>(), fe_zero()};
}

// b3 * a for b3 = 3b = 9 (y^2 = x^3 + 3): 8a + a by four additions rather
// than a Montgomery product. The chain stays short while b3 <= 256.
__device__ __forceinline__ Fe mul_b3(const Fe& a) {
  Fe t = fe_add_cc<Fq>(a, a);
  t = fe_add_cc<Fq>(t, t);
  t = fe_add_cc<Fq>(t, t);
  return fe_add_cc<Fq>(t, a);
}

// RCB'15 Algorithm 7 (12M + 2 mul_b3).
__device__ __forceinline__ Pt pt_add(const Pt& P, const Pt& Q) {
  Fe t0 = fe_mul_cc<Fq>(P.x, Q.x);
  Fe t1 = fe_mul_cc<Fq>(P.y, Q.y);
  Fe t2 = fe_mul_cc<Fq>(P.z, Q.z);
  Fe t3 = fe_mul_cc<Fq>(fe_add_cc<Fq>(P.x, P.y), fe_add_cc<Fq>(Q.x, Q.y));
  t3 = fe_sub_cc<Fq>(t3, fe_add_cc<Fq>(t0, t1));
  Fe t4 = fe_mul_cc<Fq>(fe_add_cc<Fq>(P.y, P.z), fe_add_cc<Fq>(Q.y, Q.z));
  t4 = fe_sub_cc<Fq>(t4, fe_add_cc<Fq>(t1, t2));
  Fe t5 = fe_mul_cc<Fq>(fe_add_cc<Fq>(P.x, P.z), fe_add_cc<Fq>(Q.x, Q.z));
  t5 = fe_sub_cc<Fq>(t5, fe_add_cc<Fq>(t0, t2));
  t0 = fe_add_cc<Fq>(fe_add_cc<Fq>(t0, t0), t0);
  t2 = mul_b3(t2);
  Fe z3 = fe_add_cc<Fq>(t1, t2);
  t1 = fe_sub_cc<Fq>(t1, t2);
  Fe y3 = mul_b3(t5);
  Pt R;
  R.x = fe_sub_cc<Fq>(fe_mul_cc<Fq>(t3, t1), fe_mul_cc<Fq>(t4, y3));
  R.y = fe_add_cc<Fq>(fe_mul_cc<Fq>(t1, z3), fe_mul_cc<Fq>(y3, t0));
  R.z = fe_add_cc<Fq>(fe_mul_cc<Fq>(z3, t4), fe_mul_cc<Fq>(t0, t3));
  return R;
}

// RCB'15 Algorithm 7 with Z2 = 1 (mixed addition: Q affine). Complete for
// every P, including the identity and P = +-Q.
__device__ __forceinline__ Pt pt_madd(const Pt& P, const Fe& x2, const Fe& y2) {
  Fe t0 = fe_mul_cc<Fq>(P.x, x2);
  Fe t1 = fe_mul_cc<Fq>(P.y, y2);
  Fe t3 = fe_mul_cc<Fq>(fe_add_cc<Fq>(P.x, P.y), fe_add_cc<Fq>(x2, y2));
  t3 = fe_sub_cc<Fq>(t3, fe_add_cc<Fq>(t0, t1));
  Fe t4 = fe_add_cc<Fq>(P.y, fe_mul_cc<Fq>(y2, P.z));  // Y1 Z2 + Y2 Z1
  Fe t5 = fe_add_cc<Fq>(P.x, fe_mul_cc<Fq>(x2, P.z));  // X1 Z2 + X2 Z1
  t0 = fe_add_cc<Fq>(fe_add_cc<Fq>(t0, t0), t0);
  Fe t2 = mul_b3(P.z);
  Fe z3 = fe_add_cc<Fq>(t1, t2);
  t1 = fe_sub_cc<Fq>(t1, t2);
  Fe y3 = mul_b3(t5);
  Pt R;
  R.x = fe_sub_cc<Fq>(fe_mul_cc<Fq>(t3, t1), fe_mul_cc<Fq>(t4, y3));
  R.y = fe_add_cc<Fq>(fe_mul_cc<Fq>(t1, z3), fe_mul_cc<Fq>(y3, t0));
  R.z = fe_add_cc<Fq>(fe_mul_cc<Fq>(z3, t4), fe_mul_cc<Fq>(t0, t3));
  return R;
}

// RCB'15 Algorithm 9 (6M + 2S + 1 mul_b3).
__device__ __forceinline__ Pt pt_double(const Pt& P) {
  Fe t0 = fe_mul<Fq>(P.y, P.y);
  Fe z3 = fe_add<Fq>(t0, t0);
  z3 = fe_add<Fq>(z3, z3);
  z3 = fe_add<Fq>(z3, z3);
  Fe t1 = fe_mul<Fq>(P.y, P.z);
  Fe t2 = fe_mul<Fq>(P.z, P.z);
  t2 = mul_b3(t2);
  Fe x3 = fe_mul<Fq>(t2, z3);
  Fe y3 = fe_add<Fq>(t0, t2);
  z3 = fe_mul<Fq>(t1, z3);
  t1 = fe_add<Fq>(t2, t2);
  t2 = fe_add<Fq>(t1, t2);
  t0 = fe_sub<Fq>(t0, t2);
  y3 = fe_mul<Fq>(t0, y3);
  y3 = fe_add<Fq>(x3, y3);
  t1 = fe_mul<Fq>(P.x, P.y);
  x3 = fe_mul<Fq>(t0, t1);
  x3 = fe_add<Fq>(x3, x3);
  return Pt{x3, y3, z3};
}

__device__ __forceinline__ Pt pt_select(bool c, const Pt& a, const Pt& b) {
  return Pt{fe_select(c, a.x, b.x), fe_select(c, a.y, b.y), fe_select(c, a.z, b.z)};
}

}  // namespace zk
