// Kernel D: the Pippenger window join, R = sum_w 2^(c*w) T_w.
//
// Replaces zkdcap_tpu/curves/ec_kernels.py _mk_window_join_kernel. Horner
// from the top window: R = T_{W-1}; for each lower window, c complete
// doublings then one complete addition (RCB'15 Algorithms 9 and 7, a = 0,
// b3 = 9). Every field value is canonical, so R equals the plain version
// (ec_window_join_plain) limb for limb.
//
// What bounds it: latency. The work is one dependent chain of c*(W-1)
// doublings and W-1 additions on a few hundred bytes (247 and 19 at W = 20,
// c = 13, the shape of every commitment of the k = 17 and k = 18 proofs), so
// neither memory nor the multiply rate is the limit: the time is the chain's
// depth times the latency of one step. The design cuts that latency:
//
// - One warp runs the chain. Each formula is two levels of independent
//   Montgomery products (the doubling 6 then 4, the addition 6 then 6); lane
//   j computes product j of a level, writes it to shared memory, and after a
//   __syncwarp every lane reads all of them. All lanes hold the same point
//   and compute the additions between levels redundantly; each lane reads
//   its own operands back from shared memory, not out of registers by
//   selects.
// - The doubling moves additions into products of scaled inputs: 9 Z^2 =
//   (3Z)^2, 27 Z^2 = (3Z)(9Z), 8 Y^2 = (2Y)(4Y), and X3 = (Y^2 - 27 Z^2)(2XY),
//   so one addition (three side by side) separates its two levels, where
//   Algorithm 9 has seven in sequence; 2a, 3a and 4a take one step each
//   (scale: the candidates K a - q p side by side).
// - Products, additions and subtractions are bn254_mont.cuh's, shared with
//   kernels A-C, E and G: a no-carry CIOS product (the a*b_i and m*p chains
//   side by side) and a subtraction forming a - b and a - b + p at once were
//   both slower here (H100 80GB HBM3, 700 W).
//
// One launch per MSM, <<<1, 32>>>.
#include "bn254_mont.cuh"

using namespace zk;

namespace {

constexpr int PRODUCTS = 6;  // the most products of one level

// K a mod p for K = 2..4 in one step: K a < 4p < 2^256 (p < 2^254), and the
// candidates K a - q p (q < K) are formed side by side; the largest q that
// does not go below 0 wins.
template <int K>
__device__ __forceinline__ Fe scale(const Fe& a) {
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.v[i] * K;
    s.v[i] = (uint32_t)c;
    c >>= 32;
  }
  Fe r = s;
#pragma unroll
  for (int q = 1; q < K; q++) {
    Fe d;
    int64_t br = 0;
    uint64_t qc = 0;  // q p, limb by limb
#pragma unroll
    for (int i = 0; i < 8; i++) {
      qc += (uint64_t)Fq::mod(i) * q;
      const int64_t u = (int64_t)s.v[i] - (int64_t)(uint32_t)qc + br;
      qc >>= 32;
      d.v[i] = (uint32_t)u;
      br = u >> 32;
    }
    if (br == 0) r = d;
  }
  return r;
}

__device__ __forceinline__ Fe load_fe(const uint4* p) {
  const uint4 lo = p[0], hi = p[1];
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ void store_fe(uint4* p, const Fe& a) {
  p[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  p[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

// Shared memory of the warp: a level's operands and its products.
struct Stage {
  uint4 opnd[2 * PRODUCTS][2];
  uint4 prod[PRODUCTS][2];
};

// One level: lane j < N multiplies a[j] by b[j] (lanes >= N repeat pair 0
// and write nothing); every lane returns all N products. Every lane stages
// all operands (the same values at the same addresses) and reads back its
// own pair, which costs a few stores where a choice among N values in
// registers costs 5 selects a word.
template <int N>
__device__ __forceinline__ void products(const Fe (&a)[N], const Fe (&b)[N], Fe (&r)[N],
                                         Stage& st, int lane) {
#pragma unroll
  for (int j = 0; j < N; j++) {
    store_fe(st.opnd[j], a[j]);
    store_fe(st.opnd[N + j], b[j]);
  }
  __syncwarp();
  const int j = lane < N ? lane : 0;
  const Fe p = fe_mul<Fq>(load_fe(st.opnd[j]), load_fe(st.opnd[N + j]));
  if (lane < N) store_fe(st.prod[lane], p);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < N; i++) r[i] = load_fe(st.prod[i]);
}

// RCB'15 Algorithm 9 with its additions folded into scaled product inputs.
// A level's stores come after the previous level's loads by every lane (a
// __syncwarp lies between), so one Stage serves all levels.
__device__ __forceinline__ Pt dbl(const Pt& P, Stage& st, int lane) {
  const Fe y2 = scale<2>(P.y), y4 = scale<4>(P.y);
  const Fe z3 = scale<3>(P.z), z9 = scale<3>(z3);
  Fe r[6];
  {
    const Fe a[6] = {P.y, P.y, z3, P.x, z3, y2};
    const Fe b[6] = {P.y, P.z, z3, P.y, z9, y4};
    products<6>(a, b, r, st, lane);
  }
  // r: Y^2, YZ, 9 Z^2 (= b3 Z^2), XY, 27 Z^2, 8 Y^2
  const Fe y3 = fe_add<Fq>(r[0], r[2]);
  const Fe t0 = fe_sub<Fq>(r[0], r[4]);
  const Fe xy2 = scale<2>(r[3]);
  Fe s[4];
  {
    const Fe a[4] = {r[2], r[1], t0, t0};
    const Fe b[4] = {r[5], r[5], y3, xy2};
    products<4>(a, b, s, st, lane);
  }
  return Pt{s[3], fe_add<Fq>(s[0], s[2]), s[1]};
}

// RCB'15 Algorithm 7; qs holds Q's sums X+Y, Y+Z, X+Z.
__device__ __forceinline__ Pt add(const Pt& P, const Pt& Q, const Fe (&qs)[3], Stage& st,
                                  int lane) {
  Fe r[6];
  {
    const Fe a[6] = {P.x, P.y, P.z, fe_add<Fq>(P.x, P.y), fe_add<Fq>(P.y, P.z),
                     fe_add<Fq>(P.x, P.z)};
    const Fe b[6] = {Q.x, Q.y, Q.z, qs[0], qs[1], qs[2]};
    products<6>(a, b, r, st, lane);
  }
  const Fe t3 = fe_sub<Fq>(r[3], fe_add<Fq>(r[0], r[1]));
  const Fe t4 = fe_sub<Fq>(r[4], fe_add<Fq>(r[1], r[2]));
  const Fe t5 = fe_sub<Fq>(r[5], fe_add<Fq>(r[0], r[2]));
  const Fe t0 = scale<3>(r[0]);
  const Fe t2 = scale<3>(scale<3>(r[2]));  // b3 = 9
  const Fe z3 = fe_add<Fq>(r[1], t2);
  const Fe t1 = fe_sub<Fq>(r[1], t2);
  const Fe y3 = scale<3>(scale<3>(t5));
  Fe s[6];
  {
    const Fe a[6] = {t3, t4, t1, y3, z3, t0};
    const Fe b[6] = {t1, y3, z3, t0, t4, t3};
    products<6>(a, b, s, st, lane);
  }
  return Pt{fe_sub<Fq>(s[0], s[1]), fe_add<Fq>(s[2], s[3]), fe_add<Fq>(s[4], s[5])};
}

__device__ __forceinline__ Pt load_window(const int32_t* x, const int32_t* y, const int32_t* z,
                                          int w) {
  return Pt{load_row16(x + w * 16), load_row16(y + w * 16), load_row16(z + w * 16)};
}

__global__ void __launch_bounds__(32)
window_join_kernel(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty,
                   const int32_t* __restrict__ tz, int32_t* __restrict__ ox,
                   int32_t* __restrict__ oy, int32_t* __restrict__ oz, int windows,
                   int window_bits) {
  __shared__ Stage st;
  const int lane = threadIdx.x;
  Pt R = load_window(tx, ty, tz, windows - 1);
  for (int w = windows - 2; w >= 0; w--) {
    const Pt Q = load_window(tx, ty, tz, w);
    const Fe qs[3] = {fe_add<Fq>(Q.x, Q.y), fe_add<Fq>(Q.y, Q.z), fe_add<Fq>(Q.x, Q.z)};
    for (int k = 0; k < window_bits; k++) R = dbl(R, st, lane);
    R = add(R, Q, qs, st, lane);
  }
  if (lane == 0) {
    store_row16(ox, R.x);
    store_row16(oy, R.y);
    store_row16(oz, R.z);
  }
}

}  // namespace

// tx, ty, tz: (windows, 16) per-window sums; ox, oy, oz: (16,).
extern "C" int zk_window_join(const void* tx, const void* ty, const void* tz, void* ox, void* oy,
                              void* oz, int windows, int window_bits, void* stream) {
  if (windows < 1 || window_bits < 1) return (int)cudaErrorInvalidValue;
  window_join_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tx, (const int32_t*)ty, (const int32_t*)tz, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)oz, windows, window_bits);
  return (int)cudaGetLastError();
}
