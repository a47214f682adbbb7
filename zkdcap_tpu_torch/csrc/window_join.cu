// Kernel D: the Pippenger window join, R = sum_w 2^(c*w) T_w.
//
// Replaces zkdcap_tpu/curves/ec_kernels.py _mk_window_join_kernel. Horner
// from the top window: R = T_{W-1}; for each lower window, c complete
// doublings then one complete addition (RCB'15 Algorithms 9 and 7).
//
// What bounds it: latency. The work is one dependent chain of c*(W-1)
// doublings and W-1 additions (~0.3 ms of arithmetic on a single lane) on a
// few hundred bytes, so neither memory nor the multiply rate is the limit.
// One thread runs the chain; the point of the kernel is that the join costs
// one launch per MSM instead of thousands of small eager launches.
#include "bn254_mont.cuh"

using namespace zk;

namespace {

__device__ __forceinline__ Pt load_window(const int32_t* x, const int32_t* y, const int32_t* z,
                                          int w) {
  return Pt{load_row16(x + w * 16), load_row16(y + w * 16), load_row16(z + w * 16)};
}

__global__ void window_join_kernel(const int32_t* __restrict__ tx,
                                   const int32_t* __restrict__ ty,
                                   const int32_t* __restrict__ tz, int32_t* __restrict__ ox,
                                   int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                                   int windows, int window_bits) {
  Pt R = load_window(tx, ty, tz, windows - 1);
  for (int w = windows - 2; w >= 0; w--) {
    for (int k = 0; k < window_bits; k++) R = pt_double(R);
    R = pt_add(R, load_window(tx, ty, tz, w));
  }
  store_row16(ox, R.x);
  store_row16(oy, R.y);
  store_row16(oz, R.z);
}

}  // namespace

// tx, ty, tz: (windows, 16) per-window sums; ox, oy, oz: (16,).
extern "C" int zk_window_join(const void* tx, const void* ty, const void* tz, void* ox, void* oy,
                              void* oz, int windows, int window_bits, void* stream) {
  if (windows < 1 || window_bits < 1) return (int)cudaErrorInvalidValue;
  window_join_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tx, (const int32_t*)ty, (const int32_t*)tz, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)oz, windows, window_bits);
  return (int)cudaGetLastError();
}
