// Kernel C: complete G1 addition with a per-lane select.
//
// Replaces zkdcap_tpu/curves/ec_kernels.py _mk_ec_add_kernel: for each lane,
// out = mask ? P + Q : (fallback_q ? Q : P), with P + Q the RCB'15 complete
// projective addition (a = 0). It serves the MSM's segmented Hillis-Steele
// levels, its bucket tree sums and suffix scans, and the SRS's conditional
// additions.
//
// What bounds it: a lane that adds does 12 Montgomery products (~3.2k
// 32-bit multiply-adds; b3 by additions) and moves 580 B (P, Q and its mask
// in, the sum out); a lane whose mask is clear only copies its fallback
// (388 B) and computes nothing. Unless nearly nine lanes in ten add, HBM
// bounds it. One thread per lane, points read as 16-byte vectors from the
// row-major (n, 16) layout, and a copying lane reads only its fallback:
// most lanes of the later Hillis-Steele levels copy.
#include "bn254_mont.cuh"

using namespace zk;

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ Pt load_pt(const int32_t* x, const int32_t* y, const int32_t* z,
                                      long i) {
  return Pt{load_row16(x + i * 16), load_row16(y + i * 16), load_row16(z + i * 16)};
}

__global__ void __launch_bounds__(kThreads)
ec_add_select_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                     const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                     const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
                     const int32_t* __restrict__ mask, int32_t* __restrict__ ox,
                     int32_t* __restrict__ oy, int32_t* __restrict__ oz, int n,
                     int fallback_q) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  Pt R;
  if (mask[i] != 0) R = pt_add(load_pt(x1, y1, z1, i), load_pt(x2, y2, z2, i));
  else R = fallback_q ? load_pt(x2, y2, z2, i) : load_pt(x1, y1, z1, i);
  store_row16(ox + i * 16, R.x);
  store_row16(oy + i * 16, R.y);
  store_row16(oz + i * 16, R.z);
}

}  // namespace

// All point planes are (n, 16) row-major 16-bit limbs; mask is (n,) int32.
extern "C" int zk_ec_add_select(const void* x1, const void* y1, const void* z1, const void* x2,
                                const void* y2, const void* z2, const void* mask, void* ox,
                                void* oy, void* oz, int n, int fallback_q, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int grid = (n + kThreads - 1) / kThreads;
  ec_add_select_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2,
      (const int32_t*)y2, (const int32_t*)z2, (const int32_t*)mask, (int32_t*)ox,
      (int32_t*)oy, (int32_t*)oz, n, fallback_q);
  return (int)cudaGetLastError();
}
