// Kernel B: the MSM's whole segmented mixed-addition scan.
//
// Replaces zkdcap_tpu/curves/ec_kernels.py _mk_madd_scan_full_kernel and
// _mk_madd_scan_full_kernel_r12, and with steps = 1 the single step of
// _mk_ec_madd_kernel. Each of B lanes walks M sorted affine points:
//   valid and same-run  -> acc + Q        valid and new run -> Q
//   invalid and same    -> acc            invalid and new   -> identity
// with Q's Y negated first where the negate mask is set, and writes the
// accumulator after every step.
//
// What bounds it: a step that adds (valid and same-run) costs the 11
// Montgomery products of a mixed addition (~2.9k 32-bit multiply-adds; b3
// by additions) against at most 268 B of traffic (64 B packed row + 12 B
// masks in, 3 x 64 B out). When more than about half the steps add, as in
// the MSM's scans, that is the integer multiply rate; below, HBM. Every
// lane computes the addition and selects after it, as the TPU kernel does,
// rather than branching within a warp. The design gives each lane one
// thread with the accumulator in
// registers for all M steps (no device-memory round trip between steps, one
// launch for the whole scan). The (M, 16, B) limb-major layout makes each
// limb plane a coalesced row across the warp's lanes; a packed row's 32-bit
// plane j is already the 32-bit limb j of X (j < 8) or Y (j >= 8).
#include "bn254_mont.cuh"

using namespace zk;

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
madd_scan_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ masks,
                 int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                 int32_t* __restrict__ oz, int steps, int lanes) {
  const long b = (long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= lanes) return;
  const long B = lanes;
  Pt acc = pt_inf();
  for (int m = 0; m < steps; m++) {
    const int32_t* row = rows + (long)m * 16 * B + b;
    Fe x2, y2;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      x2.v[i] = (uint32_t)row[i * B];
      y2.v[i] = (uint32_t)row[(8 + i) * B];
    }
    const int32_t* mk = masks + (long)m * 3 * B + b;
    const bool same = mk[0] != 0;
    const bool valid = mk[B] != 0;
    if (mk[2 * B] != 0) y2 = fe_sub<Fq>(fe_zero(), y2);
    const Pt sum = pt_madd(acc, x2, y2);
    const Pt q{x2, y2, fe_one<Fq>()};
    acc = valid ? pt_select(same, sum, q) : pt_select(same, acc, pt_inf());
    const long o = (long)m * 16 * B + b;
    store_limbs16(ox + o, B, acc.x);
    store_limbs16(oy + o, B, acc.y);
    store_limbs16(oz + o, B, acc.z);
  }
}

}  // namespace

// rows: (steps, 16, lanes) packed affine rows; masks: (steps, 3, lanes)
// [same-run; valid; negate-Y]; ox, oy, oz: (steps, 16, lanes) 16-bit limbs.
extern "C" int zk_madd_scan(const void* rows, const void* masks, void* ox, void* oy, void* oz,
                            int steps, int lanes, void* stream) {
  if (steps < 1 || lanes < 1) return (int)cudaErrorInvalidValue;
  const int grid = (lanes + kThreads - 1) / kThreads;
  madd_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)masks, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz,
      steps, lanes);
  return (int)cudaGetLastError();
}
