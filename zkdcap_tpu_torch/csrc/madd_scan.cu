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
// the MSM's scans, that is the integer multiply rate; below, HBM. The design
// gives each lane one thread with the accumulator in registers for all M
// steps (no device-memory round trip between steps, one launch for the
// whole scan), and cuts the cost of a step:
//
// - the products, additions and subtractions are bn254_mont.cuh's
//   carry-chain versions (one 32-bit carry chain per pass, where the 64-bit
//   multiply-add emulation spends about three instructions a word);
// - a lane computes the addition only at the steps where it adds: the
//   other three cases are selects, and a warp none of whose lanes adds at a
//   step skips the addition.
//
// Measured against it (zkdcap_tpu_torch/tools/kernel_variants.py): two
// lanes a thread, interleaved (237 registers, slower at every shape); one
// lane's step split over a group of eight threads (slower at every shape);
// storing only the run ends the MSM reads (within 2%: the stores are not
// what bounds it).
//
// The (M, 16, B) limb-major layout makes each limb plane a coalesced row
// across the warp's lanes; a packed row's 32-bit plane j is already the
// 32-bit limb j of X (j < 8) or Y (j >= 8).
#include "bn254_mont.cuh"

using namespace zk;

namespace {

constexpr int kScanThreads = 128;

struct Step {
  Fe x2, y2;
  bool same, valid;
};

__device__ __forceinline__ Step load_step(const int32_t* __restrict__ rows,
                                          const int32_t* __restrict__ masks, int m, long b,
                                          long B) {
  const int32_t* row = rows + (long)m * 16 * B + b;
  Step s;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    s.x2.v[i] = (uint32_t)row[i * B];
    s.y2.v[i] = (uint32_t)row[(8 + i) * B];
  }
  const int32_t* mk = masks + (long)m * 3 * B + b;
  s.same = mk[0] != 0;
  s.valid = mk[B] != 0;
  if (mk[2 * B] != 0) s.y2 = fe_sub_cc<Fq>(fe_zero(), s.y2);
  return s;
}

// The accumulator after a step where the lane does not add.
__device__ __forceinline__ Pt held(const Pt& acc, const Step& s) {
  return s.valid ? Pt{s.x2, s.y2, fe_one<Fq>()} : (s.same ? acc : pt_inf());
}

// One lane a thread. kMinBlocks, the blocks __launch_bounds__ asks ptxas to
// fit on an SM, caps the registers a thread may use (5: at most 102, 4: at
// most 128).
template <int kMinBlocks>
__global__ void __launch_bounds__(kScanThreads, kMinBlocks)
madd_scan_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ masks,
                 int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                 int32_t* __restrict__ oz, int steps, int lanes) {
  const long b = (long)blockIdx.x * kScanThreads + threadIdx.x;
  if (b >= lanes) return;
  const long B = lanes;
  Pt acc = pt_inf();
  for (int m = 0; m < steps; m++) {
    const Step s = load_step(rows, masks, m, b, B);
    acc = s.valid && s.same ? pt_madd(acc, s.x2, s.y2) : held(acc, s);
    const long o = (long)m * 16 * B + b;
    store_limbs16(ox + o, B, acc.x);
    store_limbs16(oy + o, B, acc.y);
    store_limbs16(oz + o, B, acc.z);
  }
}

}  // namespace

// rows: (steps, 16, lanes) packed affine rows; masks: (steps, 3, lanes)
// [same-run; valid; negate-Y]; ox, oy, oz: (steps, 16, lanes) 16-bit limbs.
//
// Every lane's scan is as long as every other's, so the time goes by waves of
// resident blocks, and a last wave that fills few SMs costs nearly a full
// one. Where all blocks fit on the card at once with at most 102 registers
// a thread (5 blocks an SM), that version runs; above, the one with up to
// 128 registers (4 blocks an SM, fewer waves' worth of latency each). On one
// H100 80GB HBM3 at 700 W (zkdcap_tpu_torch/tools/kernel_variants.py): at
// 8 and 16 x 81,920 lanes (640 blocks, one wave of 5 a SM) the first is
// 0.27 and 0.54 ms against 0.33 and 0.73; at 64 x 131,072 (1,024 blocks)
// the second 3.50 ms against 4.01.
extern "C" int zk_madd_scan(const void* rows, const void* masks, void* ox, void* oy, void* oz,
                            int steps, int lanes, void* stream) {
  if (steps < 1 || lanes < 1) return (int)cudaErrorInvalidValue;
  // lanes each card holds at once at 5 blocks an SM
  static int one_wave_lanes_of[zk::kMaxDevices] = {};
  int dev = 0;
  cudaError_t dev_err = zk::current_device(&dev);
  if (dev_err != cudaSuccess) return (int)dev_err;
  int& one_wave_lanes = one_wave_lanes_of[dev];
  if (!one_wave_lanes) {
    int sms = 0, blocks = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, madd_scan_kernel<5>,
                                                          kScanThreads, 0);
    if (err != cudaSuccess) return (int)err;
    one_wave_lanes = sms * blocks * kScanThreads;
  }
  const int grid = (lanes + kScanThreads - 1) / kScanThreads;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t *r = (const int32_t*)rows, *mk = (const int32_t*)masks;
  int32_t *x = (int32_t*)ox, *y = (int32_t*)oy, *z = (int32_t*)oz;
  if (lanes <= one_wave_lanes)
    madd_scan_kernel<5><<<grid, kScanThreads, 0, s>>>(r, mk, x, y, z, steps, lanes);
  else
    madd_scan_kernel<4><<<grid, kScanThreads, 0, s>>>(r, mk, x, y, z, steps, lanes);
  return (int)cudaGetLastError();
}
