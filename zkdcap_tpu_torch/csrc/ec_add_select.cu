// Kernel C: complete G1 addition with a per-lane select.
//
// Replaces zkdcap_tpu/curves/ec_kernels.py _mk_ec_add_kernel: for each lane,
// out = mask ? P + Q : (fallback_q ? Q : P), with P + Q the RCB'15 complete
// projective addition (a = 0). It serves the MSM's segmented Hillis-Steele
// levels, its bucket tree sums and suffix scans, and the SRS's conditional
// additions. P + Q is symmetric in P and Q (every product and sum of the
// formula is), so the kernel adds the fallback operand to the other one.
//
// What bounds it: a lane that adds does 12 Montgomery products (~3.2k
// 32-bit multiply-adds; b3 by additions) and moves 580 B (P, Q and its mask
// in, the sum out); a lane whose mask is clear only copies its fallback
// (388 B) and computes nothing. Unless nearly nine lanes in ten add, HBM
// bounds it. Most launches are small (the aggregation's tree sums and
// suffix scans: 20 to 40,960 lanes), where one addition's dependent chain
// of products is the time. Two designs, by launch size:
//
// - Large launches (ec_add_select_kernel): a block of 128 threads owns 128
//   or 256 consecutive lanes. It stages the fallback operand's rows into
//   shared memory with 16-byte cp.async copies (each coordinate's rows are
//   one contiguous stretch), lists its adding lanes (ballot and prefix
//   counts), and its threads take the listed lanes densely, one lane each,
//   so the warps that compute are full and none diverges on the mask; the
//   warps left over only stage and store. An adding lane reads its other
//   operand's 64-byte rows directly and writes its sum over its staged row;
//   the block then stores the whole tile back with coalesced 16-byte
//   stores. Rows sit in the tile with their 16-byte chunks swizzled, so
//   that eight consecutive rows read chunk k from eight different bank
//   groups.
// - Small launches (ec_add_select_group_kernel, at most kGroupMaxLanes):
//   eight threads per lane. The addition is two levels of six independent
//   products (t0-t5, then the six of X3, Y3, Z3); thread j < 6 of a lane's
//   group computes product j of each level and passes it on through shared
//   memory, so the chain is two products deep instead of twelve. Every
//   thread of the group computes the additions between the levels.
//
// Products, additions and subtractions are bn254_mont.cuh's carry-chain
// versions; every value is canonical, so each design equals the plain
// version (ec_add_select_plain) limb for limb.
#include "bn254_mont.cuh"

using namespace zk;

namespace {

// Threads of a block, large launches, and the lanes a block owns where its
// blocks do not all fit on the card at once (where they do, it owns
// kThreads: see zk_ec_add_select).
constexpr int kLanes = 256;
constexpr int kThreads = 128;
constexpr int kGroup = 8;           // threads per lane, small launches
constexpr int kGroupThreads = 128;  // 16 lanes a block
// Launches of at most this many lanes take the grouped design. On one H100
// 80GB HBM3 at 700 W (zkdcap_tpu_torch/tools/kernel_variants.py) the
// grouped kernel takes 3.6-17.1 us from 20 to 20,480 lanes, where the large
// design takes 12-26 us, but 0.030 ms at 40,960 lanes (the aggregation's
// first tree level), where the large design at one lane a thread takes
// 0.025-0.027.
constexpr int kGroupMaxLanes = 32768;

// 16 int32 limbs of 16 bits (one 64-byte row as four 16-byte chunks) <->
// 8 x 32-bit limbs.
__device__ __forceinline__ Fe row_to_fe(const int4 (&w)[4]) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    r.v[2 * k] = ((uint32_t)w[k].x & 0xffffu) | ((uint32_t)w[k].y << 16);
    r.v[2 * k + 1] = ((uint32_t)w[k].z & 0xffffu) | ((uint32_t)w[k].w << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_to_row(const Fe& a, int4 (&w)[4]) {
#pragma unroll
  for (int k = 0; k < 4; k++)
    w[k] = make_int4((int32_t)(a.v[2 * k] & 0xffffu), (int32_t)(a.v[2 * k] >> 16),
                     (int32_t)(a.v[2 * k + 1] & 0xffffu), (int32_t)(a.v[2 * k + 1] >> 16));
}

__device__ __forceinline__ Fe load_fe(const int4* row) {
  int4 w[4];
#pragma unroll
  for (int k = 0; k < 4; k++) w[k] = row[k];
  return row_to_fe(w);
}

__device__ __forceinline__ void store_fe(int4* row, const Fe& a) {
  int4 w[4];
  fe_to_row(a, w);
#pragma unroll
  for (int k = 0; k < 4; k++) row[k] = w[k];
}

// Chunk k of tile row r (16-byte units).
__device__ __forceinline__ int swz(int r, int k) { return r * 4 + (k ^ ((r >> 1) & 3)); }

__device__ __forceinline__ Fe tile_fe(const int4* tile, int r) {
  int4 w[4];
#pragma unroll
  for (int k = 0; k < 4; k++) w[k] = tile[swz(r, k)];
  return row_to_fe(w);
}

__device__ __forceinline__ void tile_store(int4* tile, int r, const Fe& a) {
  int4 w[4];
  fe_to_row(a, w);
#pragma unroll
  for (int k = 0; k < 4; k++) tile[swz(r, k)] = w[k];
}

__device__ __forceinline__ void cp_async16(int4* smem, const int4* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// kL lanes a block of kT threads (kL a multiple of kT and of 32).
template <int kL, int kT>
__global__ void __launch_bounds__(kT)
ec_add_select_kernel(const int4* __restrict__ x1, const int4* __restrict__ y1,
                     const int4* __restrict__ z1, const int4* __restrict__ x2,
                     const int4* __restrict__ y2, const int4* __restrict__ z2,
                     const int32_t* __restrict__ mask, int4* __restrict__ ox,
                     int4* __restrict__ oy, int4* __restrict__ oz, int n, int fallback_q) {
  extern __shared__ int4 tile[];  // 3 coordinates x kL rows x 4 chunks
  __shared__ int list[kL];
  __shared__ unsigned votes[kL / 32];
  const int t = threadIdx.x;
  const long base = (long)blockIdx.x * kL;
  const int rows = (int)min((long)kL, (long)n - base);
  const int4* fb[3] = {fallback_q ? x2 : x1, fallback_q ? y2 : y1, fallback_q ? z2 : z1};
  const int4* other[3] = {fallback_q ? x1 : x2, fallback_q ? y1 : y2, fallback_q ? z1 : z2};
  int4* out[3] = {ox, oy, oz};

  // stage the fallback rows: each coordinate's rows are contiguous
#pragma unroll
  for (int c = 0; c < 3; c++)
    for (int k = t; k < rows * 4; k += kT)
      cp_async16(tile + c * kL * 4 + swz(k >> 2, k & 3), fb[c] + base * 4 + k);
  asm volatile("cp.async.commit_group;\n" ::);

  // list the adding lanes in order: a vote per 32 lanes, then prefix counts
#pragma unroll
  for (int h = 0; h < kL / kT; h++) {
    const int r = h * kT + t;
    const unsigned vote = __ballot_sync(0xffffffffu, r < rows && mask[base + r] != 0);
    if ((t & 31) == 0) votes[r >> 5] = vote;
  }
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kL / 32; w++) total += __popc(votes[w]);
#pragma unroll
  for (int h = 0; h < kL / kT; h++) {
    const int r = h * kT + t;
    const unsigned vote = votes[r >> 5];
    if ((vote >> (r & 31)) & 1u) {
      int at = __popc(vote & ((1u << (r & 31)) - 1u));
      for (int w = 0; w < (r >> 5); w++) at += __popc(votes[w]);
      list[at] = r;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // the adding lanes, one a thread: the sum replaces the staged row
  for (int k = t; k < total; k += kT) {
    const int r = list[k];
    const Pt F{tile_fe(tile, r), tile_fe(tile + kL * 4, r), tile_fe(tile + 2 * kL * 4, r)};
    const long g = (base + r) * 4;
    const Pt O{load_fe(other[0] + g), load_fe(other[1] + g), load_fe(other[2] + g)};
    const Pt S = pt_add(F, O);
    tile_store(tile, r, S.x);
    tile_store(tile + kL * 4, r, S.y);
    tile_store(tile + 2 * kL * 4, r, S.z);
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < 3; c++)
    for (int k = t; k < rows * 4; k += kT)
      out[c][base * 4 + k] = tile[c * kL * 4 + swz(k >> 2, k & 3)];
}

// Coordinate c (0 X, 1 Y, 2 Z) of a point's planes, by selects rather than
// an indexed local array.
__device__ __forceinline__ const int4* coord(int c, const int4* x, const int4* y,
                                             const int4* z) {
  return c == 0 ? x : (c == 1 ? y : z);
}

// f_j of six values, by selects.
__device__ __forceinline__ Fe pick(int j, const Fe& f0, const Fe& f1, const Fe& f2, const Fe& f3,
                                   const Fe& f4, const Fe& f5) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t lo = j == 0 ? f0.v[i] : (j == 1 ? f1.v[i] : f2.v[i]);
    const uint32_t hi = j == 3 ? f3.v[i] : (j == 4 ? f4.v[i] : f5.v[i]);
    r.v[i] = j < 3 ? lo : hi;
  }
  return r;
}

__global__ void __launch_bounds__(kGroupThreads)
ec_add_select_group_kernel(const int4* __restrict__ x1, const int4* __restrict__ y1,
                           const int4* __restrict__ z1, const int4* __restrict__ x2,
                           const int4* __restrict__ y2, const int4* __restrict__ z2,
                           const int32_t* __restrict__ mask, int4* __restrict__ ox,
                           int4* __restrict__ oy, int4* __restrict__ oz, int n,
                           int fallback_q) {
  constexpr int kGroups = kGroupThreads / kGroup;
  __shared__ Fe prod[kGroups][6];
  const int g = threadIdx.x / kGroup;
  const int j = threadIdx.x % kGroup;
  const int jp = j < 6 ? j : j - 6;  // threads 6, 7 repeat products 0, 1 and keep them
  const long lane = (long)blockIdx.x * kGroups + g;
  const long i = lane < n ? lane : n - 1;  // groups past the end compute the last lane

  // level 1: t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, t3 = (X1 + Y1)(X2 + Y2),
  // t4 = (Y1 + Z1)(Y2 + Z2), t5 = (X1 + Z1)(X2 + Z2): coordinates c1 (and
  // c2 for the sums) of P and Q
  const int c1 = jp < 3 ? jp : (jp == 4 ? 1 : 0);
  const int c2 = jp < 3 ? jp : (jp == 3 ? 1 : 2);
  const Fe p1 = load_fe(coord(c1, x1, y1, z1) + i * 4);
  const Fe q1 = load_fe(coord(c1, x2, y2, z2) + i * 4);
  Fe a = p1, b = q1;
  if (jp >= 3) {
    a = fe_add_cc<Fq>(p1, load_fe(coord(c2, x1, y1, z1) + i * 4));
    b = fe_add_cc<Fq>(q1, load_fe(coord(c2, x2, y2, z2) + i * 4));
  }
  const Fe m1 = fe_mul_cc<Fq>(a, b);
  if (j < 6) prod[g][j] = m1;
  __syncwarp();
  Fe t[6];
#pragma unroll
  for (int k = 0; k < 6; k++) t[k] = prod[g][k];
  __syncwarp();

  // between the levels, as pt_add
  const Fe t3 = fe_sub_cc<Fq>(t[3], fe_add_cc<Fq>(t[0], t[1]));
  const Fe t4 = fe_sub_cc<Fq>(t[4], fe_add_cc<Fq>(t[1], t[2]));
  const Fe t5 = fe_sub_cc<Fq>(t[5], fe_add_cc<Fq>(t[0], t[2]));
  const Fe t0 = fe_add_cc<Fq>(fe_add_cc<Fq>(t[0], t[0]), t[0]);
  const Fe t2 = mul_b3(t[2]);
  const Fe z3 = fe_add_cc<Fq>(t[1], t2);
  const Fe t1 = fe_sub_cc<Fq>(t[1], t2);
  const Fe y3 = mul_b3(t5);

  // level 2: t3 t1, t4 y3, t1 z3, y3 t0, z3 t4, t0 t3
  const Fe m2 = fe_mul_cc<Fq>(pick(jp, t3, t4, t1, y3, z3, t0), pick(jp, t1, y3, z3, t0, t4, t3));
  if (j < 6) prod[g][j] = m2;
  __syncwarp();
  if (j < 3 && lane < n) {
    const Fe s0 = prod[g][2 * j], s1 = prod[g][2 * j + 1];
    const Fe r = j == 0 ? fe_sub_cc<Fq>(s0, s1) : fe_add_cc<Fq>(s0, s1);
    int4* out = j == 0 ? ox : (j == 1 ? oy : oz);
    const int4* fb = fallback_q ? coord(j, x2, y2, z2) : coord(j, x1, y1, z1);
    if (mask[i] != 0) store_fe(out + i * 4, r);
    else
#pragma unroll
      for (int k = 0; k < 4; k++) out[i * 4 + k] = fb[i * 4 + k];
  }
}

template <int kL, int kT>
int launch_large(const int4* a, const int4* b, const int4* c, const int4* d, const int4* e,
                 const int4* f, const int32_t* mask, int4* ox, int4* oy, int4* oz, int n,
                 int fallback_q, cudaStream_t s) {
  constexpr int kTileBytes = 3 * kL * 64;
  // above 48 KB, dynamic shared memory needs the opt-in, on each device
  static bool smem_set[zk::kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = zk::current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(ec_add_select_kernel<kL, kT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  ec_add_select_kernel<kL, kT><<<(n + kL - 1) / kL, kT, kTileBytes, s>>>(
      a, b, c, d, e, f, mask, ox, oy, oz, n, fallback_q);
  return (int)cudaGetLastError();
}

}  // namespace

// All point planes are (n, 16) row-major 16-bit limbs; mask is (n,) int32.
extern "C" int zk_ec_add_select(const void* x1, const void* y1, const void* z1, const void* x2,
                                const void* y2, const void* z2, const void* mask, void* ox,
                                void* oy, void* oz, int n, int fallback_q, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int4 *a = (const int4*)x1, *b = (const int4*)y1, *c = (const int4*)z1;
  const int4 *d = (const int4*)x2, *e = (const int4*)y2, *f = (const int4*)z2;
  if (n <= kGroupMaxLanes) {
    const int grid = (n + kGroupThreads / kGroup - 1) / (kGroupThreads / kGroup);
    ec_add_select_group_kernel<<<grid, kGroupThreads, 0, s>>>(
        a, b, c, d, e, f, (const int32_t*)mask, (int4*)ox, (int4*)oy, (int4*)oz, n, fallback_q);
    return (int)cudaGetLastError();
  }
  // One lane a thread where all blocks fit on the card at once (the
  // aggregation's 40,960 lanes: 0.025 ms, where 256 lanes a block take
  // 0.027-0.033), else two, so that the blocks' adding lanes fill their
  // threads in one wave. On one H100 80GB HBM3 at 700 W (chip_smoke.py's
  // DCAP profile) the 901 launches of 102,400 lanes, the proofs'
  // Hillis-Steele levels, took 49.2 ms at 256 lanes a block (400 blocks);
  // at 128 (800 blocks, 1.5 waves) they and the 104 at 40,960 took 59.4.
  static int one_wave_lanes_of[zk::kMaxDevices] = {};
  int dev = 0;
  cudaError_t dev_err = zk::current_device(&dev);
  if (dev_err != cudaSuccess) return (int)dev_err;
  int& one_wave_lanes = one_wave_lanes_of[dev];
  if (!one_wave_lanes) {
    int sms = 0, blocks = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ec_add_select_kernel<kThreads, kThreads>, kThreads, 3 * kThreads * 64);
    if (err != cudaSuccess) return (int)err;
    one_wave_lanes = sms * blocks * kThreads;
  }
  if (n <= one_wave_lanes)
    return launch_large<kThreads, kThreads>(a, b, c, d, e, f, (const int32_t*)mask, (int4*)ox,
                                            (int4*)oy, (int4*)oz, n, fallback_q, s);
  return launch_large<kLanes, kThreads>(a, b, c, d, e, f, (const int32_t*)mask, (int4*)ox,
                                       (int4*)oy, (int4*)oz, n, fallback_q, s);
}
