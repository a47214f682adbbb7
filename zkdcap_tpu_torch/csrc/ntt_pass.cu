// Kernel A: one NTT pass over BN254 Fr.
//
// Replaces zkdcap_tpu/fields/pallas_mont.py _mk_fused_pass_kernel (:257),
// _mk_fused_pass_kernel_r12 (:396) and _mk_cg_pass_kernel_r12 (:738), one
// contract: for every run of 2^S elements (S <= 11), a size-2^S forward or
// inverse NTT, natural order in and out, then optionally an elementwise
// product with a second operand (the four-step inter-pass twiddles, which
// carry n^-1 for the inverse). Outputs are canonical, so any exact algorithm
// gives the plain version's bits.
//
// Layout. x and out are (batch, rows, 2^S, 16) int32 views whose limb
// dimension is contiguous; their batch, row and element strides are
// arguments (multiples of 4 words: every element is four aligned 16-byte
// words). So the four-step transform (zkdcap_tpu_torch/ntt/ntt.py) is two
// launches and no copy: pass A reads the columns of the (N1, N2) view in
// place and writes a contiguous (N2, N1) scratch, pass B reads the
// scratch's columns and writes out[k1 + N1 k2] through a transposed view.
// An element is 64 contiguous bytes, two whole 32-byte sectors, so a column
// read or a transposed write still moves whole sectors; the JAX package's
// three swaps around its passes (zkdcap_tpu/ntt/ntt.py:226-240) have no
// counterpart here. The post-multiply takes flat element g of out's logical
// order times ptw[g % period].
//
// What bounds it: Montgomery products. A pass moves 128 B an element (192
// with the post-multiply) but computes about S/2 products on it of 264
// 32-bit multiply-adds each, so at S >= 9 the integer multiply rate bounds
// it. The first design (radix 2 through shared memory, one butterfly a thread,
// a barrier a stage) took 2.7x that bound; the product itself runs at 58% of
// the rate the bound assumes (36.5 G fe_mul_cc a second against 63.4 on one
// H100 80GB HBM3 at 700 W, zkdcap_tpu_torch/tools/kernel_variants.py), which
// sets this design's floor. What it does about each cause of the rest:
//  1. products by w^0 = R (x R R^-1 = x for canonical x) are skipped where a
//     whole warp has them: the first pass's two stages hold 1,536 of the
//     2,047 of a 2^11 transform, uniform across its threads;
//  2. the product: fe_mul_cc inlined at passes of 2^10 and 2^11, fe_mul as
//     one called function below them and where the last pass post-multiplies
//     four elements a thread (2^10 with the twiddles): one copy of the
//     product's code stays in the instruction cache where the inlined
//     products of a pass do not (2^8 over 11,264 rows: 0.41 ms called, 0.51
//     with fe_mul and 0.66 with fe_mul_cc inlined; 2^10 over 1,024 rows with
//     the twiddles: 0.218 called, 0.250 with fe_mul_cc); the additions are
//     the carry-chain fe_add_cc / fe_sub_cc (18 and 17 SASS instructions
//     against 49 and 42);
//  3. twiddles: each group of elements loads the 2^r - 1 it needs once per
//     pass (the table, at most 64 KB, stays in L1), not once per butterfly;
//  4. r = 2 stages in registers between exchanges: a thread holds 4
//     elements, so a 2^11 transform takes six passes and five barriers; the
//     first pass reads device memory (the bit reversal is its address) and
//     the last writes it (post-multiply fused), so shared memory carries only
//     the exchanges, planar (limb k of position p at k T + swz(p)) and
//     conflict-free. Eight elements a thread (three stages) spilled at 128
//     registers and, unspilled at 150-190, ran at 1.35 ms against 0.83 (the
//     inlined products of one pass outgrow the instruction cache); two a
//     thread took 0.93;
//  5. the tile (2^8 to 2^11 elements, whole rows) is picked at each launch
//     by waves: the grid that fills its last wave of resident blocks best,
//     the smaller tile on ties, the occupancy of each tile read once;
//  6. the transposes: see Layout above. With rows_rev the rows of a batch
//     are read in bit-reversed order, so the flat NTT's chunks are read as
//     the columns of the array in place, without its former gather.
#include "bn254_mont.cuh"

using namespace zk;

namespace {

constexpr int kNttMaxLog = 11;
constexpr int kNttMaxTileLog = 11;  // 2^11 elements x 32 B = 64 KB of shared memory
constexpr int kNttMinTileLog = 8;   // two warps at r = 2
// the entry point's design: 2^kNttLogR elements a thread,
// __launch_bounds__(kNttThreads, kNttMinBlocks), fe_mul called (MulCalled)
// or fe_mul_cc inlined (MulCc) as ntt_entry picks
constexpr int kNttLogR = 2;
constexpr int kNttThreads = 256;
constexpr int kNttMinBlocks = 2;
constexpr int kNttInlineLog = 10;

struct NttArgs {
  const int32_t* x;
  int32_t* out;
  const int32_t* tw;
  const int32_t* ptw;
  long rows;        // rows of each batch
  long total_rows;  // batches x rows
  long ptw_period;
  long xb, xr, xe;  // strides of x in int32 words: batch, row, element
  long ob, orow, oe;
  int log_size;
  int rows_rev;  // 0, or log2(rows): row r of each batch reads x's row bitrev(r)
  int tile_log;  // a block's tile: 2^tile_log elements, 2^(tile_log - log_size) rows
};

// Position p's word within its 32-word row of banks: p's low five bits XOR
// a function of v = p >> 5 (v mod 4 into bits 0-1 and 2-3, bit 1 of v into
// bit 4). A warp's 32 accesses of one pass at r = 2 (positions 4q + u,
// 16h + 4u + j, 64h + 16u + j, then runs of 32) land in 32 distinct banks.
__device__ __forceinline__ int swz(int p) {
  const int v = p >> 5;
  return p ^ ((v & 3) * 5) ^ ((v & 2) << 3);
}

__device__ __forceinline__ Fe tile_load(const uint32_t* sh, int T, int p) {
  const int q = swz(p);
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = sh[k * T + q];
  return r;
}

__device__ __forceinline__ void tile_store(uint32_t* sh, int T, int p, const Fe& a) {
  const int q = swz(p);
#pragma unroll
  for (int k = 0; k < 8; k++) sh[k * T + q] = a.v[k];
}

// The products the entry point's passes take (their Mul parameter): fe_mul_cc
// inlined at every use, or fe_mul as one called function (one copy of its
// code in place of one a butterfly). zkdcap_tpu_torch/tools/kernel_variants.cu
// adds the ones that lost.
struct MulCc {
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) {
    return fe_mul_cc<Fr>(a, b);
  }
};
__device__ __noinline__ Fe fe_mul_call(Fe a, Fe b) { return fe_mul<Fr>(a, b); }
struct MulCalled {
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) { return fe_mul_call(a, b); }
};

// word offset of row R (batch-major over the (batch, rows) dimensions); with
// rev > 0 the row within the batch is read bit-reversed over rev bits
__device__ __forceinline__ long row_offset(long R, long rows, long bs, long rs, int rev = 0) {
  const long b = R / rows;
  long r = R - b * rows;
  if (rev) r = (long)(__brevll((unsigned long long)r) >> (64 - rev));
  return b * bs + r * rs;
}

// Stages s0 .. s0 + RP - 1 of the radix-2 DIT over the tile's rows, each
// row held at bit-reversed positions: stage s pairs positions lo and lo + 2^s
// (bit s of lo clear) with the twiddle w^(j' 2^(S-1-s)), j' = lo mod 2^s.
// Group g of a row holds positions base + u m0 for u < 2^RP, m0 = 2^s0,
// base = (g >> s0) 2^(s0+RP) + (g mod m0); its stages mix only across u.
template <int RP, bool FIRST, bool LAST, class Mul>
__device__ __forceinline__ void ntt_stages(const NttArgs& a, uint32_t* sh, int s0,
                                           long first_row, int nt) {
  constexpr int E = 1 << RP;
  const int S = a.log_size;
  const int T = 1 << a.tile_log;
  const int m0 = 1 << s0;
  const int g_log = S - RP;  // a row has 2^g_log groups
  const int ngroups = nt << g_log;
  for (int q = threadIdx.x; q < ngroups; q += blockDim.x) {
    const int t = q >> g_log;
    const int g = q & ((1 << g_log) - 1);
    const int j = FIRST ? 0 : (g & (m0 - 1));
    const int base = ((g >> s0) << (s0 + RP)) + j;
    const long R = first_row + t;
    Fe v[E];
    if constexpr (FIRST) {
      // position p holds natural element bitrev(p): the reversal is the address
      const int32_t* xrow = a.x + row_offset(R, a.rows, a.xb, a.xr, a.rows_rev);
#pragma unroll
      for (int u = 0; u < E; u++) {
        const int i = (int)(__brev((unsigned)(base + u)) >> (32 - S));
        v[u] = load_row16(xrow + i * a.xe);
      }
    } else {
#pragma unroll
      for (int u = 0; u < E; u++) v[u] = tile_load(sh, T, (t << S) + base + u * m0);
    }
#pragma unroll
    for (int st = 0; st < RP; st++) {
      const int half = 1 << st;
      const int shift = S - 1 - s0 - st;
#pragma unroll
      for (int ul = 0; ul < half; ul++) {
        // j' = ul m0 + j; in the first pass j = 0, so ul = 0 is w^0 for every thread
        const bool unit = FIRST && ul == 0;
        Fe w;
        if (!unit) w = load_row16(a.tw + ((long)(ul * m0 + j) << shift) * 16);
#pragma unroll
        for (int uh = 0; uh < E; uh += 2 * half) {
          const int lo = uh + ul, hi = lo + half;
          const Fe tv = unit ? v[hi] : Mul::mul(v[hi], w);
          v[hi] = fe_sub_cc<Fr>(v[lo], tv);
          v[lo] = fe_add_cc<Fr>(v[lo], tv);
        }
      }
    }
    if constexpr (LAST) {
      // after the last stage position i holds output element i
      int32_t* orow = a.out + row_offset(R, a.rows, a.ob, a.orow);
      const long period = a.ptw_period;
      const bool pow2 = (period & (period - 1)) == 0;
#pragma unroll
      for (int u = 0; u < E; u++) {
        const int i = base + u * m0;
        Fe r = v[u];
        if (a.ptw != nullptr) {
          const long g_flat = (R << S) + i;
          const long k = pow2 ? (g_flat & (period - 1)) : g_flat % period;
          r = Mul::mul(r, load_row16(a.ptw + k * 16));
        }
        store_row16(orow + i * a.oe, r);
      }
    } else {
#pragma unroll
      for (int u = 0; u < E; u++) tile_store(sh, T, (t << S) + base + u * m0, v[u]);
    }
  }
}

template <int RP, class Mul>
__device__ __forceinline__ void ntt_pass_rp(bool first, bool last, const NttArgs& a,
                                            uint32_t* sh, int s0, long first_row, int nt) {
  if (first && last)
    ntt_stages<RP, true, true, Mul>(a, sh, s0, first_row, nt);
  else if (first)
    ntt_stages<RP, true, false, Mul>(a, sh, s0, first_row, nt);
  else if (last)
    ntt_stages<RP, false, true, Mul>(a, sh, s0, first_row, nt);
  else
    ntt_stages<RP, false, false, Mul>(a, sh, s0, first_row, nt);
}

// LOG_R: a thread holds 2^LOG_R elements per pass (the last pass of a size
// that LOG_R does not divide holds fewer); Mul: the product; at most MAXT
// threads a block, registers for MINB blocks an SM.
template <int LOG_R, class Mul, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) ntt_pass_kernel(const NttArgs a) {
  extern __shared__ uint32_t ntt_tile[];
  const int rows_log = a.tile_log - a.log_size;
  const long first_row = (long)blockIdx.x << rows_log;
  const long left = a.total_rows - first_row;
  const int nt = left < (1L << rows_log) ? (int)left : (1 << rows_log);
  for (int s0 = 0; s0 < a.log_size;) {
    const int rp = min(LOG_R, a.log_size - s0);
    const bool first = s0 == 0, last = s0 + rp == a.log_size;
    if (rp == 3) {
      if constexpr (LOG_R >= 3) ntt_pass_rp<3, Mul>(first, last, a, ntt_tile, s0, first_row, nt);
    } else if (rp == 2) {
      if constexpr (LOG_R >= 2) ntt_pass_rp<2, Mul>(first, last, a, ntt_tile, s0, first_row, nt);
    } else {
      ntt_pass_rp<1, Mul>(first, last, a, ntt_tile, s0, first_row, nt);
    }
    s0 += rp;
    if (!last) __syncthreads();
  }
}

template <int LOG_R, int MAXT>
constexpr int ntt_threads(int tile_log) {
  return (1 << (tile_log - LOG_R)) < MAXT ? (1 << (tile_log - LOG_R)) : MAXT;
}

// Launch with a tile of 2^tile_log elements, or (tile_log 0) the tile whose
// grid fills its last wave of resident blocks best (ties: the smaller tile,
// more blocks to balance). The occupancy of every tile is read at the
// first launch of each instantiation.
template <int LOG_R, class Mul, int MAXT, int MINB>
int ntt_launch(NttArgs a, int tile_log, cudaStream_t stream) {
  static int sms_of[zk::kMaxDevices] = {};
  static int occupancy_of[zk::kMaxDevices][kNttMaxTileLog + 1] = {};
  auto kernel = ntt_pass_kernel<LOG_R, Mul, MAXT, MINB>;
  int dev = 0;
  cudaError_t dev_err = zk::current_device(&dev);
  if (dev_err != cudaSuccess) return (int)dev_err;
  int& sms = sms_of[dev];
  int* occupancy = occupancy_of[dev];
  if (!sms) {
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)(8 * sizeof(uint32_t)) << kNttMaxTileLog);
    for (int tl = kNttMinTileLog; err == cudaSuccess && tl <= kNttMaxTileLog; tl++)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occupancy[tl], kernel, ntt_threads<LOG_R, MAXT>(tl),
          (size_t)(8 * sizeof(uint32_t)) << tl);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  const int lo = a.log_size > kNttMinTileLog ? a.log_size : kNttMinTileLog;
  if (tile_log == 0) {
    double best = -1.0;
    for (int tl = lo; tl <= kNttMaxTileLog; tl++) {
      const long per = 1L << (tl - a.log_size);
      const long blocks = (a.total_rows + per - 1) / per;
      const long slots = (long)sms * (occupancy[tl] > 0 ? occupancy[tl] : 1);
      const long waves = (blocks + slots - 1) / slots;
      const double fill = (double)blocks / (double)(waves * slots);
      if (fill > best + 1e-9) {
        best = fill;
        tile_log = tl;
      }
    }
  }
  if (tile_log < lo || tile_log > kNttMaxTileLog) return (int)cudaErrorInvalidValue;
  a.tile_log = tile_log;
  const long per = 1L << (tile_log - a.log_size);
  const long grid = (a.total_rows + per - 1) / per;
  kernel<<<(unsigned)grid, ntt_threads<LOG_R, MAXT>(tile_log),
           (size_t)(8 * sizeof(uint32_t)) << tile_log, stream>>>(a);
  return (int)cudaGetLastError();
}

NttArgs ntt_args(const void* x, void* out, const void* tw, const void* ptw, long batches,
                 long rows, int log_size, long ptw_period, long xb, long xr, long xe, long ob,
                 long orow, long oe, int rows_rev) {
  return NttArgs{(const int32_t*)x, (int32_t*)out, (const int32_t*)tw, (const int32_t*)ptw,
                 rows, batches * rows, ptw_period, xb, xr, xe, ob, orow, oe, log_size,
                 rows_rev, 0};
}

bool ntt_args_ok(long batches, long rows, int log_size, long ptw_period, int rows_rev) {
  return log_size >= 1 && log_size <= kNttMaxLog && rows >= 1 && batches >= 1 &&
         ptw_period >= 1 && rows_rev >= 0 && (rows_rev == 0 || rows == 1L << rows_rev);
}

// the entry point's kernel for the pass, at tile_log (0: by waves): the
// product called below 2^kNttInlineLog and where the last pass holds
// 2^kNttLogR elements a thread and post-multiplies them (eight products of
// one pass inlined), else inlined
int ntt_entry(const NttArgs& a, int tile_log, cudaStream_t stream) {
  if (a.log_size < kNttInlineLog || (a.ptw != nullptr && a.log_size % kNttLogR == 0))
    return ntt_launch<kNttLogR, MulCalled, kNttThreads, kNttMinBlocks>(a, tile_log, stream);
  return ntt_launch<kNttLogR, MulCc, kNttThreads, kNttMinBlocks>(a, tile_log, stream);
}

}  // namespace

// x, out: (batches, rows, 2^log_size, 16) int32 views, strides in int32
// words (xb, xr, xe and ob, orow, oe; the limbs contiguous); tw:
// (2^(log_size-1), 16) the powers of the 2^log_size-th root; ptw: null or
// (ptw_period, 16), applied to flat element g of out's logical order as
// ptw[g % ptw_period]; rows_rev: 0, or log2(rows) to read row r of each
// batch from x's row bitrev(r) (the flat NTT's chunks).
extern "C" int zk_ntt_pass(const void* x, void* out, const void* tw, const void* ptw,
                           long batches, long rows, int log_size, long ptw_period, long xb,
                           long xr, long xe, long ob, long orow, long oe, int rows_rev,
                           void* stream) {
  if (!ntt_args_ok(batches, rows, log_size, ptw_period, rows_rev))
    return (int)cudaErrorInvalidValue;
  return ntt_entry(ntt_args(x, out, tw, ptw, batches, rows, log_size, ptw_period, xb, xr, xe,
                            ob, orow, oe, rows_rev),
                   0, (cudaStream_t)stream);
}
