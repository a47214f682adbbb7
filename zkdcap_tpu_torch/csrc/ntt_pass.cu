// Kernel A: one NTT pass over BN254 Fr.
//
// Replaces zkdcap_tpu/fields/pallas_mont.py _mk_fused_pass_kernel,
// _mk_fused_pass_kernel_r12 and _mk_cg_pass_kernel_r12 (one contract): for
// every contiguous run of 2^S elements (S <= 11), a size-2^S forward or
// inverse NTT, natural order in and out, optionally followed by an
// elementwise product with a second operand (the four-step inter-pass
// twiddles, which carry n^-1 for the inverse).
//
// What bounds it: Montgomery products. A pass reads and writes each element
// once (128 B, 64 B more with the post-multiply) but does about S/2 - 1
// products on it (~264 32-bit multiply-adds each; the w^0 butterflies need
// none), plus one for the post-multiply, so at S >= 9 it is bound by the
// integer multiply rate, not by HBM.
// The design keeps the whole sub-transform in shared memory (2^11 x 32 B =
// 64 KB at the largest, above the 48 KB default, hence the attribute):
// device memory is touched once on the way in (with the bit reversal done
// by the load's address) and once on the way out (with the post-multiply
// fused). Blocks of small transforms hold several of them so that every
// block has at least 512 elements of work.
#include "bn254_mont.cuh"

using namespace zk;

namespace {

constexpr int kThreads = 256;
constexpr int kMinTileLog = 9;
constexpr int kMaxLog = 11;

__global__ void __launch_bounds__(kThreads)
ntt_pass_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                const int32_t* __restrict__ tw, const int32_t* __restrict__ ptw,
                int rows, int log_size, long ptw_period, int per_block) {
  extern __shared__ Fe sh[];
  const int size = 1 << log_size;
  const int half = size >> 1;
  const long first = (long)blockIdx.x * per_block;
  const int nt = rows - first < per_block ? (int)(rows - first) : per_block;
  const int elems = nt << log_size;
  const long base = first << log_size;

  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int t = e >> log_size;
    const int i = e & (size - 1);
    const int r = (int)(__brev((unsigned)i) >> (32 - log_size));
    sh[(t << log_size) | r] = load_row16(x + (base + e) * 16);
  }
  __syncthreads();

  // radix-2 DIT; stage s pairs (lo, lo + m) with twiddle w^(j * size/(2m))
  for (int s = 0; s < log_size; s++) {
    const int m = 1 << s;
    const int tw_step = half >> s;
    for (int q = threadIdx.x; q < nt * half; q += kThreads) {
      const int t = q >> (log_size - 1);
      const int k = q & (half - 1);
      const int j = k & (m - 1);
      const int lo = (t << log_size) + ((k >> s) << (s + 1)) + j;
      const int hi = lo + m;
      const Fe v = fe_mul<Fr>(sh[hi], load_row16(tw + (long)(j * tw_step) * 16));
      const Fe u = sh[lo];
      sh[lo] = fe_add<Fr>(u, v);
      sh[hi] = fe_sub<Fr>(u, v);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const long g = base + e;
    Fe v = sh[e];
    if (ptw != nullptr) v = fe_mul<Fr>(v, load_row16(ptw + (g % ptw_period) * 16));
    store_row16(out + g * 16, v);
  }
}

}  // namespace

// x, out: (rows << log_size, 16) int32 limbs; tw: (2^(log_size-1), 16) the
// powers of the 2^log_size-th root; ptw: null or (ptw_period, 16), applied
// to element g as ptw[g % ptw_period].
extern "C" int zk_ntt_pass(const void* x, void* out, const void* tw, const void* ptw,
                           int rows, int log_size, int ptw_period, void* stream) {
  if (log_size < 1 || log_size > kMaxLog || rows < 1) return (int)cudaErrorInvalidValue;
  const int per_block = log_size >= kMinTileLog ? 1 : (1 << (kMinTileLog - log_size));
  const size_t smem = (size_t)(per_block << log_size) * sizeof(Fe);
  cudaError_t err = cudaFuncSetAttribute(ntt_pass_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(sizeof(Fe) << kMaxLog));
  if (err != cudaSuccess) return (int)err;
  const int grid = (rows + per_block - 1) / per_block;
  ntt_pass_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, (const int32_t*)tw, (const int32_t*)ptw, rows,
      log_size, (long)ptw_period, per_block);
  return (int)cudaGetLastError();
}
