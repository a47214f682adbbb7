// Kernel F: batched bitonic sort of 32-bit operands by the first (an
// unsigned key), the payload operands moving with it.
//
// Replaces zkdcap_tpu/utils/device_sort.py _mk_sort_kernel, in both of its
// uses: bitonic_sort (_sort_call: 1 or 2 operands, the MSM's digit sort and
// run-end sort) and sort_rows_by_key (_rows_sort_call: the key and 8 packed
// point planes, per (window, segment) block).
//
// What it computes is the TPU kernel's network, exactly: stages k = 1..log n,
// in each the strides d = 2^(k-1) down to 1; the pair (i, i ^ d) of a block
// lies in an ascending run where bit k of i (the index within the block) is
// 0; it swaps only on strict inequality (ascending: key[i ^ d] < key[i] for
// the lower i; descending: key[i ^ d] > key[i]), so ties never move and the
// output, payloads included, is a fixed function of the input. Any schedule
// that keeps stage order gives the same bytes.
//
// Design: one block sorts a tile of T = 2^log_t elements of every operand in
// shared memory, all strides d < T of the stages it is given (the first
// log_t stages from the input, or the small strides of one later stage in
// place); strides d >= T of stage k run as one global pass each, one thread
// per pair. T = 2^11 for 9 operands (72 KB of shared memory), 2^13 for 1 or
// 2. Bound: bytes. A sort reads and writes every operand once at least, and
// this design reads and writes them once per global pass and once per tile
// launch besides: 1 + (log n - log t) tile launches and (log n - log t)
// (log n - log t + 1) / 2 global passes.
//
// Operand o of block (w, s) (batch w, segment s) starts at
// in[o] + w * in_ws[o] + s * in_ss[o] (strides in elements), so shared
// planes (stride 0 over w), per-window planes and plain (batch, n) arrays
// are read in place; outputs are written the same way.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_OPS = 9;
constexpr int TILE_THREADS = 512;
constexpr int PASS_THREADS = 256;

struct SortOps {
  const uint32_t* in[MAX_OPS];
  uint32_t* out[MAX_OPS];
  long in_ws[MAX_OPS], in_ss[MAX_OPS], out_ws[MAX_OPS], out_ss[MAX_OPS];
};

template <int NOPS>
constexpr int tile_log() { return NOPS > 2 ? 11 : 13; }

// the lower index of pair p at stride 2^dl
__device__ __forceinline__ long pair_lower(long p, int dl) {
  return ((p >> dl) << (dl + 1)) | (p & ((1L << dl) - 1));
}

__device__ __forceinline__ bool must_swap(uint32_t ki, uint32_t kj, long i, int k) {
  const bool asc = ((i >> k) & 1) == 0;
  return asc ? (kj < ki) : (kj > ki);
}

// Stages k_lo..k_hi on one tile, strides min(k - 1, log_t - 1) down to 0.
template <int NOPS>
__global__ void __launch_bounds__(TILE_THREADS)
bitonic_tile_kernel(SortOps ops, int S, int log_t, int k_lo, int k_hi, int from_in) {
  extern __shared__ uint32_t sm[];
  const int T = 1 << log_t;
  const int w = blockIdx.y / S, s = blockIdx.y % S;
  const long base = (long)blockIdx.x << log_t;
#pragma unroll
  for (int o = 0; o < NOPS; ++o) {
    const uint32_t* src = from_in ? ops.in[o] + w * ops.in_ws[o] + s * ops.in_ss[o]
                                  : ops.out[o] + w * ops.out_ws[o] + s * ops.out_ss[o];
    for (int i = threadIdx.x; i < T; i += blockDim.x) sm[o * T + i] = src[base + i];
  }
  __syncthreads();
  for (int k = k_lo; k <= k_hi; ++k) {
    for (int dl = min(k, log_t) - 1; dl >= 0; --dl) {
      for (int p = threadIdx.x; p < T / 2; p += blockDim.x) {
        const int i = (int)pair_lower(p, dl), j = i | (1 << dl);
        if (must_swap(sm[i], sm[j], base + i, k)) {
#pragma unroll
          for (int o = 0; o < NOPS; ++o) {
            const uint32_t t = sm[o * T + i];
            sm[o * T + i] = sm[o * T + j];
            sm[o * T + j] = t;
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int o = 0; o < NOPS; ++o) {
    uint32_t* dst = ops.out[o] + w * ops.out_ws[o] + s * ops.out_ss[o];
    for (int i = threadIdx.x; i < T; i += blockDim.x) dst[base + i] = sm[o * T + i];
  }
}

// One stride 2^dl >= T of stage k over global memory, in place on the outputs.
template <int NOPS>
__global__ void __launch_bounds__(PASS_THREADS)
bitonic_pass_kernel(SortOps ops, int S, int log_n, int k, int dl) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (1L << (log_n - 1))) return;
  const int w = blockIdx.y / S, s = blockIdx.y % S;
  const long i = pair_lower(p, dl), j = i | (1L << dl);
  uint32_t* key = ops.out[0] + w * ops.out_ws[0] + s * ops.out_ss[0];
  if (must_swap(key[i], key[j], i, k)) {
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
      uint32_t* a = ops.out[o] + w * ops.out_ws[o] + s * ops.out_ss[o];
      const uint32_t t = a[i];
      a[i] = a[j];
      a[j] = t;
    }
  }
}

template <int NOPS>
int run_sort(const SortOps& ops, int W, int S, int log_n, cudaStream_t stream) {
  const int log_t = log_n < tile_log<NOPS>() ? log_n : tile_log<NOPS>();
  const size_t smem = (size_t)NOPS * sizeof(uint32_t) << log_t;
  cudaError_t err = cudaFuncSetAttribute(bitonic_tile_kernel<NOPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 tiles(1u << (log_n - log_t), W * S);
  const dim3 pairs((unsigned)(((1L << (log_n - 1)) + PASS_THREADS - 1) / PASS_THREADS), W * S);
  const int threads = (1 << (log_t - 1)) < TILE_THREADS ? (1 << (log_t - 1)) : TILE_THREADS;
  bitonic_tile_kernel<NOPS><<<tiles, threads, smem, stream>>>(ops, S, log_t, 1, log_t, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int k = log_t + 1; k <= log_n; ++k) {
    for (int dl = k - 1; dl >= log_t; --dl) {
      bitonic_pass_kernel<NOPS><<<pairs, PASS_THREADS, 0, stream>>>(ops, S, log_n, k, dl);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    bitonic_tile_kernel<NOPS><<<tiles, threads, smem, stream>>>(ops, S, log_t, k, k, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int zk_bitonic_sort(const void* in_ptrs, const void* out_ptrs, const long* in_ws,
                               const long* in_ss, const long* out_ws, const long* out_ss,
                               int n_ops, int W, int S, int log_n, cudaStream_t stream) {
  if (n_ops < 1 || n_ops > MAX_OPS || log_n < 1 || log_n > 30 || W < 1 || S < 1 ||
      (long)W * S > 65535)
    return cudaErrorInvalidValue;
  SortOps ops = {};
  for (int o = 0; o < n_ops; ++o) {
    ops.in[o] = static_cast<const uint32_t* const*>(in_ptrs)[o];
    ops.out[o] = static_cast<uint32_t* const*>(out_ptrs)[o];
    ops.in_ws[o] = in_ws[o];
    ops.in_ss[o] = in_ss[o];
    ops.out_ws[o] = out_ws[o];
    ops.out_ss[o] = out_ss[o];
  }
  switch (n_ops) {
    case 1: return run_sort<1>(ops, W, S, log_n, stream);
    case 2: return run_sort<2>(ops, W, S, log_n, stream);
    case 9: return run_sort<9>(ops, W, S, log_n, stream);
    default: return cudaErrorInvalidValue;
  }
}
