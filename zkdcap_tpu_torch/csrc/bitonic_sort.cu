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
// Design. Only the key and one 32-bit companion go through the network,
// packed as one 64-bit word (key above): the caller's payload for a 2-operand
// sort, nothing for a 1-operand sort, and for the 9-operand row sort the
// position within the segment. The swaps read only the keys, so the position
// that ends in slot i is the one that the 9-operand network would have put
// there, ties included. The 8 planes then move once: bitonic_rows_kernel
// packs them into 32-byte rows and bitonic_permute_kernel writes slot i from
// row position[i], one sector read a slot. A descending pair is an ascending
// pair of complemented keys, so a descending run flips its key bits for the
// stage and one ascending compare-exchange serves both.
//
// A block sorts a tile of T = 2^t words in shared memory (t <= 14; 139 KB
// at 2^14 with one padding word per 16, so a thread's 16 words meet no bank
// conflict). Strides below 2^9 run in a warp round: each lane holds 16 words
// in registers (strides 1..8) and the lanes of a warp exchange them with
// __shfl_xor_sync (strides 16..256), so stages 1..9 take one pass over shared
// memory and every later stage's low 9 bits one more. Strides 2^9..T/2 run in
// rounds of 4 index bits, a thread's 16 words in registers, one barrier each.
// A stage k > t runs its strides >= T as one bitonic_group_kernel launch for
// each group of at most t - 3 of them (the block holds the 2^t words whose
// index bits outside the group and outside a low run of 2^(t-g), which keeps
// the loads coalesced, are fixed), then its strides < T as one
// bitonic_tile_kernel launch in place. A sort of 2^L per (batch, segment)
// block is 1 + 2 (L - t) launches while L - t <= t - 3, plus two for the
// row sort's planes: 13 at the 2^18 commitment (t = 12), 13 at the 2^20 MSM
// (t = 14). t is the largest tile (11..14 when L allows) that leaves two
// blocks per SM.
//
// Bound: operations and launches, not the bytes a sort must move. Each
// stride is a compare and selects on every word (the bound chip_smoke.py
// counts), and each launch reads and writes every word of the group once:
// from L2 for a 2^18 commitment's group (10.5 MB), from device memory for
// the 2^20 MSM's (67 MB), where the 13 launches cost the most. Loads are
// batched 8 deep a thread and 16 bytes wide where aligned, so a launch pays
// the memory latency once per batch, not per word.
//
// Operand o of block (w, s) (batch w, segment s) starts at
// in[o] + w * in_ws[o] + s * in_ss[o] (strides in elements), so shared
// planes (stride 0 over w), per-window planes and plain (batch, n) arrays
// are read in place; outputs are written the same way.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_OPS = 9;
constexpr int MAX_TILE_LOG = 14;
constexpr int MIN_TILE_LOG = 11;
constexpr int CHUNK = 4;       // index bits a thread's 16 registers span
constexpr int THREADS = 512;
constexpr int MIN_RUN_LOG = 3;  // a group kernel reads runs of >= 8 keys (32 B)
constexpr int WARP_BITS = 9;    // a warp's 512 words: 16 registers x 32 lanes

struct SortOps {
  const uint32_t* in[MAX_OPS];
  uint32_t* out[MAX_OPS];
  long in_ws[MAX_OPS], in_ss[MAX_OPS], out_ws[MAX_OPS], out_ss[MAX_OPS];
};

// one padding word per 16: the 16 words of a thread's round lie in 16
// distinct 8-byte banks across a half warp for every bit offset
__host__ __device__ __forceinline__ int pad(int q) { return q + (q >> 4); }

__device__ __forceinline__ uint32_t key_of(uint64_t v) { return (uint32_t)(v >> 32); }

// Bit e of the result: word e sorts descending in stage k (the two words of
// a pair agree). Below `kloc` stage k's direction bit is bit k of the tile
// index q (q0 | e << a for word e of the round), at or above it bit k of
// `fixed` (the block's global index bits).
template <int NB>
__device__ __forceinline__ uint32_t desc_mask(int k, int a, int q0, int kloc, long fixed) {
  constexpr uint32_t ALL = (1u << (1 << NB)) - 1;
  // the words e of 16 whose bit b is set, for b = 0..3: 0xAAAA, 0xCCCC, 0xF0F0, 0xFF00
  constexpr uint64_t PATTERNS = 0xFF00F0F0CCCCAAAAull;
  if (k >= kloc) return ((fixed >> k) & 1) ? ALL : 0u;
  if (k < a + NB) return (uint32_t)(PATTERNS >> (16 * (k - a))) & ALL;
  return ((q0 >> k) & 1) ? ALL : 0u;
}

// One ascending compare-exchange of words x (lower index) and y. With a
// companion (NOPS = 2) the words swap only on a strictly smaller key, so ties
// never move; a key alone (NOPS = 1, companion 0) needs only min and max.
template <int NOPS>
__device__ __forceinline__ void cmpx(uint64_t& x, uint64_t& y) {
  const uint32_t kx = key_of(x), ky = key_of(y);
  if (NOPS == 1) {
    x = (uint64_t)min(kx, ky) << 32;
    y = (uint64_t)max(kx, ky) << 32;
  } else {
    const bool sw = ky < kx;
    const uint64_t lo = sw ? y : x, hi = sw ? x : y;
    x = lo;
    y = hi;
  }
}

// Stages k_first..k_last on tile index bits [a, a + NB): each stage's
// strides from min(k - 1, a + NB - 1) down to a, in registers, 2^NB words a
// thread. Every stride of a stage below bit a must come after this call and
// every stride above it before. A descending pair is an ascending pair of
// complemented keys, so the words of a descending run have their key bits
// flipped for the stage and one ascending compare-exchange serves both.
template <int NOPS, int NB>
__device__ __forceinline__ void round_regs(uint64_t* sm, int t, int a, int k_first, int k_last,
                                           int kloc, long fixed) {
  constexpr int E = 1 << NB;
  const int groups = 1 << (t - NB);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int q0 = ((g >> a) << (a + NB)) | (g & ((1 << a) - 1));
    uint64_t v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = sm[pad(q0 | (e << a))];
    uint32_t flipped = 0;
    for (int k = k_first; k <= k_last; ++k) {
      const uint32_t dm = desc_mask<NB>(k, a, q0, kloc, fixed);
      const uint32_t change = dm ^ flipped;
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[e] ^= (uint64_t)(0u - ((change >> e) & 1u)) << 32;
      flipped = dm;
      const int top = k - 1 - a;  // highest stride of stage k in this round
#pragma unroll
      for (int s = NB - 1; s >= 0; --s) {
        if (s > top) continue;
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (!(e & (1 << s))) cmpx<NOPS>(v[e], v[e | (1 << s)]);
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      sm[pad(q0 | (e << a))] = v[e] ^ ((uint64_t)(0u - ((flipped >> e) & 1u)) << 32);
  }
  __syncthreads();
}

// Stages k_first..k_last on tile bits [lo, hi] (for k > hi + 1 one stage,
// k_first = k_last), highest stride first, in rounds of at most CHUNK bits
// (the remainder on top, so the round at bit lo is full). Stages 1..CHUNK of
// a tile (lo = 0, hi = k_last - 1) go together in one round.
template <int NOPS>
__device__ __forceinline__ void rounds(uint64_t* sm, int t, int k_first, int k_last, int lo, int hi,
                                       int kloc, long fixed) {
  const int rem = (hi - lo + 1) % CHUNK;
  for (int top = hi; top >= lo;) {
    const int nb = (top == hi && rem) ? rem : CHUNK;
    const int a = top - nb + 1;
    switch (nb) {
      case 1: round_regs<NOPS, 1>(sm, t, a, k_first, k_last, kloc, fixed); break;
      case 2: round_regs<NOPS, 2>(sm, t, a, k_first, k_last, kloc, fixed); break;
      case 3: round_regs<NOPS, 3>(sm, t, a, k_first, k_last, kloc, fixed); break;
      default: round_regs<NOPS, 4>(sm, t, a, k_first, k_last, kloc, fixed); break;
    }
    top = a - 1;
  }
}

// Stages k_first..k_last (k_last <= WARP_BITS when k_first <= WARP_BITS) on
// tile index bits [0, WARP_BITS) of a tile of t >= WARP_BITS: each warp holds
// 512-word units, lane l words q0 | e with q0 = unit << 9 | l << 4, so a
// stride of 16..256 is a __shfl_xor_sync between lanes and 1..8 one between
// registers; the stage's higher strides must come before this call.
template <int NOPS>
__device__ __forceinline__ void warp_round(uint64_t* sm, int t, int k_first, int k_last, int kloc,
                                           long fixed) {
  const int lane = threadIdx.x & 31;
  for (int u = threadIdx.x >> 5; u < (1 << (t - WARP_BITS)); u += blockDim.x >> 5) {
    const int q0 = (u << WARP_BITS) | (lane << CHUNK);
    uint64_t v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = sm[pad(q0 | e)];
    uint32_t flipped = 0;
    for (int k = k_first; k <= k_last; ++k) {
      const uint32_t dm = desc_mask<CHUNK>(k, 0, q0, kloc, fixed);
      const uint32_t change = dm ^ flipped;
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] ^= (uint64_t)(0u - ((change >> e) & 1u)) << 32;
      flipped = dm;
      const int top = min(k - 1, WARP_BITS - 1);
      for (int s = top; s >= CHUNK; --s) {  // between lanes: the lower lane keeps the min
        const int d = 1 << (s - CHUNK);
        const bool upper = lane & d;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const uint32_t mine = key_of(v[e]);
          if (NOPS == 1) {
            const uint32_t theirs = __shfl_xor_sync(0xffffffffu, mine, d);
            v[e] = (uint64_t)(upper ? max(mine, theirs) : min(mine, theirs)) << 32;
          } else {
            const uint64_t p = __shfl_xor_sync(0xffffffffu, v[e], d);
            const uint32_t theirs = key_of(p);
            if (upper ? (mine < theirs) : (theirs < mine)) v[e] = p;
          }
        }
      }
#pragma unroll
      for (int s = CHUNK - 1; s >= 0; --s) {  // between registers
        if (s > top) continue;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (!(e & (1 << s))) cmpx<NOPS>(v[e], v[e | (1 << s)]);
      }
    }
#pragma unroll
    for (int e = 0; e < 16; ++e)
      sm[pad(q0 | e)] = v[e] ^ ((uint64_t)(0u - ((flipped >> e) & 1u)) << 32);
  }
  __syncthreads();
}

// Block (w, s) of operand o: its first element in the input or the output.
__device__ __forceinline__ const uint32_t* in_block(const SortOps& ops, int o, int w, int s) {
  return ops.in[o] + w * ops.in_ws[o] + s * ops.in_ss[o];
}
__device__ __forceinline__ uint32_t* out_block(const SortOps& ops, int o, int w, int s) {
  return ops.out[o] + w * ops.out_ws[o] + s * ops.out_ss[o];
}

// Global index (within the block's segment) of tile word q: tile bits
// [0, run) are index bits [0, run), tile bits [run, t) index bits
// [lo, lo + t - run), the rest are `fixed`.
__device__ __forceinline__ long tile_index(int q, int run, int lo, long fixed) {
  return (q & ((1 << run) - 1)) | ((long)(q >> run) << lo) | fixed;
}

// Load the tile: key above, companion below (operand 1; the index itself
// when the input pointer of operand 1 is null; nothing for NOPS = 1). Where
// `vec` (every pointer 16-byte aligned, every block offset a multiple of 4,
// runs of 4 or more), a thread moves 4 consecutive words per 16-byte access;
// either way it has BATCH accesses in flight before it stores any.
constexpr int BATCH = 8;
constexpr int VBATCH = 4;

__device__ __forceinline__ uint64_t word(uint32_t key, uint32_t comp) {
  return ((uint64_t)key << 32) | comp;
}

template <int NOPS>
__device__ __forceinline__ void load_tile(uint64_t* sm, const uint32_t* key, const uint32_t* comp,
                                          int t, int run, int lo, long fixed, int vec) {
  const int T = 1 << t;
  if (vec) {
    for (int q0 = 4 * threadIdx.x; q0 < T; q0 += 4 * VBATCH * blockDim.x) {
      uint4 kv[VBATCH], cv[VBATCH];
#pragma unroll
      for (int j = 0; j < VBATCH; ++j) {
        const int q = q0 + 4 * j * blockDim.x;
        if (q < T) {
          const long i = tile_index(q, run, lo, fixed);
          kv[j] = *reinterpret_cast<const uint4*>(key + i);
          const uint32_t c = (uint32_t)i;
          cv[j] = NOPS == 1 ? make_uint4(0, 0, 0, 0)
                  : comp    ? *reinterpret_cast<const uint4*>(comp + i)
                            : make_uint4(c, c + 1, c + 2, c + 3);
        }
      }
#pragma unroll
      for (int j = 0; j < VBATCH; ++j) {
        const int q = q0 + 4 * j * blockDim.x;
        if (q < T) {
          sm[pad(q)] = word(kv[j].x, cv[j].x);
          sm[pad(q + 1)] = word(kv[j].y, cv[j].y);
          sm[pad(q + 2)] = word(kv[j].z, cv[j].z);
          sm[pad(q + 3)] = word(kv[j].w, cv[j].w);
        }
      }
    }
  } else {
    for (int q0 = threadIdx.x; q0 < T; q0 += BATCH * blockDim.x) {
      uint32_t kv[BATCH], cv[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int q = q0 + j * blockDim.x;
        if (q < T) {
          const long i = tile_index(q, run, lo, fixed);
          kv[j] = key[i];
          cv[j] = NOPS == 2 ? (comp ? comp[i] : (uint32_t)i) : 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int q = q0 + j * blockDim.x;
        if (q < T) sm[pad(q)] = word(kv[j], cv[j]);
      }
    }
  }
  __syncthreads();
}

template <int NOPS>
__device__ __forceinline__ void store_tile(const uint64_t* sm, uint32_t* key, uint32_t* comp,
                                           int t, int run, int lo, long fixed, int vec) {
  const int T = 1 << t;
  if (vec) {
    for (int q = 4 * threadIdx.x; q < T; q += 4 * blockDim.x) {
      const uint64_t a = sm[pad(q)], b = sm[pad(q + 1)], c = sm[pad(q + 2)], d = sm[pad(q + 3)];
      const long i = tile_index(q, run, lo, fixed);
      *reinterpret_cast<uint4*>(key + i) = make_uint4(key_of(a), key_of(b), key_of(c), key_of(d));
      if (NOPS == 2)
        *reinterpret_cast<uint4*>(comp + i) =
            make_uint4((uint32_t)a, (uint32_t)b, (uint32_t)c, (uint32_t)d);
    }
    return;
  }
  for (int q0 = threadIdx.x; q0 < T; q0 += BATCH * blockDim.x) {
    uint64_t v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int q = q0 + j * blockDim.x;
      if (q < T) v[j] = sm[pad(q)];
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int q = q0 + j * blockDim.x;
      if (q < T) {
        const long i = tile_index(q, run, lo, fixed);
        key[i] = key_of(v[j]);
        if (NOPS == 2) comp[i] = (uint32_t)v[j];
      }
    }
  }
}

// Stages k_first..k_last on the tile of 2^t consecutive indices (from the
// input when from_in, else in place on the output): all strides < 2^t.
template <int NOPS>
__global__ void __launch_bounds__(THREADS)
bitonic_tile_kernel(SortOps ops, int S, int t, int k_first, int k_last, int from_in, int vec) {
  extern __shared__ uint64_t sm[];
  const int w = blockIdx.y / S, s = blockIdx.y % S;
  const long base = (long)blockIdx.x << t;
  uint32_t* okey = out_block(ops, 0, w, s);
  uint32_t* ocomp = NOPS == 2 ? out_block(ops, 1, w, s) : nullptr;
  const uint32_t* ikey = from_in ? in_block(ops, 0, w, s) : okey;
  const uint32_t* icomp = ocomp;
  if (from_in) icomp = (NOPS == 2 && ops.in[1]) ? in_block(ops, 1, w, s) : nullptr;
  load_tile<NOPS>(sm, ikey, icomp, t, t, t, base, vec);
  for (int k = k_first; k <= k_last;) {
    if (t < WARP_BITS) {  // stages 1..4 go together in one round of registers
      const int k_hi = k == 1 ? min(k_last, min(t, CHUNK)) : k;
      rounds<NOPS>(sm, t, k, k_hi, 0, min(k_hi, t) - 1, t, base);
      k = k_hi + 1;
      continue;
    }
    // strides >= 2^9 in rounds of registers, then the rest in one warp round
    // (stages 1..9 together)
    const int k_hi = k <= WARP_BITS ? min(k_last, WARP_BITS) : k;
    if (k > WARP_BITS) rounds<NOPS>(sm, t, k, k, WARP_BITS, min(k, t) - 1, t, base);
    warp_round<NOPS>(sm, t, k, k_hi, t, base);
    k = k_hi + 1;
  }
  store_tile<NOPS>(sm, okey, ocomp, t, t, t, base, vec);
}

// Strides 2^hi..2^lo (hi = lo + g - 1 >= t) of stage k, in place on the
// output: the block holds index runs of 2^(t-g) at every value of bits
// [lo, hi]; the other bits are the block's.
template <int NOPS>
__global__ void __launch_bounds__(THREADS)
bitonic_group_kernel(SortOps ops, int S, int t, int k, int lo, int g, int vec) {
  extern __shared__ uint64_t sm[];
  const int w = blockIdx.y / S, s = blockIdx.y % S;
  const int run = t - g;
  const long bx = blockIdx.x;
  const long fixed = ((bx & ((1L << (lo - run)) - 1)) << run) | ((bx >> (lo - run)) << (lo + g));
  uint32_t* okey = out_block(ops, 0, w, s);
  uint32_t* ocomp = NOPS == 2 ? out_block(ops, 1, w, s) : nullptr;
  load_tile<NOPS>(sm, okey, ocomp, t, run, lo, fixed, vec);
  // tile bits [run, t) are index bits [lo, lo + g); the direction bit k is
  // above them, so it is one of the block's bits (or k = log n: ascending)
  rounds<NOPS>(sm, t, k, k, run, t - 1, 0, fixed);
  store_tile<NOPS>(sm, okey, ocomp, t, run, lo, fixed, vec);
}

// The row sort's planes, moved once, in two coalesced passes: the 8 planes
// of a block into 32-byte rows (bitonic_rows_kernel), then slot i of plane o
// takes word o - 1 of row order[i] (bitonic_permute_kernel), one 32-byte
// sector a slot where 8 reads from the plane-major planes would fetch 8.
constexpr int PLANES = MAX_OPS - 1;

__global__ void __launch_bounds__(256)
bitonic_rows_kernel(SortOps ops, uint4* __restrict__ rows, int S, long n) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int w = blockIdx.y / S, s = blockIdx.y % S;
  uint32_t r[PLANES];
#pragma unroll
  for (int o = 0; o < PLANES; ++o) r[o] = in_block(ops, o + 1, w, s)[j];
  uint4* dst = rows + 2 * ((long)blockIdx.y * n + j);
  dst[0] = make_uint4(r[0], r[1], r[2], r[3]);
  dst[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// `shared`: the rows of batch 0 serve every batch.
__global__ void __launch_bounds__(256)
bitonic_permute_kernel(SortOps ops, const uint32_t* __restrict__ order,
                       const uint4* __restrict__ rows, int S, long n, int shared) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int w = blockIdx.y / S, s = blockIdx.y % S;
  const uint32_t src = order[(long)blockIdx.y * n + i];
  const uint4* row = rows + 2 * ((long)(shared ? s : blockIdx.y) * n + src);
  const uint4 a = __ldg(row), b = __ldg(row + 1);
  const uint32_t r[PLANES] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int o = 0; o < PLANES; ++o) out_block(ops, o + 1, w, s)[i] = r[o];
}

// One-time state is per device (cudaFuncSetAttribute applies in the current
// device's context), indexed by the current device's ordinal.
constexpr int kMaxDevices = 64;

int sm_count(int dev) {
  static int count[kMaxDevices] = {};
  if (!count[dev] &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 132;
  return count[dev];
}

template <int NOPS>
int run_network(const SortOps& ops, int W, int S, int log_n, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  // the largest tile that leaves two blocks per SM, within [MIN_TILE_LOG, MAX_TILE_LOG]
  int t = log_n < MAX_TILE_LOG ? log_n : MAX_TILE_LOG;
  while (t > MIN_TILE_LOG && ((long)W * S << (log_n - t)) < 2L * sm_count(dev)) --t;
  const size_t smem = sizeof(uint64_t) * (size_t)pad(1 << t);
  static bool attr_set[kMaxDevices] = {};
  if (!attr_set[dev]) {
    const int max_smem = (int)(sizeof(uint64_t) * (size_t)pad(1 << MAX_TILE_LOG));
    if ((err = cudaFuncSetAttribute(bitonic_tile_kernel<NOPS>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem)) ||
        (err = cudaFuncSetAttribute(bitonic_group_kernel<NOPS>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem)))
      return err;
    attr_set[dev] = true;
  }
  // 16-byte accesses where every block of operands 0 and 1 starts aligned
  int vec = t >= 2;
  for (int o = 0; o < NOPS; ++o) {
    const long strides = ops.in_ws[o] | ops.in_ss[o] | ops.out_ws[o] | ops.out_ss[o];
    vec &= (strides % 4 == 0) && (reinterpret_cast<uintptr_t>(ops.out[o]) % 16 == 0) &&
           (reinterpret_cast<uintptr_t>(ops.in[o]) % 16 == 0);
  }
  const dim3 grid(1u << (log_n - t), W * S);
  const int groups = 1 << (t > CHUNK ? t - CHUNK : 0);
  const int threads = groups < 32 ? 32 : (groups < THREADS ? groups : THREADS);
  bitonic_tile_kernel<NOPS><<<grid, threads, smem, stream>>>(ops, S, t, 1, t, 1, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int k = t + 1; k <= log_n; ++k) {
    for (int hi = k - 1; hi >= t;) {
      const int g = hi - t + 1 < t - MIN_RUN_LOG ? hi - t + 1 : t - MIN_RUN_LOG;
      bitonic_group_kernel<NOPS><<<grid, threads, smem, stream>>>(ops, S, t, k, hi - g + 1, g, vec);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      hi -= g;
    }
    bitonic_tile_kernel<NOPS><<<grid, threads, smem, stream>>>(ops, S, t, k, k, 0, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// n_ops 1 (key), 2 (key + payload) or 9 (key + 8 planes, every plane with
// the same block strides). For 9, `scratch` holds W * S * 2^log_n 32-bit words
// (the positions, block (w, s) at (w * S + s) * 2^log_n), rounded up to a
// multiple of 4, and then the planes as 32-byte rows: 8 * S * 2^log_n words
// when the planes are shared by the batches (batch stride 0), 8 * W * S *
// 2^log_n otherwise; unused for 1 or 2.
extern "C" int zk_bitonic_sort(const void* in_ptrs, const void* out_ptrs, const long* in_ws,
                               const long* in_ss, const long* out_ws, const long* out_ss,
                               int n_ops, int W, int S, int log_n, void* scratch,
                               cudaStream_t stream) {
  if ((n_ops != 1 && n_ops != 2 && n_ops != MAX_OPS) || log_n < 1 || log_n > 30 || W < 1 ||
      S < 1 || (long)W * S > 65535 || (n_ops == MAX_OPS && !scratch))
    return cudaErrorInvalidValue;
  for (int o = 2; o < n_ops; ++o)
    if (in_ws[o] != in_ws[1] || in_ss[o] != in_ss[1]) return cudaErrorInvalidValue;
  SortOps ops = {};
  for (int o = 0; o < n_ops; ++o) {
    ops.in[o] = static_cast<const uint32_t* const*>(in_ptrs)[o];
    ops.out[o] = static_cast<uint32_t* const*>(out_ptrs)[o];
    ops.in_ws[o] = in_ws[o];
    ops.in_ss[o] = in_ss[o];
    ops.out_ws[o] = out_ws[o];
    ops.out_ss[o] = out_ss[o];
  }
  if (n_ops == 1) return run_network<1>(ops, W, S, log_n, stream);
  if (n_ops == 2) return run_network<2>(ops, W, S, log_n, stream);
  // the row sort: key + position through the network, then the planes once
  const long n = 1L << log_n;
  SortOps net = {};
  net.in[0] = ops.in[0];
  net.in_ws[0] = ops.in_ws[0];
  net.in_ss[0] = ops.in_ss[0];
  net.out[0] = ops.out[0];
  net.out_ws[0] = ops.out_ws[0];
  net.out_ss[0] = ops.out_ss[0];
  net.in[1] = nullptr;  // the position within the segment
  net.out[1] = static_cast<uint32_t*>(scratch);  // the positions
  net.out_ws[1] = S * n;
  net.out_ss[1] = n;
  int err = run_network<2>(net, W, S, log_n, stream);
  if (err) return err;
  uint32_t* order = static_cast<uint32_t*>(scratch);
  uint4* rows = reinterpret_cast<uint4*>(order + (((long)W * S * n + 3) & ~3L));
  const int shared = in_ws[1] == 0;
  const unsigned chunks = (unsigned)((n + 255) / 256);
  bitonic_rows_kernel<<<dim3(chunks, (shared ? 1 : W) * S), 256, 0, stream>>>(ops, rows, S, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bitonic_permute_kernel<<<dim3(chunks, W * S), 256, 0, stream>>>(ops, order, rows, S, n, shared);
  return cudaGetLastError();
}
