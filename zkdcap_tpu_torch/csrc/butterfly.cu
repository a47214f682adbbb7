// Kernel G: one radix-2 DIT stage of the flat NTT over BN254 Fr.
//
// Replaces zkdcap_tpu/fields/pallas_mont.py _mk_butterfly_kernel (butterfly):
// there, for limb-major (16, M) lo, hi and w it returns plus = lo + t and
// minus = lo - t with t = hi * w * R^-1 mod p, all canonical; the caller
// slices lo and hi out of the stage, tiles the twiddles and stacks the
// results back. Here the stage's addressing is in the kernel: over row-major
// (rows, 2^log_n, 16) int32 limbs, with half-span m = 2^s, element i of
// every block of 2m is lo and element i + m is hi, and the twiddle of
// butterfly i is row (i * tw_stride) of one power table of the n-th root
// (tw_stride = n / 2m gives w_{2m}^i). plus goes to lo's position and minus
// to hi's, in place (out == x) or into another array.
//
// One thread per butterfly: it reads lo, hi and its twiddle as 16-byte
// vectors (neighbouring threads read neighbouring rows), does one Montgomery
// product, one addition and one subtraction, and writes two rows.
//
// What bounds it: bytes. Per butterfly it moves four 64-byte rows, plus its
// twiddle row (each of the m distinct twiddles is read once from HBM, the
// rest hit L2): the top stage of a 2^24 transform moves 2.68 GB, 0.80 ms at
// 3.35 TB/s, against 0.13 ms for its 2^23 products of 264 32-bit
// multiply-adds at 16.75 T/s.
#include "bn254_mont.cuh"

using namespace zk;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
butterfly_kernel(const int32_t* x, int32_t* out, const int32_t* __restrict__ tw,
                 long total, int log_n, int s, long tw_stride) {
  const long g = (long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= total) return;
  const long row = g >> (log_n - 1);
  const long k = g & ((1L << (log_n - 1)) - 1);
  const long i = k & ((1L << s) - 1);
  const long lo = (row << log_n) + ((k >> s) << (s + 1)) + i;
  const long hi = lo + (1L << s);
  const Fe u = load_row16(x + lo * 16);
  const Fe v = fe_mul<Fr>(load_row16(x + hi * 16), load_row16(tw + i * tw_stride * 16));
  store_row16(out + lo * 16, fe_add<Fr>(u, v));
  store_row16(out + hi * 16, fe_sub<Fr>(u, v));
}

}  // namespace

// x, out: (rows << log_n, 16) int32 limbs, out == x allowed; tw: the power
// table, row i * tw_stride the twiddle of butterfly i (i < 2^s); stage s
// pairs element j with j + 2^s in every block of 2^(s+1).
extern "C" int zk_butterfly(const void* x, void* out, const void* tw, long rows, int log_n,
                            int s, long tw_stride, void* stream) {
  if (rows < 1 || log_n < 1 || log_n > 40 || s < 0 || s >= log_n || tw_stride < 1)
    return (int)cudaErrorInvalidValue;
  const long total = rows << (log_n - 1);
  const long grid = (total + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  butterfly_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, (const int32_t*)tw, total, log_n, s, tw_stride);
  return (int)cudaGetLastError();
}
