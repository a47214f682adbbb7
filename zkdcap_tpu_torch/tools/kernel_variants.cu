// Design variants of kernels B and C, built and timed by kernel_variants.py
// beside each other on one card. Nothing of the package launches them.
//
// - C: the package's entry point, and the grouped and large designs each
//   forced at every size, the large one at both block shapes the entry
//   point picks between (the lane-count threshold and the block shape).
// - B: the package's entry point, two lanes a thread, the accumulator
//   stored only at run ends, one lane's step split over a group of eight
//   threads (each of five, then six, products on its own thread), one lane
//   a thread with fe_mul's products in place of fe_mul_cc's, and the
//   package's kernel at both register budgets the entry point picks
//   between.
// - E: the elementwise product with fe_mul and with fe_mul_cc (whether
//   the other kernels should take the carry-chain product).
// - A: the package's entry point and, with a forced tile or not, 2, 4 and 8
//   elements a thread, each product below, two launch bounds; the first design
//   (one butterfly a thread, a barrier a stage, contiguous rows only); and
//   the rate of each product alone.
#include "../csrc/ec_add_select.cu"
#include "../csrc/madd_scan.cu"
#include "../csrc/ntt_pass.cu"

namespace {

// B, one lane's step over a group of eight threads: thread j < 5 computes
// product j of the mixed addition's first level (X1 x2, Y1 y2,
// (X1 + Y1)(x2 + y2), y2 Z1, x2 Z1), thread j < 6 product j of the second
// (pt_add's six); every thread of the group holds the accumulator and
// computes the additions; thread j < 3 stores coordinate j.
constexpr int kBGroup = 8;
constexpr int kBGroupThreads = 128;

__device__ __forceinline__ int32_t* coord_out(int c, int32_t* x, int32_t* y, int32_t* z) {
  return c == 0 ? x : (c == 1 ? y : z);
}

__global__ void __launch_bounds__(kBGroupThreads)
madd_scan_group_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ masks,
                       int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                       int32_t* __restrict__ oz, int steps, int lanes) {
  constexpr int kGroups = kBGroupThreads / kBGroup;
  __shared__ Fe prod[kGroups][6];
  const int g = threadIdx.x / kBGroup;
  const int j = threadIdx.x % kBGroup;
  const int jp = j < 6 ? j : j - 6;
  const long lane = (long)blockIdx.x * kGroups + g;
  const long b = lane < lanes ? lane : lanes - 1;
  const long B = lanes;
  Pt acc = pt_inf();
  for (int m = 0; m < steps; m++) {
    const Step s = load_step(rows, masks, m, b, B);
    const Fe xy1 = fe_add_cc<Fq>(acc.x, acc.y), xy2 = fe_add_cc<Fq>(s.x2, s.y2);
    const Fe m1 = fe_mul_cc<Fq>(pick(jp, acc.x, acc.y, xy1, acc.z, acc.z, acc.x),
                                pick(jp, s.x2, s.y2, xy2, s.y2, s.x2, s.x2));
    if (j < 5) prod[g][j] = m1;
    __syncwarp();
    Fe p[5];
#pragma unroll
    for (int k = 0; k < 5; k++) p[k] = prod[g][k];
    __syncwarp();
    const Fe t3 = fe_sub_cc<Fq>(p[2], fe_add_cc<Fq>(p[0], p[1]));
    const Fe t4 = fe_add_cc<Fq>(acc.y, p[3]);
    const Fe t5 = fe_add_cc<Fq>(acc.x, p[4]);
    const Fe t0 = fe_add_cc<Fq>(fe_add_cc<Fq>(p[0], p[0]), p[0]);
    const Fe t2 = mul_b3(acc.z);
    const Fe z3 = fe_add_cc<Fq>(p[1], t2);
    const Fe t1 = fe_sub_cc<Fq>(p[1], t2);
    const Fe y3 = mul_b3(t5);
    const Fe m2 =
        fe_mul_cc<Fq>(pick(jp, t3, t4, t1, y3, z3, t0), pick(jp, t1, y3, z3, t0, t4, t3));
    if (j < 6) prod[g][j] = m2;
    __syncwarp();
    Fe q[6];
#pragma unroll
    for (int k = 0; k < 6; k++) q[k] = prod[g][k];
    __syncwarp();
    const Pt sum{fe_sub_cc<Fq>(q[0], q[1]), fe_add_cc<Fq>(q[2], q[3]), fe_add_cc<Fq>(q[4], q[5])};
    acc = s.valid && s.same ? sum : held(acc, s);
    if (j < 3 && lane < lanes) {
      const Fe c = j == 0 ? acc.x : (j == 1 ? acc.y : acc.z);
      store_limbs16(coord_out(j, ox, oy, oz) + (long)m * 16 * B + b, B, c);
    }
  }
}

// B, one lane a thread as csrc/madd_scan.cu, with fe_mul (64-bit
// multiply-adds) for the products and the carry-chain additions.
__device__ __forceinline__ Pt pt_madd_mul64(const Pt& P, const Fe& x2, const Fe& y2) {
  Fe t0 = fe_mul<Fq>(P.x, x2);
  Fe t1 = fe_mul<Fq>(P.y, y2);
  Fe t3 = fe_mul<Fq>(fe_add_cc<Fq>(P.x, P.y), fe_add_cc<Fq>(x2, y2));
  t3 = fe_sub_cc<Fq>(t3, fe_add_cc<Fq>(t0, t1));
  Fe t4 = fe_add_cc<Fq>(P.y, fe_mul<Fq>(y2, P.z));
  Fe t5 = fe_add_cc<Fq>(P.x, fe_mul<Fq>(x2, P.z));
  t0 = fe_add_cc<Fq>(fe_add_cc<Fq>(t0, t0), t0);
  Fe t2 = mul_b3(P.z);
  Fe z3 = fe_add_cc<Fq>(t1, t2);
  t1 = fe_sub_cc<Fq>(t1, t2);
  Fe y3 = mul_b3(t5);
  Pt R;
  R.x = fe_sub_cc<Fq>(fe_mul<Fq>(t3, t1), fe_mul<Fq>(t4, y3));
  R.y = fe_add_cc<Fq>(fe_mul<Fq>(t1, z3), fe_mul<Fq>(y3, t0));
  R.z = fe_add_cc<Fq>(fe_mul<Fq>(z3, t4), fe_mul<Fq>(t0, t3));
  return R;
}

__global__ void __launch_bounds__(kScanThreads)
madd_scan_mul64_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ masks,
                       int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                       int32_t* __restrict__ oz, int steps, int lanes) {
  const long b = (long)blockIdx.x * kScanThreads + threadIdx.x;
  if (b >= lanes) return;
  const long B = lanes;
  Pt acc = pt_inf();
  for (int m = 0; m < steps; m++) {
    const Step s = load_step(rows, masks, m, b, B);
    acc = s.valid && s.same ? pt_madd_mul64(acc, s.x2, s.y2) : held(acc, s);
    const long o = (long)m * 16 * B + b;
    store_limbs16(ox + o, B, acc.x);
    store_limbs16(oy + o, B, acc.y);
    store_limbs16(oz + o, B, acc.z);
  }
}

// B, two lanes a thread (lanes g and g + T of T threads), the two additions
// side by side where either lane adds.
__global__ void __launch_bounds__(kScanThreads)
madd_scan_2lanes_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ masks,
                        int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                        int32_t* __restrict__ oz, int steps, int lanes) {
  const long T = (lanes + 1) / 2;
  const long g = (long)blockIdx.x * kScanThreads + threadIdx.x;
  if (g >= T) return;
  const long B = lanes;
  const bool live1 = g + T < B;
  const long b[2] = {g, live1 ? g + T : g};
  Pt acc[2] = {pt_inf(), pt_inf()};
  for (int m = 0; m < steps; m++) {
    const Step s[2] = {load_step(rows, masks, m, b[0], B), load_step(rows, masks, m, b[1], B)};
    const bool add0 = s[0].valid && s[0].same, add1 = s[1].valid && s[1].same;
    if (add0 || add1) {
      const Pt u0 = pt_madd(acc[0], s[0].x2, s[0].y2), u1 = pt_madd(acc[1], s[1].x2, s[1].y2);
      acc[0] = add0 ? u0 : held(acc[0], s[0]);
      acc[1] = add1 ? u1 : held(acc[1], s[1]);
    } else {
      acc[0] = held(acc[0], s[0]);
      acc[1] = held(acc[1], s[1]);
    }
#pragma unroll
    for (int l = 0; l < 2; l++) {
      if (l == 1 && !live1) continue;
      const long o = (long)m * 16 * B + b[l];
      store_limbs16(ox + o, B, acc[l].x);
      store_limbs16(oy + o, B, acc[l].y);
      store_limbs16(oz + o, B, acc[l].z);
    }
  }
}

// B, one lane a thread, storing the accumulator only at the steps the MSM
// reads: where the next step starts a new run, and the last.
__global__ void __launch_bounds__(kScanThreads)
madd_scan_ends_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ masks,
                      int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                      int32_t* __restrict__ oz, int steps, int lanes) {
  const long b = (long)blockIdx.x * kScanThreads + threadIdx.x;
  if (b >= lanes) return;
  const long B = lanes;
  Pt acc = pt_inf();
  for (int m = 0; m < steps; m++) {
    const Step s = load_step(rows, masks, m, b, B);
    acc = s.valid && s.same ? pt_madd(acc, s.x2, s.y2) : held(acc, s);
    if (m + 1 < steps && masks[(long)(m + 1) * 3 * B + b] != 0) continue;
    const long o = (long)m * 16 * B + b;
    store_limbs16(ox + o, B, acc.x);
    store_limbs16(oy + o, B, acc.y);
    store_limbs16(oz + o, B, acc.z);
  }
}

// E as csrc/mont_mul.cu has it (full b, Fr), with either product.
template <bool kCarryChain>
__global__ void __launch_bounds__(256)
mont_mul_variant_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                        int32_t* __restrict__ out, long n) {
  const long g = (long)blockIdx.x * 256 + threadIdx.x;
  if (g >= n) return;
  const Fe x = load_row16(a + g * 16);
  const Fe y = load_row16(b + g * 16);
  store_row16(out + g * 16, kCarryChain ? fe_mul_cc<Fr>(x, y) : fe_mul<Fr>(x, y));
}

// Products kernel A's variants take beside csrc/ntt_pass.cu's MulCc and
// MulCalled: fe_mul inlined, fe_mul_cc called, and two rewrites of fe_mul,
// one adding the row's carry to the partial sum before the wide
// multiply-add (MulA), one doing that in PTX (mad.wide.u32 with a 64-bit
// addend, MulP).
struct MulInline {
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) { return fe_mul<Fr>(a, b); }
};
__device__ __noinline__ Fe fe_mul_cc_call(Fe a, Fe b) { return fe_mul_cc<Fr>(a, b); }
struct MulCcCalled {
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) {
    return fe_mul_cc_call(a, b);
  }
};

__device__ __forceinline__ Fe fe_mul_a(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const uint64_t s = (uint64_t)a.v[j] * b.v[i] + ((uint64_t)t[j] + c);
      t[j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * Fr::INV;
    s = (uint64_t)m * Fr::mod(0) + t[0];
    c = (uint32_t)(s >> 32);
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (uint64_t)m * Fr::mod(j) + ((uint64_t)t[j] + c);
      t[j - 1] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = t[i];
  return reduce_once<Fr>(r, t[8]);
}
struct MulA {
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) { return fe_mul_a(a, b); }
};

// lo + 2^32 carry = a b + t + carry
__device__ __forceinline__ void mac_wide(uint32_t& lo, uint32_t& carry, uint32_t a, uint32_t b,
                                         uint32_t t) {
  asm("{\n\t.reg .u32 l, h;\n\t.reg .u64 acc, r;\n\t"
      "add.cc.u32 l, %2, %3;\n\t"
      "addc.u32 h, 0, 0;\n\t"
      "mov.b64 acc, {l, h};\n\t"
      "mad.wide.u32 r, %4, %5, acc;\n\t"
      "mov.b64 {%0, %1}, r;\n\t}"
      : "=r"(lo), "=r"(carry)
      : "r"(t), "r"(carry), "r"(a), "r"(b));
}

__device__ __forceinline__ Fe fe_mul_p(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) mac_wide(t[j], c, a.v[j], b.v[i], t[j]);
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * Fr::INV;
    uint32_t lo;
    c = 0;
    mac_wide(lo, c, m, Fr::mod(0), t[0]);
#pragma unroll
    for (int j = 1; j < 8; j++) mac_wide(t[j - 1], c, m, Fr::mod(j), t[j]);
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = t[i];
  return reduce_once<Fr>(r, t[8]);
}
struct MulP {
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) { return fe_mul_p(a, b); }
};

// A's first design: a block of 256 threads holds whole rows (at least 512
// elements) in shared memory as 32-byte elements; every stage is one
// butterfly a thread, its twiddle read in the 16-bit layout, then a barrier.
__global__ void __launch_bounds__(256)
ntt_pass_pr1_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                    const int32_t* __restrict__ tw, const int32_t* __restrict__ ptw,
                    int rows, int log_size, long ptw_period, int per_block) {
  extern __shared__ Fe sh[];
  const int size = 1 << log_size;
  const int half = size >> 1;
  const long first = (long)blockIdx.x * per_block;
  const int nt = rows - first < per_block ? (int)(rows - first) : per_block;
  const int elems = nt << log_size;
  const long base = first << log_size;
  for (int e = threadIdx.x; e < elems; e += 256) {
    const int t = e >> log_size;
    const int i = e & (size - 1);
    const int r = (int)(__brev((unsigned)i) >> (32 - log_size));
    sh[(t << log_size) | r] = load_row16(x + (base + e) * 16);
  }
  __syncthreads();
  for (int s = 0; s < log_size; s++) {
    const int m = 1 << s;
    const int tw_step = half >> s;
    for (int q = threadIdx.x; q < nt * half; q += 256) {
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
  for (int e = threadIdx.x; e < elems; e += 256) {
    const long g = base + e;
    Fe v = sh[e];
    if (ptw != nullptr) v = fe_mul<Fr>(v, load_row16(ptw + (g % ptw_period) * 16));
    store_row16(out + g * 16, v);
  }
}

// The card's rate of one product: every thread runs four independent chains
// of `iters` products by one operand (Mul::mul), no memory in the loop.
template <class Mul>
__global__ void __launch_bounds__(256)
product_rate_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
                    int32_t* __restrict__ out, int iters) {
  const long g = (long)blockIdx.x * 256 + threadIdx.x;
  Fe v[4];
#pragma unroll
  for (int c = 0; c < 4; c++) v[c] = load_row16(x + (4 * g + c) * 16);
  const Fe b = load_row16(w + g * 16);
#pragma unroll 1
  for (int k = 0; k < iters; k++) {
#pragma unroll
    for (int c = 0; c < 4; c++) v[c] = Mul::mul(v[c], b);
  }
#pragma unroll
  for (int c = 0; c < 4; c++) store_row16(out + (4 * g + c) * 16, v[c]);
}

}  // namespace

// x, out: (4 * threads, 16); w: (threads, 16); threads a multiple of 256;
// mul: 0 fe_mul, 1 fe_mul_cc, 2 fe_mul called, 3 fe_mul_a, 4 fe_mul_p.
extern "C" int zkv_product_rate(int mul, const void* x, const void* w, void* out, long threads,
                                int iters, void* stream) {
  const unsigned grid = (unsigned)(threads / 256);
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t *a = (const int32_t*)x, *b = (const int32_t*)w;
  int32_t* o = (int32_t*)out;
  switch (mul) {
    case 1: product_rate_kernel<MulCc><<<grid, 256, 0, s>>>(a, b, o, iters); break;
    case 2: product_rate_kernel<MulCalled><<<grid, 256, 0, s>>>(a, b, o, iters); break;
    case 3: product_rate_kernel<MulA><<<grid, 256, 0, s>>>(a, b, o, iters); break;
    case 4: product_rate_kernel<MulP><<<grid, 256, 0, s>>>(a, b, o, iters); break;
    default: product_rate_kernel<MulInline><<<grid, 256, 0, s>>>(a, b, o, iters); break;
  }
  return (int)cudaGetLastError();
}

// design: 0 csrc/ec_add_select.cu's entry point, 1 the grouped design, 2-3 the
// large design at 256 lanes a block of 128 threads and 128 of 128.
extern "C" int zkv_ec_add_select(int design, const void* x1, const void* y1, const void* z1,
                                 const void* x2, const void* y2, const void* z2,
                                 const void* mask, void* ox, void* oy, void* oz, int n,
                                 int fallback_q, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (design == 0)
    return zk_ec_add_select(x1, y1, z1, x2, y2, z2, mask, ox, oy, oz, n, fallback_q, stream);
  // the entry point picks by n; force each design here
  const int4 *a = (const int4*)x1, *b = (const int4*)y1, *c = (const int4*)z1;
  const int4 *d = (const int4*)x2, *e = (const int4*)y2, *f = (const int4*)z2;
  const int32_t* mk = (const int32_t*)mask;
  int4 *u = (int4*)ox, *v = (int4*)oy, *w = (int4*)oz;
  if (design == 1) {
    const int per = kGroupThreads / kGroup;
    ec_add_select_group_kernel<<<(n + per - 1) / per, kGroupThreads, 0, s>>>(
        a, b, c, d, e, f, mk, u, v, w, n, fallback_q);
    return (int)cudaGetLastError();
  }
  if (design == 2) return launch_large<256, 128>(a, b, c, d, e, f, mk, u, v, w, n, fallback_q, s);
  return launch_large<128, 128>(a, b, c, d, e, f, mk, u, v, w, n, fallback_q, s);
}

// design: 0 csrc/madd_scan.cu's entry point, 1 two lanes a thread, 2 storing run
// ends only, 3 a group of eight threads a lane, 4 fe_mul's 64-bit products,
// 5-6 csrc/madd_scan.cu's kernel with __launch_bounds__ asking for 4 and 5
// blocks an SM.
extern "C" int zkv_madd_scan(int design, const void* rows, const void* masks, void* ox,
                             void* oy, void* oz, int steps, int lanes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* r = (const int32_t*)rows;
  const int32_t* mk = (const int32_t*)masks;
  int32_t *x = (int32_t*)ox, *y = (int32_t*)oy, *z = (int32_t*)oz;
  const int grid = (lanes + kScanThreads - 1) / kScanThreads;
  const int t = kScanThreads;
  switch (design) {
    case 0: return zk_madd_scan(rows, masks, ox, oy, oz, steps, lanes, stream);
    case 1:
      madd_scan_2lanes_kernel<<<((lanes + 1) / 2 + t - 1) / t, t, 0, s>>>(r, mk, x, y, z, steps,
                                                                          lanes);
      break;
    case 2: madd_scan_ends_kernel<<<grid, t, 0, s>>>(r, mk, x, y, z, steps, lanes); break;
    case 3: {
      const int per = kBGroupThreads / kBGroup;
      madd_scan_group_kernel<<<(lanes + per - 1) / per, kBGroupThreads, 0, s>>>(
          r, mk, x, y, z, steps, lanes);
      break;
    }
    case 4: madd_scan_mul64_kernel<<<grid, t, 0, s>>>(r, mk, x, y, z, steps, lanes); break;
    case 5: madd_scan_kernel<4><<<grid, t, 0, s>>>(r, mk, x, y, z, steps, lanes); break;
    default: madd_scan_kernel<5><<<grid, t, 0, s>>>(r, mk, x, y, z, steps, lanes); break;
  }
  return (int)cudaGetLastError();
}

// design: 0 fe_mul, 1 fe_mul_cc; a, b, out (n, 16) Fr.
extern "C" int zkv_mont_mul(int design, const void* a, const void* b, void* out, long n,
                            void* stream) {
  const long grid = (n + 255) / 256;
  auto kernel = design ? mont_mul_variant_kernel<true> : mont_mul_variant_kernel<false>;
  kernel<<<(unsigned)grid, 256, 0, (cudaStream_t)stream>>>((const int32_t*)a, (const int32_t*)b,
                                                            (int32_t*)out, n);
  return (int)cudaGetLastError();
}

// design: 0 csrc/ntt_pass.cu's kernel as its entry point launches it, then
// (elements a thread, product, __launch_bounds__): 1 (4, fe_mul, 256 x 2),
// 2 (4, fe_mul_cc, 256 x 2), 3 (4, fe_mul called, 256 x 2), 4 (4, fe_mul_cc
// called, 256 x 2), 5 (4, fe_mul, 256 x 3), 6 (4, fe_mul_a, 256 x 2), 7 (4,
// fe_mul_p, 256 x 2), 8 (8, fe_mul, 128 x 3), 9 (8, fe_mul called, 128 x 3),
// 10 (2, fe_mul, 256 x 3), all with tile_log (0: the pick by waves); 11 the
// first design (contiguous x and out, tile_log ignored). The other arguments
// are zk_ntt_pass's.
extern "C" int zkv_ntt_pass(int design, int tile_log, const void* x, void* out, const void* tw,
                            const void* ptw, long batches, long rows, int log_size,
                            long ptw_period, long xb, long xr, long xe, long ob, long orow,
                            long oe, void* stream) {
  if (!ntt_args_ok(batches, rows, log_size, ptw_period, 0)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const NttArgs a =
      ntt_args(x, out, tw, ptw, batches, rows, log_size, ptw_period, xb, xr, xe, ob, orow, oe, 0);
  switch (design) {
    case 0: return ntt_entry(a, tile_log, s);
    case 1: return ntt_launch<2, MulInline, 256, 2>(a, tile_log, s);
    case 2: return ntt_launch<2, MulCc, 256, 2>(a, tile_log, s);
    case 3: return ntt_launch<2, MulCalled, 256, 2>(a, tile_log, s);
    case 4: return ntt_launch<2, MulCcCalled, 256, 2>(a, tile_log, s);
    case 5: return ntt_launch<2, MulInline, 256, 3>(a, tile_log, s);
    case 6: return ntt_launch<2, MulA, 256, 2>(a, tile_log, s);
    case 7: return ntt_launch<2, MulP, 256, 2>(a, tile_log, s);
    case 8: return ntt_launch<3, MulInline, 128, 3>(a, tile_log, s);
    case 9: return ntt_launch<3, MulCalled, 128, 3>(a, tile_log, s);
    case 10: return ntt_launch<1, MulInline, 256, 3>(a, tile_log, s);
    default: break;
  }
  const long total = batches * rows;
  const int per_block = log_size >= 9 ? 1 : (1 << (9 - log_size));
  cudaError_t err = cudaFuncSetAttribute(ntt_pass_pr1_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(sizeof(Fe) << 11));
  if (err != cudaSuccess) return (int)err;
  ntt_pass_pr1_kernel<<<(unsigned)((total + per_block - 1) / per_block), 256,
                        (size_t)(per_block << log_size) * sizeof(Fe), s>>>(
      (const int32_t*)x, (int32_t*)out, (const int32_t*)tw, (const int32_t*)ptw, (int)total,
      log_size, ptw_period, per_block);
  return (int)cudaGetLastError();
}
