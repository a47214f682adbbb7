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
#include "../csrc/ec_add_select.cu"
#include "../csrc/madd_scan.cu"

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

}  // namespace

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
