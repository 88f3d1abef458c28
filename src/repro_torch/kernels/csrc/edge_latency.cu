// Edge-latency kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Both kernels compute the paper's per-edge bilinear max (§3)
//
//     out[b, e] = max_u  x_i[b, e, u] * t[b, e, u]
//
// with x_i already scaled by the source operator's selectivity.
//
// K1, edge_latency_dense_kernel, replaces the Pallas kernel
// repro.kernels.edge_latency.edge_latency_pallas (body
// _edge_latency_blocked_kernel):  t[b, e, u] = sum_v com[b|0, u, v] * x_j[b, e, v].
//   Bound: operations.  2*B*E*V^2 multiply-adds against 2*B*E*V + V^2
//   inputs; at V = 4096 that is ~1000 flops per byte, far above the card's
//   ridge.  The bar is 1e-5 relative to float64, which plain TF32 misses,
//   so the products run on the tensor cores in split TF32 ("3xTF32", see
//   the helpers below): three TF32 products per multiply-add, 3 * 2*B*E*V^2
//   operations at the TF32 tensor-core rate, against 2*B*E*V^2 at the FP32
//   CUDA-core rate for the float32 route it replaced.
//   Design: see the K1 section below (wgmma m64n128k8 TF32 from two
//   consumer warpgroups, 128 x 128 CTA tiles, a 4-deep cp.async ring in the
//   swizzled layout, a persistent grid, partial maxima per u tile and a
//   finish kernel).  The tensor cores' own f32 accumulation is
//   undocumented, so v is summed in stages wherever one accumulator over V
//   drifts past ~3e-6 of float64 at the serving shape.  Measured on an
//   H100 80GB HBM3 (700 W) at B 1024, E 21, V 4096, one accumulator read
//   1.05e-5 and 9.1e-6 of float64 in two runs, 32-deep stage sums 5.3e-7
//   and 3.5e-7 (PERF.md).  So each 32-deep v stage accumulates
//   in a fresh accumulator and the stages are added on the CUDA cores in
//   ascending v with round-to-nearest fadd.  A shared com (com batch 1,
//   the (1, V, V) scenario the score grid sends) has batch stride 0 and
//   the caller flattens the (B, E) rows into one row axis, so it is never
//   replicated.
//   u >= V columns are skipped before the max (never a 0 that could win
//   over negative values) and v >= V loads read as 0.
//
// K2, edge_latency_structured_kernel, replaces
// repro.kernels.edge_latency.edge_latency_structured_pallas (body
// _edge_latency_structured_blocked_kernel):
//   t[b, e, u] = sum_r mass[b, e, r] * a[c, r, u] + corr[c, u] * x_j[b, e, u],
//   c = b or 0 (shared scenario).
//   Bound: bytes.  x_i and x_j are each read once (2*B*E*V floats); a, corr
//   and mass are small (R << V), so HBM bandwidth is the limit.
//   Design: a CTA owns 8 edge rows, keeps their (8, R) mass in shared
//   memory and streams u with coalesced loads (consecutive threads, consecutive
//   u).  Each a[r, u] value is loaded once per CTA and reused for the 8 rows;
//   x_i/x_j are loaded before the R loop so their latency hides behind it.
//   The running max lives in registers and is reduced across the CTA once at
//   the end.
//
// K4a, edge_latency_dense_single_tile_kernel, replaces
// repro.kernels.edge_latency.edge_latency_pallas_single_tile (body
// _edge_latency_single_tile_kernel): K1's function with the whole (V, V)
// com tile and the CTA's 8 x_j rows resident in shared memory, no u or v
// blocking.  It is the bitwise reference K1 is held against at small V.
//   Bound: operations, as K1.  It is a reference, not a fast path: 8 warps
//   take the n8 u tiles in turn, and the m16 A fragment carries the CTA's
//   8 rows (its rows 8..15 are zero).  The com tile's row pitch is odd (V
//   or V + 1).
//   Parity with K1: every t[e, u] is K1's sum — the same split of the same
//   operands, the same three TF32 products per k8 step in the same order
//   (mma_split_tf32; mma.sync here, wgmma in K1), the same 32-deep stages
//   from v = 0, each stage in a fresh accumulator added in ascending v,
//   operands beyond V read as 0 — then x_i * t folds into an fmaxf (exact,
//   order-free).  A tensor-core product's entry depends only on its own
//   row, column and accumulator, so where a value sits in the fragment does
//   not matter, and mma.sync m16n8k8 and wgmma m64n128k8 TF32 products
//   accumulate alike (K4a == K1 bitwise, chip_smoke.py's single_tile phase
//   and tests/test_torch_cuda.py hold them to it on the card).
//   (The reference's tests compare the single-tile and blocked Pallas
//   kernels for the "identical dot" of one whole-V contraction; here the
//   identity is K1's staged split-TF32 order, not one dot.)
//   Size: V*pitch + 8*V floats must fit the 227 KB a CTA can use, so
//   V <= 237; the wrapper refuses larger V before any launch.
//
// K4b, edge_latency_structured_single_tile_kernel, replaces
// repro.kernels.edge_latency.edge_latency_structured_pallas_single_tile
// (body _edge_latency_structured_single_tile_kernel): K2's function with
// a[c] (R, V) and corr[c] (V) resident in shared memory, the whole V in
// one tile.
//   Bound: bytes, as K2: x_i and x_j are read once.
//   Design: one CTA per SM (the tile takes up to all 227 KB) on a
//   persistent grid that walks the (b, e) rows in order, so each CTA
//   copies the tile once for a shared scenario and again only when b
//   changes for a per-batch one; its 8 warps take a row each and stream
//   x_i and x_j in 16-byte loads, two steps of four chunks in flight per
//   lane (4-byte loads where V % 4 != 0 or an operand is not 16-byte
//   aligned).  See the K4b section below.
//   Parity with K2: t is one fmaf chain over ascending r from 0.0f, and
//   the epilogue is K2's own helper (structured_term), an explicit
//   fmaf(c, x_j, t) times x_i, so no contraction choice of the compiler
//   can differ between the two kernels.
//   Size: (R + 1)*V + 8*R floats within 227 KB (V <= 6449 at R = 8).
//
// Block policy (repro_torch.kernels.autotune, the counterpart of
// repro.kernels.autotune): K1's ring depth (STAGES) and raster group
// (GROUP) and K2's rows per CTA (ROWS) and u columns per thread per step
// (UNROLL) are template parameters, instantiated for the configs listed in
// K1_CONFIGS and K2_CONFIGS below; the launchers take the config and refuse
// any other.  None of them changes the order in which an output element is
// summed: K1 adds its 32-deep v stages in ascending v whatever the ring
// depth, and the raster group only decides which CTA computes which tile;
// K2's per-row fmaf chain over r is the same for every row block and
// unroll, and the maxima are exact.  So every config of K1 is bitwise equal
// to every other and to K4a, and every config of K2 to every other and to
// K4b.  K1_STAGES, K1_GROUP, S_ROWS and S_UNROLL are the default config.
//
// Summation order is fixed by the tiling, so a repeat launch on the same
// inputs is bitwise identical.  Each entry point takes raw pointers, element
// strides and the CUDA stream, launches on that stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include "grid.cuh"

namespace {

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// The structured epilogue x_i * (t + c * x_j), written once for K2 and K4b
// with the multiply-add explicit: left to the compiler's contraction, the
// two kernels could round it differently.
__device__ __forceinline__ float structured_term(float x_i, float t, float c,
                                                 float x_j) {
  return x_i * fmaf(c, x_j, t);
}

// -- split-TF32 tensor-core arithmetic (K1 and K4a) ----------------------------
//
// Each float32 operand is split as a = hi + lo with hi = tf32(a) and
// lo = tf32(a - hi) (round to nearest, ties away; a - hi is exact),
// and a k8 step of the product accumulates lo*hi + hi*lo + hi*hi with three
// mma.sync.m16n8k8 TF32 products, the small terms first.  The dropped lo*lo
// term and the residual of lo are ~2^-22 of each product.  K1 and K4a call
// these helpers in the same order from the same v = 0 with the same 32-deep
// stages, which is what makes them bitwise equal.

// round to TF32's 10 explicit mantissa bits, to nearest with ties away
// (cvt.rna.tf32.f32's rounding, without its inf/NaN guard, which sm_90
// spends two more instructions on): add half a TF32 ulp to the magnitude
// bits and mask the low 13
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float h = tf32_round(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_round(x - h));
}

// d += a (16x8, row) * b (8x8, col), TF32 operands, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k8 step of the split product from raw float32 fragments: a (the
// m16k8 A fragment: rows g, g+8 x columns t, t+4) and b (the k8n8 B
// fragment: column g x rows t, t+4).
__device__ __forceinline__ void mma_split_tf32(float (&d)[4],
                                               const float (&a)[4],
                                               const float (&b)[2]) {
  uint32_t ahi[4], alo[4], bhi[2], blo[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ahi[i], alo[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bhi[i], blo[i]);
  mma_tf32(d, alo, bhi[0], bhi[1]);
  mma_tf32(d, ahi, blo[0], blo[1]);
  mma_tf32(d, ahi, bhi[0], bhi[1]);
}

// K1 and K4a's depth of one stage: each 32-deep v range is accumulated in a
// fresh accumulator, and the stages are added on the CUDA cores, in
// ascending v, with round-to-nearest fadd.
constexpr int STAGE_V = 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// global -> shared copies; valid == false fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x4 float32 matrices (8x8 b16 as ldmatrix sees them)
__device__ __forceinline__ void ldmatrix_x4(float (&r)[4], uint32_t a) {
  uint32_t x[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(a) : "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = __uint_as_float(x[i]);
}

// -- K1: dense ---------------------------------------------------------------
//
// A GEMM t = x_j com^T with both operands K-major (v contiguous), as TF32
// wgmma needs, and the max over u fused into the epilogue.  com is split
// once per launch into hi and lo copies (edge_latency_dense_split_kernel,
// into the caller's scratch); x_j is split in registers.  A CTA is two
// consumer warpgroups: a 128-row x 128-u tile, 64 rows each.  A ring of
// STAGES 32-deep v stages holds the x_j tile and the com_hi and com_lo
// tiles in wgmma's 128-byte-swizzled K-major layout (a 32-float row is one
// swizzle row: 16-byte chunk c of row r at chunk c ^ (r % 8)), filled with
// cp.async (16 bytes a copy when V is a multiple of 4, else 4).  Per stage
// a warpgroup ldmatrix'es its x_j fragments, splits them, and issues three
// wgmma m64n128k8 TF32 products per k8 step (lo*hi, hi*lo, hi*hi) into a
// fresh accumulator, which it adds into its running sums after the stage.
// The kernel is persistent: gridDim.x CTAs walk the (batch, row tile,
// u tile) tiles in a grouped order (GROUP row tiles share each u tile,
// so a com tile is read by neighbouring CTAs together and a group's x_j
// rows stay in L2 while its u tiles pass).  A row's 128 columns sit in the
// 4 lanes of one warp, so each tile's partial max over its u columns needs
// only two shuffles; it goes to partial[b][u tile][row], and the finish
// kernel takes the max over u tiles (fmaxf: exact and order-free, so a
// repeat launch is bitwise identical).  u >= V columns are skipped, never
// compared as 0, and v >= V loads read as 0.

constexpr int K1_BM = 128, K1_BN = 128, K1_THREADS = 256;
constexpr int K1_STAGES = 4;    // the default ring depth
constexpr int K1_GROUP = 8;     // the default raster group
constexpr uint32_t K1_TILE = 128 * 128;           // 128 rows x 32 floats
constexpr uint32_t K1_STAGE = 3 * K1_TILE;        // x_j, com_hi, com_lo
// a CTA's dynamic shared memory: the ring, + atom alignment
constexpr size_t k1_smem(int stages) { return stages * K1_STAGE + 1024; }
static_assert(K1_BM == K1_BN, "x_j and com tiles must have equal rows");
static_assert(k1_smem(K1_STAGES) <= 232448, "the ring must fit 227 KB");

// K1's instantiations, (STAGES, GROUP); the default first.  A ring of 5
// stages (241 KB) would not fit the 227 KB a CTA can use.
#define K1_CONFIGS(X) X(4, 8) X(4, 16) X(4, 4) X(3, 8) X(3, 16) X(2, 8)

__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  // K-major, 128-byte swizzle: 8-row atoms 1024 bytes apart
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (m64n128, f32) = a (registers, tf32) b (smem, K-major, tf32)
//                     + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


__global__ void edge_latency_dense_split_kernel(const float* __restrict__ x,
                                  float* __restrict__ hi,
                                  float* __restrict__ lo, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float h = tf32_round(x[i]);
    hi[i] = h;
    lo[i] = tf32_round(x[i] - h);
  }
}

// Each 32-deep v stage accumulates in a fresh accumulator (acc) that is
// added to the running sum on the CUDA cores.  VEC: 16-byte copies
// (V % 4 == 0); STAGES: the ring's depth; GROUP: the raster group.
template <bool VEC, int STAGES, int GROUP>
__global__ void __launch_bounds__(K1_THREADS, 1)
edge_latency_dense_kernel(const float* __restrict__ xi,
                          const float* __restrict__ xj,
                          const float* __restrict__ com_hi,
                          const float* __restrict__ com_lo,
                          float* __restrict__ partial,
                          int64_t n_batch, int64_t rows, int64_t V,
                          int64_t x_bs, int64_t x_rs,
                          int64_t com_bs, int64_t com_rs) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4, wgi = warp / 4;
  // the ldmatrix row of this lane in its warpgroup's x_j fragments (rows
  // + 8 for matrices 1 and 3, the k8 step's second chunk for 2 and 3)
  const int arow = wgi * 64 + (warp % 4) * 16 + lane % 8 + ((lane / 8) % 2) * 8;
  const int achunk = lane / 16;
  const int rrow = wgi * 64 + (warp % 4) * 16 + g;   // this lane's C rows

  const int64_t n_rt = (rows + K1_BM - 1) / K1_BM;
  const int64_t n_ut = (V + K1_BN - 1) / K1_BN;
  const int64_t per_b = n_rt * n_ut;
  const int nk = (int)((V + STAGE_V - 1) / STAGE_V);

  for (int64_t tile = blockIdx.x; tile < n_batch * per_b;
       tile += gridDim.x) {
    const int64_t b = tile / per_b, rem = tile % per_b;
    const int64_t grp = rem / (GROUP * n_ut);
    const int64_t in = rem % (GROUP * n_ut);
    const int64_t gsz = n_rt - grp * GROUP < GROUP ? n_rt - grp * GROUP
                                                   : GROUP;
    const int64_t row0 = (grp * GROUP + in % gsz) * K1_BM;
    const int64_t ut = in / gsz, u0 = ut * K1_BN;
    const float* a_src = xj + b * x_bs;
    const float* h_src = com_hi + b * com_bs;
    const float* l_src = com_lo + b * com_bs;

    auto load_stage = [&](int slot, int kt) {
      const uint32_t st = ring + slot * K1_STAGE;
      const int64_t v0 = (int64_t)kt * STAGE_V;
      if constexpr (VEC) {
        const int c = tid % 8, r0 = tid / 8;           // 32 rows a pass
        const uint32_t d0 = st + r0 * 128 + ((c ^ (r0 % 8)) * 16);
        const int64_t v = v0 + c * 4;
#pragma unroll
        for (int i = 0; i < K1_BM / 32; ++i) {
          const int r = r0 + i * 32;
          bool ok = row0 + r < rows && v < V;
          cp_async16(d0 + i * 32 * 128,
                     ok ? a_src + (row0 + r) * x_rs + v : a_src, ok);
          ok = u0 + r < V && v < V;
          const int64_t off = (u0 + r) * com_rs + v;
          cp_async16(d0 + K1_TILE + i * 32 * 128, ok ? h_src + off : h_src,
                     ok);
          cp_async16(d0 + 2 * K1_TILE + i * 32 * 128,
                     ok ? l_src + off : l_src, ok);
        }
      } else {
        const int e = tid % STAGE_V, r0 = tid / STAGE_V;   // 8 rows a pass
        const int64_t v = v0 + e;
        const uint32_t d0 = st + r0 * 128 + (((e / 4) ^ r0) * 16) + (e % 4) * 4;
#pragma unroll 4
        for (int i = 0; i < K1_BM / 8; ++i) {
          const int r = r0 + i * 8;
          bool ok = row0 + r < rows && v < V;
          cp_async4(d0 + i * 8 * 128,
                    ok ? a_src + (row0 + r) * x_rs + v : a_src, ok);
          ok = u0 + r < V && v < V;
          const int64_t off = (u0 + r) * com_rs + v;
          cp_async4(d0 + K1_TILE + i * 8 * 128, ok ? h_src + off : h_src, ok);
          cp_async4(d0 + 2 * K1_TILE + i * 8 * 128, ok ? l_src + off : l_src,
                    ok);
        }
      }
    };

    float sum[64], acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = acc[i] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load_stage(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      fence_proxy_async();    // the copies are visible to wgmma's reads
      __syncthreads();        // stage kt landed; slot (kt - 1) is free
      if (kt + STAGES - 1 < nk)
        load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
      cp_async_commit();

      const uint32_t st = ring + (kt % STAGES) * K1_STAGE;
      uint32_t ahi[STAGE_V / 8][4], alo[STAGE_V / 8][4];
#pragma unroll
      for (int kk = 0; kk < STAGE_V / 8; ++kk) {
        float a[4];
        ldmatrix_x4(a, st + arow * 128
                           + (((2 * kk + achunk) ^ (arow % 8)) * 16));
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a[i], ahi[kk][i], alo[kk][i]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STAGE_V / 8; ++kk) {
        const uint64_t dh = make_desc(st + K1_TILE + kk * 32);
        const uint64_t dl = make_desc(st + 2 * K1_TILE + kk * 32);
        wgmma_tf32_n128(acc, alo[kk], dh, kk != 0);
        wgmma_tf32_n128(acc, ahi[kk], dl, 1);
        wgmma_tf32_n128(acc, ahi[kk], dh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
    cp_async_wait<0>();

    // epilogue: this tile's max over its u columns, for rows rrow, rrow + 8
    const float* xi_b = xi + b * x_bs;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t r = row0 + rrow + hh * 8;
      float mv = neg_inf();
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < K1_BN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int64_t u = u0 + j * 8 + 2 * t + c;
            if (u < V)
              mv = fmaxf(mv, xi_b[r * x_rs + u] * sum[j * 4 + hh * 2 + c]);
          }
      }
      mv = fmaxf(mv, __shfl_xor_sync(0xffffffffu, mv, 1));
      mv = fmaxf(mv, __shfl_xor_sync(0xffffffffu, mv, 2));
      if (t == 0 && r < rows) partial[(b * n_ut + ut) * rows + r] = mv;
    }
    __syncthreads();          // the ring is free for the next tile
  }
}

// out[b, r] = max over u tiles of partial[b, :, r]
__global__ void edge_latency_dense_finish_kernel(
    const float* __restrict__ partial, float* __restrict__ out,
    int64_t n_batch, int64_t rows, int64_t n_ut, int64_t out_bs) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_batch * rows) return;
  const int64_t b = idx / rows, r = idx % rows;
  const float* p = partial + b * n_ut * rows + r;
  float m = p[0];
  for (int64_t ut = 1; ut < n_ut; ++ut) m = fmaxf(m, p[ut * rows]);
  out[b * out_bs + r] = m;
}

// -- K2: structured (region-factored) ----------------------------------------

constexpr int S_ROWS = 8;       // the default edge rows per CTA
constexpr int S_THREADS = 256;
constexpr int S_UNROLL = 4;     // the default u columns per thread per step,
                                // S_THREADS apart

// K2's instantiations, (ROWS, UNROLL); the default first.  A CTA's shared
// memory is ROWS * R floats of mass (dynamic) and its (8, ROWS) partial
// maxima (static), so a large R leaves only the small row blocks.  16 rows
// a CTA spilled at the 128 registers the launch bound allows and ran ~45 %
// slower at the serving shape: not instantiated.
#define K2_CONFIGS(X) X(8, 4) X(8, 2) X(8, 8) X(4, 4) X(4, 8)

// two CTAs per SM (≤128 registers) keep more loads in flight
template <int ROWS, int UNROLL>
__global__ void __launch_bounds__(S_THREADS, 2)
edge_latency_structured_kernel(const float* __restrict__ xi,
                               const float* __restrict__ xj,
                               const float* __restrict__ mass,
                               const float* __restrict__ a,
                               const float* __restrict__ corr,
                               float* __restrict__ out,
                               int64_t rows, int64_t V, int64_t R,
                               int64_t x_bs, int64_t x_rs,
                               int64_t mass_bs, int64_t mass_rs,
                               int64_t a_bs, int64_t a_rs,
                               int64_t corr_bs, int64_t out_bs) {
  extern __shared__ float smass[];                  // [ROWS][R]
  __shared__ float red[S_THREADS / 32][ROWS];

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int nrows = rows - row0 < ROWS ? (int)(rows - row0) : ROWS;
  const float* xi_b = xi + b * x_bs + row0 * x_rs;
  const float* xj_b = xj + b * x_bs + row0 * x_rs;
  const float* mass_b = mass + b * mass_bs + row0 * mass_rs;
  const float* a_b = a + b * a_bs;
  const float* corr_b = corr + b * corr_bs;

  for (int64_t idx = tid; idx < ROWS * R; idx += S_THREADS) {
    const int64_t i = idx / R, r = idx % R;
    smass[idx] = i < nrows ? mass_b[i * mass_rs + r] : 0.f;
  }
  __syncthreads();

  float m[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) m[i] = neg_inf();

  for (int64_t ub = 0; ub < V; ub += (int64_t)S_THREADS * UNROLL) {
#pragma unroll
    for (int s = 0; s < UNROLL; ++s) {
      const int64_t u = ub + (int64_t)s * S_THREADS + tid;
      if (u >= V) break;
      float x_i[ROWS], x_j[ROWS], t[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        x_i[i] = i < nrows ? xi_b[i * x_rs + u] : 0.f;
        x_j[i] = i < nrows ? xj_b[i * x_rs + u] : 0.f;
        t[i] = 0.f;
      }
      const float c = corr_b[u];
      for (int64_t r = 0; r < R; ++r) {
        const float av = __ldg(a_b + r * a_rs + u);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) t[i] = fmaf(smass[i * R + r], av, t[i]);
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        if (i < nrows)
          m[i] = fmaxf(m[i], structured_term(x_i[i], t[i], c, x_j[i]));
    }
  }

  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
    if (lane == 0) red[warp][i] = m[i];
  }
  __syncthreads();
  if (tid < nrows) {
    float v = red[0][tid];
#pragma unroll
    for (int w = 1; w < S_THREADS / 32; ++w) v = fmaxf(v, red[w][tid]);
    out[b * out_bs + row0 + tid] = v;
  }
}

// -- K4a / K4b: whole-V single-tile references --------------------------------

constexpr int T_ROWS = 8;   // K4a: edge rows per CTA; K4b: warps, a row each
constexpr int T_THREADS = 32 * T_ROWS;

// com row pitch: V rounded up to odd, so lane-strided rows hit 32 banks
__host__ __device__ __forceinline__ int64_t single_tile_pitch(int64_t V) {
  return V | 1;
}

__global__ void __launch_bounds__(T_THREADS)
edge_latency_dense_single_tile_kernel(const float* __restrict__ xi,
                                      const float* __restrict__ xj,
                                      const float* __restrict__ com,
                                      float* __restrict__ out,
                                      int64_t E, int64_t V, int64_t x_bs,
                                      int64_t com_bs, int64_t out_bs) {
  extern __shared__ float smem[];
  const int64_t pitch = single_tile_pitch(V);
  float* com_s = smem;                     // [V][pitch]
  float* xj_s = smem + V * pitch;          // [T_ROWS][V]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t b = blockIdx.y;
  const int64_t e0 = (int64_t)blockIdx.x * T_ROWS;
  const float* com_b = com + b * com_bs;
  const float* xj_b = xj + b * x_bs;

  for (int64_t idx = tid; idx < V * V; idx += T_THREADS)
    com_s[(idx / V) * pitch + idx % V] = com_b[idx];
  for (int64_t idx = tid; idx < T_ROWS * V; idx += T_THREADS) {
    const int64_t e = e0 + idx / V;
    xj_s[idx] = e < E ? xj_b[e * V + idx % V] : 0.f;
  }
  __syncthreads();

  // K1's arithmetic on the resident tile: the m16 A fragment holds the
  // CTA's 8 rows (rows 8..15 are zero), each warp takes n8 u tiles in
  // turn, and every (row, u) is summed as in K1 — a fresh accumulator per
  // 32-deep stage from v = 0, the stages added in ascending v, operands
  // beyond V read as 0.
  const int64_t e = e0 + g;
  const float* xj_row = xj_s + (int64_t)g * V;
  const int nk = (int)((V + STAGE_V - 1) / STAGE_V);
  float m = neg_inf();
  for (int64_t n0 = (int64_t)warp * 8; n0 < V; n0 += T_THREADS / 4) {
    const int64_t u = n0 + g;              // this lane's B column
    const float* com_row = com_s + u * pitch;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < nk; ++s) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < STAGE_V / 8; ++kk) {
        const int64_t v = (int64_t)s * STAGE_V + kk * 8 + t;
        const float a[4] = {v < V ? xj_row[v] : 0.f, 0.f,
                            v + 4 < V ? xj_row[v + 4] : 0.f, 0.f};
        const float bv[2] = {u < V && v < V ? com_row[v] : 0.f,
                             u < V && v + 4 < V ? com_row[v + 4] : 0.f};
        mma_split_tf32(acc, a, bv);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[c] += acc[c];
    }
    // sum[0], sum[1]: row g, u columns n0 + 2t, n0 + 2t + 1
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int64_t uc = n0 + 2 * t + c;
      if (uc < V && e < E)
        m = fmaxf(m, xi[b * x_bs + e * V + uc] * sum[c]);
    }
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  // the row maxima of the warps that had u tiles meet in the operands'
  // shared memory (a static buffer would push V = 237 past 227 KB): at
  // most min(8, ceil(V / 8)) * 8 floats, which V * pitch + 8 * V holds
  const int busy = (int)((V + 7) / 8 < T_THREADS / 32 ? (V + 7) / 8
                                                      : T_THREADS / 32);
  __syncthreads();                         // every warp is done with com_s
  if (t == 0 && warp < busy) smem[warp * T_ROWS + g] = m;
  __syncthreads();
  if (tid < T_ROWS && e0 + tid < E) {
    float mv = smem[tid];
    for (int w = 1; w < busy; ++w) mv = fmaxf(mv, smem[w * T_ROWS + tid]);
    out[b * out_bs + e0 + tid] = mv;
  }
}

// K4b: a persistent grid walks the edge rows, flattened over (b, e) in
// that order; CTA i takes the contiguous range [i n / G, (i + 1) n / G) of
// the n = B E rows.  The CTA copies a[c] and corr[c] into shared memory
// with cp.async (16 bytes a copy on the vector path) and copies them again
// only when c changes: once per CTA for a shared scenario, at most once
// per batch it touches for a per-batch one.  Its 8 warps then take the
// range's rows in turn, one row each, the row's mass staged in the warp's
// slot of shared memory.  A lane takes the 16-byte chunks k = lane,
// lane + 32, ... of x_i and x_j (single floats on the scalar path), U
// of them a step, and loads the next step's chunks before it computes the
// current ones, so two steps' loads are in flight.  Consecutive lanes
// read consecutive 16-byte chunks of a[r] and corr: no bank conflict.
// one chunk of W floats from device memory (read-only path; 16-byte
// loads ask L2 to fetch the whole 256-byte block around them) or shared
// memory
template <int W>
__device__ __forceinline__ void load_chunk(float (&d)[W], const float* p) {
  if constexpr (W == 4) {
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]) : "l"(p));
  } else {
    d[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void smem_chunk(float (&d)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
    d[0] = *p;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(T_THREADS, 1)
edge_latency_structured_single_tile_kernel(const float* __restrict__ xi,
                                           const float* __restrict__ xj,
                                           const float* __restrict__ mass,
                                           const float* __restrict__ a,
                                           const float* __restrict__ corr,
                                           float* __restrict__ out,
                                           int64_t n_batch, int64_t E,
                                           int64_t V, int64_t R,
                                           int64_t x_bs, int64_t mass_bs,
                                           int64_t a_bs, int64_t corr_bs,
                                           int64_t out_bs) {
  constexpr int W = VEC ? 4 : 1;           // floats per chunk
  constexpr int U = VEC ? 4 : 8;           // chunks per lane per step
  extern __shared__ __align__(16) float tile_smem[];
  float* a_s = tile_smem;                  // [R][V]
  float* corr_s = tile_smem + R * V;       // [V]
  float* mass_s = corr_s + V;              // [T_ROWS][R], a row per warp

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t n = n_batch * E;
  const int64_t r0 = (int64_t)blockIdx.x * n / gridDim.x;
  const int64_t r1 = ((int64_t)blockIdx.x + 1) * n / gridDim.x;
  const bool shared = a_bs == 0 && corr_bs == 0;
  const int64_t nk = V / W;                // chunks per row
  float* mass_row = mass_s + (int64_t)warp * R;
  int64_t tile = -1;                       // the scenario in shared memory
  for (int64_t s0 = r0; s0 < r1;) {
    const int64_t b0 = s0 / E;
    const int64_t c = shared ? 0 : b0;
    const int64_t s1 = shared || (b0 + 1) * E > r1 ? r1 : (b0 + 1) * E;
    if (c != tile) {                       // CTA-uniform
      __syncthreads();                     // every warp is done with it
      const float* a_c = a + c * a_bs;
      const float* corr_c = corr + c * corr_bs;
      const uint32_t a_dst = smem_addr(a_s), corr_dst = smem_addr(corr_s);
      for (int64_t k = tid; k < R * nk; k += T_THREADS) {
        if (VEC) cp_async16(a_dst + 16 * (uint32_t)k, a_c + 4 * k, true);
        else cp_async4(a_dst + 4 * (uint32_t)k, a_c + k, true);
      }
      for (int64_t k = tid; k < nk; k += T_THREADS) {
        if (VEC) cp_async16(corr_dst + 16 * (uint32_t)k, corr_c + 4 * k, true);
        else cp_async4(corr_dst + 4 * (uint32_t)k, corr_c + k, true);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      tile = c;
    }
    for (int64_t row = s0 + warp; row < s1; row += T_ROWS) {
      const int64_t b = row / E, e = row % E;
      const float* xi_row = xi + b * x_bs + e * V;
      const float* xj_row = xj + b * x_bs + e * V;
      float pi[U][W], pj[U][W];            // this step's chunks
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int64_t k = (int64_t)j * 32 + lane;
        if (k < nk) {
          load_chunk<W>(pi[j], xi_row + k * W);
          load_chunk<W>(pj[j], xj_row + k * W);
        }
      }
      __syncwarp();                        // the previous row's mass is read
      for (int64_t r = lane; r < R; r += 32)
        mass_row[r] = __ldg(mass + b * mass_bs + e * R + r);
      __syncwarp();
      float m = neg_inf();
      for (int64_t k0 = 0; k0 < nk; k0 += 32 * U) {
        float ni[U][W], nj[U][W];          // the next step's chunks
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int64_t k = k0 + 32 * U + (int64_t)j * 32 + lane;
          if (k < nk) {
            load_chunk<W>(ni[j], xi_row + k * W);
            load_chunk<W>(nj[j], xj_row + k * W);
          }
        }
        float t[U][W];
#pragma unroll
        for (int j = 0; j < U; ++j)
#pragma unroll
          for (int q = 0; q < W; ++q) t[j][q] = 0.f;
        // K2's chain: t = fmaf(mass[r], a[r, u], t) over ascending r
        for (int64_t r = 0; r < R; ++r) {
          const float mr = mass_row[r];
          const float* a_r = a_s + r * V;
#pragma unroll
          for (int j = 0; j < U; ++j) {
            const int64_t k = k0 + (int64_t)j * 32 + lane;
            if (k < nk) {
              float av[W];
              smem_chunk<W>(av, a_r + k * W);
#pragma unroll
              for (int q = 0; q < W; ++q) t[j][q] = fmaf(mr, av[q], t[j][q]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int64_t k = k0 + (int64_t)j * 32 + lane;
          if (k < nk) {
            float cv[W];
            smem_chunk<W>(cv, corr_s + k * W);
#pragma unroll
            for (int q = 0; q < W; ++q)
              m = fmaxf(m, structured_term(pi[j][q], t[j][q], cv[q],
                                           pj[j][q]));
          }
#pragma unroll
          for (int q = 0; q < W; ++q) {
            pi[j][q] = ni[j][q];
            pj[j][q] = nj[j][q];
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) out[b * out_bs + e] = m;
    }
    s0 = s1;
  }
}

// Opt in to more than 48 KB of dynamic shared memory before a launch that
// needs it (the launch fails otherwise).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// -- the launches of one K1 / K2 config ---------------------------------------

// K1 at one (STAGES, GROUP): the split of com, the persistent grid, the
// finish.  info[0] receives the tiles, info[1] the CTAs launched.
template <int STAGES, int GROUP>
cudaError_t dense_launch(const float* xi, const float* xj, const float* com,
                         float* com_hi, float* com_lo, float* partial,
                         float* out, int64_t n_batch, int64_t rows, int64_t V,
                         int64_t x_bs, int64_t x_rs, int64_t com_bs,
                         int64_t com_rs, int64_t out_bs, int64_t n_com,
                         bool vec, int64_t* info, cudaStream_t s) {
  constexpr size_t smem = k1_smem(STAGES);
  const auto kern = vec ? edge_latency_dense_kernel<true, STAGES, GROUP>
                        : edge_latency_dense_kernel<false, STAGES, GROUP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t n_ut = (V + K1_BN - 1) / K1_BN;
  const int64_t tiles = n_batch * ((rows + K1_BM - 1) / K1_BM) * n_ut;
  unsigned grid = 0;
  int sms = 0;
  if ((err = persistent_grid(kern, K1_THREADS, smem, tiles, &grid, &sms)) !=
      cudaSuccess)
    return err;
  edge_latency_dense_split_kernel<<<sms * 8, 256, 0, s>>>(com, com_hi, com_lo,
                                                          n_com);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kern<<<grid, K1_THREADS, smem, s>>>(xi, xj, com_hi, com_lo, partial,
                                      n_batch, rows, V, x_bs, x_rs, com_bs,
                                      com_rs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t n = n_batch * rows;
  edge_latency_dense_finish_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                                     s>>>(partial, out, n_batch, rows, n_ut,
                                          out_bs);
  info[0] = tiles;
  info[1] = grid;
  return cudaGetLastError();
}

// K2 at one (ROWS, UNROLL): a CTA per ROWS edge rows of each batch.
// info[0] receives the tiles (CTAs), info[1] the CTAs launched.
template <int ROWS, int UNROLL>
cudaError_t structured_launch(const float* xi, const float* xj,
                              const float* mass, const float* a,
                              const float* corr, float* out, int64_t n_batch,
                              int64_t rows, int64_t V, int64_t R,
                              int64_t x_bs, int64_t x_rs, int64_t mass_bs,
                              int64_t mass_rs, int64_t a_bs, int64_t a_rs,
                              int64_t corr_bs, int64_t out_bs, int64_t* info,
                              cudaStream_t s) {
  const int64_t blocks = (rows + ROWS - 1) / ROWS;
  if (n_batch > 65535 || blocks > 0x7fffffff)
    return cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)ROWS * (size_t)R * sizeof(float);
  const auto kern = edge_latency_structured_kernel<ROWS, UNROLL>;
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)blocks, (unsigned)n_batch);
  kern<<<grid, S_THREADS, smem, s>>>(xi, xj, mass, a, corr, out, rows, V, R,
                                     x_bs, x_rs, mass_bs, mass_rs, a_bs, a_rs,
                                     corr_bs, out_bs);
  info[0] = blocks * n_batch;
  info[1] = blocks * n_batch;
  return cudaGetLastError();
}

// CTAs of `kernel` that fit on one SM at `threads` threads and `smem` bytes
// of dynamic shared memory (the occupancy calculator; registers included)
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, size_t smem,
                      int64_t* out) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int n = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &n, kernel, threads, smem)) != cudaSuccess)
    return err;
  *out = n;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// K1.  n_batch row blocks (1 when com is shared and the caller flattened
// (B, E) into rows); com_bs = 0 shares one com across batches.  The caller
// gives com_hi and com_lo, scratch of com's n_com floats, and partial, a
// (n_batch, ceil(V / 128), rows) float32 scratch.  Three launches: the
// split of com, a persistent grid of (CTAs per SM) x (SMs) over the tiles,
// and the finish.  (stages, group) must be one of K1_CONFIGS; any other is
// refused with cudaErrorInvalidValue before anything runs.  info (2
// int64s) receives the tiles and the CTAs launched.
int edge_latency_dense_launch(const float* xi, const float* xj,
                              const float* com, float* com_hi, float* com_lo,
                              float* partial, float* out,
                              int64_t n_batch, int64_t rows, int64_t V,
                              int64_t x_bs, int64_t x_rs,
                              int64_t com_bs, int64_t com_rs,
                              int64_t out_bs, int64_t n_com, int64_t stages,
                              int64_t group, int64_t* info, void* stream) {
  if (n_batch < 1 || rows < 1 || V < 1 || n_com < 1)
    return (int)cudaErrorInvalidConfiguration;
  const bool vec = V % 4 == 0 && x_rs % 4 == 0 && x_bs % 4 == 0 &&
                   com_rs % 4 == 0 && com_bs % 4 == 0 &&
                   (uintptr_t)xj % 16 == 0 && (uintptr_t)com_hi % 16 == 0 &&
                   (uintptr_t)com_lo % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define K1_LAUNCH(ST_, GR_)                                                   \
  if (stages == ST_ && group == GR_)                                          \
    return (int)dense_launch<ST_, GR_>(xi, xj, com, com_hi, com_lo, partial,  \
                                       out, n_batch, rows, V, x_bs, x_rs,     \
                                       com_bs, com_rs, out_bs, n_com, vec,    \
                                       info, s);
  K1_CONFIGS(K1_LAUNCH)
#undef K1_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K2.  a_bs = corr_bs = 0 shares one scenario across batches.  The (ROWS,
// R) mass tile lives in dynamic shared memory, so R is bounded by the
// 227 KB a CTA can use (R <= ~7200 at ROWS 8); a larger R fails
// cudaFuncSetAttribute.  (rows_per_cta, unroll) must be one of K2_CONFIGS;
// any other is refused with cudaErrorInvalidValue.  info as K1's.
int edge_latency_structured_launch(const float* xi, const float* xj,
                                   const float* mass, const float* a,
                                   const float* corr, float* out,
                                   int64_t n_batch, int64_t rows, int64_t V,
                                   int64_t R, int64_t x_bs, int64_t x_rs,
                                   int64_t mass_bs, int64_t mass_rs,
                                   int64_t a_bs, int64_t a_rs,
                                   int64_t corr_bs, int64_t out_bs,
                                   int64_t rows_per_cta, int64_t unroll,
                                   int64_t* info, void* stream) {
  if (n_batch < 1 || rows < 1 || R < 1)
    return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
#define K2_LAUNCH(RW_, UN_)                                                   \
  if (rows_per_cta == RW_ && unroll == UN_)                                   \
    return (int)structured_launch<RW_, UN_>(                                  \
        xi, xj, mass, a, corr, out, n_batch, rows, V, R, x_bs, x_rs,         \
        mass_bs, mass_rs, a_bs, a_rs, corr_bs, out_bs, info, s);
  K2_CONFIGS(K2_LAUNCH)
#undef K2_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// CTAs per SM of one instantiation on the current device: kind 0 is K1
// (a = STAGES, b = GROUP, its ring's shared memory), kind 1 is K2 (a =
// ROWS, b = UNROLL, ROWS * R floats of shared memory).  An instantiation
// that does not exist is refused with cudaErrorInvalidValue.
int edge_latency_ctas_per_sm(int64_t kind, int64_t a, int64_t b, int64_t R,
                             int64_t* out) {
#define K1_OCC(ST_, GR_)                                                      \
  if (kind == 0 && a == ST_ && b == GR_)                                      \
    return (int)occupancy(&edge_latency_dense_kernel<true, ST_, GR_>,         \
                          K1_THREADS, k1_smem(ST_), out);
  K1_CONFIGS(K1_OCC)
#undef K1_OCC
#define K2_OCC(RW_, UN_)                                                      \
  if (kind == 1 && a == RW_ && b == UN_)                                      \
    return (int)occupancy(&edge_latency_structured_kernel<RW_, UN_>,          \
                          S_THREADS, (size_t)RW_ * (size_t)R * sizeof(float), \
                          out);
  K2_CONFIGS(K2_OCC)
#undef K2_OCC
  return (int)cudaErrorInvalidValue;
}

// K4a.  Grid (ceil(E / 8), n_batch); com_bs = 0 shares one com across
// batches.  Shared memory: V*pitch + 8*V floats (the wrapper refuses what
// exceeds 227 KB; cudaFuncSetAttribute would refuse it too).
int edge_latency_dense_single_tile_launch(const float* xi, const float* xj,
                                          const float* com, float* out,
                                          int64_t n_batch, int64_t E,
                                          int64_t V, int64_t x_bs,
                                          int64_t com_bs, int64_t out_bs,
                                          void* stream) {
  const int64_t blocks = (E + T_ROWS - 1) / T_ROWS;
  if (n_batch < 1 || n_batch > 65535 || blocks < 1 || blocks > 0x7fffffff ||
      V < 1)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem =
      sizeof(float) * (size_t)(V * single_tile_pitch(V) + T_ROWS * V);
  const cudaError_t err = allow_smem(edge_latency_dense_single_tile_kernel,
                                     smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)blocks, (unsigned)n_batch);
  edge_latency_dense_single_tile_kernel<<<grid, T_THREADS, smem,
                                          (cudaStream_t)stream>>>(
      xi, xj, com, out, E, V, x_bs, com_bs, out_bs);
  return (int)cudaGetLastError();
}

// K4b.  a_bs = corr_bs = 0 shares one scenario across batches.  Shared
// memory: (R + 1)*V + 8*R floats.  A persistent grid of min(CTAs per SM x
// SMs, ceil(B E / 8)) CTAs; 16-byte loads when V % 4 == 0 and every
// operand and batch stride is 16-byte aligned, else 4-byte ones.
int edge_latency_structured_single_tile_launch(
    const float* xi, const float* xj, const float* mass, const float* a,
    const float* corr, float* out, int64_t n_batch, int64_t E, int64_t V,
    int64_t R, int64_t x_bs, int64_t mass_bs, int64_t a_bs, int64_t corr_bs,
    int64_t out_bs, void* stream) {
  if (n_batch < 1 || E < 1 || V < 1 || R < 1)
    return (int)cudaErrorInvalidConfiguration;
  const bool vec = V % 4 == 0 && x_bs % 4 == 0 && a_bs % 4 == 0 &&
                   corr_bs % 4 == 0 && (uintptr_t)xi % 16 == 0 &&
                   (uintptr_t)xj % 16 == 0 && (uintptr_t)a % 16 == 0 &&
                   (uintptr_t)corr % 16 == 0;
  const auto kern = vec ? edge_latency_structured_single_tile_kernel<true>
                        : edge_latency_structured_single_tile_kernel<false>;
  const size_t smem = sizeof(float) * (size_t)((R + 1) * V + T_ROWS * R);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  unsigned grid = 0;
  if ((err = persistent_grid(kern, T_THREADS, smem,
                             (n_batch * E + T_ROWS - 1) / T_ROWS, &grid)) !=
      cudaSuccess)
    return (int)err;
  kern<<<grid, T_THREADS, smem, (cudaStream_t)stream>>>(
      xi, xj, mass, a, corr, out, n_batch, E, V, R, x_bs, mass_bs, a_bs,
      corr_bs, out_bs);
  return (int)cudaGetLastError();
}

const char* edge_latency_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
