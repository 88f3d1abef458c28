// Flash attention (K5) for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:76
// (flash_attention_pallas, body _flash_kernel).  It computes what that
// kernel computes, per (batch, head):
//
//     o = softmax(q k^T * D^-1/2, masked k_pos <= q_pos when causal) v
//
// with q, k, v (B, S, H, D) in float32 or bfloat16 (kv already repeated to
// H): scores, the running max m and denominator l and the accumulator in
// float32.  Masked scores take the reference's value -1e30, the denominator
// is floored at 1e-30 before the division, and the output is written in
// q's dtype (bfloat16 rounds to nearest even).  Key tiles entirely above
// the diagonal are never loaded, and q tiles are launched heaviest first
// (the last q tile has the most keys under a causal mask).  Rows and keys
// past the end load as 0 (keys are masked, rows are not stored), so any S
// works.  The operands are read in their strided (B, S, H, D) layout, never
// transposed.
//
// Bound on this card: operations.  At the LM-scoring shape (a shard of 11
// rows x 2048 tokens, 16 heads of 128, bf16) one launch does
// 4*B*H*D*S(S+1)/2 ~ 1.9e11 operations against 4*B*S*H*D*2 ~ 369 MB of
// inputs and output: ~500 operations per byte, above the card's bf16 ridge
// (~295), so arithmetic is the limit.  The roofline in
// repro_torch.perf.roofline prices it at the bf16 tensor-core peak, 0.19 ms.
//
// The route is chosen by dtype before the launch, never as a fallback:
//
// * bfloat16 operands: the tensor cores through wgmma, in the shape of
//   FlashAttention-3.  A CTA owns one (b, h) and a 128-row q tile: two
//   consumer warpgroups of 64 rows and one producer warp (288 threads, one
//   CTA per SM).  Keys come in 64-key tiles.
//   - Loads: the producer issues TMA copies of Q once and of a ring of
//     STAGES K and V tiles, each completing on its own mbarrier; the
//     consumers release a slot on an "empty" mbarrier once the products
//     that read it are done.  Q, K and V are described to TMA as 4-D
//     (D, S, H, B) tensor maps over the strided model layout (no
//     transposes), in 64 d x 64 row boxes with the 128-byte swizzle, so
//     shared memory holds [D / 64][rows][64] bf16 in wgmma's canonical
//     layout.  Rows past S, and d past D for a head dim under 64, are
//     TMA's zero fill.  cuTensorMapEncodeTiled is reached through the
//     CUDA runtime's entry-point query (no -lcuda); a refused map or launch
//     raises in the wrapper, with no fallback.
//   - S_j = Q K_j^T is wgmma m64n64k16 with both operands in shared memory
//     (K-major); products of bf16 values are exact in f32, so S differs
//     from the reference only in summation order.  O += P_{j-1} V_{j-1} is
//     wgmma m64n{64,128}k16 with P as the register A operand (the S
//     accumulator layout of two n8 blocks is the A layout of one k16 step)
//     and V read MN-major (the transpose bit).
//   - Within a warpgroup the two are issued together and the online
//     softmax of S_j runs on the CUDA cores while the tensor cores finish
//     P_{j-1} V_{j-1}; O is rescaled once that product is in.  Between the
//     warpgroups, named barriers pass the turn to issue products back and
//     forth (ping-pong), so one's softmax meets the other's products.  Both
//     walk the CTA's key tiles, so the first warpgroup also takes the tile
//     wholly above its rows: fully masked, p = 0 and alpha = 1, an exact
//     no-op.
//   - P alternates between two register sets (the tile loop is unrolled by
//     two), and every operand's registers are pinned around its wgmma
//     group: a register of an in-flight wgmma written by another
//     instruction makes ptxas serialize every wgmma of the kernel (a wait
//     after each, with no diagnostic).
//   - The softmax keeps the row max in raw units and folds D^-1/2 * log2 e
//     into one fma before ex2; a row's max and sum reduce over the 4 lanes
//     that share it.  Only tiles that cross the diagonal or the ragged end
//     are masked (int32 bounds per warp).
//   - Numerics decision: p is rounded once to bf16 (8 significant bits)
//     and l sums the rounded weights, so the output is an exact convex
//     combination of the rows of v with those weights.  The reference
//     keeps p in f32.  At the serving shape (11 x 2048 x 16 x 128, causal,
//     randn operands; chip_smoke.py on an H100 80GB HBM3) the kernel is
//     3.4e-3 (max |err| / max |out|) from the plain version in f32 math,
//     against the 1e-2 bar (BF16_REL), of which the output's own bf16
//     rounding may spend up to 3.9e-3; p split into bf16 hi + lo (two P.V
//     products, emulated there) gives 1.7e-3 at twice the P.V cost, so the
//     single product is taken.  tests/test_torch_precision.py emulates this
//     rounding against the reference on the CPU.
// * float32 operands must stay within 1e-5 of float64, which no tensor-core
//   format meets, so they run on the CUDA cores in float32 (the first
//   version of this kernel): one CTA of 256 threads owns a 64-row q tile
//   kept in shared memory; per 64-key tile K is staged, each thread
//   computes a 4 x 4 block of scores with float4 reads, the 16 threads of a
//   row group agree on the row max with shuffles, p goes to shared memory,
//   V replaces K in the same buffer, and each thread adds p v into its
//   4 x D/16 accumulator.
//
// The summation order is fixed by the tiling, so a repeat launch is
// bitwise identical.  The entry point takes raw pointers, element strides
// of the (B, S, H) axes (D must be contiguous, the other strides 16-byte
// multiples) and the CUDA stream, launches on that stream and returns
// cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float L_FLOOR = 1e-30f;

// -- bfloat16: tensor cores (wgmma) -------------------------------------------

namespace tc {

constexpr int BQ = 128;       // q rows per CTA: two consumer warpgroups
constexpr int BK = 64;        // keys per tile
constexpr int STAGES = 3;     // K and V tiles in flight
constexpr int NT = 288;       // 8 consumer warps + 1 producer warp

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the head dim padded to whole 64-element (128-byte) swizzle rows
template <int D>
__host__ __device__ constexpr int dpad() { return D < 64 ? 64 : D; }

// ex2.approx: ~2 ulp, far inside the bf16 rounding p gets next
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);    // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pin a wgmma operand's registers in program order: no instruction that
// reads or writes them moves across this point, so none lands inside a
// wgmma pipeline stage (ptxas serializes every wgmma of a kernel in which
// one does).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d (m64n64, f32) = a (smem, K-major) b (smem, K-major) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n64, f32) += a (registers, bf16) b (smem, MN-major, bf16)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n128, f32) += a (registers, bf16) b (smem, MN-major, bf16)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One online-softmax step on a 64-key tile's S fragment (raw q.k, the
// m64n64 accumulator layout: s[j*4 + c] is row g + 8*(c/2), key
// 8j + 2t + c%2 of the warp's 16 rows).  Keys at or past lim_k, and under
// a causal mask keys past row + diag (diag = the warp's first row minus
// the tile's first key), take the reference's -1e30; only tiles that need
// it are masked.  m is kept in raw units: m_new = max(m, row max), alpha =
// exp2((m - m_new) * scale_log2), p = exp2(s * scale_log2 - m_new *
// scale_log2), rounded to bf16 once and packed as the P.V A fragments; ls
// sums the rounded weights.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2],
                                             float scale_log2, bool mask,
                                             int lim_k, int diag, bool causal,
                                             int g, int t,
                                             uint32_t (&pa)[BK / 16][4],
                                             float (&alpha)[2],
                                             float (&ls)[2]) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = j * 8 + 2 * t + (c % 2), rl = g + 8 * (c / 2);
        if (kc >= lim_k || (causal && kc > rl + diag)) s[j * 4 + c] = NEG;
      }
  }
  float mt[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) mt[c / 2] = fmaxf(mt[c / 2], s[j * 4 + c]);
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    alpha[r] = fast_exp2((m[r] - mt[r]) * scale_log2);
    m[r] = mt[r];
    ms[r] = mt[r] * scale_log2;
    ls[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t u = pack_bf16(
          fast_exp2(fmaf(s[j * 4 + 2 * r], scale_log2, -ms[r])),
          fast_exp2(fmaf(s[j * 4 + 2 * r + 1], scale_log2, -ms[r])));
      pa[j / 2][(j % 2) * 2 + r] = u;
      ls[r] += __uint_as_float(u << 16) + __uint_as_float(u & 0xffff0000u);
    }
}

// The tile's masking bounds for a warp whose first row is q0 + wrow:
// lim_k = keys left before Skv (capped at BK), diag = (q0 + wrow) - k0
// (capped so it fits an int), mask = whether any of its entries is masked.
__device__ __forceinline__ bool tile_bounds(int64_t k0, int64_t q0, int wrow,
                                            int64_t Skv, bool causal,
                                            int& lim_k, int& diag) {
  const int64_t left = Skv - k0, d = q0 + wrow - k0;
  lim_k = left < BK ? (int)left : BK;
  diag = d > BK ? BK : d < -2 * BK ? -2 * BK : (int)d;
  return lim_k < BK || (causal && diag < BK - 1);
}

// Issue O += P V for one 64-key tile (P in registers, V MN-major at v_s)
// as one wgmma group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[dpad<D>() / 2],
                                         uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_s) {
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = make_desc(v_s + kk * 16 * 128, BK * 128, 1024);
    if constexpr (dpad<D>() == 64)
      wgmma_rs_n64(acc, pa[kk], dv);
    else
      wgmma_rs_n128(acc, pa[kk], dv);
  }
  wgmma_commit();
}

// Issue S = Q K^T for one 64-key tile as one wgmma group: Q and K K-major
// in shared memory (the warpgroup's Q rows at q_s, 64-wide d blocks BQ rows
// apart; K at k_s); the first product overwrites s.
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[32], uint32_t q_s,
                                        uint32_t k_s) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss_n64(s,
                 make_desc(q_s + (ks / 4) * (BQ * 128) + (ks % 4) * 32, 16,
                           1024),
                 make_desc(k_s + (ks / 4) * (BK * 128) + (ks % 4) * 32, 16,
                           1024),
                 ks > 0);
  wgmma_commit();
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Wait for the completion of the barrier's phase of this parity.  The
// spin is bounded: a lost arrival traps (a launch error) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1u << 26)) __trap();
  }
}
// One (64 d x 64 rows) box of a (D, S, H, B) bf16 tensor map into shared
// memory at dst, completing on bar.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int d, int row, int h,
                                        int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
         "r"(row), "r"(h), "r"(b)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Q, then STAGES K and STAGES V tiles, each [D / 64][rows][64] bf16 in the
// 128-byte swizzle (what TMA writes and wgmma reads), 1024 bytes of slack
// to align the base to a swizzle atom, and the mbarriers
template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(dpad<D>() / 64) * 128 * (BQ + 2 * STAGES * BK) + 1024 +
         8 * (1 + 3 * STAGES);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o, int64_t H,
                            int64_t Sq, int64_t Skv, int64_t o_sb,
                            int64_t o_ss, int64_t o_sh, float scale_log2,
                            int causal) {
  constexpr int DP = dpad<D>(), NB = DP / 64;
  constexpr uint32_t Q_BYTES = NB * BQ * 128, KV_BYTES = NB * BK * 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t Qs = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t Ks = Qs + Q_BYTES, Vs = Ks + STAGES * KV_BYTES;
  const uint32_t bars = Vs + STAGES * KV_BYTES;   // 8 bytes each
  const uint32_t qfull = bars;
  auto kfull = [&](int i) { return bars + 8 * (1 + i); };
  auto vfull = [&](int i) { return bars + 8 * (1 + STAGES + i); };
  auto empty = [&](int i) { return bars + 8 * (1 + 2 * STAGES + i); };

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * BQ;
  const int64_t kend = causal ? (Skv < q0 + BQ ? Skv : q0 + BQ) : Skv;
  const int ntiles = (int)((kend + BK - 1) / BK);

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(kfull(i), 1);
      mbar_init(vfull(i), 1);
      mbar_init(empty(i), 8);          // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {                     // the producer
    if (lane == 0) {
      mbar_expect_tx(qfull, Q_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int db = 0; db < NB; ++db)
          tma_box(Qs + db * (BQ * 128) + w * 64 * 128, &qmap, qfull,
                  db * 64, (int)(q0 + w * 64), (int)h, (int)b);
      for (int j = 0; j < ntiles; ++j) {
        const int slot = j % STAGES;
        if (j >= STAGES) mbar_wait(empty(slot), ((j / STAGES) - 1) & 1);
        mbar_expect_tx(kfull(slot), KV_BYTES);
        for (int db = 0; db < NB; ++db)
          tma_box(Ks + slot * KV_BYTES + db * (BK * 128), &kmap, kfull(slot),
                  db * 64, j * BK, (int)h, (int)b);
        mbar_expect_tx(vfull(slot), KV_BYTES);
        for (int db = 0; db < NB; ++db)
          tma_box(Vs + slot * KV_BYTES + db * (BK * 128), &vmap, vfull(slot),
                  db * 64, j * BK, (int)h, (int)b);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 q rows
  const int g = lane / 4, t = lane % 4, wgi = warp / 4;
  const int wrow = wgi * 64 + (warp % 4) * 16;
  const int64_t qr0 = q0 + wrow + g, qr1 = qr0 + 8;
  // both warpgroups walk all ntiles tiles (the first one's last tile is
  // then fully masked: p = 0, alpha = 1, an exact no-op) so that they take
  // the same number of turns in the ping-pong below
  const int nt = ntiles;
  const uint32_t Qw = Qs + wgi * 64 * 128;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  uint32_t pa[BK / 16][4], pb[BK / 16][4];
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  auto release = [&](int j) {          // K_j and V_j are read
    if (lane == 0) mbar_arrive(empty(j % STAGES));
  };
  mbar_wait(qfull, 0);
  if (nt > 0) {
    mbar_wait(kfull(0), 0);
    issue_s<D>(s, Qw, Ks);
    wgmma_wait<0>();
    fence_regs(s);
    int lim_k, diag;
    const bool mask = tile_bounds(0, q0, wrow, Skv, causal, lim_k, diag);
    float alpha[2], ls[2];
    softmax_tile(s, m, scale_log2, mask, lim_k, diag, causal, g, t, pa,
                 alpha, ls);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = ls[r];
  }
  // Ping-pong: a warpgroup issues its tile's products only on its turn and
  // then hands the turn to the other, so one's softmax runs while the
  // other's products keep the tensor cores busy (named barriers 1 and 2).
  const int my_bar = 1 + wgi, other_bar = 2 - wgi;
  if (wgi == 1) named_arrive(1, 256);          // the first turn is WG 0's
  auto step = [&](int it, uint32_t (&pp)[BK / 16][4],
                  uint32_t (&pn)[BK / 16][4]) {
    const int slot = it % STAGES, prev = (it - 1) % STAGES;
    mbar_wait(kfull(slot), (it / STAGES) & 1);
    mbar_wait(vfull(prev), ((it - 1) / STAGES) & 1);
    named_sync(my_bar, 256);
    issue_s<D>(s, Qw, Ks + slot * KV_BYTES);
    issue_pv<D>(acc, pp, Vs + prev * KV_BYTES);
    named_arrive(other_bar, 256);
    wgmma_wait<1>();                 // S_it is in; P_{it-1} V_{it-1} flies
    fence_regs(s);
    int lim_k, diag;
    const bool mask = tile_bounds((int64_t)it * BK, q0, wrow, Skv, causal,
                                  lim_k, diag);
    float alpha[2], ls[2];
    softmax_tile(s, m, scale_log2, mask, lim_k, diag, causal, g, t, pn,
                 alpha, ls);
    wgmma_wait<0>();
    fence_regs(acc);
    release(it - 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[j * 4] *= alpha[0];
      acc[j * 4 + 1] *= alpha[0];
      acc[j * 4 + 2] *= alpha[1];
      acc[j * 4 + 3] *= alpha[1];
    }
  };
  int it = 1;
  for (; it + 1 < nt; it += 2) {
    step(it, pa, pb);
    step(it + 1, pb, pa);
  }
  if (nt > 0) {
    const int last = (nt - 1) % STAGES;
    const uint32_t lastp = ((nt - 1) / STAGES) & 1;
    if (it < nt) {                     // one tile left: P_{nt-1} lands in pb
      step(it, pa, pb);
      mbar_wait(vfull(last), lastp);
      issue_pv<D>(acc, pb, Vs + last * KV_BYTES);
    } else {
      mbar_wait(vfull(last), lastp);
      issue_pv<D>(acc, pa, Vs + last * KV_BYTES);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(nt - 1);
  }
  if (wgi == 0) named_sync(1, 256);   // WG 1's last hand-over

  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], L_FLOOR);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qp = r == 0 ? qr0 : qr1;
    if (qp >= Sq) continue;
    __nv_bfloat16* orow = ob + qp * o_ss + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[j * 4 + 2 * r] / l[r],
                                acc[j * 4 + 2 * r + 1] / l[r]);
  }
}

}  // namespace tc

// -- float32: CUDA cores --------------------------------------------------------

namespace fp32 {

constexpr int BQ = 64;     // q rows per CTA
constexpr int BK = 64;     // keys per tile
constexpr int NT = 256;    // threads: 16 row groups x 16 lanes

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)((BQ + BK) * (D + 4) + BQ * (BK + 4));
}

// Copy rows [row0, row0 + ROWS) of a (n, D) slice with row stride rs
// (elements) into a float [ROWS][D + 4] tile; rows >= n read as 0.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int64_t rs, int64_t row0,
                                          int64_t n) {
  constexpr int CH = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n)
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * rs + c * 4);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c * 4) = val;
  }
}

template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int64_t H, int64_t Sq, int64_t Skv,
                           int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t o_sb, int64_t o_ss, int64_t o_sh,
                           float scale, int causal) {
  constexpr int PITCH = D + 4, PPITCH = BK + 4;
  constexpr int CPT = D / 16;                   // output columns per thread
  constexpr int VW = CPT < 4 ? CPT : 4;         // ... read/written VW at once
  constexpr int NV = CPT / VW;                  // ... in NV vectors
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BQ][PITCH]
  float* KVs = Qs + BQ * PITCH;     // [BK][PITCH], K then V of one tile
  float* Ps = KVs + BK * PITCH;     // [BQ][PPITCH]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * BQ;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  load_tile<D, BQ>(Qs, qb, q_ss, q0, Sq);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  // causal: only keys k_pos <= q0 + BQ - 1 can be unmasked for this tile
  const int64_t kend = causal ? (Skv < q0 + BQ ? Skv : q0 + BQ) : Skv;
  for (int64_t k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                       // last tile's V and P are read
    load_tile<D, BK>(KVs, kb, k_ss, k0, Skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * PITCH + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * c) * PITCH + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float t = s[i][c];
          t = fmaf(qv[i].x, kv[c].x, t);
          t = fmaf(qv[i].y, kv[c].y, t);
          t = fmaf(qv[i].z, kv[c].z, t);
          t = fmaf(qv[i].w, kv[c].w, t);
          s[i][c] = t;
        }
    }

    // scale, mask, online softmax; p overwrites s
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qp = q0 + ty * 4 + i;
      float mt = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t kp = k0 + tx + 16 * c;
        float x = s[i][c] * scale;
        if (kp >= Skv || (causal && kp > qp)) x = NEG;
        s[i][c] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - mn);
        ls += p;
        Ps[(ty * 4 + i) * PPITCH + tx + 16 * c] = p;
      }
      l[i] = l[i] * alpha + ls;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                       // K is read, P is written
    load_tile<D, BK>(KVs, vb, v_ss, k0, Skv);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * PPITCH + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = KVs + (kk + e) * PITCH + tx * VW;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float vv[VW];
          load_vec<VW>(vrow + j * 16 * VW, vv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                          : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int w = 0; w < VW; ++w)
              acc[i][j * VW + w] = fmaf(p, vv[w], acc[i][j * VW + w]);
          }
        }
      }
    }
  }

  float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = fmaxf(lt, L_FLOOR);
    const int64_t qp = q0 + ty * 4 + i;
    if (qp < Sq) {
      float* orow = ob + qp * o_ss + tx * VW;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float out[VW];
#pragma unroll
        for (int w = 0; w < VW; ++w) out[w] = acc[i][j * VW + w] / lt;
        store_vec<VW>(orow + j * 16 * VW, out);
      }
    }
  }
}

}  // namespace fp32

// cuTensorMapEncodeTiled, a CUDA driver API function, looked up through the
// runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// A (D, S, H, B) bf16 tensor map of x with element strides (sb, ss, sh),
// boxes of 64 d x 64 rows in the 128-byte swizzle; d past D and rows past S
// read as 0.
bool make_map(CUtensorMap* map, const void* x, int64_t B, int64_t S,
              int64_t H, int64_t D, int64_t sb, int64_t ss, int64_t sh) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                       int64_t B, int64_t H, int64_t Sq, int64_t Skv,
                       const int64_t* st, double scale, int causal,
                       cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, Sq, H, D, st[0], st[1], st[2]) ||
      !make_map(&km, k, B, Skv, H, D, st[3], st[4], st[5]) ||
      !make_map(&vm, v, B, Skv, H, D, st[6], st[7], st[8]))
    return cudaErrorInvalidValue;
  constexpr size_t smem = tc::smem_bytes<D>();
  auto kern = tc::flash_attention_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Sq + tc::BQ - 1) / tc::BQ), (unsigned)(B * H));
  kern<<<grid, tc::NT, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), H, Sq, Skv, st[9], st[10],
      st[11], (float)(scale * 1.4426950408889634), causal);
  return cudaGetLastError();
}

template <bool BF16, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t B, int64_t H, int64_t Sq, int64_t Skv,
                   const int64_t* st, double scale, int causal,
                   cudaStream_t stream) {
  if constexpr (BF16) {
    return launch_bf16<D>(q, k, v, o, B, H, Sq, Skv, st, scale, causal,
                          stream);
  } else {
    constexpr size_t smem = fp32::smem_bytes<D>();
    auto kern = fp32::flash_attention_f32_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((Sq + fp32::BQ - 1) / fp32::BQ),
                    (unsigned)(B * H));
    kern<<<grid, fp32::NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H, Sq, Skv,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], st[10], st[11], (float)scale, causal);
  }
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int64_t B, int64_t H, int64_t Sq, int64_t Skv,
                     int64_t D, const int64_t* st, double scale, int causal,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<BF16, 16>(q, k, v, o, B, H, Sq, Skv, st, scale, causal, stream);
    case 32: return launch<BF16, 32>(q, k, v, o, B, H, Sq, Skv, st, scale, causal, stream);
    case 64: return launch<BF16, 64>(q, k, v, o, B, H, Sq, Skv, st, scale, causal, stream);
    case 128: return launch<BF16, 128>(q, k, v, o, B, H, Sq, Skv, st, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (B, S, H, D) with element strides (batch, seq, head) each and
// a contiguous D in {16, 32, 64, 128}; bf16 != 0 means bfloat16 operands
// (tensor cores, grid (ceil(Sq / 128), B * H)), else float32 (CUDA cores,
// grid (ceil(Sq / 64), B * H)).  scale is D^-1/2.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int64_t B, int64_t H, int64_t Sq,
                           int64_t Skv, int64_t D,
                           int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t o_sb, int64_t o_ss, int64_t o_sh,
                           int64_t bf16, int64_t causal, double scale,
                           void* stream) {
  if (B * H > 65535 || B * H < 1 || Sq < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_d<true>(q, k, v, o, B, H, Sq, Skv, D, st, scale,
                            causal != 0, s)
           : launch_d<false>(q, k, v, o, B, H, Sq, Skv, D, st, scale,
                             causal != 0, s);
  return (int)err;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
