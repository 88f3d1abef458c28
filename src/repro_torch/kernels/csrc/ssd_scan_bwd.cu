// The gradient of the Mamba2 SSD chunked scan (K6's backward) for Hopper
// (sm_90a), bound to Python with ctypes.
//
// The Pallas kernel src/repro/kernels/ssd_scan.py:70 (ssd_scan_pallas) has
// no gradient: the reference trains through jax.grad of
// src/repro/models/mamba2.py::ssd_chunked.  This computes that gradient
// for K6's y (the final state is not differentiated), what
// kernels/ref.py::ssd_scan_bwd_plain writes out.  Per (batch, head), over
// chunks of Q rows, with a_j = dt_j A, cum its in-chunk cumsum, total =
// cum[Q-1], L_ij = exp(cum_i - cum_j) for j <= i, G = C B^T, w_j =
// exp(total - cum_j) dt_j, S_c the state carried into chunk c and dS_{c+1}
// the gradient of the state it hands on (dS_n = 0):
//
//     dS_c  = exp(total_c) dS_{c+1} + sum_i exp(cum_i) C_i (x) dy_i
//     dx_j  = dt_j sum_{i>=j} G_ij L_ij dy_i + w_j B_j . dS_{c+1} + D dy_j
//     dG_ij = sum_h L_ij dt_j (dy_i . x_j)
//     dC_i  = sum_j dG_ij B_j + sum_h exp(cum_i) S_c dy_i
//     dB_j  = sum_i dG_ij C_i + sum_h w_j dS_{c+1} x_j
//     ddt_j = sum_i G_ij L_ij (dy_i . x_j) + exp(total - cum_j) dw_j + A da_j,
//             dw_j = B_j . dS_{c+1} x_j
//     dA = sum dt_j da_j,  dD = sum x . dy
//
// where da is the in-chunk reverse cumsum of dcum: the row sums of T_ij =
// G_ij L_ij dt_j (dy_i . x_j) less its column sums, exp(cum_i) C_i . S_c dy_i,
// -w_j dw_j, and at the chunk's last row dtotal = exp(total) <S_c, dS_{c+1}>
// + sum_j w_j dw_j.  Operands as the forward takes them: x (b, L, H, P) and
// B, C (b, L, N) in float32 or bfloat16 (one dtype; P <= 64, N <= 128) read
// through their strides (P and N contiguous), dt (b, L, H), A and D (H,)
// float32, dy (b, L, H, P) in x's dtype through its strides.  dx is written
// contiguous in x's dtype, dB and dC contiguous (b, L, N) in B's, ddt
// contiguous (b, L, H) and dA, dD (H,) in float32.  Any L (the ragged last
// chunk's rows past L load as zero, dt 0, so they add nothing) and any Q.
//
// Bound on this card: at Mamba2-1.3B's training shape (b 4, L 2048, H 64,
// P 64, N 128, Q 256, bf16) the function reads x and dy and writes dx
// (3 x 67.1 MB), reads B, C, dt, writes their gradients (15 MB): 216 MB,
// 0.065 ms at 3.35 TB/s; its operations (perf/roofline.py::
// ssd_scan_bwd_terms) are 6.1e10, 0.062 ms at the bf16 tensor-core peak.
//
// The route is chosen by dtype before the launch, never as a fallback.  Both
// take four chunk-parallel passes, the forward's three mirrored and a
// reduction, and keep the cumsums and the row / column sums that cancel in
// dA in float64 (a decay's exponent is a difference of two cumsums, so its
// float32 error would scale with |cum|, ~500 at the probe's decays).
//
// * bfloat16 operands: the tensor cores (namespace tc), every product a
//   wgmma with float32 accumulators.
//   1. states (ssd_bwd_tc_states_kernel), one CTA (a warpgroup) per
//      (batch, chunk, head, which): one warp scans dt A in float64 (which 0
//      writes the cumsums to the (b, n, H, Q) scratch for pass 3), then
//      s_c = B^T (w x) (which 0, chunks 0..n-2) or ds_c = C^T (e dy) (which
//      1, chunks 1..n-1) over the chunk's 64-row tiles in two cp.async
//      stages: the x or dy tile is scaled in place by w_j or e_j =
//      exp(cum_j) and rounded to bf16 once, then wgmma with B^T / C^T
//      MN-major in two m64 halves over N; the (N, P) state leaves in float32
//      through shared memory into the (b, n, H, N, P) scratches;
//   2. state passing (ssd_bwd_tc_pass_kernel), one thread per (batch, head,
//      state row, 4 columns): S_c forward and dS_{c+1} in reverse, the
//      loads of 8 chunks issued before their chain of multiply-adds; each
//      rounded to bf16 into the swizzled (Npad, 64) tiles pass 3's wgmma
//      reads (the forward's layout), S_c also in float32 where s_c was, and
//      <S_c, dS_{c+1}> as one partial a warp.  The float32 route's pass, a
//      thread an element, waits on one load per chunk and direction (each
//      chunk's load stands behind the store before it);
//   3. chunk (ssd_bwd_tc_chunk_kernel), one CTA per (batch, chunk, 2
//      heads), two warpgroups.  Per key tile jt (B_jt and the heads' x_jt;
//      C_jt and dy_jt as query tile jt in the first stage; the heads' S_c
//      and dS_{c+1} over the second stage, reloaded each key tile):
//      the state terms, warpgroup w on head w: U = B_jt dS_w gives dx_j =
//      w_j U + D dy_j and dw_j = x_j . U_j; Z = C_jt S_w gives dcs_j =
//      e_j dy_j . Z_j; and over the warpgroup's 64 columns of N, for both
//      heads, x_jt dS^T and dy_jt S^T scaled by w_j and e_j in float32 give
//      the state parts of dB and dC, written to the partials;
//      then per query tile it >= jt (two cp.async stages) warpgroup w takes
//      the tile's query columns 32w..32w+31 for both heads (m64n32): G^T =
//      B_jt C_it^T once, D^T = x_jt dy_it^T a head; the masked decays;
//      M^T = G^T L^T dt_j rounded to bf16 straight into wgmma's A fragment
//      (the rows of G^T are the keys, so M^T is already in A's layout: no
//      shared-memory round trip); dx_jt += M^T dy_it over the warpgroup's
//      query rows; the row sums of R D^T (over a quad) and of T (a float64
//      row a (warp, row group), summed in order) in float64 from the float32
//      products, never from a rounded operand; dG^T summed over the two
//      heads in order and rounded to bf16 once into a shared tile; then,
//      over the warpgroup's columns of N, dB_jt += dG^T C_it and dC_it +=
//      dG B_jt added to this CTA's rows of the float32 partials (b, L,
//      ceil(H / 2), N rounded up to even; every load of a row issued before
//      its first store).  dx_jt's shares (each warpgroup holds a share of
//      both heads) stay in shared memory and are summed in order when jt
//      ends.  Last, one warp a head takes the reverse cumsum of dcum into
//      ddt and the chunk's dA and dD in float64;
//   4. reduce (ssd_bwd_tc_reduce_kernel): dB and dC over the head blocks'
//      partials, dA and dD over (batch, chunk), each in a fixed order.
//   What bounds it: latency, not the tensor cores (6.1e10 operations are
//   0.062 ms at their peak).  Pass 3 takes one CTA of 8 warps an SM (230 976
//   bytes of shared memory at Q 256, 254 registers a thread and no spills,
//   which chip_smoke.py prints and checks from the ptxas report), and its
//   read-modify-writes of the partials, two a pair of tiles, are most of
//   its time.  What the design does about it: every product is a wgmma
//   with float32 accumulators; cp.async of 16 bytes with zero fill into the
//   128-byte swizzle that wgmma reads (not TMA: a chunk's rows need not be
//   a multiple of 64, and a tile zero-fills the rows past the chunk's end;
//   rows that are not 16-byte aligned are filled by scalar loads); below
//   the diagonal the decays factor as exp(cum_i - cum_jl) exp(cum_jl -
//   cum_j) with jl the key tile's last row, 64 + 64 exponentials a tile,
//   not 4 096; the accumulators of dx live in shared memory (a fragment a
//   thread), and the loaders read the thread index anew, so that no
//   fragment or address is held in registers across the loops.
//   Numerics: the six operands that are not inputs (w x, e dy, M, dG, S_c,
//   dS_{c+1}) are rounded to bf16 once each; products of bf16 inputs are
//   exact and sums float32.  Emulated on the CPU at b 1, L 2048, H 8, P 64,
//   N 128, Q 256 (tests/test_torch_precision.py, chip_smoke.py's
//   ssd_bwd_passes) against the plain version in float32 math, the worst
//   gradient norm-wise: bf16 once 2.615e-3 / 3.128e-3 (fast / slow
//   decay), bf16 hi + lo 9.9e-5 / 1.7e-4, TF32 9.1e-4 / 1.0e-3; each
//   operand rounded alone at most 2.6e-3.  The bar is 1e-2, so one bf16
//   rounding is taken.
// * float32 operands must stay within 1e-5 of float64, which no tensor-core
//   format meets, so they take the first version of this kernel on the CUDA
//   cores (namespace fp32), float32 products fed from shared memory:
//   1. states (ssd_bwd_states_kernel), one CTA per (batch, chunk, head):
//      the scan of dt A in float64 (written to a (b, n, H, Q) scratch for
//      pass 3), then s_c = B^T (w x) (the forward's chunk state,
//      recomputed: chunks 0..n-2) and ds_c = C^T (exp(cum) dy) (the chunk's
//      share of the state gradient: chunks 1..n-1) over 32-row tiles, each
//      (N, P) in float32 into (b, n, H, N, P) scratches;
//   2. state passing (ssd_bwd_pass_kernel), one thread per (batch, head, N,
//      P) element, in place: forward S_{c+1} = exp(total_c) S_c + s_c, S_c
//      left where s_c was; in reverse dS_c = exp(total_c) dS_{c+1} + ds_c,
//      dS_{c+1} left where ds_c was.  The chunk-start states are recomputed
//      here rather than saved by the forward (67 MB a layer at the training
//      shape that the forward need not keep);
//   3. chunk (ssd_bwd_chunk_kernel), one CTA per (batch, chunk, 4 heads):
//      per key tile jt of 64 rows and query tile it >= jt, G = C_it B_jt^T
//      once for the 4 heads, per head dy_it x_jt^T, the masked decays, the
//      row and column sums of T, dx_jt's intra-chunk sum in registers and
//      dG summed over the heads; then dB_jt += dG^T C_it (registers) and
//      dC_it += dG B_jt (read-modify-write of this CTA's own rows of a
//      partial); after the query tiles, key tile jt's state terms (B_jt
//      dS, x_jt dS^T, dy_jt S_c^T) finish dx, dB, dC and the state parts of
//      ddt and dcum; last, one thread a head takes the reverse cumsum of
//      dcum into ddt and the chunk's dA and dD, in float64.  Tiles above
//      the diagonal are never visited and exp(cum_i - cum_j) is formed only
//      for j <= i;
//   4. reduce (ssd_bwd_reduce_kernel): dB and dC summed over the head
//      blocks' partials (b, L, ceil(H / 4), N), dA and dD over (batch,
//      chunk), each in a fixed order.
// No atomics: every partial has one writer and every sum a fixed order, so
// a repeat launch is bitwise identical.  Every exponent is <= 0 (A < 0,
// dt >= 0).  Every entry point takes the same arguments, launches on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_N = 128;    // state size N
constexpr int MAX_P = 64;     // head dim P
constexpr int SMEM_LIMIT = 232448;

struct Args {
  const void* x;
  const void* B;
  const void* C;
  const float* dt;
  const float* A;
  const float* D;
  const void* dy;
  void* dx;
  float* ddt;
  float* dBp;                 // (b, L, nhb, N) partials of dB, dC
  float* dCp;
  float* dAp;                 // (b, n, H) partials of dA, dD
  float* dDp;
  void* dB;
  void* dC;
  float* dA;
  float* dD;
  double* cum;                // (b, n, H, Q)
  float* s;                   // (b, n, H, N, P): s_c, then S_c
  float* ds;                  // (b, n, H, N, P): ds_c, then dS_{c+1}
  void* Sb;                   // bf16 route: (b, n, H, Npad, 64) S_c and
  void* dSb;                  // dS_{c+1} tiles in bf16, swizzled
  float* ssp;                 // bf16 route: (b, n, H, ssp_count) partials
  int64_t b, L, H, P, N, Q, n, nhb;
  int64_t x_sb, x_sl, x_sh;
  int64_t B_sb, B_sl, C_sb, C_sl;
  int64_t d_sb, d_sl, d_sh;
  int64_t g_sb, g_sl, g_sh;   // dy
};

namespace fp32 {

constexpr int NT = 256;       // threads of passes 1 and 3: 16 x 16
constexpr int T1 = 32;        // rows a tile, pass 1
constexpr int T = 64;         // rows a tile, pass 3
constexpr int HB = 4;         // heads a CTA, pass 3
constexpr int NT2 = 256;      // threads a block, passes 2 and 4

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows r < nr of `cols` elements from base + r * rs into dst + r * pitch as
// float32; rows r >= valid load as 0.
template <typename E>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const E* __restrict__ base,
                                          int64_t rs, int nr, int valid,
                                          int cols) {
  for (int e = threadIdx.x; e < nr * cols; e += NT) {
    const int r = e / cols, k = e % cols;
    dst[r * pitch + k] = r < valid ? ld(base + r * rs + k) : 0.f;
  }
}

// In-place inclusive scan of v[0..n) by the block's NT threads, in a fixed
// order; wsum holds NT / 32 doubles.
__device__ void block_scan(double* v, int n, double* wsum) {
  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  double carry = 0.0;
  for (int base = 0; base < n; base += NT) {
    const int k = base + t;
    double x = k < n ? v[k] : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[wp] = x;
    __syncthreads();
    double pre = carry;
    for (int w = 0; w < wp; ++w) pre += wsum[w];
    if (k < n) v[k] = pre + x;
    __syncthreads();
    carry = v[min(base + NT, n) - 1];
  }
  __syncthreads();
}

// Sum of v over the block in a fixed order, valid in thread 0; red holds
// NT / 32 floats.  Every thread must call it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Sum over the 16 lanes that share ty (lanes tx = 0..15 of a half warp).
__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -- pass 1: cumsums, recomputed chunk states and chunk state gradients ---------

// bytes: the cumsums and the scan's warp sums in float64, the rest float32
__host__ __device__ inline int64_t states_bytes(int64_t N, int64_t P,
                                                int64_t Q) {
  return 8 * (Q + NT / 32) +
         4 * (2 * Q + 2 * T1 * (N + 1) + 2 * T1 * (P + 1));
}

template <typename E>
__global__ void __launch_bounds__(NT) ssd_bwd_states_kernel(Args a) {
  extern __shared__ float sm[];
  const int H = (int)a.H, N = (int)a.N, P = (int)a.P, Q = (int)a.Q;
  const int n = (int)a.n;
  const int64_t idx = blockIdx.x;
  const int h = (int)(idx % H);
  const int c = (int)((idx / H) % n);
  const int64_t bi = idx / H / n;
  const int64_t l0 = (int64_t)c * Q;
  const int rows = (int)(a.L - l0 < Q ? a.L - l0 : Q);
  double* cum = reinterpret_cast<double*>(sm);
  double* wsum = cum + Q;
  float* wv = reinterpret_cast<float*>(wsum + NT / 32);
  float* ev = wv + Q;
  float* Bt = ev + Q;
  float* Ct = Bt + T1 * (N + 1);
  float* Xt = Ct + T1 * (N + 1);
  float* Yt = Xt + T1 * (P + 1);
  const double Ah = a.A[h];
  const float* dt = a.dt + bi * a.d_sb + l0 * a.d_sl + h * a.d_sh;
  for (int k = threadIdx.x; k < Q; k += NT)
    cum[k] = k < rows ? dt[k * a.d_sl] * Ah : 0.0;
  __syncthreads();
  block_scan(cum, Q, wsum);
  const double total = cum[Q - 1];
  double* cg = a.cum + ((bi * n + c) * H + h) * Q;
  for (int k = threadIdx.x; k < Q; k += NT) {
    cg[k] = cum[k];
    wv[k] = k < rows ? expf((float)(total - cum[k])) * dt[k * a.d_sl] : 0.f;
    ev[k] = k < rows ? expf((float)cum[k]) : 0.f;
  }
  const bool want_s = c < n - 1, want_ds = c > 0;
  if (!want_s && !want_ds) return;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float as[8][4], ad[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) as[r][q] = ad[r][q] = 0.f;
  const E* xb = static_cast<const E*>(a.x) + bi * a.x_sb + l0 * a.x_sl +
                h * a.x_sh;
  const E* gb = static_cast<const E*>(a.dy) + bi * a.g_sb + l0 * a.g_sl +
                h * a.g_sh;
  const E* Bb = static_cast<const E*>(a.B) + bi * a.B_sb + l0 * a.B_sl;
  const E* Cb = static_cast<const E*>(a.C) + bi * a.C_sb + l0 * a.C_sl;
  for (int j0 = 0; j0 < rows; j0 += T1) {
    __syncthreads();             // the tiles of the step before are read
    const int nv = min(T1, rows - j0);
    load_rows(Bt, N + 1, Bb + j0 * a.B_sl, a.B_sl, T1, nv, N);
    load_rows(Ct, N + 1, Cb + j0 * a.C_sl, a.C_sl, T1, nv, N);
    load_rows(Xt, P + 1, xb + j0 * a.x_sl, a.x_sl, T1, nv, P);
    load_rows(Yt, P + 1, gb + j0 * a.g_sl, a.g_sl, T1, nv, P);
    __syncthreads();
    for (int r = 0; r < nv; ++r) {
      const float w = wv[j0 + r], e = ev[j0 + r];
      float xv[4], yv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        xv[q] = p < P ? Xt[r * (P + 1) + p] : 0.f;
        yv[q] = p < P ? Yt[r * (P + 1) + p] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = ty + 16 * i;
        const float bv = k < N ? Bt[r * (N + 1) + k] * w : 0.f;
        const float cv = k < N ? Ct[r * (N + 1) + k] * e : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          as[i][q] = fmaf(bv, xv[q], as[i][q]);
          ad[i][q] = fmaf(cv, yv[q], ad[i][q]);
        }
      }
    }
  }
  const int64_t o = ((bi * n + c) * H + h) * (int64_t)N * P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = ty + 16 * i;
    if (k >= N) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = tx + 16 * q;
      if (p >= P) continue;
      if (want_s) a.s[o + k * P + p] = as[i][q];
      if (want_ds) a.ds[o + k * P + p] = ad[i][q];
    }
  }
}

// -- pass 2: state passing, forward for S_c and in reverse for dS_{c+1} --------

__global__ void __launch_bounds__(NT2) ssd_bwd_pass_kernel(Args a) {
  const int64_t NP = a.N * a.P;
  const int64_t idx = (int64_t)blockIdx.x * NT2 + threadIdx.x;
  if (idx >= a.b * a.H * NP) return;
  const int64_t e = idx % NP, bh = idx / NP;
  const int64_t h = bh % a.H, bi = bh / a.H;
  const int n = (int)a.n;
  float S = 0.f;
  for (int c = 0; c < n; ++c) {
    const int64_t at = ((bi * n + c) * a.H + h) * NP + e;
    const float tot = (float)a.cum[((bi * n + c) * a.H + h) * a.Q + a.Q - 1];
    const float sc = c < n - 1 ? a.s[at] : 0.f;
    a.s[at] = S;
    S = fmaf(expf(tot), S, sc);
  }
  float dS = 0.f;
  for (int c = n - 1; c >= 0; --c) {
    const int64_t at = ((bi * n + c) * a.H + h) * NP + e;
    const float tot = (float)a.cum[((bi * n + c) * a.H + h) * a.Q + a.Q - 1];
    const float dc = c > 0 ? a.ds[at] : 0.f;
    a.ds[at] = dS;
    dS = fmaf(expf(tot), dS, dc);
  }
}

// -- pass 3: the chunk's gradients ---------------------------------------------

// bytes: the cumsums and the row and column sums of T in float64, the rest
// float32
__host__ __device__ inline int64_t chunk_bytes(int64_t N, int64_t P,
                                               int64_t Q) {
  return 8 * 3 * HB * Q + 4 * (2 * T * (N + 1) + 2 * T * (P + 1) +
                               4 * T * (T + 1) + 3 * HB * Q + NT / 32 +
                               2 * HB);
}

template <typename E>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_chunk_kernel(Args a) {
  extern __shared__ float sm[];
  const int H = (int)a.H, N = (int)a.N, P = (int)a.P, Q = (int)a.Q;
  const int n = (int)a.n, nhb = (int)a.nhb;
  const int64_t idx = blockIdx.x;
  const int hb = (int)(idx % nhb);
  const int c = (int)((idx / nhb) % n);
  const int64_t bi = idx / nhb / n;
  const int64_t l0 = (int64_t)c * Q;
  const int rows = (int)(a.L - l0 < Q ? a.L - l0 : Q);
  const int nt = (rows + T - 1) / T;
  const int h0 = hb * HB, nh = min(HB, H - h0);
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int NP1 = N + 1, PP1 = P + 1, TP1 = T + 1;
  // (HB, Q) each, float64: the cumsums, and the row sums of T and column
  // sums of R (dy . x), whose differences cancel in dcum's reverse cumsum
  // (the sum over a chunk of row less column sums is 0)
  double* cumv = reinterpret_cast<double*>(sm);
  double* dcr = cumv + HB * Q;
  double* dcc = dcr + HB * Q;
  float* Cs = reinterpret_cast<float*>(dcc + HB * Q);
  float* Bs = Cs + T * NP1;
  float* Xs = Bs + T * NP1;
  float* Ys = Xs + T * PP1;
  float* Dg = Ys + T * PP1;     // dG summed over the heads
  float* Rt = Dg + T * TP1;     // R = G L
  float* Qt = Rt + T * TP1;     // R (dy . x)
  float* St = Qt + T * TP1;     // one spare tile
  float* dSn = Dg;              // state phase: dS_{c+1} (N, P + 1) ...
  float* Sc = Dg + N * PP1;     // ... and S_c (N, P + 1) over the tiles
  float* dtv = St + T * TP1;    // (HB, Q) each
  float* dcs = dtv + HB * Q;    // exp(cum_i) C_i . S_c dy_i
  float* dws = dcs + HB * Q;    // dw_j = B_j . dS_{c+1} x_j
  float* red = dws + HB * Q;    // NT / 32
  float* hdD = red + NT / 32;   // (HB,) x . dy
  float* hSS = hdD + HB;        // (HB,) <S_c, dS_{c+1}>

  for (int e = t; e < HB * Q; e += NT) {
    const int hh = e / Q, k = e % Q;
    const int h = min(h0 + hh, H - 1);
    cumv[e] = a.cum[((bi * n + c) * H + h) * Q + k];
    dtv[e] = hh < nh && k < rows
                 ? a.dt[bi * a.d_sb + (l0 + k) * a.d_sl + h * a.d_sh]
                 : 0.f;
    dcr[e] = dcc[e] = 0.0;
    dcs[e] = dws[e] = 0.f;
  }
  if (t < HB) hdD[t] = hSS[t] = 0.f;
  __syncthreads();

  const E* Bb = static_cast<const E*>(a.B) + bi * a.B_sb + l0 * a.B_sl;
  const E* Cb = static_cast<const E*>(a.C) + bi * a.C_sb + l0 * a.C_sl;
  const E* xb = static_cast<const E*>(a.x) + bi * a.x_sb + l0 * a.x_sl;
  const E* gb = static_cast<const E*>(a.dy) + bi * a.g_sb + l0 * a.g_sl;
  float* dCp = a.dCp + ((bi * a.L + l0) * nhb + hb) * (int64_t)N;
  float* dBp = a.dBp + ((bi * a.L + l0) * nhb + hb) * (int64_t)N;
  const int64_t rstride = (int64_t)nhb * N;   // a row of the partials

  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * T, nj = min(T, rows - j0);
    float dBa[4][8], dxa[HB][4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 8; ++q) dBa[r][q] = 0.f;
#pragma unroll
      for (int hh = 0; hh < HB; ++hh)
#pragma unroll
        for (int q = 0; q < 4; ++q) dxa[hh][r][q] = 0.f;
    }
    load_rows(Bs, NP1, Bb + j0 * a.B_sl, a.B_sl, T, nj, N);

    for (int it = jt; it < nt; ++it) {
      const int i0 = it * T, ni = min(T, rows - i0);
      load_rows(Cs, NP1, Cb + i0 * a.C_sl, a.C_sl, T, ni, N);
      __syncthreads();
      // G = C_it B_jt^T (rows i = ty + 16r, keys j = tx + 16q); dG := 0
      float g[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) g[r][q] = 0.f;
      for (int k = 0; k < N; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * NP1 + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = Bs[(tx + 16 * q) * NP1 + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) g[r][q] = fmaf(cv[r], bv[q], g[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) Dg[(ty + 16 * r) * TP1 + tx + 16 * q] = 0.f;

#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        if (hh >= nh) break;
        const int h = h0 + hh;
        const double* cm = cumv + hh * Q;
        const float* dd = dtv + hh * Q;
        load_rows(Ys, PP1, gb + i0 * a.g_sl + h * a.g_sh, a.g_sl, T, ni, P);
        load_rows(Xs, PP1, xb + j0 * a.x_sl + h * a.x_sh, a.x_sl, T, nj, P);
        __syncthreads();
        // dy_it . x_jt, then the masked decays and the tiles of R, R (dy.x)
        float d[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) d[r][q] = 0.f;
        for (int k = 0; k < P; ++k) {
          float yv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) yv[r] = Ys[(ty + 16 * r) * PP1 + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = Xs[(tx + 16 * q) * PP1 + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) d[r][q] = fmaf(yv[r], xv[q], d[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int il = ty + 16 * r, i = i0 + il;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int jl = tx + 16 * q, j = j0 + jl;
            const bool ok = j <= i && i < rows;
            const float Lv = ok ? expf((float)(cm[i] - cm[j])) : 0.f;
            const float R = g[r][q] * Lv;
            Rt[il * TP1 + jl] = R;
            Qt[il * TP1 + jl] = R * d[r][q];
            Dg[il * TP1 + jl] = fmaf(Lv * (ok ? dd[j] : 0.f), d[r][q],
                                     Dg[il * TP1 + jl]);
          }
        }
        __syncthreads();
        // row sums of T into dcr, column sums of R (dy.x) into dcc
        if (t < T) {
          if (t < ni) {
            double s = 0.0;       // exact products of float32 values
            for (int jl = 0; jl < T; ++jl)
              s += (double)(j0 + jl < rows ? dd[j0 + jl] : 0.f) *
                   Qt[t * TP1 + jl];
            dcr[hh * Q + i0 + t] += s;
          }
        } else if (t < 2 * T) {
          const int jl = t - T;
          if (jl < nj) {
            double s = 0.0;
            for (int il = 0; il < T; ++il) s += Qt[il * TP1 + jl];
            dcc[hh * Q + j0 + jl] += s;
          }
        }
        // dx_jt += R^T dy_it (keys j = ty + 16r, p = tx + 16q)
        for (int k = 0; k < T; ++k) {
          float rv[4], yv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) rv[r] = Rt[k * TP1 + ty + 16 * r];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = tx + 16 * q;
            yv[q] = p < P ? Ys[k * PP1 + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              dxa[hh][r][q] = fmaf(rv[r], yv[q], dxa[hh][r][q]);
        }
        __syncthreads();
      }
      // dB_jt += dG^T C_it (keys j = ty + 16r, n = tx + 16q)
      for (int k = 0; k < T; ++k) {
        float gv[4], cv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = Dg[k * TP1 + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int m = tx + 16 * q;
          cv[q] = m < N ? Cs[k * NP1 + m] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) dBa[r][q] = fmaf(gv[r], cv[q], dBa[r][q]);
      }
      // dC_it += dG B_jt (rows i = ty + 16r, n = tx + 16q), this CTA's rows
      {
        float acc[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
        for (int k = 0; k < T; ++k) {
          float gv[4], bv[8];
#pragma unroll
          for (int r = 0; r < 4; ++r) gv[r] = Dg[(ty + 16 * r) * TP1 + k];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int m = tx + 16 * q;
            bv[q] = m < N ? Bs[k * NP1 + m] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(gv[r], bv[q], acc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int il = ty + 16 * r;
          if (il >= ni) continue;
          float* row = dCp + (i0 + il) * rstride;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int m = tx + 16 * q;
            if (m < N) row[m] += acc[r][q];
          }
        }
      }
      __syncthreads();          // Cs, Dg are free for the next query tile
    }

    // key tile jt's state terms, per head
    load_rows(Cs, NP1, Cb + j0 * a.C_sl, a.C_sl, T, nj, N);
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      if (hh >= nh) break;
      const int h = h0 + hh;
      const double* cm = cumv + hh * Q;
      const float* dd = dtv + hh * Q;
      const double total = cm[Q - 1];
      const int64_t so = ((bi * n + c) * H + h) * (int64_t)N * P;
      for (int e = t; e < N * P; e += NT) {
        const int k = e / P, p = e % P;
        dSn[k * PP1 + p] = a.ds[so + e];
        Sc[k * PP1 + p] = a.s[so + e];
      }
      load_rows(Xs, PP1, xb + j0 * a.x_sl + h * a.x_sh, a.x_sl, T, nj, P);
      load_rows(Ys, PP1, gb + j0 * a.g_sl + h * a.g_sh, a.g_sl, T, nj, P);
      __syncthreads();
      const float Dh = a.D[h];
      float part = 0.f;         // this thread's share of x . dy
      // dx_j = dt_j (R^T dy)_j + w_j B_j . dS + D dy_j
      {
        float u[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) u[r][q] = 0.f;
        for (int k = 0; k < N; ++k) {
          float bv[4], sv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) bv[r] = Bs[(ty + 16 * r) * NP1 + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = tx + 16 * q;
            sv[q] = p < P ? dSn[k * PP1 + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) u[r][q] = fmaf(bv[r], sv[q], u[r][q]);
        }
        E* dxb = static_cast<E*>(a.dx);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int jl = ty + 16 * r, j = j0 + jl;
          if (jl >= nj) continue;
          const float w = expf((float)(total - cm[j])) * dd[j];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = tx + 16 * q;
            if (p >= P) continue;
            const float gy = Ys[jl * PP1 + p];
            part = fmaf(Xs[jl * PP1 + p], gy, part);
            st(dxb + ((bi * a.L + l0 + j) * H + h) * P + p,
               dd[j] * dxa[hh][r][q] + w * u[r][q] + Dh * gy);
          }
        }
      }
      // V = x_j dS^T: dB_j += w_j V, dw_j = B_j . V
      {
        float v[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) v[r][q] = 0.f;
        for (int k = 0; k < P; ++k) {
          float xv[4], sv[8];
#pragma unroll
          for (int r = 0; r < 4; ++r) xv[r] = Xs[(ty + 16 * r) * PP1 + k];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int m = tx + 16 * q;
            sv[q] = m < N ? dSn[m * PP1 + k] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q) v[r][q] = fmaf(xv[r], sv[q], v[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int jl = ty + 16 * r, j = j0 + jl;
          const float w =
              jl < nj ? expf((float)(total - cm[j])) * dd[j]
                      : 0.f;
          float dw = 0.f;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int m = tx + 16 * q;
            if (m >= N) continue;
            dw = fmaf(Bs[jl * NP1 + m], v[r][q], dw);
            dBa[r][q] = fmaf(w, v[r][q], dBa[r][q]);
          }
          dw = row16_sum(dw);
          if (tx == 0 && jl < nj) dws[hh * Q + j] = dw;
        }
      }
      // W = dy_i S_c^T: dC_i += exp(cum_i) W, dcum_i += exp(cum_i) C_i . W
      {
        float v[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) v[r][q] = 0.f;
        for (int k = 0; k < P; ++k) {
          float yv[4], sv[8];
#pragma unroll
          for (int r = 0; r < 4; ++r) yv[r] = Ys[(ty + 16 * r) * PP1 + k];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int m = tx + 16 * q;
            sv[q] = m < N ? Sc[m * PP1 + k] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q) v[r][q] = fmaf(yv[r], sv[q], v[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int il = ty + 16 * r, i = j0 + il;
          const float e = il < nj ? expf((float)cm[i]) : 0.f;
          float cw = 0.f;
          float* row = dCp + (j0 + il) * rstride;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int m = tx + 16 * q;
            if (m >= N) continue;
            cw = fmaf(Cs[il * NP1 + m], v[r][q], cw);
            if (il < nj) row[m] += e * v[r][q];
          }
          cw = row16_sum(cw);
          if (tx == 0 && il < nj) dcs[hh * Q + i] = e * cw;
        }
      }
      // x . dy, and at the first key tile <S_c, dS_{c+1}>
      const float sd = block_sum(part, red);
      float ss = 0.f;
      if (jt == 0) {
        for (int e = t; e < N * P; e += NT) {
          const int k = e / P, p = e % P;
          ss = fmaf(Sc[k * PP1 + p], dSn[k * PP1 + p], ss);
        }
        ss = block_sum(ss, red);
      }
      if (t == 0) {
        hdD[hh] += sd;
        if (jt == 0) hSS[hh] = ss;
      }
      __syncthreads();          // the staged states and tiles are read
    }
    // dB's partial for key tile jt
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jl = ty + 16 * r;
      if (jl >= nj) continue;
      float* row = dBp + (j0 + jl) * rstride;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int m = tx + 16 * q;
        if (m < N) row[m] = dBa[r][q];
      }
    }
  }
  __syncthreads();

  // one thread a head: dtotal, dcum's reverse cumsum, ddt, dA and dD
  if (t < nh) {
    const int hh = t, h = h0 + hh;
    const double* cm = cumv + hh * Q;
    const float* dd = dtv + hh * Q;
    const double total = cm[Q - 1];
    const double Ah = a.A[h];
    // in float64: dtotal's share of w_k dw_k cancels the rows' own in da
    double dtot = (double)expf((float)total) * hSS[hh];
    for (int k = 0; k < rows; ++k)
      dtot += (double)expf((float)(total - cm[k])) * dd[k] * dws[hh * Q + k];
    double da = 0.0, dA = 0.0;
    for (int k = rows - 1; k >= 0; --k) {
      const double dec = expf((float)(total - cm[k]));
      da += dcr[hh * Q + k] - (double)dd[k] * dcc[hh * Q + k] +
            dcs[hh * Q + k] - dec * dd[k] * dws[hh * Q + k] +
            (k == rows - 1 ? dtot : 0.0);
      a.ddt[(bi * a.L + l0 + k) * H + h] =
          (float)(dcc[hh * Q + k] + dec * dws[hh * Q + k] + Ah * da);
      dA += dd[k] * da;
    }
    a.dAp[(bi * n + c) * H + h] = (float)dA;
    a.dDp[(bi * n + c) * H + h] = hdD[hh];
  }
}

// -- pass 4: the fixed-order sums over head blocks and chunks ------------------

template <typename E>
__global__ void __launch_bounds__(NT2) ssd_bwd_reduce_kernel(Args a) {
  const int64_t idx = (int64_t)blockIdx.x * NT2 + threadIdx.x;
  const int64_t rows = a.b * a.L * a.N;
  if (idx < rows) {
    const int64_t k = idx % a.N, bl = idx / a.N;
    const float* pb = a.dBp + bl * a.nhb * a.N + k;
    const float* pc = a.dCp + bl * a.nhb * a.N + k;
    float sb = 0.f, sc = 0.f;
    for (int64_t q = 0; q < a.nhb; ++q) {
      sb += pb[q * a.N];
      sc += pc[q * a.N];
    }
    st(static_cast<E*>(a.dB) + idx, sb);
    st(static_cast<E*>(a.dC) + idx, sc);
  } else if (idx < rows + a.H) {
    const int64_t h = idx - rows;
    float sa = 0.f, sd = 0.f;
    for (int64_t q = 0; q < a.b * a.n; ++q) {
      sa += a.dAp[q * a.H + h];
      sd += a.dDp[q * a.H + h];
    }
    a.dA[h] = sa;
    a.dD[h] = sd;
  }
}

template <typename K>
cudaError_t with_smem(K kern, int64_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename E>
cudaError_t launch(int pass, const Args& a, cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  if (pass == 0) {
    const int64_t bytes = states_bytes(a.N, a.P, a.Q);
    if ((err = with_smem(ssd_bwd_states_kernel<E>, bytes)) != cudaSuccess)
      return err;
    ssd_bwd_states_kernel<E>
        <<<(unsigned)(a.b * a.n * a.H), NT, (size_t)bytes, st>>>(a);
  } else if (pass == 1) {
    const int64_t blocks = (a.b * a.H * a.N * a.P + NT2 - 1) / NT2;
    ssd_bwd_pass_kernel<<<(unsigned)blocks, NT2, 0, st>>>(a);
  } else if (pass == 2) {
    const int64_t bytes = chunk_bytes(a.N, a.P, a.Q);
    if ((err = with_smem(ssd_bwd_chunk_kernel<E>, bytes)) != cudaSuccess)
      return err;
    ssd_bwd_chunk_kernel<E>
        <<<(unsigned)(a.b * a.n * a.nhb), NT, (size_t)bytes, st>>>(a);
  } else {
    const int64_t blocks = (a.b * a.L * a.N + a.H + NT2 - 1) / NT2;
    ssd_bwd_reduce_kernel<E><<<(unsigned)blocks, NT2, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace fp32

namespace tc {

constexpr int TR = 64;            // rows of a tile: wgmma's M
constexpr int HB = 2;             // heads a chunk CTA, one warpgroup each
constexpr int NT1 = 128;          // pass 1: one warpgroup
constexpr int NT3 = 128 * HB;     // pass 3
constexpr int NT2 = 256;          // passes 2 and 4
constexpr int TILE = TR * 128;    // bytes of 64 rows x 64 bf16 (one swizzle block)
constexpr int NBLK = MAX_N / 64;  // swizzle blocks of a B or C row (N <= 128)
constexpr int CSP = TR + 1;       // pitch of the row sums of T (doubles)

__host__ __device__ inline int64_t npad_of(int64_t N) { return (N + 15) / 16 * 16; }
__host__ __device__ inline int64_t qpad_of(int64_t Q) { return (Q + TR - 1) / TR * TR; }
// columns of a state row pass 2 takes a thread: 4 where P % 4 == 0
__host__ __device__ inline int vec_of(int64_t P) { return P % 4 == 0 ? 4 : 1; }
// the row width of the partials of dB and dC: N rounded up to even, so that
// a thread's two columns are one 8-byte access
__host__ __device__ inline int64_t even_of(int64_t N) { return (N + 1) / 2 * 2; }
// pass 2's partial sums of <S_c, dS_{c+1}> a (batch, chunk, head): one a warp
__host__ __device__ inline int64_t ssp_count(int64_t N, int64_t P) {
  return npad_of(N) * (64 / vec_of(P)) / 32;
}

// bytes: two stages of a B or C tile and an x or dy tile, the cumsums in
// float64 and the row weights, plus 1 KB to align the swizzle atoms
__host__ inline int64_t states_smem(int64_t Q) {
  return 1024 + 2 * (NBLK + 1) * TILE + 12 * qpad_of(Q);
}
// bytes from the second stage to the dG tile, to the next 1 KB: the heads'
// states' tiles while the state terms are formed, else the stage and then
// the row sums of T a (head, warp, row group) and column in float64
constexpr uint32_t CHUNK_SX =
    ((HB * 2 * NBLK * TILE > (NBLK + HB) * TILE + HB * 32 * CSP * 8
          ? HB * 2 * NBLK * TILE
          : (NBLK + HB) * TILE + HB * 32 * CSP * 8) + 1023) / 1024 * 1024;
// bytes: B_jt and the heads' x_jt; two stages of C_it and the heads' dy_it,
// the second of which, with the bytes after it, holds the heads' S_c and
// dS_{c+1} while the state terms are formed; the dG tile; dx's and dB's
// accumulators, a fragment a thread; per head the cumsums and the row and
// column sums of T in float64, dt and two more rows in float32; the column
// decays, a few sums and each thread's x . dy; plus 1 KB to align the
// swizzle atoms
__host__ inline int64_t chunk_smem(int64_t Q) {
  const int64_t qp = qpad_of(Q);
  return 1024 + (NBLK + HB) * TILE + (NBLK + HB) * TILE + CHUNK_SX + TILE +
         2 * HB * 32 * 128 * 4 + HB * qp * (2 * 8 + 3 * 4) +
         HB * HB * qp * 8 + HB * TR * 4 + 64 + NT3 * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// byte offset of (row r, column c) in a [cols / 64][64 rows][64] bf16 tile
// in the 128-byte swizzle: 16-byte chunk k of row r sits at chunk k ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c / 64) * TILE + r * 128 + ((((c % 64) / 8) ^ (r % 8)) * 16) +
         (c % 8) * 2;
}
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);    // 128-byte swizzle
}
// K-major operand of 64 rows: k16 step ks of a [K / 64][64][64] tile
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  return make_desc(tile + (ks / 4) * TILE + (ks % 4) * 32, 16, 1024);
}
// MN-major operand of 64 columns: k16 step ks (rows 16ks..) of a
// [rows][64] tile
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int ks) {
  return make_desc(tile + ks * 16 * 128, TILE, 1024);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin a wgmma operand's registers in program order (see flash_attention.cu:
// ptxas serializes every wgmma of a kernel in which another instruction
// touches an in-flight operand).
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

// d (m64n64, f32) = a (smem) b (smem) + (scale_d ? d : 0); TA / TB: the
// operand is MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (m64n32, f32) = a (smem) b (smem) + (scale_d ? d : 0), as wgmma_ss
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (m64n64, f32) += a (registers, bf16) b (smem, MN-major, bf16)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
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

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// what threads wrote to shared memory becomes visible to wgmma's reads
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The thread's index, read anew where it is called: what is derived from it
// is then recomputed there rather than hoisted out of the loops and held in
// registers for the whole kernel (the tile loaders' addresses).
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// Rows r < 64 of `cols` bf16 values at src + r * rs into the swizzled
// [NB][64][64] tile at dst, by NT threads; rows >= nvalid and columns >=
// cols are 0 (the reference's zero padding, and a chunk's end inside a
// tile).  VEC: 16-byte cp.async with zero fill (rows and src 16-byte
// aligned), waited for by the caller; else scalar loads and shared stores.
template <bool VEC, int NB, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t rs, int nvalid, int cols) {
  const int tid = fresh_tid();
  constexpr int CH = NB * 8;   // 16-byte chunks per row
  static_assert(TR * CH % NT == 0, "whole chunks per thread");
  auto chunk = [&](int u) {
    const int e = tid + u * NT;
    const int r = e / CH, k = e % CH, c0 = k * 8;
    const uint32_t d =
        dst + (k / 8) * TILE + r * 128 + (((k % 8) ^ (r % 8)) * 16);
    const int left = cols - c0;
    const int valid = r < nvalid ? (left < 0 ? 0 : left > 8 ? 8 : left) : 0;
    const __nv_bfloat16* p = src + (valid ? r * rs + c0 : 0);
    if constexpr (VEC) {
      cp16(d, p, 2 * valid);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint16_t lo = 2 * i < valid
            ? *reinterpret_cast<const uint16_t*>(p + 2 * i) : 0;
        const uint16_t hi = 2 * i + 1 < valid
            ? *reinterpret_cast<const uint16_t*>(p + 2 * i + 1) : 0;
        w[i] = (uint32_t)lo | ((uint32_t)hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(d), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  };
  // a chunk at a time: no address or load is held across chunks
#pragma unroll 1
  for (int u = 0; u < TR * CH / NT; ++u) chunk(u);
}

__device__ __forceinline__ const __nv_bfloat16* bf(const void* p) {
  return static_cast<const __nv_bfloat16*>(p);
}

// Pass 1, the chunk states and their gradients' chunk shares.  One CTA (one
// warpgroup) per (batch, chunk, head, which): which 0 takes s_c = B^T (w x)
// (chunks 0..n-2) and writes the chunk's cumsums, which 1 ds_c = C^T (e dy)
// (chunks 1..n-1).  dt arrives by cp.async with the first tile; the first
// warp scans dt * A over the chunk in float64 and forms the row weights w_j
// = exp(total - cum_j) dt_j or e_j = exp(cum_j).  Over the chunk's 64-row
// tiles (two stages) the x or dy tile is scaled by its weights in place
// (rounded to bf16 once) and the state takes += B^T (w x) or C^T (e dy):
// wgmma with B^T / C^T MN-major in two m64 halves over N and the scaled
// tile MN-major.  The (N, P) state leaves in float32 through shared memory
// in 16-byte stores where P % 32 == 0.
template <bool VEC>
__global__ void __launch_bounds__(NT1, 2) ssd_bwd_tc_states_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int H = (int)a.H, N = (int)a.N, P = (int)a.P, Q = (int)a.Q;
  const int n = (int)a.n, qp = (int)qpad_of(Q);
  constexpr uint32_t tileN = NBLK * TILE, stage = tileN + TILE;
  double* cumS = reinterpret_cast<double*>(gbase + 2 * stage);   // (qp,)
  float* fS = reinterpret_cast<float*>(cumS + qp);               // (qp,)

  int64_t blk = blockIdx.x;
  const int which = (int)(blk % 2);
  blk /= 2;
  const int h = (int)(blk % H);
  const int c = (int)((blk / H) % n);
  const int64_t bi = blk / H / n;
  const int64_t l0 = (int64_t)c * Q;
  const int rows = (int)(a.L - l0 < Q ? a.L - l0 : Q);
  const bool want = which == 0 ? c < n - 1 : c > 0;
  if (which == 1 && !want) return;   // chunk 0 has no state gradient share
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ntiles = (rows + TR - 1) / TR;
  const __nv_bfloat16* M = bf(which == 0 ? a.B : a.C);
  const int64_t M_sb = which == 0 ? a.B_sb : a.C_sb;
  const int64_t M_sl = which == 0 ? a.B_sl : a.C_sl;
  const __nv_bfloat16* V = which == 0
      ? bf(a.x) + bi * a.x_sb + l0 * a.x_sl + h * a.x_sh
      : bf(a.dy) + bi * a.g_sb + l0 * a.g_sl + h * a.g_sh;
  const int64_t V_sl = which == 0 ? a.x_sl : a.g_sl;

  auto issue = [&](int rt, int st) {
    const uint32_t sb = base + st * stage;
    const int64_t r0 = rt * TR;
    const int nv = rows - rt * TR;
    load_tile<VEC, NBLK, NT1>(sb, M + bi * M_sb + (l0 + r0) * M_sl, M_sl, nv,
                              N);
    load_tile<VEC, 1, NT1>(sb + tileN, V + r0 * V_sl, V_sl, nv, P);
    cp_commit();
  };

  for (int e = tid; e < qp; e += NT1) {          // dt, 0 past the rows
    const bool ok = e < rows;
    cp4(smem_addr(fS + e),
        ok ? a.dt + bi * a.d_sb + (l0 + e) * a.d_sl + h * a.d_sh : a.dt,
        ok ? 4 : 0);
  }
  cp_commit();
  if (want) {
    issue(0, 0);
    cp_wait<1>();
  } else {
    cp_wait<0>();
  }
  __syncthreads();

  if (warp == 0) {   // the scan of dt * A in float64, then the row weights
    const double Ah = a.A[h];
    double carry = 0.0;
    for (int r0 = 0; r0 < qp; r0 += 32) {
      double v = (double)fS[r0 + lane] * Ah;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      cumS[r0 + lane] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    __syncwarp();
    const double total = cumS[Q - 1];
    if (which == 0) {
      double* cg = a.cum + ((bi * n + c) * H + h) * (int64_t)Q;
      for (int k = lane; k < Q; k += 32) cg[k] = cumS[k];
    }
    for (int k = lane; k < qp; k += 32)
      fS[k] = k >= rows ? 0.f
              : which == 0 ? expf((float)(total - cumS[k])) * fS[k]
                           : expf((float)cumS[k]);
  }
  if (!want) return;
  __syncthreads();

  float acc[NBLK][32];
#pragma unroll
  for (int m = 0; m < NBLK; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;

  for (int rt = 0; rt < ntiles; ++rt) {
    const int st = rt & 1;
    if (rt + 1 < ntiles) {
      issue(rt + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_async();
    __syncthreads();              // tile rt is in, for every thread
    const uint32_t sb = base + st * stage, vs = sb + tileN;
    unsigned char* vg = gbase + (vs - base);
    const float* f = fS + rt * TR;
#pragma unroll
    for (int u = 0; u < TR * 8 / NT1; ++u) {   // v_j *= f_j, in place
      const int e = tid + u * NT1, j = e / 8;
      uint4* q = reinterpret_cast<uint4*>(vg + j * 128 + (e % 8) * 16);
      uint4 v = *q;
      uint32_t* p32 = reinterpret_cast<uint32_t*>(&v);
      const float fj = f[j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p32[i] = pack_bf16(__uint_as_float(p32[i] << 16) * fj,
                           __uint_as_float(p32[i] & 0xffff0000u) * fj);
      *q = v;
    }
    fence_async();
    __syncthreads();
#pragma unroll
    for (int m = 0; m < NBLK; ++m) fence_regs(acc[m]);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < NBLK; ++m)
      if (m * 64 < N)
#pragma unroll
        for (int ks = 0; ks < TR / 16; ++ks)
          wgmma_ss<1, 1>(acc[m], desc_mn(sb + m * TILE, ks), desc_mn(vs, ks),
                         1);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int m = 0; m < NBLK; ++m) fence_regs(acc[m]);
    __syncthreads();              // stage st is free for tile rt + 2
  }

  const int g = lane / 4, t = lane % 4;
  float* s = (which == 0 ? a.s : a.ds) +
             ((bi * n + c) * H + h) * (int64_t)N * P;
  if (P % 32 == 0) {
    // through shared memory (the stages are free): the (N, P) tile with
    // its 16-byte column chunks XOR-swizzled by row, then out in coalesced
    // 16-byte stores
    float* sm = reinterpret_cast<float*>(gbase);
    const int cpr = P / 4;           // 16-byte chunks per row
#pragma unroll
    for (int m = 0; m < NBLK; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const int nn = m * 64 + warp * 16 + g + 8 * (q / 2);
          const int p = 8 * j + 2 * t;
          if (p < P)
            *reinterpret_cast<float2*>(
                sm + nn * P + (((p / 4) ^ (nn % 8)) * 4) + p % 4) =
                make_float2(acc[m][j * 4 + q], acc[m][j * 4 + q + 1]);
        }
    __syncthreads();
    for (int e = tid; e < N * cpr; e += NT1) {
      const int nn = e / cpr, k = e % cpr;
      *reinterpret_cast<float4*>(s + nn * P + k * 4) =
          *reinterpret_cast<const float4*>(sm + nn * P + ((k ^ (nn % 8)) * 4));
    }
    return;
  }
#pragma unroll
  for (int m = 0; m < NBLK; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int nn = m * 64 + warp * 16 + g + 8 * (q / 2);
        const int p = 8 * j + 2 * t + (q % 2);
        if (nn < N && p < P) s[nn * P + p] = acc[m][j * 4 + q];
      }
}

// Pass 2, state passing.  One thread per (batch, head, state row n < Npad,
// V columns), V = 4 where P % 4 == 0: forward S_0 = 0, S_{c+1} =
// exp(total_c) S_c + s_c, S_c written in float32 where s_c was and rounded
// to bf16 into pass 3's swizzled (Npad, 64) tile Sb; in reverse dS_n = 0,
// dS_c = exp(total_c) dS_{c+1} + ds_c, dS_{c+1} rounded to bf16 into dSb,
// and <S_c, dS_{c+1}> summed over the warp's elements into one partial a
// warp (rows n >= N and columns p >= P are 0).  The loads of 8 chunks are
// issued before their chain of multiply-adds.
template <int V>
__global__ void __launch_bounds__(NT2) ssd_bwd_tc_pass_kernel(Args a) {
  const int64_t N = a.N, P = a.P, Q = a.Q, n = a.n, npad = npad_of(N);
  constexpr int G = 64 / V;          // column groups per state row
  const int64_t e = (int64_t)blockIdx.x * NT2 + threadIdx.x;
  if (e >= a.b * a.H * npad * G) return;    // whole warps: npad * G % 32 == 0
  const int p = (int)(e % G) * V, r = (int)((e / G) % npad);
  const int64_t h = (e / (G * npad)) % a.H, bi = e / (G * npad * a.H);
  const bool ok = r < N && p < P;
  const int at = r * 64 + (((p / 8) ^ (r % 8)) * 8) + p % 8;
  const int64_t bh = bi * n * a.H + h;       // (bi, c = 0, h)
  const double* __restrict__ cum = a.cum + bh * Q + Q - 1;
  float* __restrict__ s = a.s + bh * N * P + (ok ? r * P + p : 0);
  const float* __restrict__ ds = a.ds + bh * N * P + (ok ? r * P + p : 0);
  __nv_bfloat16* Sb = static_cast<__nv_bfloat16*>(a.Sb) + bh * npad * 64 + at;
  __nv_bfloat16* dSb =
      static_cast<__nv_bfloat16*>(a.dSb) + bh * npad * 64 + at;
  const int64_t cs = a.H * Q, ss = a.H * N * P, bs = a.H * npad * 64;
  const int64_t cnt = npad * G / 32;
  float* ssp = a.ssp + bh * cnt + (e % (npad * G)) / 32;
  const int64_t ps = a.H * cnt;
  float S[V];
#pragma unroll
  for (int v = 0; v < V; ++v) S[v] = 0.f;
  auto put = [&](__nv_bfloat16* dst, const float (&v)[V]) {
    if constexpr (V == 4) {
      uint2 o;
      o.x = ok ? pack_bf16(v[0], v[1]) : 0u;
      o.y = ok ? pack_bf16(v[2], v[3]) : 0u;
      *reinterpret_cast<uint2*>(dst) = o;
    } else {
      *dst = __float2bfloat16_rn(ok ? v[0] : 0.f);
    }
  };
  auto get = [&](const float* src, float (&v)[V], bool in) {
    if constexpr (V == 4) {
      const float4 f = in && ok ? *reinterpret_cast<const float4*>(src)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
      v[0] = in && ok ? *src : 0.f;
    }
  };
  for (int64_t k0 = 0; k0 < n; k0 += 8) {
    float tot[8], sv[8][V];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t k = k0 + u;
      tot[u] = k + 1 < n ? (float)cum[k * cs] : 0.f;
      get(s + k * ss, sv[u], k + 1 < n);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t k = k0 + u;
      if (k >= n) break;
      put(Sb + k * bs, S);
      if (ok) {
        if constexpr (V == 4)
          *reinterpret_cast<float4*>(s + k * ss) =
              make_float4(S[0], S[1], S[2], S[3]);
        else
          s[k * ss] = S[0];
      }
      const float dec = expf(tot[u]);
#pragma unroll
      for (int v = 0; v < V; ++v) S[v] = fmaf(dec, S[v], sv[u][v]);
    }
  }
  float dS[V];
#pragma unroll
  for (int v = 0; v < V; ++v) dS[v] = 0.f;
  for (int64_t k0 = n - 1; k0 >= 0; k0 -= 8) {
    float tot[8], dv[8][V], Sv[8][V];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t k = k0 - u;
      tot[u] = k >= 1 ? (float)cum[k * cs] : 0.f;
      get(ds + (k >= 1 ? k : 0) * ss, dv[u], k >= 1);
      get(s + (k >= 0 ? k : 0) * ss, Sv[u], k >= 0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t k = k0 - u;
      if (k < 0) break;
      put(dSb + k * bs, dS);
      float part = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) part = fmaf(Sv[u][v], dS[v], part);
      part = warp_sum(part);
      if (threadIdx.x % 32 == 0) ssp[k * ps] = part;
      const float dec = expf(tot[u]);
#pragma unroll
      for (int v = 0; v < V; ++v) dS[v] = fmaf(dec, dS[v], dv[u][v]);
    }
  }
}

// Pass 3, every gradient of a chunk.  One CTA per (batch, chunk, 2 heads),
// two warpgroups.  Per key tile jt (B_jt and the heads' x_jt; C_jt and
// dy_jt as query tile jt in the first stage; the heads' S_c and dS_{c+1},
// bf16 from pass 2, over the second stage and the bytes after it):
//   state terms, warpgroup w on head w (j the tile's rows):
//     U = B_jt dS_w: dx_j = w_j U_j + D dy_j, dw_j = x_j . U_j
//     Z = C_jt S_w: dcs_j = e_j dy_j . Z_j      (wgmma, states MN-major)
//     dB_j = sum_h w_jh x_jh dS_h^T, dC_j = sum_h e_jh dy_jh S_h^T over
//            the warpgroup's 64 columns of N, written to the partials
//                                                (wgmma, states K-major)
//   per query tile it >= jt (two cp.async stages), warpgroup w on the
//   tile's query columns 32w..32w+31 for both heads (m64n32):
//     G^T = B_jt C_it^T once, D^T = x_jt dy_it^T a head (wgmma, K-major)
//     L^T, M^T = G^T L^T dt_j (bf16, wgmma's A fragment), the row sums of
//     R D^T = G^T L^T D^T (quads) and of T (a float64 row a (warp, row
//     group) in shared memory) in float64; dG^T = the heads' dt_j L^T D^T
//     in order
//     dx_jt[h] += M^T dy_it over the warpgroup's query rows (wgmma, M from
//            registers; both heads' shares in shared memory)
//     dG^T rounded to bf16 once into a shared tile, then over the
//     warpgroup's 64 columns of N dB_jt += dG^T C_it and dC_it += dG B_jt,
//     added to this CTA's rows of the partials  (wgmma, dG K- / MN-major)
// then dx_jt = the two warpgroups' shares in order, in bf16; last, one
// warp a head takes the reverse cumsum of dcum into ddt and the chunk's
// dA and dD, in float64.
template <bool VEC>
__global__ void __launch_bounds__(NT3, 1) ssd_bwd_tc_chunk_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int H = (int)a.H, N = (int)a.N, P = (int)a.P, Q = (int)a.Q;
  const int n = (int)a.n, nhb = (int)a.nhb, qp = (int)qpad_of(Q);
  const int64_t idx = blockIdx.x;
  const int hb = (int)(idx % nhb);
  const int c = (int)((idx / nhb) % n);
  const int64_t bi = idx / nhb / n;
  const int64_t l0 = (int64_t)c * Q;
  const int rows = (int)(a.L - l0 < Q ? a.L - l0 : Q);
  const int nt = (rows + TR - 1) / TR;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int lane = tid % 32, warp = wt / 32, g = lane / 4, t = lane % 4;
  const int wrow = warp * 16 + g;
  const int h = hb * HB + wg;                // the head whose state terms,
  const bool hv = h < H;                     // dx and dcum this warpgroup ends
  const int nh = H - hb * HB < HB ? H - hb * HB : HB;   // heads of the block
  const bool half = wg * 64 < N;             // its columns of dB, dC hold n < N
  const int nkN = (N + 15) / 16, nkP = (P + 15) / 16;
  const int npad = (int)npad_of(N);
  const int cq = wg * 32;                    // its query columns in a tile

  constexpr uint32_t tileN = NBLK * TILE, stage = tileN + HB * TILE;
  const uint32_t Bs = base, Xs = Bs + tileN;             // x_jt: + hh * TILE
  const uint32_t st0 = Xs + HB * TILE;                   // C_it, dy_it
  const uint32_t Ss = st0 + stage;                       // S_c, dS_{c+1}
  const uint32_t dGs = Ss + CHUNK_SX;
  // per head, the row sums of T a (warp, row group) and column, over the
  // states' second half
  double* csum = reinterpret_cast<double*>(gbase + (st0 + 2 * stage - base));
  // the warpgroup's shares of dx_jt, its own head's and the other head's,
  // a fragment a thread: [wg][32][128] each
  float* dxa = reinterpret_cast<float*>(gbase + (dGs + TILE - base));
  float* dxs = dxa + HB * 32 * 128;
  double* cumv = reinterpret_cast<double*>(dxs + HB * 32 * 128);
  double* dcr = cumv + HB * qp;            // row sums of T, per head
  double* dcc = dcr + HB * qp;             // column sums of R (x . dy), per
                                             // (warpgroup, head)
  float* dtv = reinterpret_cast<float*>(dcc + HB * HB * qp);
  float* dcs = dtv + HB * qp;              // e_i C_i . S_c dy_i
  float* dws = dcs + HB * qp;              // dw_j = B_j . dS_{c+1} x_j
  float* uS = dws + HB * qp;               // (HB, 64) column decays
  float* red = uS + HB * TR;                 // (HB, 4) warp sums
  float* hss = red + HB * 4;                 // (HB,) <S_c, dS_{c+1}>
  float* dDs = hss + HB;                     // (NT3,) each thread's x . dy
  const int hq = wg * qp;
  float* dxo = dxa + wg * 32 * 128 + wt;     // this thread's fragment of
  float* dxw = dxs + wg * 32 * 128 + wt;     // dx of its head and the other

  for (int e = tid; e < HB * qp; e += NT3) {   // the heads' cumsums, dt
    const int hh = e / qp, k = e % qp;
    const int hx = hb * HB + hh < H ? hb * HB + hh : H - 1;
    cumv[e] = k < Q ? a.cum[((bi * n + c) * H + hx) * (int64_t)Q + k] : 0.0;
    dtv[e] = hb * HB + hh < H && k < rows
                 ? a.dt[bi * a.d_sb + (l0 + k) * a.d_sl + hx * a.d_sh]
                 : 0.f;
    dcr[e] = 0.0;
    dcs[e] = dws[e] = 0.f;
  }
  for (int e = tid; e < HB * HB * qp; e += NT3) dcc[e] = 0.0;
  auto issue_states = [&]() {      // the heads' S_c and dS_{c+1} tiles
#pragma unroll 1
    for (int e = fresh_tid(); e < HB * 2 * NBLK * 512; e += NT3) {
      const int hh = e / (2 * NBLK * 512), rem = e % (2 * NBLK * 512);
      const int which = rem / (NBLK * 512), q = rem % (NBLK * 512);
      const int hx = hb * HB + hh;
      const bool ok = hx < H && q / 8 < npad;
      const __nv_bfloat16* src =
          static_cast<const __nv_bfloat16*>(which ? a.dSb : a.Sb) +
          ((bi * n + c) * H + (ok ? hx : 0)) * (int64_t)npad * 64 +
          (ok ? q * 8 : 0);
      cp16(Ss + hh * 2 * tileN + which * tileN + q * 16, src, ok ? 16 : 0);
    }
  };
  auto issue_keys = [&](int jt) {
    const int64_t r0 = l0 + jt * TR;
    const int nv = rows - jt * TR;
    load_tile<VEC, NBLK, NT3>(Bs, bf(a.B) + bi * a.B_sb + r0 * a.B_sl,
                              a.B_sl, nv, N);
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      const int hx = hb * HB + hh;
      load_tile<VEC, 1, NT3>(Xs + hh * TILE,
                             bf(a.x) + bi * a.x_sb + r0 * a.x_sl +
                                 (hx < H ? hx : H - 1) * a.x_sh,
                             a.x_sl, hx < H ? nv : 0, P);
    }
  };
  auto issue_query = [&](int it, int st) {
    const uint32_t sb = st0 + st * stage;
    const int64_t r0 = l0 + it * TR;
    const int nv = rows - it * TR;
    load_tile<VEC, NBLK, NT3>(sb, bf(a.C) + bi * a.C_sb + r0 * a.C_sl,
                              a.C_sl, nv, N);
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      const int hx = hb * HB + hh;
      load_tile<VEC, 1, NT3>(sb + tileN + hh * TILE,
                             bf(a.dy) + bi * a.g_sb + r0 * a.g_sl +
                                 (hx < H ? hx : H - 1) * a.g_sh,
                             a.g_sl, hx < H ? nv : 0, P);
    }
  };
  if (wt < 32) {     // <S_c, dS_{c+1}> of the head: pass 2's warp partials
    const int64_t cnt = ssp_count(N, P);
    const float* sp = a.ssp + ((bi * n + c) * H + (hv ? h : 0)) * cnt;
    float v = 0.f;
    for (int64_t k = lane; k < cnt; k += 32) v += sp[k];
    v = warp_sum(v);
    if (lane == 0) hss[wg] = hv ? v : 0.f;
  }

  // this head block's rows of the partials of dB and dC (rows of N rounded
  // up to even): a fragment's element (row r0 + wrow + 8r, column wg * 64 +
  // 8 j8 + 2t + e) is its register j8 * 4 + 2r + e; rows >= rows and
  // columns >= N are skipped.  With add: the partial += v (every load
  // issued before the first store), else the partial = v
  const int Ne = (int)even_of(N);
  float* dCp = a.dCp + ((bi * a.L + l0) * nhb + hb) * (int64_t)Ne;
  float* dBp = a.dBp + ((bi * a.L + l0) * nhb + hb) * (int64_t)Ne;
  const int64_t rstride = (int64_t)nhb * Ne;
  auto frag_store = [&](float* p0, int r0, const float (&v)[32], bool add) {
    const int ft = fresh_tid(), fw = ft / 128, fl = ft % 32;
    const int frow = (ft % 128) / 32 * 16 + fl / 4, f2t = 2 * (fl % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + frow + 8 * r;
      if (i >= rows) continue;
      float2* row = reinterpret_cast<float2*>(p0 + (int64_t)i * rstride +
                                              fw * 64 + f2t);
      float2 o[8];
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        o[j8] = add && fw * 64 + 8 * j8 + f2t < N ? row[4 * j8]
                                                  : make_float2(0.f, 0.f);
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const int k = j8 * 4 + 2 * r;
        if (fw * 64 + 8 * j8 + f2t < N)
          row[4 * j8] = make_float2(o[j8].x + v[k], o[j8].y + v[k + 1]);
      }
    }
  };
  auto frag_get = [&](const float* p, float (&v)[32]) {
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = p[k * 128];
  };
  auto frag_put = [&](float* p, const float (&v)[32]) {
#pragma unroll
    for (int k = 0; k < 32; ++k) p[k * 128] = v[k];
  };

  issue_keys(0);
  issue_query(0, 0);
  issue_states();
  cp_commit();
  dDs[tid] = 0.f;                    // this thread's share of x . dy
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * TR;
    if (jt > 0) {
      issue_keys(jt);
      issue_query(jt, 0);
      issue_states();
      cp_commit();
    }
    cp_wait<0>();
    fence_async();
    __syncthreads();       // key tile jt, query tile jt and the states are in

    // dx_jt of the two heads: this warpgroup's share (its query columns),
    // its own head's (dxo) also the state term and D dy
    {
      float z[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) z[k] = 0.f;
      frag_put(dxw, z);
    }

    // -- state terms -----------------------------------------------------------
    {
      const uint32_t Ys0 = st0 + tileN;
      const unsigned char* xg = gbase + (Xs + wg * TILE - base);
      const unsigned char* yg = gbase + (Ys0 + wg * TILE - base);
      float acc[32];
      // U = B_jt dS_h: dx_j = w_j U + D dy_j, dw_j = x_j . U_j
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * NBLK; ++ks)
        if (ks < nkN)
          wgmma_ss<0, 1>(acc, desc_k(Bs, ks),
                         desc_mn(Ss + wg * 2 * tileN + tileN, ks), ks);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      {
        const double total = cumv[hq + Q - 1];
        const float Dh = hv ? a.D[h] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int jl = wrow + 8 * r, j = j0 + jl;
          const bool in = j < rows;
          const float wj = in ? expf((float)(total - cumv[hq + j])) *
                                    dtv[hq + j]
                              : 0.f;
          float dw = 0.f, xy = 0.f;
#pragma unroll
          for (int j8 = 0; j8 < 8; ++j8) {
            const int p = 8 * j8 + 2 * t, k = j8 * 4 + 2 * r;
            const __nv_bfloat162 xv =
                *reinterpret_cast<const __nv_bfloat162*>(xg + swz(jl, p));
            const __nv_bfloat162 yv =
                *reinterpret_cast<const __nv_bfloat162*>(yg + swz(jl, p));
            const float x0 = __low2float(xv), x1 = __high2float(xv);
            const float y0 = __low2float(yv), y1 = __high2float(yv);
            dw = fmaf(x1, acc[k + 1], fmaf(x0, acc[k], dw));
            xy = fmaf(x1, y1, fmaf(x0, y0, xy));
            dxo[k * 128] = fmaf(wj, acc[k], Dh * y0);
            dxo[(k + 1) * 128] = fmaf(wj, acc[k + 1], Dh * y1);
          }
          dw = quad_sum(dw);
          if (t == 0 && in) dws[hq + j] = dw;
          dDs[tid] += xy;
        }
      }
      // Z = C_jt S_h: dcs_j = e_j dy_j . Z_j
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * NBLK; ++ks)
        if (ks < nkN)
          wgmma_ss<0, 1>(acc, desc_k(st0, ks),
                         desc_mn(Ss + wg * 2 * tileN, ks), ks);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int jl = wrow + 8 * r, j = j0 + jl;
        float cz = 0.f;
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8) {
          const int p = 8 * j8 + 2 * t, k = j8 * 4 + 2 * r;
          const __nv_bfloat162 yv =
              *reinterpret_cast<const __nv_bfloat162*>(yg + swz(jl, p));
          cz = fmaf(__high2float(yv), acc[k + 1],
                    fmaf(__low2float(yv), acc[k], cz));
        }
        cz = quad_sum(cz);
        if (t == 0 && j < rows) dcs[hq + j] = expf((float)cumv[hq + j]) * cz;
      }
      if (half) {
        // dB_jt = sum_h w_jh x_jh dS_h^T and dC_jt += sum_h e_jh dy_jh
        // S_h^T into the partials, over the warpgroup's columns of N
#pragma unroll 1
        for (int part = 0; part < 2; ++part) {
#pragma unroll 1
          for (int hh = 0; hh < nh; ++hh) {
            const uint32_t A = part == 0 ? Xs + hh * TILE : Ys0 + hh * TILE;
            const uint32_t St = Ss + hh * 2 * tileN +
                                (part == 0 ? tileN : 0) + wg * TILE;
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              if (ks < nkP)
                wgmma_ss<0, 0>(acc, desc_k(A, ks), desc_k(St, ks), ks);
            wgmma_commit();
            wgmma_wait0();
            fence_regs(acc);
            const double* ch = cumv + hh * qp;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int j = j0 + wrow + 8 * r;
              const float f = j >= rows ? 0.f
                              : part == 0
                                  ? expf((float)(ch[Q - 1] - ch[j])) *
                                        dtv[hh * qp + j]
                                  : expf((float)ch[j]);
#pragma unroll
              for (int j8 = 0; j8 < 8; ++j8) {
                const int k = j8 * 4 + 2 * r;
                acc[k] *= f;
                acc[k + 1] *= f;
              }
            }
            if (part == 1) frag_store(dCp, j0, acc, jt > 0 || hh > 0);
            else frag_store(dBp, j0, acc, hh > 0);
          }
        }
      }
    }
    __syncthreads();                 // the states' bytes are free
    if (jt + 1 < nt) {
      issue_query(jt + 1, 1);
      cp_commit();
    }

    // -- query tiles it >= jt --------------------------------------------------
    for (int it = jt; it < nt; ++it) {
      const int st = (it - jt) & 1;
      if (it > jt) {
        if (it + 1 < nt) {
          issue_query(it + 1, st ^ 1);
          cp_commit();
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        fence_async();
        __syncthreads();             // query tile it is in
      }
      const int i0 = it * TR;
      const uint32_t sb = st0 + st * stage;
      // G^T = B_jt C_it^T on this warpgroup's 32 query columns
      float G[16];
      fence_regs(G);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * NBLK; ++ks)
        if (ks < nkN)
          wgmma_ss32<0, 0>(G, desc_k(Bs, ks), desc_k(sb + cq * 128, ks), ks);
      wgmma_commit();
      // the decays: below the diagonal every key j is under every row i, so
      // with jl the key tile's last row L_ij = exp(cum_i - cum_jl) exp(cum_jl
      // - cum_j), both exponents <= 0: u_i once a column (while the products
      // are in flight), v_j once a row.  On the diagonal one exp an entry,
      // of u_i - v_j with u_i = cum_i - cum_j0 and v_j = cum_j - cum_j0 in
      // float32 (differences inside one tile)
      const bool below = it > jt;
      if (wt < 32 * HB) {            // column cq + wt % 32 of head wt / 32
        const int hh = wt / 32, il = cq + wt % 32, i = i0 + il;
        const double* ch = cumv + hh * qp;
        uS[hh * TR + il] =
            below ? (i < rows ? expf((float)(ch[i] - ch[j0 + TR - 1])) : 0.f)
                  : (float)(ch[i] - ch[j0]);
      }
      named_sync(1 + wg, 128);
      wgmma_wait0();
      fence_regs(G);
      // per head: D^T = x_jt dy_it^T on the same columns, M^T (bf16, wgmma's
      // A fragment) for dx, the row sums of R D^T (rs), per column T over
      // the thread's two rows (csum), and dG^T summed over the heads in order
      float dG[16];
      uint32_t pa[2][4];
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        if (hh >= nh) break;
        const uint32_t Ys = sb + tileN + hh * TILE;
        float Dt[16];
        fence_regs(Dt);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (ks < nkP)
            wgmma_ss32<0, 0>(Dt, desc_k(Xs + hh * TILE, ks),
                             desc_k(Ys + cq * 128, ks), ks);
        wgmma_commit();
        const double* ch = cumv + hh * qp;
        const float* dh = dtv + hh * qp;
        float vj[2], dj[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = j0 + wrow + 8 * r;
          dj[r] = dh[j];
          vj[r] = below ? expf((float)(ch[j0 + TR - 1] - ch[j]))
                        : (float)(ch[j] - ch[j0]);
        }
        wgmma_wait0();
        fence_regs(Dt);
        double rs[2] = {0.0, 0.0};
        double* cw = csum + ((hh * 4 + warp) * 8 + g) * CSP;
        auto elementwise = [&](auto below_tile) {   // one body per decay form
          constexpr bool BELOW = decltype(below_tile)::value;
#pragma unroll
          for (int j4 = 0; j4 < 4; ++j4) {
            float m[2][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int il = cq + 8 * j4 + 2 * t + e, i = i0 + il;
              const float u = uS[hh * TR + il];
              double col = 0.0;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int j = j0 + wrow + 8 * r, k = j4 * 4 + 2 * r + e;
                float Lv;
                if constexpr (BELOW) Lv = u * vj[r];
                else Lv = j <= i && i < rows ? expf(u - vj[r]) : 0.f;
                const float Rv = G[k] * Lv;
                const float rd = Rv * Dt[k];
                const float sh = Lv * dj[r] * Dt[k];
                m[r][e] = Rv * dj[r];
                rs[r] += rd;
                col += (double)rd * dj[r];
                dG[k] = hh == 0 ? sh : dG[k] + sh;
              }
              cw[il] = col;
            }
            pa[j4 / 2][(j4 % 2) * 2] = pack_bf16(m[0][0], m[0][1]);
            pa[j4 / 2][(j4 % 2) * 2 + 1] = pack_bf16(m[1][0], m[1][1]);
          }
        };
        if (below) elementwise(std::true_type{});
        else elementwise(std::false_type{});
        // dx_jt[hh] += M^T dy_it over this warpgroup's query rows
        auto dx_update = [&](float (&d)[32]) {
          fence_regs(d);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) fence_regs(pa[kk]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            wgmma_rs(d, pa[kk], desc_mn(Ys, wg * 2 + kk));
          wgmma_commit();
        };
        float* dxp = hh == wg ? dxo : dxw;
        float dxt[32];
        frag_get(dxp, dxt);
        dx_update(dxt);
        // column sums of R (x . dy), key j: over the quad, this warpgroup's
        // share of the columns
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          double v = rs[r];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          const int j = j0 + wrow + 8 * r;
          if (t == 0 && j < rows) dcc[(wg * HB + hh) * qp + j] += v;
        }
        wgmma_wait0();
        fence_regs(dxt);
        frag_put(dxp, dxt);
      }
      // dG^T on this warpgroup's columns, rounded to bf16 once
      {
        unsigned char* dgt = gbase + (dGs - base);
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int k = j4 * 4 + 2 * r;
            *reinterpret_cast<uint32_t*>(
                dgt + swz(wrow + 8 * r, cq + 8 * j4 + 2 * t)) =
                pack_bf16(dG[k], dG[k + 1]);
          }
        fence_async();
      }
      __syncthreads();               // dG^T and the partials of T are in
      if (tid < TR * HB) {           // row sums of T, query i: (warp, g) order
        const int hh = tid / TR, il = tid % TR, i = i0 + il;
        const double* cr = csum + hh * 32 * CSP + il;
        double v = 0.0;
#pragma unroll 8
        for (int q = 0; q < 32; ++q) v += cr[q * CSP];
        if (i < rows && hh < nh) dcr[hh * qp + i] += v;
      }
      if (half) {
        // dB_jt += dG^T C_it and dC_it += dG B_jt into this CTA's rows of
        // the partials (dC's first pair writes its rows)
        float pB[32];
        fence_regs(pB);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss<0, 1>(pB, desc_k(dGs, ks), desc_mn(sb + wg * TILE, ks),
                         ks);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(pB);
        frag_store(dBp, j0, pB, true);
        fence_regs(pB);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss<1, 1>(pB, desc_mn(dGs, ks), desc_mn(Bs + wg * TILE, ks),
                         ks);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(pB);
        frag_store(dCp, i0, pB, jt > 0 || it == jt);
      }
      __syncthreads();               // stage st, the dG tile, csum are free
    }

    // dx_jt: the warpgroups' shares summed in order (warpgroup 0's first),
    // in bf16 (the other warpgroup's share of this head is its dxw)
    {
      float v[32];
      const float* oth = dxs + (1 - wg) * 32 * 128 + wt;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float o = oth[k * 128], m = dxo[k * 128];
        v[k] = wg == 0 ? m + o : o + m;
      }
      if (hv) {
        __nv_bfloat16* dxh = static_cast<__nv_bfloat16*>(a.dx) +
                             ((bi * a.L + l0) * H + h) * (int64_t)P;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = j0 + wrow + 8 * r;
          if (j >= rows) continue;
          __nv_bfloat16* row = dxh + (int64_t)j * H * P;
#pragma unroll
          for (int j8 = 0; j8 < 8; ++j8) {
            const int p = 8 * j8 + 2 * t, k = j8 * 4 + 2 * r;
            if (p >= P) break;
            if (P % 2 == 0) {
              *reinterpret_cast<__nv_bfloat162*>(row + p) =
                  __floats2bfloat162_rn(v[k], v[k + 1]);
            } else {
              row[p] = __float2bfloat16_rn(v[k]);
              if (p + 1 < P) row[p + 1] = __float2bfloat16_rn(v[k + 1]);
            }
          }
        }
      }
      __syncthreads();               // the shares of dx are read
    }
  }

  // one warp a head: dtotal, dcum's reverse cumsum, ddt, dA and dD
  const float dDp = warp_sum(dDs[tid]);
  if (lane == 0) red[wg * 4 + warp] = dDp;
  __syncthreads();
  if (wt < 32 && hv) {
    const double* cm = cumv + hq;
    const float* dd = dtv + hq;
    const double total = cm[Q - 1];
    const double Ah = a.A[h];
    // in float64: dtotal's share of w_k dw_k cancels the rows' own in da
    double sd = 0.0;
    for (int k = lane; k < rows; k += 32)
      sd += (double)expf((float)(total - cm[k])) * dd[k] * dws[hq + k];
    const double dtot =
        (double)expf((float)total) * hss[wg] + warp_sum(sd);
    double carry = 0.0, dA = 0.0;
    for (int k0 = (rows - 1) / 32 * 32; k0 >= 0; k0 -= 32) {
      const int k = k0 + 31 - lane;       // lane 0 takes the block's last row
      double v = 0.0, dec = 0.0, cc = 0.0;
      if (k < rows) {
        dec = expf((float)(total - cm[k]));
        cc = dcc[wg * qp + k] + dcc[(HB + wg) * qp + k];
        v = dcr[hq + k] - (double)dd[k] * cc + dcs[hq + k] -
            dec * dd[k] * dws[hq + k] + (k == rows - 1 ? dtot : 0.0);
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      const double da = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
      if (k < rows) {
        a.ddt[(bi * a.L + l0 + k) * H + h] =
            (float)(cc + dec * dws[hq + k] + Ah * da);
        dA += dd[k] * da;
      }
    }
    dA = warp_sum(dA);
    if (lane == 0) {
      a.dAp[(bi * n + c) * H + h] = (float)dA;
      a.dDp[(bi * n + c) * H + h] =
          red[wg * 4] + red[wg * 4 + 1] + red[wg * 4 + 2] + red[wg * 4 + 3];
    }
  }
}

// Pass 4: dB and dC summed over the head blocks' partials (b, L, nhb, N
// rounded up to even), dA and dD over (batch, chunk), each in a fixed order.
__global__ void __launch_bounds__(NT2) ssd_bwd_tc_reduce_kernel(Args a) {
  const int64_t idx = (int64_t)blockIdx.x * NT2 + threadIdx.x;
  const int64_t rows = a.b * a.L * a.N, Ne = even_of(a.N);
  if (idx < rows) {
    const int64_t k = idx % a.N, bl = idx / a.N;
    const float* pb = a.dBp + bl * a.nhb * Ne + k;
    const float* pc = a.dCp + bl * a.nhb * Ne + k;
    float sb = 0.f, sc = 0.f;
    for (int64_t q = 0; q < a.nhb; ++q) {
      sb += pb[q * Ne];
      sc += pc[q * Ne];
    }
    static_cast<__nv_bfloat16*>(a.dB)[idx] = __float2bfloat16_rn(sb);
    static_cast<__nv_bfloat16*>(a.dC)[idx] = __float2bfloat16_rn(sc);
  } else if (idx < rows + a.H) {
    const int64_t h = idx - rows;
    float sa = 0.f, sd = 0.f;
    for (int64_t q = 0; q < a.b * a.n; ++q) {
      sa += a.dAp[q * a.H + h];
      sd += a.dDp[q * a.H + h];
    }
    a.dA[h] = sa;
    a.dD[h] = sd;
  }
}

// 16-byte loads need every row of x, B, C and dy to start 16-byte aligned
bool vec_ok(const Args& a) {
  const int64_t st[10] = {a.x_sb, a.x_sl, a.x_sh, a.B_sb, a.B_sl,
                          a.C_sb, a.C_sl, a.g_sb, a.g_sl, a.g_sh};
  bool ok = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.B) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.C) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.dy) % 16 == 0;
  for (int64_t s : st) ok = ok && s % 8 == 0;
  return ok;
}

template <typename K>
cudaError_t with_smem(K kern, int64_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool VEC>
cudaError_t launch_v(int pass, const Args& a, cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  if (pass == 0) {
    const int64_t bytes = states_smem(a.Q);
    if ((err = with_smem(ssd_bwd_tc_states_kernel<VEC>, bytes)) != cudaSuccess)
      return err;
    ssd_bwd_tc_states_kernel<VEC>
        <<<(unsigned)(2 * a.b * a.n * a.H), NT1, (size_t)bytes, st>>>(a);
  } else {
    const int64_t bytes = chunk_smem(a.Q);
    if ((err = with_smem(ssd_bwd_tc_chunk_kernel<VEC>, bytes)) != cudaSuccess)
      return err;
    ssd_bwd_tc_chunk_kernel<VEC>
        <<<(unsigned)(a.b * a.n * a.nhb), NT3, (size_t)bytes, st>>>(a);
  }
  return cudaGetLastError();
}

cudaError_t launch(int pass, const Args& a, cudaStream_t st) {
  if (pass == 0 || pass == 2)
    return vec_ok(a) ? launch_v<true>(pass, a, st)
                     : launch_v<false>(pass, a, st);
  if (pass == 1) {
    const int V = vec_of(a.P);
    const int64_t blocks =
        (a.b * a.H * npad_of(a.N) * (64 / V) + NT2 - 1) / NT2;
    if (V == 4)
      ssd_bwd_tc_pass_kernel<4><<<(unsigned)blocks, NT2, 0, st>>>(a);
    else
      ssd_bwd_tc_pass_kernel<1><<<(unsigned)blocks, NT2, 0, st>>>(a);
  } else {
    const int64_t blocks = (a.b * a.L * a.N + a.H + NT2 - 1) / NT2;
    ssd_bwd_tc_reduce_kernel<<<(unsigned)blocks, NT2, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// Every entry point takes the same arguments: the operands x (b, L, H, P),
// B, C (b, L, N) of one dtype (bf16 != 0: bfloat16, else float32), dt
// (b, L, H), A, D (H,) float32 and dy (b, L, H, P) of x's dtype, with the
// element strides (batch, seq[, head]) of x, B, C, dt and dy (P and N
// contiguous); the outputs dx (contiguous, x's dtype), ddt (b, L, H) f32,
// the partials dBp, dCp (b, L, nhb, N) f32 (nhb = ceil(H / 4) for float32,
// zeroed by the caller; for bfloat16 nhb = ceil(H / 2) and N rounded up to
// even), dAp, dDp (b, n, H) f32,
// dB, dC (b, L, N) contiguous in B's dtype, dA, dD (H,) f32; the scratch cum
// (b, n, H, Q) f64, s and ds (b, n, H, N, P) f32 and, for bfloat16 only, Sb
// and dSb (b, n, H, Npad, 64) bf16 (Npad = N rounded up to 16) and ssp
// (b, n, H, Npad * 16 / 32) f32 (Npad * 64 / 32 where P % 4 != 0); n =
// ceil(L / Q).  Passes in order: states, pass, chunk, reduce.

#define BWD_ARGS                                                              \
  const void *x, const void *B, const void *C, const void *dt,              \
      const void *A, const void *D, const void *dy, void *dx, void *ddt,    \
      void *dBp, void *dCp, void *dAp, void *dDp, void *dB, void *dC,       \
      void *dA, void *dD, void *cum, void *s, void *ds, void *Sb,           \
      void *dSb, void *ssp, int64_t b, int64_t L, int64_t H, int64_t P,     \
      int64_t N, int64_t Q, int64_t bf16, int64_t x_sb, int64_t x_sl,       \
      int64_t x_sh, int64_t B_sb, int64_t B_sl, int64_t C_sb, int64_t C_sl, \
      int64_t d_sb, int64_t d_sl, int64_t d_sh, int64_t g_sb, int64_t g_sl, \
      int64_t g_sh, void *stream

#define BWD_PASS_ARGS                                                         \
  x, B, C, dt, A, D, dy, dx, ddt, dBp, dCp, dAp, dDp, dB, dC, dA, dD, cum, s, \
      ds, Sb, dSb, ssp, b, L, H, P, N, Q, bf16, x_sb, x_sl, x_sh, B_sb,      \
      B_sl, C_sb, C_sl, d_sb, d_sl, d_sh, g_sb, g_sl, g_sh, stream

static int run(int pass, BWD_ARGS) {
  if (b < 1 || L < 1 || H < 1 || P < 1 || P > MAX_P || N < 1 || N > MAX_N ||
      Q < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (L + Q - 1) / Q;
  const int64_t nhb = (H + (bf16 ? tc::HB : fp32::HB) - 1) /
                      (bf16 ? tc::HB : fp32::HB);
  const bool fits =
      bf16 ? tc::chunk_smem(Q) <= SMEM_LIMIT &&
                 tc::states_smem(Q) <= SMEM_LIMIT &&
                 2 * b * n * H <= 2147483647 &&
                 (b * H * tc::npad_of(N) * 64 + tc::NT2 - 1) / tc::NT2 <=
                     2147483647
           : fp32::chunk_bytes(N, P, Q) <= SMEM_LIMIT &&
                 fp32::states_bytes(N, P, Q) <= SMEM_LIMIT &&
                 b * n * H <= 2147483647 &&
                 (b * H * N * P + fp32::NT2 - 1) / fp32::NT2 <= 2147483647;
  if (!fits || (b * L * N + H + 255) / 256 > 2147483647)
    return (int)cudaErrorInvalidValue;
  const Args a{x, B, C, static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(D), dy,
               dx, static_cast<float*>(ddt), static_cast<float*>(dBp),
               static_cast<float*>(dCp), static_cast<float*>(dAp),
               static_cast<float*>(dDp), dB, dC, static_cast<float*>(dA),
               static_cast<float*>(dD), static_cast<double*>(cum),
               static_cast<float*>(s), static_cast<float*>(ds), Sb, dSb,
               static_cast<float*>(ssp), b, L, H, P, N, Q, n, nhb, x_sb, x_sl,
               x_sh, B_sb, B_sl, C_sb, C_sl, d_sb, d_sl, d_sh, g_sb, g_sl,
               g_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? tc::launch(pass, a, st) : fp32::launch<float>(pass, a, st));
}

// pass 1: float32 b * n * H CTAs of 256 threads; bfloat16 2 * b * n * H
// CTAs of 128
int ssd_bwd_states_launch(BWD_ARGS) { return run(0, BWD_PASS_ARGS); }

// pass 2: float32 one thread per (b, H, N, P) element; bfloat16 one per
// (b, H, Npad, 4 columns)
int ssd_bwd_pass_launch(BWD_ARGS) { return run(1, BWD_PASS_ARGS); }

// pass 3: float32 b * n * ceil(H / 4) CTAs of 256 threads; bfloat16
// b * n * ceil(H / 2) CTAs of 256 (a warpgroup a head)
int ssd_bwd_chunk_launch(BWD_ARGS) { return run(2, BWD_PASS_ARGS); }

// pass 4: one thread per (b, L, N) element and per head
int ssd_bwd_reduce_launch(BWD_ARGS) { return run(3, BWD_PASS_ARGS); }

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
