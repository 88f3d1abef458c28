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
// Design: four chunk-parallel passes, the forward's three mirrored and a
// reduction, on the CUDA cores in float32 for both dtypes (bfloat16 is
// widened as it is loaded; a first, simple kernel that is right: tensor
// cores are later work).  The two routes are one template, so the float32
// route keeps float32's 1e-5 and the bfloat16 route loses nothing to a
// rounding of its products.
//   1. states (ssd_bwd_states_kernel), one CTA per (batch, chunk, head):
//      the scan of dt A in float64 (written to a (b, n, H, Q) scratch for
//      pass 3: a decay's exponent is a difference of two cumsums, so its
//      float32 error would scale with |cum|, ~500 at the probe's decays),
//      then s_c = B^T (w x) (the forward's chunk state, recomputed: chunks
//      0..n-2) and ds_c = C^T (exp(cum) dy) (the chunk's share of the state
//      gradient: chunks 1..n-1) over 32-row tiles, each (N, P) in float32
//      into (b, n, H, N, P) scratches;
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
//      dcum into ddt and the chunk's dA and dD, in float64 (dA and ddt
//      sum terms that largely cancel).  Tiles above the diagonal
//      are never visited and exp(cum_i - cum_j) is formed only for j <= i;
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

namespace {

constexpr int MAX_N = 128;    // state size N
constexpr int MAX_P = 64;     // head dim P
constexpr int SMEM_LIMIT = 232448;
constexpr int NT = 256;       // threads of passes 1 and 3: 16 x 16
constexpr int T1 = 32;        // rows a tile, pass 1
constexpr int T = 64;         // rows a tile, pass 3
constexpr int HB = 4;         // heads a CTA, pass 3
constexpr int NT2 = 256;      // threads a block, passes 2 and 4

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
  int64_t b, L, H, P, N, Q, n, nhb;
  int64_t x_sb, x_sl, x_sh;
  int64_t B_sb, B_sl, C_sb, C_sl;
  int64_t d_sb, d_sl, d_sh;
  int64_t g_sb, g_sl, g_sh;   // dy
};

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

}  // namespace

extern "C" {

// Every entry point takes the same arguments: the operands x (b, L, H, P),
// B, C (b, L, N) of one dtype (bf16 != 0: bfloat16, else float32), dt
// (b, L, H), A, D (H,) float32 and dy (b, L, H, P) of x's dtype, with the
// element strides (batch, seq[, head]) of x, B, C, dt and dy (P and N
// contiguous); the outputs dx (contiguous, x's dtype), ddt (b, L, H) f32,
// the partials dBp, dCp (b, L, ceil(H / 4), N) f32, zeroed by the caller,
// and dAp, dDp (b, n, H) f32, dB, dC (b, L, N) contiguous in B's dtype, dA,
// dD (H,) f32; the scratch cum (b, n, H, Q) f64, s and ds (b, n, H, N, P) f32,
// n = ceil(L / Q).  Passes in order: states, pass, chunk, reduce.

#define BWD_ARGS                                                              \
  const void *x, const void *B, const void *C, const void *dt,              \
      const void *A, const void *D, const void *dy, void *dx, void *ddt,    \
      void *dBp, void *dCp, void *dAp, void *dDp, void *dB, void *dC,       \
      void *dA, void *dD, void *cum, void *s, void *ds, int64_t b,          \
      int64_t L, int64_t H, int64_t P, int64_t N, int64_t Q, int64_t bf16,  \
      int64_t x_sb, int64_t x_sl, int64_t x_sh, int64_t B_sb, int64_t B_sl, \
      int64_t C_sb, int64_t C_sl, int64_t d_sb, int64_t d_sl, int64_t d_sh, \
      int64_t g_sb, int64_t g_sl, int64_t g_sh, void *stream

static int run(int pass, BWD_ARGS) {
  if (b < 1 || L < 1 || H < 1 || P < 1 || P > MAX_P || N < 1 || N > MAX_N ||
      Q < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (L + Q - 1) / Q, nhb = (H + HB - 1) / HB;
  if (chunk_bytes(N, P, Q) > SMEM_LIMIT ||
      states_bytes(N, P, Q) > SMEM_LIMIT || b * n * H > 2147483647 ||
      (b * H * N * P + NT2 - 1) / NT2 > 2147483647 ||
      (b * L * N + H + NT2 - 1) / NT2 > 2147483647)
    return (int)cudaErrorInvalidValue;
  const Args a{x, B, C, static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(D), dy,
               dx, static_cast<float*>(ddt), static_cast<float*>(dBp),
               static_cast<float*>(dCp), static_cast<float*>(dAp),
               static_cast<float*>(dDp), dB, dC, static_cast<float*>(dA),
               static_cast<float*>(dD), static_cast<double*>(cum),
               static_cast<float*>(s), static_cast<float*>(ds), b, L, H, P, N,
               Q, n, nhb, x_sb, x_sl, x_sh, B_sb, B_sl, C_sb, C_sl, d_sb, d_sl,
               d_sh, g_sb, g_sl, g_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<__nv_bfloat16>(pass, a, st)
                    : launch<float>(pass, a, st));
}

// pass 1: b * n * H CTAs of 256 threads
int ssd_bwd_states_launch(BWD_ARGS) {
  return run(0, x, B, C, dt, A, D, dy, dx, ddt, dBp, dCp, dAp, dDp, dB, dC,
             dA, dD, cum, s, ds, b, L, H, P, N, Q, bf16, x_sb, x_sl, x_sh,
             B_sb, B_sl, C_sb, C_sl, d_sb, d_sl, d_sh, g_sb, g_sl, g_sh,
             stream);
}

// pass 2: one thread per (b, H, N, P) element
int ssd_bwd_pass_launch(BWD_ARGS) {
  return run(1, x, B, C, dt, A, D, dy, dx, ddt, dBp, dCp, dAp, dDp, dB, dC,
             dA, dD, cum, s, ds, b, L, H, P, N, Q, bf16, x_sb, x_sl, x_sh,
             B_sb, B_sl, C_sb, C_sl, d_sb, d_sl, d_sh, g_sb, g_sl, g_sh,
             stream);
}

// pass 3: b * n * ceil(H / 4) CTAs of 256 threads
int ssd_bwd_chunk_launch(BWD_ARGS) {
  return run(2, x, B, C, dt, A, D, dy, dx, ddt, dBp, dCp, dAp, dDp, dB, dC,
             dA, dD, cum, s, ds, b, L, H, P, N, Q, bf16, x_sb, x_sl, x_sh,
             B_sb, B_sl, C_sb, C_sl, d_sb, d_sl, d_sh, g_sb, g_sl, g_sh,
             stream);
}

// pass 4: one thread per (b, L, N) element and per head
int ssd_bwd_reduce_launch(BWD_ARGS) {
  return run(3, x, B, C, dt, A, D, dy, dx, ddt, dBp, dCp, dAp, dDp, dB, dC,
             dA, dD, cum, s, ds, b, L, H, P, N, Q, bf16, x_sb, x_sl, x_sh,
             B_sb, B_sl, C_sb, C_sl, d_sb, d_sl, d_sh, g_sb, g_sl, g_sh,
             stream);
}

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
