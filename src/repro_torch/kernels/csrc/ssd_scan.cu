// Mamba2 SSD chunked scan (K6) for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:70
// (ssd_scan_pallas, body _ssd_kernel), and computes what it and
// src/repro/models/mamba2.py::ssd_chunked compute.  Per (batch, head), over
// chunks of Q rows, with cum = cumsum(dt * A) inside a chunk and total =
// cum[Q-1]:
//
//     y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . S_c + D x_i
//     S_{c+1} = exp(total_c) S_c + s_c,  s_c = sum_j exp(total - cum_j) dt_j
//                                              B_j (x) x_j,   S_0 = 0
//
// x (b, L, H, P) and B, C (b, L, N) in float32 or bfloat16 (one dtype for
// the three, P <= 64, N <= 128), dt (b, L, H), A and D (H,) in float32; y in
// x's dtype (bfloat16 rounds to nearest even).  B and C are shared by all
// heads.  On request the final state S_n (b, H, N, P) is written in float32
// too (ssd_chunked's second output, the Mamba2 prefill's cache); y is the
// same whether or not it is asked for.  Any L (the ragged last chunk is the
// reference's zero padding: dt 0 past L, so the last chunk's decay and
// weights end at row L - 1; rows past L are not stored), any H and any Q
// from the caller.
//
// Bound on this card: bytes.  At the LM-scoring shape (a shard of 11 rows
// x 2048 tokens, 64 heads of P = 64, N = 128, Q = 256, bf16) the function
// reads x (184.5 MB), B and C (11.5 MB) and dt (5.8 MB) and writes y
// (184.5 MB): 386 MB, 0.115 ms at 3.35 TB/s.  Its operations, counted per
// chunk as 2Q^2N (C.B^T) + Q(Q+1)HP (the masked M.x) + 2QNHP (carried
// term) + 2QNHP (state update), are 7.2e10: 0.073 ms at the bf16
// tensor-core peak (perf/roofline.py::ssd_scan_terms).
//
// The route is chosen by dtype before the launch, never as a fallback.
//
// * bfloat16 operands: the chunked SSD of arXiv:2405.21060 (section 6),
//   made chunk-parallel, in three passes on the tensor cores (namespace tc):
//   1. chunk states (ssd_scan_states_kernel), one CTA per (batch, chunk, 2
//      heads), one warpgroup per head: the scan of dt * A (cum to a
//      (b, n, H, Q) scratch for pass 3, the weights w_j = exp(total -
//      cum_j) dt_j from reverse sums), then s_c = B^T (w x) over the
//      chunk's 64-row tiles with wgmma (m64n64k16, B^T and w x both
//      MN-major from shared memory), written in float32 to a
//      (b, n - 1, H, N, P) scratch (the last chunk's, only when the final
//      state is asked for, straight into the final-state output);
//   2. state passing (ssd_scan_pass_kernel), S_{c+1} = exp(total_c) S_c +
//      s_c in float32, sequential over the n chunks and parallel over
//      (b, H, N, P); each S is written rounded to bf16 in pass 3's
//      swizzled (Npad, 64) tile; the final state exp(total_{n-1}) S_{n-1} +
//      s_{n-1} is written in float32 when asked for (with one chunk pass 1
//      has written s_0, which is the final state, and this pass is not
//      launched);
//   3. output (ssd_scan_output_kernel), one CTA per (batch, chunk, 64-row
//      tile, 2 heads), one warpgroup per head: the carried term
//      exp(cum_i) C_i S_c and, per key tile j <= i, C_i B_j^T, M = C.B^T
//      exp(cum_i - cum_j) dt_j masked to j <= i in registers, M x_j[h] --
//      all wgmma with float32 accumulators; y = acc + D x_i.  Key tiles
//      above the diagonal are never loaded.
//   At the serving shape that is 2 816 CTAs for pass 1 and 11 264 for pass
//   3 (two of each per SM), where one CTA per (batch, 4 heads) walked the
//   chunks in order before.  The passes are ordered on the stream; nothing
//   spins on another CTA.
//   What bounds the design: its own bytes and the latency of its loads.
//   The scratch adds 161.5 MB of float32 states written and read and
//   80.7 MB of bf16 states written and read once per row tile (from L2
//   when the tiles of a chunk run together), and x and B are read by two
//   passes: about 0.3 ms at 3.35 TB/s.  What the design does about it:
//   - Loads: cp.async of 16 bytes with zero fill into the 128-byte swizzle
//     that wgmma reads, in two stages.  A pass-3 CTA issues C, S and the
//     cumsums together, and the first key tile behind them, so that tile
//     arrives while the carried term is formed.  Not TMA: a chunk of Q rows
//     need not be a multiple of 64, so a tile zero-fills rows past the
//     chunk's end, which a tensor map's bounds cannot do.  Where a row of
//     x, B or C is not 16-byte aligned (N 4 or P 8 with contiguous
//     operands) the same tiles are filled by scalar loads.  Columns past N
//     or P are zero up to the wgmma multiples (64 columns, k steps of 16).
//   - Stores: pass 1's states and pass 3's y leave through shared memory
//     in coalesced 16-byte stores (P % 32 == 0 / P % 8 == 0; else direct):
//     straight from the accumulator layout every store covers half a
//     sector, and the states were most of pass 1's time.
//   - Pass 3 gives each warpgroup one head, so each forms its own C B^T:
//     one warpgroup holding both heads' accumulators forms it once per
//     CTA, but needs more than the 128 registers that two CTAs per SM
//     leave, and was slower in development runs.
//   - Decays: below the diagonal every key is under every row, so
//     exp(cum_i - cum_j) = exp(cum_i - cum_jl) exp(cum_jl - cum_j) with jl
//     the key tile's last row: 64 + 64 exponentials a tile, not 4 096.
//   - Numerics decision: the tensor cores multiply bf16, so M, S and w x
//     are rounded to bf16 once each (Mamba's own kernels round M and the
//     states so); products are exact and sums float32.  Emulated at a
//     serving-like shape (b 1, L 2048, H 8, P 64, N 128, Q 256, fast and
//     slow decay; tests/test_torch_precision.py) against the plain version
//     in float32 math: 1.7e-3 / 1.1e-3 (2.6e-3 / 2.9e-3 once y is rounded
//     to bf16, as both sides write it); the three as bf16 hi + lo give
//     3.1e-6 / 1.7e-6 (1.3e-3 / 1.4e-3 with y in bf16) at twice the
//     products, as TF32 2.2e-4 / 1.2e-4 (2.6e-3 / 2.9e-3) at half the
//     rate.  The bar is 1e-2, so one bf16 rounding is taken.  chip_smoke.py
//     prints every candidate at the serving shape.
//   - Exponents: never exp(cum_i) * exp(-cum_j) (exp(-cum) overflows over a
//     chunk).  The decays are exp2 of in-chunk differences times log2 e and
//     the state weights exp of reverse sums, every exponent <= 0.
// * float32 operands must stay within 1e-5 of float64, which no tensor-core
//   format meets, so they run the first version of this kernel on the CUDA
//   cores (namespace fp32): one CTA of 256 threads per (batch, block of 4
//   heads) walks the chunks in order with the 4 states (N, P) in shared
//   memory, in 32-row sub-tiles; the intra-chunk exponent cum_i - cum_j is
//   summed from the diagonal outwards and total - cum_j from a reverse
//   scan, so their float32 error scales with the exponent, not with |cum|.
//   It updates the states after the last chunk only when the final state
//   is asked for, and then writes them out.
//
// No atomics, and the summation order is fixed by the tiling, so a repeat
// launch is bitwise identical.  Every entry point takes raw pointers and
// element strides (P and N contiguous), launches on the given stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 128;    // state size N
constexpr int MAX_P = 64;     // head dim P
constexpr int SMEM_LIMIT = 232448;

// -- float32: CUDA cores ----------------------------------------------------------

namespace fp32 {


constexpr int HB = 4;         // heads per CTA
constexpr int T = 32;         // rows per sub-tile
constexpr int NT = 256;       // threads

// 16 bytes: 4 float32
struct alignas(16) Vec {
  static constexpr int n = 4;
  float v[n];
};

// Rows q = r * nh + h (r < T, h < nh) of `cols` elements from
// base + r * rs + h * hs into dst + q * pitch, as float32; rows with
// r >= nvalid or h >= hvalid load as 0.  VEC: 16-byte loads, all issued
// into registers before any is stored (cols, rs, hs and base aligned to
// 16 bytes; at most 8 vectors per thread), so their latencies overlap.
template <bool VEC>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* __restrict__ base,
                                          int64_t rs, int64_t hs, int nh,
                                          int hvalid, int nvalid, int cols) {
  if (VEC) {
    constexpr int V = Vec::n;
    const int vpr = cols / V, total = T * nh * vpr;
    Vec buf[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = threadIdx.x + k * NT;
      const int q = e / vpr, r = q / nh, h = q % nh;
      if (e < total && r < nvalid && h < hvalid)
        buf[k] = *reinterpret_cast<const Vec*>(base + r * rs + h * hs +
                                                    (e % vpr) * V);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = threadIdx.x + k * NT;
      if (e >= total) break;
      const int q = e / vpr, r = q / nh, h = q % nh;
      float* d = dst + q * pitch + (e % vpr) * V;
      const bool ok = r < nvalid && h < hvalid;
#pragma unroll
      for (int i = 0; i < V; ++i) d[i] = ok ? buf[k].v[i] : 0.f;
    }
  } else {
    const int total = T * nh * cols;
#pragma unroll 4
    for (int e = threadIdx.x; e < total; e += NT) {
      const int q = e / cols, r = q / nh, h = q % nh, k = e % cols;
      dst[q * pitch + k] =
          r < nvalid && h < hvalid ? base[r * rs + h * hs + k] : 0.f;
    }
  }
}

struct Args {
  const void* x;
  const void* B;
  const void* C;
  const float* dt;
  const float* A;
  const float* D;
  void* y;
  float* fs;                  // (b, H, N, P) final states, or null
  int64_t b, L, H, P, N, Q;
  int64_t x_sb, x_sl, x_sh;   // x strides (P contiguous)
  int64_t B_sb, B_sl;         // B strides (N contiguous)
  int64_t C_sb, C_sl;         // C strides (N contiguous)
  int64_t d_sb, d_sl, d_sh;   // dt strides
};

__host__ __device__ inline int64_t mpitch(int64_t N) {
  // the B tile (T x (N+1)) and the M tiles (HB x T x (T+1)) share a buffer
  const int64_t b = T * (N + 1), m = HB * T * (T + 1);
  return b > m ? b : m;
}

__host__ inline int64_t smem_floats(int64_t N, int64_t P, int64_t Q) {
  return HB * N * P + T * (N + 1) + mpitch(N) + T * HB * P + T * (T + 1) +
         3 * HB * Q;
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 1) ssd_scan_f32_kernel(Args a) {
  extern __shared__ float sm[];
  const int N = (int)a.N, P = (int)a.P, Q = (int)a.Q, NP1 = N + 1;
  float* S = sm;                         // (HB, N, P) states
  float* Cb = S + HB * N * P;            // (T, N+1) C rows of the i tile
  float* Bm = Cb + T * NP1;              // (T, N+1) B rows, then M tiles
  float* X = Bm + mpitch(N);             // (T, HB, P) x rows of the j tile
  float* CB = X + T * HB * P;            // (T, T+1) C.B^T, then weights
  float* cum = CB + T * (T + 1);         // (HB, Q) cumsum(dt*A)
  float* rev = cum + HB * Q;             // (HB, Q) sum of dt*A over (r, Q)
  float* dts = rev + HB * Q;             // (HB, Q) dt

  const float* __restrict__ x = static_cast<const float*>(a.x);
  const float* __restrict__ Bg = static_cast<const float*>(a.B);
  const float* __restrict__ Cg = static_cast<const float*>(a.C);
  float* __restrict__ y = static_cast<float*>(a.y);
  const int tid = threadIdx.x;
  const int64_t bi = blockIdx.x;
  const int h0 = blockIdx.y * HB;

  // output mapping: head yh, rows ti*4 + r, columns tp + 8c
  const int yh = tid / 64, ti = (tid % 64) / 8, tp = tid % 8;
  const bool y_head = h0 + yh < a.H;
  const float Dy = y_head ? a.D[h0 + yh] : 0.f;
  // M mapping (threads < HB*T): head mh, row mi
  const int mh = tid / T, mi = tid % T;
  const float Am = (tid < HB * T && h0 + mh < a.H) ? a.A[h0 + mh] : 0.f;
  // state-update mapping: rows tn*4 + r of N, columns tp + 8c of P
  const int tn = tid / 8;

  for (int e = tid; e < HB * N * P; e += NT) S[e] = 0.f;

  const int64_t nchunks = (a.L + Q - 1) / Q;
  for (int64_t c = 0; c < nchunks; ++c) {
    const int64_t l0 = c * Q;
    const int rows = (int)(a.L - l0 < Q ? a.L - l0 : Q);
    const int ntiles = (rows + T - 1) / T;
    __syncthreads();  // the previous chunk is done with dts/cum/rev
    for (int e = tid; e < HB * Q; e += NT) {
      const int h = e / Q, r = e % Q;
      dts[e] = (r < rows && h0 + h < a.H)
                   ? a.dt[bi * a.d_sb + (l0 + r) * a.d_sl + (h0 + h) * a.d_sh]
                   : 0.f;
    }
    __syncthreads();
    if (tid < HB) {
      const float Ah = h0 + tid < a.H ? a.A[h0 + tid] : 0.f;
      const float* d = dts + tid * Q;
      float s = 0.f;
      for (int r = 0; r < Q; ++r) {
        s += d[r] * Ah;
        cum[tid * Q + r] = s;
      }
      s = 0.f;
      for (int r = Q - 1; r >= 0; --r) {
        rev[tid * Q + r] = s;
        s += d[r] * Ah;
      }
    }
    __syncthreads();

    // ---- outputs, one 32-row tile at a time -----------------------------
    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * T;
      load_tile<VEC>(Cb, NP1, Cg + bi * a.C_sb + (l0 + i0) * a.C_sl,
                         a.C_sl, 0, 1, 1, rows - i0, N);
      __syncthreads();
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
      if (c > 0) {  // the carried-in state: exp(cum_i) * C_i . S
        const float* Sh = S + yh * N * P;
        for (int n = 0; n < N; ++n) {
          float cv[4], sv[8];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Cb[(ti * 4 + r) * NP1 + n];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            sv[q] = tp + 8 * q < P ? Sh[n * P + tp + 8 * q] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[r][q] += cv[r] * sv[q];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ti * 4 + r;
          const float g = i < rows ? expf(cum[yh * Q + i]) : 0.f;
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] *= g;
        }
      }
      float seg = 0.f;  // sum of dt*A over (j, i] for this thread's M row
      for (int jt = it; jt >= 0; --jt) {
        const int j0 = jt * T;
        __syncthreads();  // the previous key tile's readers are done
        load_tile<VEC>(Bm, NP1, Bg + bi * a.B_sb + (l0 + j0) * a.B_sl,
                           a.B_sl, 0, 1, 1, rows - j0, N);
        load_tile<VEC>(X, P,
                           x + bi * a.x_sb + (l0 + j0) * a.x_sl + h0 * a.x_sh,
                           a.x_sl, a.x_sh, HB, (int)(a.H - h0), rows - j0, P);
        __syncthreads();
        {  // C_i . B_j^T, once for the 4 heads: 4 entries per thread
          const int ci = tid / 8, cj = (tid % 8) * 4;
          float s4[4] = {0.f, 0.f, 0.f, 0.f};
          for (int n = 0; n < N; ++n) {
            const float cv = Cb[ci * NP1 + n];
#pragma unroll
            for (int r = 0; r < 4; ++r) s4[r] += cv * Bm[(cj + r) * NP1 + n];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) CB[ci * (T + 1) + cj + r] = s4[r];
        }
        __syncthreads();
        if (tid < HB * T) {  // M = C.B^T * exp(cum_i - cum_j) * dt_j, j <= i
          const int i = i0 + mi;
          const float* d = dts + mh * Q;
          float* Mrow = Bm + (mh * T + mi) * (T + 1);
          for (int j = T - 1; j >= 0; --j) {
            const int jj = j0 + j;
            float m = 0.f;
            if (i < rows && jj <= i) {
              m = CB[mi * (T + 1) + j] * expf(seg) * d[jj];
              seg += d[jj] * Am;
            }
            Mrow[j] = m;
          }
        }
        __syncthreads();
        const float* Mh = Bm + yh * T * (T + 1);
        for (int j = 0; j < T; ++j) {
          float mv[4], xv[8];
#pragma unroll
          for (int r = 0; r < 4; ++r) mv[r] = Mh[(ti * 4 + r) * (T + 1) + j];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            xv[q] = tp + 8 * q < P ? X[(j * HB + yh) * P + tp + 8 * q] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[r][q] += mv[r] * xv[q];
        }
        if (jt == it) {  // X holds x_i: the skip term D * x_i
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q)
              if (tp + 8 * q < P)
                acc[r][q] += Dy * X[((ti * 4 + r) * HB + yh) * P + tp + 8 * q];
        }
      }
      if (y_head) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ti * 4 + r;
          if (i >= rows) continue;
          float* yr = y + ((bi * a.L + l0 + i) * a.H + h0 + yh) * a.P;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (tp + 8 * q < P) yr[tp + 8 * q] = acc[r][q];
        }
      }
      __syncthreads();  // Cb is reloaded by the next tile
    }

    // ---- state update: S <- exp(total) S + sum_j w_j B_j (x) x_j ---------
    if (c + 1 == nchunks && a.fs == nullptr) break;  // not asked for
    for (int e = tid; e < HB * N * P; e += NT)
      S[e] *= expf(cum[(e / (N * P)) * Q + Q - 1]);
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * T;
      __syncthreads();
      load_tile<VEC>(Bm, NP1, Bg + bi * a.B_sb + (l0 + j0) * a.B_sl,
                         a.B_sl, 0, 1, 1, rows - j0, N);
      load_tile<VEC>(X, P,
                         x + bi * a.x_sb + (l0 + j0) * a.x_sl + h0 * a.x_sh,
                         a.x_sl, a.x_sh, HB, (int)(a.H - h0), rows - j0, P);
      if (tid < HB * T) {  // w_j = exp(total - cum_j) * dt_j
        const int jj = j0 + mi;
        CB[tid] = jj < rows ? expf(rev[mh * Q + jj]) * dts[mh * Q + jj] : 0.f;
      }
      __syncthreads();
      for (int h = 0; h < HB; ++h) {
        if (h0 + h >= a.H) break;
        float acc[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
        for (int j = 0; j < T; ++j) {
          const float w = CB[h * T + j];
          float bv[4], xv[8];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            bv[r] = tn * 4 + r < N ? Bm[j * NP1 + tn * 4 + r] * w : 0.f;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            xv[q] = tp + 8 * q < P ? X[(j * HB + h) * P + tp + 8 * q] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[r][q] += bv[r] * xv[q];
        }
        float* Sh = S + h * N * P;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (tn * 4 + r < N && tp + 8 * q < P)
              Sh[(tn * 4 + r) * P + tp + 8 * q] += acc[r][q];
      }
    }
  }
  if (a.fs == nullptr) return;
  __syncthreads();
  for (int e = tid; e < HB * N * P; e += NT) {
    const int64_t h = h0 + e / (N * P);
    if (h < a.H) a.fs[(bi * a.H + h) * N * P + e % (N * P)] = S[e];
  }
}

template <bool VEC>
cudaError_t launch_v(const Args& a, int64_t bytes, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_f32_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)a.b, (unsigned)((a.H + HB - 1) / HB));
  ssd_scan_f32_kernel<VEC><<<grid, NT, (size_t)bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int64_t bytes = 4 * smem_floats(a.N, a.P, a.Q);
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  // 16-byte loads where every row of x, B and C starts 16-byte aligned
  constexpr int V = Vec::n;
  const int64_t st[7] = {a.x_sb, a.x_sl, a.x_sh, a.B_sb, a.B_sl, a.C_sb,
                         a.C_sl};
  bool vec = a.P % V == 0 && a.N % V == 0 &&
             reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(a.B) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(a.C) % 16 == 0;
  for (int64_t s : st) vec = vec && s % V == 0;
  return vec ? launch_v<true>(a, bytes, stream)
             : launch_v<false>(a, bytes, stream);
}


}  // namespace fp32

// -- bfloat16: three chunk-parallel passes on the tensor cores ----------------

namespace tc {

constexpr int TR = 64;            // rows of a tile: wgmma's M
constexpr int HB1 = 2;            // heads per chunk-state CTA, one warpgroup each
constexpr int NT1 = 128 * HB1;
constexpr int HB3 = 2;            // heads per output CTA, one warpgroup each
constexpr int NT3 = 128 * HB3;
constexpr int NT2 = 256;
constexpr int TILE = TR * 128;    // bytes of 64 rows x 64 bf16 (one swizzle block)
constexpr int NBLK = MAX_N / 64;  // swizzle blocks of a B or C row (N <= 128)
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  const float* dt;
  const float* A;
  const float* D;
  __nv_bfloat16* y;
  float* cum;               // (b, n, H, Q) cumsum(dt * A) inside each chunk
  float* s;                 // (b, n - 1, H, N, P) chunk-local end states
  __nv_bfloat16* Sb;        // (b, n - 1, H, Npad, 64) carried-in states
  float* fs;                // (b, H, N, P) final states, or null
  int64_t b, L, H, P, N, Q, n;
  int64_t x_sb, x_sl, x_sh, B_sb, B_sl, C_sb, C_sl, d_sb, d_sl, d_sh;
};

__host__ __device__ inline int64_t npad_of(int64_t N) { return (N + 15) / 16 * 16; }
__host__ __device__ inline int64_t qpad_of(int64_t Q) { return (Q + TR - 1) / TR * TR; }

__host__ inline int64_t states_smem(int64_t N, int64_t Q) {
  return 1024 + 2 * (NBLK + HB1) * TILE + 4 * HB1 * qpad_of(Q);
}
__host__ inline int64_t output_smem(int64_t N, int64_t Q) {
  return 1024 + NBLK * TILE + 2 * (NBLK + HB3) * TILE +
         4 * HB3 * (2 * qpad_of(Q) + TR);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// Rows r < 64 of `cols` bf16 values at src + r * rs into the swizzled
// [NB][64][64] tile at dst, by NT threads; rows >= nvalid and columns >=
// cols are 0 (the reference's zero padding, and a chunk's end inside a
// tile).  VEC: 16-byte cp.async with zero fill (rows and src 16-byte
// aligned), waited for by the caller; else scalar loads and shared stores.
template <bool VEC, int NB, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t rs, int nvalid, int cols,
                                          int tid) {
  constexpr int CH = NB * 8;   // 16-byte chunks per row
  static_assert(TR * CH % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int u = 0; u < TR * CH / NT; ++u) {
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
  }
}

// Pass 1, chunk states.  One CTA per (batch, chunk, 2 heads), one
// warpgroup per head, two CTAs per SM.  dt arrives by cp.async with the
// first tile; the first warp of each warpgroup scans its head's dt * A
// over the chunk (cum to global for pass 3; the reverse sums give the
// weights w_j = exp(total - cum_j) dt_j in shared memory).  Then, over the
// chunk's 64-row tiles (two stages), each warpgroup scales its x tile by w
// in place (rounded to bf16 once) and adds s += B^T (w x): wgmma with B^T
// MN-major (N in m64 halves; the second is zero for N <= 64) and w x
// MN-major.  The last chunk's state is
// needed only for the final state, written straight to its output; when
// that is not asked for, the last chunk's CTAs only scan.
template <bool VEC>
__global__ void __launch_bounds__(NT1, 2) ssd_scan_states_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int N = (int)a.N, P = (int)a.P, Q = (int)a.Q;
  const int qpad = (int)qpad_of(Q);
  constexpr uint32_t tileB = NBLK * TILE, stage = tileB + HB1 * TILE;
  float* wS = reinterpret_cast<float*>(gbase + 2 * stage);   // (HB1, qpad)

  const int64_t hblocks = (a.H + HB1 - 1) / HB1;
  const int64_t blk = blockIdx.x;
  const int64_t c = blk % a.n, hb = (blk / a.n) % hblocks,
                bi = blk / (a.n * hblocks);
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int lane = tid % 32;
  const int64_t l0 = c * Q;
  const int rows = (int)(a.L - l0 < Q ? a.L - l0 : Q);
  const int64_t h = hb * HB1 + wg;
  const bool hv = h < a.H;
  const bool last = c + 1 == a.n;
  const bool keep = !last || a.fs != nullptr;   // this chunk's state is used
  const int ntiles = (rows + TR - 1) / TR;

  auto issue = [&](int rt, int st) {
    const uint32_t sb = base + st * stage;
    const int64_t r0 = l0 + rt * TR;
    const int nv = rows - rt * TR;
    load_tile<VEC, NBLK, NT1>(sb, a.B + bi * a.B_sb + r0 * a.B_sl, a.B_sl,
                              nv, N, tid);
#pragma unroll
    for (int hh = 0; hh < HB1; ++hh) {
      const int64_t hx = hb * HB1 + hh;
      load_tile<VEC, 1, NT1>(sb + tileB + hh * TILE,
                             a.x + bi * a.x_sb + r0 * a.x_sl +
                                 (hx < a.H ? hx : a.H - 1) * a.x_sh,
                             a.x_sl, hx < a.H ? nv : 0, P, tid);
    }
    cp_commit();
  };

  for (int e = tid; e < HB1 * qpad; e += NT1) {     // dt, 0 past the rows
    const int hh = e / qpad, r = e % qpad;
    const int64_t hd = hb * HB1 + hh;
    const bool ok = hd < a.H && r < rows;
    cp4(base + 2 * stage + 4 * e,
        ok ? a.dt + bi * a.d_sb + (l0 + r) * a.d_sl + hd * a.d_sh : a.dt,
        ok ? 4 : 0);
  }
  cp_commit();
  if (keep) issue(0, 0);
  if (keep) cp_wait<1>(); else cp_wait<0>();
  __syncthreads();

  if (wt < 32) {     // the scan of head h, by the warpgroup's first warp
    const float Ah = hv ? a.A[h] : 0.f;
    float* w = wS + wg * qpad;
    float* cum = a.cum + ((bi * a.n + c) * a.H + h) * Q;
    float carry = 0.f;
    for (int r0 = 0; r0 < qpad; r0 += 32) {
      const int r = r0 + lane;
      float v = w[r] * Ah;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (hv && r < Q) cum[r] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    carry = 0.f;     // reverse: rev_r = sum of dt*A over (r, Q)
    for (int r0 = qpad - 32; r0 >= 0; r0 -= 32) {
      const int r = r0 + 31 - lane;
      const float d = w[r];
      float v = d * Ah;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      const float ex = __shfl_up_sync(0xffffffffu, v, 1);
      const float rev = (lane ? ex : 0.f) + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
      w[r] = expf(rev) * d;
    }
  }
  if (!keep) return;
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
    const uint32_t sb = base + st * stage, xs = sb + tileB + wg * TILE;
    unsigned char* xg = gbase + (xs - base);
    const float* w = wS + wg * qpad + rt * TR;
#pragma unroll
    for (int u = 0; u < TR * 8 / 128; ++u) {   // x_j *= w_j, in place
      const int e = wt + u * 128, j = e / 8;
      uint4* q = reinterpret_cast<uint4*>(xg + j * 128 + (e % 8) * 16);
      uint4 v = *q;
      uint32_t* p32 = reinterpret_cast<uint32_t*>(&v);
      const float wj = w[j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p32[i] = pack_bf16(__uint_as_float(p32[i] << 16) * wj,
                           __uint_as_float(p32[i] & 0xffff0000u) * wj);
      *q = v;
    }
    fence_async();
    named_sync(1 + wg, 128);
#pragma unroll
    for (int m = 0; m < NBLK; ++m) fence_regs(acc[m]);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < NBLK; ++m)
#pragma unroll
      for (int ks = 0; ks < TR / 16; ++ks)
        wgmma_ss<1, 1>(acc[m], desc_mn(sb + m * TILE, ks), desc_mn(xs, ks),
                       1);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int m = 0; m < NBLK; ++m) fence_regs(acc[m]);
    __syncthreads();              // stage st is free for tile rt + 2
  }

  if (!hv) return;
  const int warp = wt / 32, g = lane / 4, t = lane % 4;
  float* s = last ? a.fs + (bi * a.H + h) * (int64_t)N * P
                  : a.s + ((bi * (a.n - 1) + c) * a.H + h) * (int64_t)N * P;
  if (P % 32 == 0) {
    // through shared memory (the stages are free): the warpgroup's (N, P)
    // tile with its 16-byte column chunks XOR-swizzled by row, then out in
    // coalesced 16-byte stores
    float* st = reinterpret_cast<float*>(gbase) + wg * (NBLK * 64 * P);
    const int cpr = P / 4;           // 16-byte chunks per row
#pragma unroll
    for (int m = 0; m < NBLK; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const int n = m * 64 + warp * 16 + g + 8 * (q / 2);
          const int p = 8 * j + 2 * t;
          if (p < P)
            *reinterpret_cast<float2*>(
                st + n * P + (((p / 4) ^ (n % 8)) * 4) + p % 4) =
                make_float2(acc[m][j * 4 + q], acc[m][j * 4 + q + 1]);
        }
    named_sync(1 + wg, 128);
    for (int e = wt; e < N * cpr; e += 128) {
      const int n = e / cpr, k = e % cpr;
      *reinterpret_cast<float4*>(s + n * P + k * 4) =
          *reinterpret_cast<const float4*>(st + n * P + ((k ^ (n % 8)) * 4));
    }
    return;
  }
#pragma unroll
  for (int m = 0; m < NBLK; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = m * 64 + warp * 16 + g + 8 * (q / 2);
        const int p = 8 * j + 2 * t + (q % 2);
        if (n < N && p < P) s[n * P + p] = acc[m][j * 4 + q];
      }
}

// Pass 2, state passing: S_1 = s_0, S_{c+1} = exp(total_c) S_c + s_c in
// float32, sequential over the chunks and parallel over (b, H, N, 64 / V
// groups of V columns); each S_{c+1} is written rounded to bf16 in pass
// 3's swizzled (Npad, 64) tile, zero where n >= N or p >= P.  V = 4 (float4
// loads, 8-byte stores) where P % 4 == 0.  The loads of 8 chunks are issued
// before their chain of multiply-adds.  When the final state is asked for,
// pass 1 has put s_{n-1} there, and S_n = exp(total_{n-1}) S_{n-1} +
// s_{n-1} replaces it.
template <int V>
__global__ void __launch_bounds__(NT2) ssd_scan_pass_kernel(Args a) {
  const int64_t N = a.N, P = a.P, Q = a.Q, npad = npad_of(N);
  constexpr int G = 64 / V;          // column groups per state row
  const int64_t e = (int64_t)blockIdx.x * NT2 + threadIdx.x;
  if (e >= a.b * a.H * npad * G) return;
  const int p = (int)(e % G) * V, n = (int)((e / G) % npad);
  const int64_t h = (e / (G * npad)) % a.H, bi = e / (G * npad * a.H);
  const bool ok = n < N && p < P;
  const int at = n * 64 + ((((p / 8) ^ (n % 8))) * 8) + p % 8;
  const float* __restrict__ cum = a.cum + (bi * a.n * a.H + h) * Q + Q - 1;
  const float* __restrict__ s =
      a.s + (bi * (a.n - 1) * a.H + h) * N * P + n * P + p;
  __nv_bfloat16* __restrict__ Sb =
      a.Sb + (bi * (a.n - 1) * a.H + h) * npad * 64 + at;
  const int64_t cs = a.H * Q, ss = a.H * N * P, bs = a.H * npad * 64;
  float S[V];
#pragma unroll
  for (int v = 0; v < V; ++v) S[v] = 0.f;
  for (int64_t k0 = 0; k0 + 1 < a.n; k0 += 8) {
    float tot[8], sv[8][V];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t k = k0 + u;
      const bool in = k + 1 < a.n;
      tot[u] = in ? cum[k * cs] : 0.f;
      if constexpr (V == 4) {
        const float4 f = in && ok
            ? *reinterpret_cast<const float4*>(s + k * ss)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        sv[u][0] = f.x; sv[u][1] = f.y; sv[u][2] = f.z; sv[u][3] = f.w;
      } else {
        sv[u][0] = in && ok ? s[k * ss] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t k = k0 + u;
      if (k + 1 >= a.n) break;
      const float dec = expf(tot[u]);
#pragma unroll
      for (int v = 0; v < V; ++v) S[v] = fmaf(dec, S[v], sv[u][v]);
      if constexpr (V == 4) {
        uint2 o;
        o.x = pack_bf16(S[0], S[1]);
        o.y = pack_bf16(S[2], S[3]);
        *reinterpret_cast<uint2*>(Sb + k * bs) = o;
      } else {
        Sb[k * bs] = __float2bfloat16_rn(S[0]);
      }
    }
  }
  if (a.fs == nullptr || !ok) return;
  const float dec = expf(cum[(a.n - 1) * cs]);
  float* __restrict__ f = a.fs + (bi * a.H + h) * N * P + n * P + p;
#pragma unroll
  for (int v = 0; v < V; ++v) f[v] = fmaf(dec, S[v], f[v]);
}

// Pass 3, output.  One CTA per (batch, chunk, 64-row tile, 2 heads), one
// warpgroup per head, two CTAs per SM.  The two warpgroups share the loads
// of the C rows and of each key tile; the tiles of one (batch, chunk,
// heads) are adjacent in the grid, heaviest first, so they share S and the
// key tiles in L2.  Per warpgroup, on the tile's rows i:
//   acc  = exp(cum_i) * (C_i S_c[h])                    (wgmma, S MN-major)
//   for key tiles j <= i (two cp.async stages):
//     CB   = C_i B_j^T                                  (wgmma, both K-major)
//     M    = CB * exp(cum_i - cum_j) * dt_j, j <= i     (registers, bf16)
//     acc += M x_j[h]                                   (wgmma, x MN-major)
//   y = acc + D_h x_i, rounded to bf16.
// Each warpgroup forms its own C B^T (see the header).
template <bool VEC>
__global__ void __launch_bounds__(NT3, 2) ssd_scan_output_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int N = (int)a.N, P = (int)a.P, Q = (int)a.Q;
  const int npad = (int)npad_of(N), qp = (int)qpad_of(Q);
  const int T = qp / TR;
  constexpr uint32_t tileB = NBLK * TILE, stage = tileB + HB3 * TILE;
  const uint32_t Cs = base, st0 = Cs + tileB;
  float* cumS = reinterpret_cast<float*>(gbase + tileB + 2 * stage);
  float* dtS = cumS + HB3 * qp;

  const int64_t hblocks = (a.H + HB3 - 1) / HB3;
  int64_t blk = blockIdx.x;
  const int it = T - 1 - (int)(blk % T);
  blk /= T;
  const int64_t hb = blk % hblocks;
  blk /= hblocks;
  const int64_t c = blk % a.n, bi = blk / a.n;
  const int64_t l0 = c * Q;
  const int rows = (int)(a.L - l0 < Q ? a.L - l0 : Q);
  const int i0 = it * TR;
  if (i0 >= rows) return;            // past the ragged end of the last chunk
  const int kend = i0 + TR;          // rows of the chunk the CTA reads
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int lane = tid % 32, warp = wt / 32;
  const int g = lane / 4, t = lane % 4, wrow = warp * 16 + g;
  const int64_t h = hb * HB3 + wg;   // this warpgroup's head
  const bool hv = h < a.H;

  auto issue = [&](int jt, int st) {   // key tile jt: B_j and x_j of 2 heads
    const uint32_t sb = st0 + st * stage;
    const int64_t r0 = l0 + jt * TR;
    const int nv = rows - jt * TR;
    load_tile<VEC, NBLK, NT3>(sb, a.B + bi * a.B_sb + r0 * a.B_sl, a.B_sl,
                              nv, N, tid);
#pragma unroll
    for (int hh = 0; hh < HB3; ++hh) {
      const int64_t hx = hb * HB3 + hh;
      load_tile<VEC, 1, NT3>(sb + tileB + hh * TILE,
                             a.x + bi * a.x_sb + r0 * a.x_sl +
                                 (hx < a.H ? hx : a.H - 1) * a.x_sh,
                             a.x_sl, hx < a.H ? nv : 0, P, tid);
    }
  };
  // two groups: the cumsums and dt of the rows the CTA reads, its C rows
  // and (c > 0) the carried-in states of both heads, for the carried term;
  // then key tile 0, which arrives while that term is formed
  for (int e = tid; e < HB3 * kend; e += NT3) {
    const int hh = e / kend, r = e % kend;
    const int64_t hx = hb * HB3 + hh;
    const bool okc = hx < a.H && r < Q, okd = hx < a.H && r < rows;
    cp4(smem_addr(cumS + hh * qp + r),
        okc ? a.cum + ((bi * a.n + c) * a.H + hx) * Q + r : a.cum,
        okc ? 4 : 0);
    cp4(smem_addr(dtS + hh * qp + r),
        okd ? a.dt + bi * a.d_sb + (l0 + r) * a.d_sl + hx * a.d_sh : a.dt,
        okd ? 4 : 0);
  }
  load_tile<VEC, NBLK, NT3>(Cs, a.C + bi * a.C_sb + (l0 + i0) * a.C_sl,
                            a.C_sl, rows - i0, N, tid);
  const uint32_t Sh = st0 + stage + wg * npad * 128;   // S_c[h], in stage 1
  if (c > 0) {       // free until key tile 1 arrives
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        a.Sb + ((bi * (a.n - 1) + c - 1) * a.H + (hv ? h : a.H - 1)) * npad *
                   64);
    for (int e = wt; e < npad * 8; e += 128)
      cp16(Sh + e * 16, src + e * 16, 16);
  }
  cp_commit();
  issue(0, 0);
  cp_commit();
  cp_wait<1>();
  fence_async();
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int nk = (N + 15) / 16;      // k16 steps over the state
  const float* cm = cumS + wg * qp;
  const float* dd = dtS + wg * qp;
  float* vS = dtS + HB3 * qp + wg * TR;   // (HB3, 64) column factors
  const int ia = i0 + wrow, ib = ia + 8;
  if (c > 0) {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * NBLK; ++ks)
      if (ks < nk) wgmma_ss<0, 1>(acc, desc_k(Cs, ks), desc_mn(Sh, ks), ks);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    const float e0 = fast_exp2(cm[ia] * LOG2E);
    const float e1 = fast_exp2(cm[ib] * LOG2E);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j * 4] *= e0;
      acc[j * 4 + 1] *= e0;
      acc[j * 4 + 2] *= e1;
      acc[j * 4 + 3] *= e1;
    }
    __syncthreads();                 // stage 1 is free for key tile 1
  }

  float cb[32];
  uint32_t pa[4][4];
  const float ca = cm[ia], cbv = cm[ib];
  for (int jt = 0; jt <= it; ++jt) {
    const int st = jt & 1;
    if (jt < it) {
      issue(jt + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_async();
    __syncthreads();                 // key tile jt is in
    const uint32_t sb = st0 + st * stage;
    fence_regs(cb);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * NBLK; ++ks)
      if (ks < nk) wgmma_ss<0, 0>(cb, desc_k(Cs, ks), desc_k(sb, ks), ks);
    wgmma_commit();
    // M = C.B^T * exp(cum_i - cum_j) * dt_j on j <= i, rows of the chunk.
    // Below the diagonal every j is under every i, so with jl the tile's
    // last row the decay is exp(cum_i - cum_jl) exp(cum_jl - cum_j), both
    // exponents <= 0: v_j = exp(cum_jl - cum_j) dt_j once per column (while
    // C.B^T is in flight), u_i once per row.  On the diagonal tile, one
    // exp per entry, masked.
    const bool below = jt < it;
    if (below) {
      const float cl = cm[jt * TR + TR - 1];
      if (wt < TR)
        vS[wt] = fast_exp2((cl - cm[jt * TR + wt]) * LOG2E) * dd[jt * TR + wt];
      named_sync(1 + wg, 128);
    }
    wgmma_wait0();
    fence_regs(cb);
    if (below) {
      const float cl = cm[jt * TR + TR - 1];
      const float ua = ia < rows ? fast_exp2((ca - cl) * LOG2E) : 0.f;
      const float ub = ib < rows ? fast_exp2((cbv - cl) * LOG2E) : 0.f;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const float2 v = *reinterpret_cast<const float2*>(vS + 8 * j8 + 2 * t);
        pa[j8 / 2][(j8 % 2) * 2] =
            pack_bf16(cb[j8 * 4] * ua * v.x, cb[j8 * 4 + 1] * ua * v.y);
        pa[j8 / 2][(j8 % 2) * 2 + 1] =
            pack_bf16(cb[j8 * 4 + 2] * ub * v.x, cb[j8 * 4 + 3] * ub * v.y);
      }
    } else {
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        float m[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = q < 2 ? ia : ib;
          const int j = jt * TR + 8 * j8 + 2 * t + q % 2;
          const float ci = q < 2 ? ca : cbv;
          m[q] = j <= i && i < rows
              ? cb[j8 * 4 + q] * fast_exp2((ci - cm[j]) * LOG2E) * dd[j]
              : 0.f;
        }
        pa[j8 / 2][(j8 % 2) * 2] = pack_bf16(m[0], m[1]);
        pa[j8 / 2][(j8 % 2) * 2 + 1] = pack_bf16(m[2], m[3]);
      }
    }
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, pa[kk], desc_mn(sb + tileB + wg * TILE, kk));

    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    if (jt < it) __syncthreads();    // stage st is free for tile jt + 2
  }
  if (!hv) return;

  // y = acc + D x_i (x_i is the last key tile's x), rounded to bf16; where
  // P % 8 == 0 the warpgroup's (64, P) tile goes through the other stage
  // (swizzled) and out in 16-byte stores
  const unsigned char* xh =
      gbase + (st0 + (it & 1) * stage + tileB + wg * TILE - base);
  const float Dh = a.D[h];
  const bool pairs = P % 2 == 0, staged = P % 8 == 0;
  unsigned char* yt =
      gbase + (st0 + ((it + 1) & 1) * stage + wg * TILE - base);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int il = wrow + 8 * r, i = i0 + il;
    if (i >= rows) continue;
    __nv_bfloat16* yr = a.y + ((bi * a.L + l0 + i) * a.H + h) * P;
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      const int p = 8 * j8 + 2 * t;
      if (p >= P) break;
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(xh + swz(il, p));
      const float v0 = acc[j8 * 4 + 2 * r] + Dh * __bfloat162float(xv.x);
      const float v1 = acc[j8 * 4 + 2 * r + 1] + Dh * __bfloat162float(xv.y);
      if (staged) {
        *reinterpret_cast<__nv_bfloat162*>(yt + swz(il, p)) =
            __floats2bfloat162_rn(v0, v1);
      } else if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(yr + p) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        yr[p] = __float2bfloat16_rn(v0);
        if (p + 1 < P) yr[p + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
  if (!staged) return;
  named_sync(1 + wg, 128);
  const int cpr = P / 8;             // 16-byte chunks per row
  for (int e = wt; e < TR * cpr; e += 128) {
    const int il = e / cpr, k = e % cpr;
    if (i0 + il >= rows) continue;
    *reinterpret_cast<uint4*>(a.y + ((bi * a.L + l0 + i0 + il) * a.H + h) * P +
                              k * 8) =
        *reinterpret_cast<const uint4*>(yt + il * 128 +
                                        ((k ^ (il % 8)) * 16));
  }
}

template <bool VEC>
cudaError_t launch_states(const Args& a, cudaStream_t stream) {
  const int64_t bytes = states_smem(a.N, a.Q);
  auto kern = ssd_scan_states_kernel<VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = a.b * a.n * ((a.H + HB1 - 1) / HB1);
  kern<<<(unsigned)blocks, NT1, (size_t)bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_output(const Args& a, cudaStream_t stream) {
  const int64_t bytes = output_smem(a.N, a.Q);
  auto kern = ssd_scan_output_kernel<VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks =
      a.b * a.n * ((a.H + HB3 - 1) / HB3) * (qpad_of(a.Q) / TR);
  kern<<<(unsigned)blocks, NT3, (size_t)bytes, stream>>>(a);
  return cudaGetLastError();
}

// 16-byte loads need every row of x, B and C to start 16-byte aligned
bool vec_ok(const Args& a) {
  const int64_t st[7] = {a.x_sb, a.x_sl, a.x_sh, a.B_sb, a.B_sl, a.C_sb,
                         a.C_sl};
  bool ok = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.B) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.C) % 16 == 0;
  for (int64_t s : st) ok = ok && s % 8 == 0;
  return ok;
}

}  // namespace tc

#define SSD_ARGS                                                              \
  const void *x, const void *B, const void *C, const void *dt,              \
      const void *A, const void *D, void *y, void *cum, void *s, void *Sb,  \
      void *fs, int64_t b, int64_t L, int64_t H, int64_t P, int64_t N,     \
      int64_t Q,                                                            \
      int64_t x_sb, int64_t x_sl, int64_t x_sh, int64_t B_sb, int64_t B_sl, \
      int64_t C_sb, int64_t C_sl, int64_t d_sb, int64_t d_sl, int64_t d_sh, \
      void *stream

bool bad_shape(int64_t b, int64_t L, int64_t H, int64_t P, int64_t N,
               int64_t Q) {
  return b < 1 || L < 1 || H < 1 || P < 1 || P > MAX_P || N < 1 ||
         N > MAX_N || Q < 1;
}

tc::Args tc_args(SSD_ARGS) {
  (void)stream;
  return tc::Args{static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(B),
                  static_cast<const __nv_bfloat16*>(C),
                  static_cast<const float*>(dt), static_cast<const float*>(A),
                  static_cast<const float*>(D),
                  static_cast<__nv_bfloat16*>(y), static_cast<float*>(cum),
                  static_cast<float*>(s), static_cast<__nv_bfloat16*>(Sb),
                  static_cast<float*>(fs), b, L, H, P, N, Q, (L + Q - 1) / Q, x_sb, x_sl, x_sh, B_sb,
                  B_sl, C_sb, C_sl, d_sb, d_sl, d_sh};
}

}  // namespace

extern "C" {

// Every entry point takes the same arguments: x (b, L, H, P) with element
// strides (batch, seq, head) and P contiguous; B, C (b, L, N) with strides
// (batch, seq) and N contiguous; dt (b, L, H) with strides (batch, seq,
// head); A, D (H,); y a new contiguous (b, L, H, P); the bf16 route's
// scratch cum (b, n, H, Q) and s (b, n - 1, H, N, P) float32 and Sb
// (b, n - 1, H, Npad, 64) bf16 with n = ceil(L / Q), Npad = N rounded up to
// 16 (unused by the float32 route); fs a (b, H, N, P) float32 output for the
// final state, or null when it is not asked for (every pass of a call takes
// the same fs).

// float32 operands, CUDA cores: grid (b, ceil(H / 4)).
int ssd_scan_f32_launch(SSD_ARGS) {
  (void)cum; (void)s; (void)Sb;
  if (bad_shape(b, L, H, P, N, Q) || b > 2147483647 ||
      (H + fp32::HB - 1) / fp32::HB > 65535)
    return (int)cudaErrorInvalidValue;
  const fp32::Args a{x, B, C, static_cast<const float*>(dt),
                     static_cast<const float*>(A),
                     static_cast<const float*>(D), y,
                     static_cast<float*>(fs), b, L, H, P, N, Q, x_sb,
                     x_sl, x_sh, B_sb, B_sl, C_sb, C_sl, d_sb, d_sl, d_sh};
  return (int)fp32::launch(a, static_cast<cudaStream_t>(stream));
}

// bf16, pass 1 (chunk states and the in-chunk cumsums): b * n * ceil(H / 4)
// CTAs of 512 threads.
int ssd_scan_states_launch(SSD_ARGS) {
  const tc::Args a = tc_args(x, B, C, dt, A, D, y, cum, s, Sb, fs, b, L, H, P,
                             N, Q, x_sb, x_sl, x_sh, B_sb, B_sl, C_sb, C_sl,
                             d_sb, d_sl, d_sh, stream);
  if (bad_shape(b, L, H, P, N, Q) || tc::states_smem(N, Q) > SMEM_LIMIT ||
      b * a.n * ((H + tc::HB1 - 1) / tc::HB1) > 2147483647)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(tc::vec_ok(a) ? tc::launch_states<true>(a, st)
                             : tc::launch_states<false>(a, st));
}

// bf16, pass 2 (state passing), n > 1 only: b * H * Npad * 64 threads.
int ssd_scan_pass_launch(SSD_ARGS) {
  const tc::Args a = tc_args(x, B, C, dt, A, D, y, cum, s, Sb, fs, b, L, H, P,
                             N, Q, x_sb, x_sl, x_sh, B_sb, B_sl, C_sb, C_sl,
                             d_sb, d_sl, d_sh, stream);
  const int V = P % 4 == 0 ? 4 : 1;
  const int64_t blocks = (b * H * tc::npad_of(N) * (64 / V) + tc::NT2 - 1) /
                         tc::NT2;
  if (bad_shape(b, L, H, P, N, Q) || a.n < 2 || blocks > 2147483647)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V == 4)
    tc::ssd_scan_pass_kernel<4><<<(unsigned)blocks, tc::NT2, 0, st>>>(a);
  else
    tc::ssd_scan_pass_kernel<1><<<(unsigned)blocks, tc::NT2, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// bf16, pass 3 (output): b * n * ceil(H / 2) * ceil(Q / 64) CTAs of 128
// threads.
int ssd_scan_output_launch(SSD_ARGS) {
  const tc::Args a = tc_args(x, B, C, dt, A, D, y, cum, s, Sb, fs, b, L, H, P,
                             N, Q, x_sb, x_sl, x_sh, B_sb, B_sl, C_sb, C_sl,
                             d_sb, d_sl, d_sh, stream);
  if (bad_shape(b, L, H, P, N, Q) || tc::output_smem(N, Q) > SMEM_LIMIT ||
      b * a.n * ((H + tc::HB3 - 1) / tc::HB3) * (tc::qpad_of(Q) / tc::TR) >
          2147483647)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(tc::vec_ok(a) ? tc::launch_output<true>(a, st)
                             : tc::launch_output<false>(a, st));
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
