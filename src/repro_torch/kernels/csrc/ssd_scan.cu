// Mamba2 SSD chunked scan (K6) for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:70
// (ssd_scan_pallas, body _ssd_kernel), and computes what it and
// src/repro/models/mamba2.py::ssd_chunked compute.  Per (batch, head), over
// chunks of Q rows taken in order, with cum = cumsum(dt * A) inside a chunk
// and total = cum[Q-1]:
//
//     y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . S + D x_i
//     S  <- exp(total) S + sum_j exp(total - cum_j) dt_j B_j (x) x_j
//
// x (b, L, H, P) and B, C (b, L, N) in float32 or bfloat16 (one dtype for
// the three), dt (b, L, H), A and D (H,) in float32.  All arithmetic is
// float32; y is rounded once to x's dtype (bfloat16 to nearest even).  B and
// C are shared by all heads.  The final state is not returned (the forward
// without a cache throws it away).  Any L works: the ragged last chunk loads
// as zeros past L, which is the reference's zero padding, and rows past L
// are not stored.  Any H works: heads past H in the last head block are
// skipped.  Q comes from the caller.
//
// Exponents.  Never exp(cum_i) * exp(-cum_j): over a 256-row chunk cum
// falls to several hundred below zero and exp(-cum) overflows.  The
// intra-chunk exponent cum_i - cum_j is formed as the sum of dt*A over
// (j, i], accumulated from the diagonal outwards, and total - cum_j as the
// sum over (j, Q) from a reverse scan.  Both equal the reference's
// differences; summed this way their float32 error scales with the
// exponent itself, not with |cum|, so a decay near 1 late in a chunk keeps
// full precision (the difference of two large cums does not).
//
// Bound on this card: bytes.  At the LM-scoring shape (a shard of 11 rows
// x 2048 tokens, 64 heads of P = 64, N = 128, Q = 256, bf16) one launch
// moves x and y (184.5 MB each), B and C (11.5 MB) and dt (5.8 MB): 386 MB,
// 0.115 ms at 3.35 TB/s.  Its operations, counted per chunk as 2Q^2N
// (C.B^T) + Q(Q+1)HP (the masked M.x) + 2QNHP (carried term) + 2QNHP (state
// update), are 7.2e10: 0.073 ms at the bf16 tensor-core peak.  So bytes
// bound it (perf/roofline.py::ssd_scan_terms).
//
// Design: the first, simple version -- right before fast.  It runs in
// float32 on the CUDA cores, so the FP32 FMA rate (1.08 ms for those
// operations at 67 TFLOP/s) is its floor, far above the bytes bound.
//   * One CTA of 256 threads per (batch, block of 4 heads): 11 x 16 = 176
//     CTAs at the serving shape.  A block of 8 heads would halve the C.B^T
//     work per head but give 88 CTAs on 132 SMs and need 256 KB of state;
//     a block of 2 would leave the state at 64 KB but compute C.B^T once
//     per two heads.  The chunk loop is sequential inside the CTA.
//   * The 4 heads' states (N, P) live in shared memory for the whole
//     sequence (4 x 32 KB at N = 128, P = 64), as the TPU kernel keeps its
//     state in VMEM scratch across its sequential chunk axis.
//   * Each chunk is walked in 32-row sub-tiles.  For an output tile i the
//     carried term C_i.S is formed first (a 32 x N x P product per head,
//     4 x 8 outputs per thread), then the key tiles j = i, i-1, ..., 0:
//     C_i.B_j^T is computed once for the 4 heads, turned into the masked,
//     decayed M per head (the exponent carried across key tiles per row),
//     and M.x_j is added.  The state update follows once all of the
//     chunk's rows are out, so every row reads the chunk's carried-in
//     state; after the last chunk it is skipped.
//   * Shared memory: states 128 KB, C and B tiles (row pitch N+1), the x
//     tile of 4 heads, the C.B^T tile and three (4, Q) scan rows: 209 KB
//     at the serving shape, one CTA per SM.  With 8 warps per SM the tile
//     loads are latency-bound, so where every row is 16-byte aligned they
//     are 16-byte loads, all of a thread's issued before any is stored.
// The summation order is fixed by the tiling, so a repeat launch is
// bitwise identical.  The entry point takes raw pointers and element
// strides (P and N contiguous), launches on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HB = 4;         // heads per CTA
constexpr int T = 32;         // rows per sub-tile
constexpr int NT = 256;       // threads
constexpr int MAX_N = 128;    // state size N (4 rows per thread in the update)
constexpr int MAX_P = 64;     // head dim P (8 columns per thread)
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of TI: 8 bf16 or 4 float32
template <typename TI>
struct alignas(16) Vec {
  static constexpr int n = 16 / sizeof(TI);
  TI v[n];
};

// Rows q = r * nh + h (r < T, h < nh) of `cols` elements from
// base + r * rs + h * hs into dst + q * pitch, as float32; rows with
// r >= nvalid or h >= hvalid load as 0.  VEC: 16-byte loads, all issued
// into registers before any is stored (cols, rs, hs and base aligned to
// 16 bytes; at most 8 vectors per thread), so their latencies overlap.
template <typename TI, bool VEC>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const TI* __restrict__ base,
                                          int64_t rs, int64_t hs, int nh,
                                          int hvalid, int nvalid, int cols) {
  if (VEC) {
    constexpr int V = Vec<TI>::n;
    const int vpr = cols / V, total = T * nh * vpr;
    Vec<TI> buf[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = threadIdx.x + k * NT;
      const int q = e / vpr, r = q / nh, h = q % nh;
      if (e < total && r < nvalid && h < hvalid)
        buf[k] = *reinterpret_cast<const Vec<TI>*>(base + r * rs + h * hs +
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
      for (int i = 0; i < V; ++i) d[i] = ok ? to_f(buf[k].v[i]) : 0.f;
    }
  } else {
    const int total = T * nh * cols;
#pragma unroll 4
    for (int e = threadIdx.x; e < total; e += NT) {
      const int q = e / cols, r = q / nh, h = q % nh, k = e % cols;
      dst[q * pitch + k] =
          r < nvalid && h < hvalid ? to_f(base[r * rs + h * hs + k]) : 0.f;
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

template <typename TI, bool VEC>
__global__ void __launch_bounds__(NT, 1) ssd_scan_kernel(Args a) {
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

  const TI* __restrict__ x = static_cast<const TI*>(a.x);
  const TI* __restrict__ Bg = static_cast<const TI*>(a.B);
  const TI* __restrict__ Cg = static_cast<const TI*>(a.C);
  TI* __restrict__ y = static_cast<TI*>(a.y);
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
      load_tile<TI, VEC>(Cb, NP1, Cg + bi * a.C_sb + (l0 + i0) * a.C_sl,
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
        load_tile<TI, VEC>(Bm, NP1, Bg + bi * a.B_sb + (l0 + j0) * a.B_sl,
                           a.B_sl, 0, 1, 1, rows - j0, N);
        load_tile<TI, VEC>(X, P,
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
          TI* yr = y + ((bi * a.L + l0 + i) * a.H + h0 + yh) * a.P;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (tp + 8 * q < P) put(yr + tp + 8 * q, acc[r][q]);
        }
      }
      __syncthreads();  // Cb is reloaded by the next tile
    }

    // ---- state update: S <- exp(total) S + sum_j w_j B_j (x) x_j ---------
    if (c + 1 == nchunks) break;  // the final state is not returned
    for (int e = tid; e < HB * N * P; e += NT)
      S[e] *= expf(cum[(e / (N * P)) * Q + Q - 1]);
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * T;
      __syncthreads();
      load_tile<TI, VEC>(Bm, NP1, Bg + bi * a.B_sb + (l0 + j0) * a.B_sl,
                         a.B_sl, 0, 1, 1, rows - j0, N);
      load_tile<TI, VEC>(X, P,
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
}

template <typename TI, bool VEC>
cudaError_t launch_v(const Args& a, int64_t bytes, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<TI, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)a.b, (unsigned)((a.H + HB - 1) / HB));
  ssd_scan_kernel<TI, VEC><<<grid, NT, (size_t)bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int64_t bytes = 4 * smem_floats(a.N, a.P, a.Q);
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  // 16-byte loads where every row of x, B and C starts 16-byte aligned
  constexpr int V = Vec<TI>::n;
  const int64_t st[7] = {a.x_sb, a.x_sl, a.x_sh, a.B_sb, a.B_sl, a.C_sb,
                         a.C_sl};
  bool vec = a.P % V == 0 && a.N % V == 0 &&
             reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(a.B) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(a.C) % 16 == 0;
  for (int64_t s : st) vec = vec && s % V == 0;
  return vec ? launch_v<TI, true>(a, bytes, stream)
             : launch_v<TI, false>(a, bytes, stream);
}

}  // namespace

extern "C" {

// x (b, L, H, P) with element strides (batch, seq, head) and P contiguous;
// B, C (b, L, N) with strides (batch, seq) and N contiguous; dt (b, L, H)
// with strides (batch, seq, head); A, D (H,); y a new contiguous
// (b, L, H, P).  bf16 != 0 means bfloat16 x/B/C/y, else float32.  Grid:
// (b, ceil(H / 4)).
int ssd_scan_launch(const void* x, const void* B, const void* C,
                    const void* dt, const void* A, const void* D, void* y,
                    int64_t b, int64_t L, int64_t H, int64_t P, int64_t N,
                    int64_t Q, int64_t x_sb, int64_t x_sl, int64_t x_sh,
                    int64_t B_sb, int64_t B_sl, int64_t C_sb, int64_t C_sl,
                    int64_t d_sb, int64_t d_sl, int64_t d_sh, int64_t bf16,
                    void* stream) {
  if (b < 1 || b > 2147483647 || L < 1 || H < 1 || (H + HB - 1) / HB > 65535 ||
      P < 1 || P > MAX_P || N < 1 || N > MAX_N || Q < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{x, B, C, static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(D), y,
               b, L, H, P, N, Q, x_sb, x_sl, x_sh, B_sb, B_sl, C_sb, C_sl,
               d_sb, d_sl, d_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s));
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
