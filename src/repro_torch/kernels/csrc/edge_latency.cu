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
//   Bound: operations.  2*B*E*V^2 FP32 multiply-adds against 2*B*E*V + V^2
//   inputs; at V = 4096 that is ~1000 flops per byte, far above the card's
//   FP32 ridge, so the card's FP32 FMA rate (no tensor cores: TF32 misses the
//   1e-5 bar) is the limit.
//   Design: a classic shared-memory SGEMM tile with the max fused into the
//   epilogue.  A CTA owns 64 edge rows and walks every u-tile (128 wide); for
//   each it accumulates the 64x128 block of t over 16-deep v-tiles staged in
//   shared memory (x_j and com are both v-contiguous, so both tiles are
//   stored transposed, v-major), each of 256 threads holding a 4x8 register
//   tile.
//   Global loads for the next v-tile are issued before the current tile's
//   FMAs (register prefetch).  After the last v-tile the block is multiplied
//   by x_i and folded into a per-thread running row max, so t never reaches
//   device memory and no cross-CTA reduction is needed.  A shared com
//   (com batch 1, the (1, V, V) scenario the score grid sends) has batch
//   stride 0 and the caller flattens the (B, E) rows into one row axis, so
//   every CTA reuses the same com tiles from L2.  u >= V columns are skipped
//   before the max (never a 0 that could win over negative values) and
//   v >= V loads read as 0.
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
//   Bound: operations, as K1 (2*B*E*V^2 FP32 multiply-adds).  It is a
//   reference, not a fast path: one warp per edge row, each lane owning
//   u = lane, lane + 32, ..., so every com row is read from shared memory
//   once per warp.  The com tile's row pitch is odd (V or V + 1), so the
//   32 lanes' rows fall in 32 different banks.
//   Parity with K1: t[e, u] is ONE fmaf chain over ascending v from 0.0f
//   (K1's chain, which reads its v >= V padding as fmaf(0, 0, acc) == acc),
//   then x_i * t folds into a running fmaxf; nothing is split or
//   reassociated, and there is no u padding to mask.
//   Size: V*pitch + 8*V floats must fit the 227 KB a CTA can use, so
//   V <= 237; the wrapper refuses larger V before any launch.
//
// K4b, edge_latency_structured_single_tile_kernel, replaces
// repro.kernels.edge_latency.edge_latency_structured_pallas_single_tile
// (body _edge_latency_structured_single_tile_kernel): K2's function with
// a[c] (R, V), corr[c] (V) and the CTA's (8, R) mass rows resident.
//   Bound: bytes, as K2.  Same thread layout as K4a; lanes read
//   consecutive u of a[c], one bank each.
//   Parity with K2: t is one fmaf chain over ascending r from 0.0f, and
//   the epilogue is K2's own helper (structured_term), an explicit
//   fmaf(c, x_j, t) times x_i, so no contraction choice of the compiler
//   can differ between the two kernels.
//   Size: (R + 1)*V + 8*R floats within 227 KB (V <= 6449 at R = 8).
//
// Summation order is fixed by the tiling, so a repeat launch on the same
// inputs is bitwise identical.  Each entry point takes raw pointers, element
// strides and the CUDA stream, launches on that stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// The structured epilogue x_i * (t + c * x_j), written once for K2 and K4b
// with the multiply-add explicit: left to the compiler's contraction, the
// two kernels could round it differently.
__device__ __forceinline__ float structured_term(float x_i, float t, float c,
                                                 float x_j) {
  return x_i * fmaf(c, x_j, t);
}

// -- K1: dense ---------------------------------------------------------------
//
// A CTA tile of BM edge rows x BN u columns over BK-deep v-tiles; each of the
// (BM/TM)*(BN/TN) threads holds a TM x TN register tile made of float4
// groups (TM/4 row groups BM/(TM/4) apart, TN/4 column groups BN/(TN/4)
// apart), so its shared-memory reads are 16-byte and bank-conflict free.
// The row group's BN/TN threads are consecutive lanes of one warp, which
// lets the final row max reduce with shuffles.

// __launch_bounds__(threads, 1): one CTA per SM is all the register tile
// allows anyway, and saying so frees the compiler to keep the prefetch and
// the accumulators in registers (without it ptxas squeezes to fewer
// registers and the kernel ran slower on the H100).
template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), 1)
edge_latency_dense_kernel(const float* __restrict__ xi,
                          const float* __restrict__ xj,
                          const float* __restrict__ com,
                          float* __restrict__ out,
                          int64_t rows, int64_t V,
                          int64_t x_bs, int64_t x_rs,
                          int64_t com_bs, int64_t com_rs,
                          int64_t out_bs) {
  constexpr int TX = BN / TN, T = TX * (BM / TM);
  constexpr int ALOADS = BM * BK / T, BLOADS = BN * BK / T;
  constexpr int MS = BM / (TM / 4), NS = BN / (TN / 4);   // group strides
  // pitch +4 keeps rows 16-byte aligned; the transposed stores conflict
  // at most 2-way
  __shared__ __align__(16) float As[BK][BM + 4];   // x_j tile, [v][row]
  __shared__ __align__(16) float Bs[BK][BN + 4];   // com tile, [v][u]

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int64_t b = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const float* xi_b = xi + b * x_bs;
  const float* xj_b = xj + b * x_bs;
  const float* com_b = com + b * com_bs;

  float rmax[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) rmax[i] = neg_inf();
  float a_reg[ALOADS], b_reg[BLOADS];

  for (int64_t u0 = 0; u0 < V; u0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    // prefetch v-tile 0 of this u-tile: consecutive threads read
    // consecutive v of one row
#pragma unroll
    for (int l = 0; l < ALOADS; ++l) {
      const int idx = tid + l * T;
      const int64_t r = row0 + idx / BK, v = idx % BK;
      a_reg[l] = (r < rows && v < V) ? xj_b[r * x_rs + v] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < BLOADS; ++l) {
      const int idx = tid + l * T;
      const int64_t u = u0 + idx / BK, v = idx % BK;
      b_reg[l] = (u < V && v < V) ? com_b[u * com_rs + v] : 0.f;
    }

    for (int64_t v0 = 0; v0 < V; v0 += BK) {
      __syncthreads();   // the previous tile's FMAs are done with As/Bs
#pragma unroll
      for (int l = 0; l < ALOADS; ++l) {
        const int idx = tid + l * T;
        As[idx % BK][idx / BK] = a_reg[l];
      }
#pragma unroll
      for (int l = 0; l < BLOADS; ++l) {
        const int idx = tid + l * T;
        Bs[idx % BK][idx / BK] = b_reg[l];
      }
      __syncthreads();

      const int64_t vn = v0 + BK;   // issue the next tile's loads now
      if (vn < V) {
#pragma unroll
        for (int l = 0; l < ALOADS; ++l) {
          const int idx = tid + l * T;
          const int64_t r = row0 + idx / BK, v = vn + idx % BK;
          a_reg[l] = (r < rows && v < V) ? xj_b[r * x_rs + v] : 0.f;
        }
#pragma unroll
        for (int l = 0; l < BLOADS; ++l) {
          const int idx = tid + l * T;
          const int64_t u = u0 + idx / BK, v = vn + idx % BK;
          b_reg[l] = (u < V && v < V) ? com_b[u * com_rs + v] : 0.f;
        }
      }

#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int g = 0; g < TM / 4; ++g) {
          const float4 t =
              *reinterpret_cast<const float4*>(&As[k][g * MS + ty * 4]);
          av[4 * g] = t.x; av[4 * g + 1] = t.y;
          av[4 * g + 2] = t.z; av[4 * g + 3] = t.w;
        }
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 t =
              *reinterpret_cast<const float4*>(&Bs[k][g * NS + tx * 4]);
          bv[4 * g] = t.x; bv[4 * g + 1] = t.y;
          bv[4 * g + 2] = t.z; bv[4 * g + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    // epilogue: fold this u-tile into the running row max; u >= V columns
    // are skipped, never compared as 0
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t r = row0 + (i / 4) * MS + ty * 4 + i % 4;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int64_t u = u0 + (j / 4) * NS + tx * 4 + j % 4;
        if (u < V) rmax[i] = fmaxf(rmax[i], xi_b[r * x_rs + u] * acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], off));
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t r = row0 + (i / 4) * MS + ty * 4 + i % 4;
      if (r < rows) out[b * out_bs + r] = rmax[i];
    }
  }
}

// The instantiation the wrapper launches: fixed constants until the block
// policy (K3 in ROADMAP.md) picks them per shape.
constexpr int D_BM = 64, D_BN = 128, D_BK = 16, D_TM = 4, D_TN = 8;
constexpr int D_THREADS = (D_BM / D_TM) * (D_BN / D_TN);   // 256

// -- K2: structured (region-factored) ----------------------------------------

constexpr int S_ROWS = 8;       // edge rows per CTA
constexpr int S_THREADS = 256;
constexpr int S_UNROLL = 4;     // u columns per thread per step, S_THREADS apart

// two CTAs per SM (≤128 registers, no spills) keep more loads in flight
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
  extern __shared__ float smass[];                  // [S_ROWS][R]
  __shared__ float red[S_THREADS / 32][S_ROWS];

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * S_ROWS;
  const int nrows = rows - row0 < S_ROWS ? (int)(rows - row0) : S_ROWS;
  const float* xi_b = xi + b * x_bs + row0 * x_rs;
  const float* xj_b = xj + b * x_bs + row0 * x_rs;
  const float* mass_b = mass + b * mass_bs + row0 * mass_rs;
  const float* a_b = a + b * a_bs;
  const float* corr_b = corr + b * corr_bs;

  for (int64_t idx = tid; idx < S_ROWS * R; idx += S_THREADS) {
    const int64_t i = idx / R, r = idx % R;
    smass[idx] = i < nrows ? mass_b[i * mass_rs + r] : 0.f;
  }
  __syncthreads();

  float m[S_ROWS];
#pragma unroll
  for (int i = 0; i < S_ROWS; ++i) m[i] = neg_inf();

  for (int64_t ub = 0; ub < V; ub += (int64_t)S_THREADS * S_UNROLL) {
#pragma unroll
    for (int s = 0; s < S_UNROLL; ++s) {
      const int64_t u = ub + (int64_t)s * S_THREADS + tid;
      if (u >= V) break;
      float x_i[S_ROWS], x_j[S_ROWS], t[S_ROWS];
#pragma unroll
      for (int i = 0; i < S_ROWS; ++i) {
        x_i[i] = i < nrows ? xi_b[i * x_rs + u] : 0.f;
        x_j[i] = i < nrows ? xj_b[i * x_rs + u] : 0.f;
        t[i] = 0.f;
      }
      const float c = corr_b[u];
      for (int64_t r = 0; r < R; ++r) {
        const float av = __ldg(a_b + r * a_rs + u);
#pragma unroll
        for (int i = 0; i < S_ROWS; ++i) t[i] = fmaf(smass[i * R + r], av, t[i]);
      }
#pragma unroll
      for (int i = 0; i < S_ROWS; ++i)
        if (i < nrows)
          m[i] = fmaxf(m[i], structured_term(x_i[i], t[i], c, x_j[i]));
    }
  }

  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int i = 0; i < S_ROWS; ++i) {
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

constexpr int T_ROWS = 8;                 // edge rows per CTA, one warp each
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

  const int64_t e = e0 + warp;
  if (e >= E) return;                      // no barrier follows
  const float* xi_row = xi + b * x_bs + e * V;
  const float* xj_row = xj_s + (int64_t)warp * V;
  float m = neg_inf();
  for (int64_t u = lane; u < V; u += 32) {
    const float* com_row = com_s + u * pitch;
    float t = 0.f;
    for (int64_t v = 0; v < V; ++v) t = fmaf(com_row[v], xj_row[v], t);
    m = fmaxf(m, xi_row[u] * t);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[b * out_bs + e] = m;
}

__global__ void __launch_bounds__(T_THREADS)
edge_latency_structured_single_tile_kernel(const float* __restrict__ xi,
                                           const float* __restrict__ xj,
                                           const float* __restrict__ mass,
                                           const float* __restrict__ a,
                                           const float* __restrict__ corr,
                                           float* __restrict__ out,
                                           int64_t E, int64_t V, int64_t R,
                                           int64_t x_bs, int64_t mass_bs,
                                           int64_t a_bs, int64_t corr_bs,
                                           int64_t out_bs) {
  extern __shared__ float smem[];
  float* a_s = smem;                       // [R][V]
  float* corr_s = smem + R * V;            // [V]
  float* mass_s = corr_s + V;              // [T_ROWS][R]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t b = blockIdx.y;
  const int64_t e0 = (int64_t)blockIdx.x * T_ROWS;
  const float* a_b = a + b * a_bs;
  const float* corr_b = corr + b * corr_bs;
  const float* mass_b = mass + b * mass_bs;

  for (int64_t idx = tid; idx < R * V; idx += T_THREADS) a_s[idx] = a_b[idx];
  for (int64_t idx = tid; idx < V; idx += T_THREADS) corr_s[idx] = corr_b[idx];
  for (int64_t idx = tid; idx < T_ROWS * R; idx += T_THREADS) {
    const int64_t e = e0 + idx / R;
    mass_s[idx] = e < E ? mass_b[e * R + idx % R] : 0.f;
  }
  __syncthreads();

  const int64_t e = e0 + warp;
  if (e >= E) return;                      // no barrier follows
  const float* xi_row = xi + b * x_bs + e * V;
  const float* xj_row = xj + b * x_bs + e * V;
  const float* mass_row = mass_s + (int64_t)warp * R;
  float m = neg_inf();
  for (int64_t u = lane; u < V; u += 32) {
    float t = 0.f;
    for (int64_t r = 0; r < R; ++r) t = fmaf(mass_row[r], a_s[r * V + u], t);
    m = fmaxf(m, structured_term(xi_row[u], t, corr_s[u], xj_row[u]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[b * out_bs + e] = m;
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

}  // namespace

extern "C" {

// K1.  n_batch CTAs rows along grid.y (1 when com is shared and the caller
// flattened (B, E) into rows); com_bs = 0 shares one com across batches.
int edge_latency_dense_launch(const float* xi, const float* xj,
                              const float* com, float* out,
                              int64_t n_batch, int64_t rows, int64_t V,
                              int64_t x_bs, int64_t x_rs,
                              int64_t com_bs, int64_t com_rs,
                              int64_t out_bs, void* stream) {
  const int64_t blocks = (rows + D_BM - 1) / D_BM;
  if (n_batch < 1 || n_batch > 65535 || blocks < 1 || blocks > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)blocks, (unsigned)n_batch);
  edge_latency_dense_kernel<D_BM, D_BN, D_BK, D_TM, D_TN>
      <<<grid, D_THREADS, 0, (cudaStream_t)stream>>>(
          xi, xj, com, out, rows, V, x_bs, x_rs, com_bs, com_rs, out_bs);
  return (int)cudaGetLastError();
}

// K2.  a_bs = corr_bs = 0 shares one scenario across batches.  The (8, R)
// mass tile lives in dynamic shared memory, so R is bounded by the 227 KB a
// CTA can use (R <= ~7200); a larger R fails cudaFuncSetAttribute.
int edge_latency_structured_launch(const float* xi, const float* xj,
                                   const float* mass, const float* a,
                                   const float* corr, float* out,
                                   int64_t n_batch, int64_t rows, int64_t V,
                                   int64_t R, int64_t x_bs, int64_t x_rs,
                                   int64_t mass_bs, int64_t mass_rs,
                                   int64_t a_bs, int64_t a_rs,
                                   int64_t corr_bs, int64_t out_bs,
                                   void* stream) {
  const int64_t blocks = (rows + S_ROWS - 1) / S_ROWS;
  if (n_batch < 1 || n_batch > 65535 || blocks < 1 || blocks > 0x7fffffff ||
      R < 1)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)S_ROWS * (size_t)R * sizeof(float);
  const cudaError_t err = allow_smem(edge_latency_structured_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)blocks, (unsigned)n_batch);
  edge_latency_structured_kernel<<<grid, S_THREADS, smem,
                                   (cudaStream_t)stream>>>(
      xi, xj, mass, a, corr, out, rows, V, R, x_bs, x_rs, mass_bs, mass_rs,
      a_bs, a_rs, corr_bs, out_bs);
  return (int)cudaGetLastError();
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
// memory: (R + 1)*V + 8*R floats.
int edge_latency_structured_single_tile_launch(
    const float* xi, const float* xj, const float* mass, const float* a,
    const float* corr, float* out, int64_t n_batch, int64_t E, int64_t V,
    int64_t R, int64_t x_bs, int64_t mass_bs, int64_t a_bs, int64_t corr_bs,
    int64_t out_bs, void* stream) {
  const int64_t blocks = (E + T_ROWS - 1) / T_ROWS;
  if (n_batch < 1 || n_batch > 65535 || blocks < 1 || blocks > 0x7fffffff ||
      V < 1 || R < 1)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * (size_t)((R + 1) * V + T_ROWS * R);
  const cudaError_t err =
      allow_smem(edge_latency_structured_single_tile_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)blocks, (unsigned)n_batch);
  edge_latency_structured_single_tile_kernel<<<grid, T_THREADS, smem,
                                               (cudaStream_t)stream>>>(
      xi, xj, mass, a, corr, out, E, V, R, x_bs, mass_bs, a_bs, corr_bs,
      out_bs);
  return (int)cudaGetLastError();
}

const char* edge_latency_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
