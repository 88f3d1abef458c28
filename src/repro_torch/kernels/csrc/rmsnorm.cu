// RMSNorm (K7) for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm.py:30
// (rmsnorm_pallas, body _rmsnorm_kernel :22), which computes what
// src/repro/models/layers.py::rms_norm computes with a weight:
//
//     y = (x * rsqrt(mean(x^2) + eps)) * w
//
// per row of x (rows, D), in float32 (the mean is the sum of squares over
// D, divided by D), rounded once to x's dtype (bfloat16 to nearest even).
// x is float32 or bfloat16, w is float32 (the parameters are float32).  Any
// row count and any D: 2048 and 4096 in Mamba2-1.3B's block and gate norms,
// 1536 / 3072 or 2560 / 5120 in its 780m and 2.7B siblings, 128 for a
// qk-norm.
//
// Bound on this card: bytes.  It reads x once, w once and writes y once,
// with ~4 operations per element: at the LM-scoring shape (22 528 rows of
// one shard, bf16) the block norm (D = 2048) moves 184.5 MB, 0.055 ms at
// 3.35 TB/s, and the gate norm (D = 4096) 369 MB, 0.110 ms.
//
// Two kernels.  Both give one warp to a row and sum its squares in the
// same fixed order, so a repeat launch is bitwise identical:
//   lane l takes the 16-byte vectors k = l, l + 32, l + 64, ... of the row
//   (8 bf16 or 4 float32 each; single elements on the scalar path) and
//   sums f * f over them with fmaf, vector by vector, element by element;
//   the 32 lane partials meet in a shuffle butterfly (xor 16, 8, 4, 2, 1).
//
// rmsnorm_rows_kernel, for every D whose row is whole 16-byte vectors, up
// to 32 per lane (D <= 8192 bf16, 4096 float32), with 16-byte aligned
// operands.  A template on the vectors a lane holds, NV, rounded up to one
// of the instantiated counts (ROWS_NV below); a lane's vectors past the
// row's end are zeros, which add nothing to the sum and are not stored.
// The row is read from device memory once, into registers, and stays
// there across the reduction; the scaled row is written from them.  w is
// staged once per CTA in shared memory as P = (elements per vector) / 4
// planes of float4, plane h holding w[n*k + 4h .. n*k + 4h + 3] at index
// k, so the lanes of a warp read consecutive float4s (no bank conflict)
// where they read x's vector k.  The grid is persistent (CTAs per SM x
// SMs, from the occupancy calculator): each warp walks rows gridDim.x * 4
// apart and, where the registers allow it (NV <= 16: bf16 D <= 4096,
// float32 D <= 2048), loads its next row before it reduces the current
// one, so the next row's loads are in flight behind the reduction and the
// stores.  x is read with the L2 256-byte prefetch hint.  (A ring of rows
// in shared memory filled by 1-D bulk copies (TMA) was tried and was no
// faster.)
//
// rmsnorm_kernel, every other D or an operand that is not 16-byte aligned:
// 8 rows per CTA, the row read twice (the second pass from L1/L2), with
// 16-byte loads of x and w where D and the pointers allow it, else one
// element at a time.
//
// The entry point takes raw pointers, launches on the given stream and
// returns cudaGetLastError().
//
// The backward (K7's gradient; the Pallas kernel has none: JAX cannot
// differentiate it, so the reference trains through rms_norm's plain math,
// and the port's forward needs a hand-written gradient to train on the
// card).  With g the upstream gradient in x's dtype and r = rsqrt(mean(x^2)
// + eps) recomputed from x (the forward stores nothing extra):
//
//     dx = r * (g * w) - x * r^3 * mean(x * g * w)   rounded once to x's dtype
//     dw = sum over rows of g * x * r                 float32
//
// Bound on this card: bytes.  It reads x and g and writes dx (w and dw are
// one row): at 8 192 x 4 096 bf16 201 MB, 0.060 ms at 3.35 TB/s.
//
// The grid is a function of rows and D alone (bwd_grid): a CTA for every 8
// rows, at most 264 (two on each of the H100's 132 SMs) for rows of 2048
// elements or more, up to 8 times as many for narrower rows.  CTA b of G
// takes the rows b, b + G, b + 2G, ... (the grid sweeps x, g and dx
// together, as the forward's warps do; a contiguous run of rows a CTA is
// slower on the H100: tools/k7_bwd_probe.py, variant "runs"); a CTA has
// BT threads (32 <= BT <= 256, enough for one row), thread t the loads k
// = t, t + BT, ... of a row.  Per row the two sums (x*x and x*g*w) meet in a xor
// butterfly per warp, then the warps' partials in shared memory are added
// in warp order by every thread: one barrier a row.  Where a thread holds
// at most 16 values of a row (D <= 4096 bf16 or float32), it unpacks them
// once and keeps g * w from the sums for dx.
//
// rmsnorm_bwd_ring_kernel, for rows of whole 16-byte vectors (up to 4 a
// thread: D <= 8192 bf16, 4096 float32) with 16-byte aligned operands.
// The CTA streams its rows through a ring of S stages in shared memory,
// S - 1 rows ahead of the one it reduces (cp.async, 16 bytes a copy; 6, 4
// or 2 stages for 1, 2 or 4 vectors a thread: a ring of at most 64 KB), so
// the bytes in flight do not wait on the row's barrier.  A thread copies
// and reads back only its own vectors, so the ring itself needs no
// barrier: a stage is refilled by the thread that has just read it.  The
// forward needs no ring (a TMA ring was no faster there): a warp holds its
// row and the next in registers with no CTA barrier; the backward has two
// input streams and a barrier a row, so registers alone would hold at
// most one row ahead.  w is staged once per CTA as float4 planes (as the
// forward's), the thread's dw columns are summed in registers.  At the
// end each CTA writes its dw partial to one row of a (G, D) float32
// scratch, and where the device holds the whole grid at once the launch
// is cooperative: the CTAs meet at a grid barrier and sum the partials
// into dw in the same launch.  Otherwise rmsnorm_bwd_dw_kernel sums them
// in a launch of its own, in the same order: tiles of 16 columns, each
// column's partials added over p = s, s + 16, ... for 16 slices s, the
// slices then added in order.  No atomics in any sum: a repeat launch is
// bitwise identical, and the order is the same on any card.
//
// rmsnorm_bwd_scalar_kernel, every other row (D not whole vectors, or an
// operand not 16-byte aligned): one element a load, w and the thread's dw
// columns in registers, the next row loaded before the current one is
// reduced where the registers allow; the dw sum is its own launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "grid.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

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

// element i of a 16-byte vector of TI, held as a uint4, as float32 (a
// bf16 is the high half of its float32)
template <typename TI>
__device__ __forceinline__ float elem(const uint4& u, int i) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(TI) == 4)
    return __uint_as_float(w[i]);
  else
    return __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
}

// n float32 values rounded to a 16-byte vector of TI
__device__ __forceinline__ uint4 pack(const float (&o)[4], float) {
  return make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                    __float_as_uint(o[2]), __float_as_uint(o[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&o)[8], __nv_bfloat16) {
  return make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]), pack2(o[4], o[5]),
                    pack2(o[6], o[7]));
}

// -- rows of whole 16-byte vectors: the row in registers ----------------------

constexpr int RT = 128;          // threads of a rows-kernel CTA
constexpr int RW = RT / 32;      // its warps, one row each at a time

// 16 bytes from device memory on the read-only path, asking L2 to fetch
// the whole 256-byte block around it
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

// a lane's vectors k = j * 32 + lane of a row of nv vectors; zeros past it
template <int NV>
__device__ __forceinline__ void load_row(uint4 (&r)[NV], const uint4* row,
                                         int lane, int nv) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = j * 32 + lane;
    r[j] = k < nv ? ld_stream(row + k) : make_uint4(0, 0, 0, 0);
  }
}

template <typename TI, int NV>
__global__ void __launch_bounds__(RT) rmsnorm_rows_kernel(
    const TI* __restrict__ x, const float* __restrict__ w, TI* __restrict__ y,
    int64_t rows, int nv, float eps) {
  constexpr int n = Vec<TI>::n;
  constexpr int P = n / 4;                 // float4s of w per x vector
  constexpr bool PREFETCH = NV <= 16;      // two rows fit the registers
  __shared__ float4 w_s[P][NV * 32];
  const int D = nv * n;                    // nv: 16-byte vectors per row

  const float4* w4 = reinterpret_cast<const float4*>(w);
  for (int i = threadIdx.x; i < D / 4; i += RT) w_s[i % P][i / P] = w4[i];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int64_t stride = (int64_t)gridDim.x * RW;
  int64_t row = (int64_t)blockIdx.x * RW + threadIdx.x / 32;
  if (row >= rows) return;                 // no barrier follows
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  uint4 cur[NV], nxt[NV];
  load_row<NV>(cur, xv + row * nv, lane, nv);
  for (;;) {
    const int64_t next = row + stride;
    if (PREFETCH && next < rows) load_row<NV>(nxt, xv + next * nv, lane, nv);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const float f = elem<TI>(cur[j], i);
        ss = fmaf(f, f, ss);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      ss += __shfl_xor_sync(FULL, ss, off);
    const float inv = rsqrtf(ss / (float)D + eps);
    uint4* yr = yv + row * nv;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = j * 32 + lane;
      if (k >= nv) break;
      float o[n];
#pragma unroll
      for (int h = 0; h < P; ++h) {
        const float4 wv = w_s[h][k];
        const float wh[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          o[4 * h + q] = (elem<TI>(cur[j], 4 * h + q) * inv) * wh[q];
      }
      yr[k] = pack(o, TI());
    }
    if (next >= rows) break;
    row = next;
    if (PREFETCH) {
#pragma unroll
      for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
    } else {
      load_row<NV>(cur, xv + row * nv, lane, nv);
    }
  }
}

// -- every other D: two passes over the row -----------------------------------

constexpr int ROWS = 8;  // rows (warps) per CTA
constexpr int NT = 32 * ROWS;

template <typename TI, bool VEC>
__global__ void __launch_bounds__(NT) rmsnorm_kernel(
    const TI* __restrict__ x, const float* __restrict__ w, TI* __restrict__ y,
    int64_t rows, int64_t D, float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= rows) return;
  const TI* xr = x + row * D;
  TI* yr = y + row * D;
  constexpr int V = Vec<TI>::n;
  float ss = 0.f;
  if (VEC) {
    const Vec<TI>* xv = reinterpret_cast<const Vec<TI>*>(xr);
    for (int64_t k = lane; k < D / V; k += 32) {
      const Vec<TI> t = xv[k];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = to_f(t.v[i]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int64_t k = lane; k < D; k += 32) {
      const float f = to_f(xr[k]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    ss += __shfl_xor_sync(FULL, ss, off);
  const float inv = rsqrtf(ss / (float)D + eps);
  if (VEC) {
    const Vec<TI>* xv = reinterpret_cast<const Vec<TI>*>(xr);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    Vec<TI>* yv = reinterpret_cast<Vec<TI>*>(yr);
    for (int64_t k = lane; k < D / V; k += 32) {
      const Vec<TI> t = xv[k];
      Vec<TI> o;
#pragma unroll
      for (int h = 0; h < V / 4; ++h) {
        const float4 wv = __ldg(w4 + k * (V / 4) + h);
        const float wh[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          put(&o.v[4 * h + q], (to_f(t.v[4 * h + q]) * inv) * wh[q]);
      }
      yv[k] = o;
    }
  } else {
    for (int64_t k = lane; k < D; k += 32)
      put(yr + k, (to_f(xr[k]) * inv) * w[k]);
  }
}

// the rows kernel's instantiated vectors per lane: a row of nv vectors
// takes the first count >= ceil(nv / 32)
constexpr int ROWS_NV[] = {1, 2, 4, 8, 12, 16, 20, 24, 32};
constexpr int N_ROWS_NV = sizeof(ROWS_NV) / sizeof(ROWS_NV[0]);

template <typename TI, int I = 0>
cudaError_t launch_rows(const TI* x, const float* w, TI* y, int64_t rows,
                        int nv, float eps, cudaStream_t s) {
  constexpr int NV = ROWS_NV[I];
  if constexpr (I + 1 < N_ROWS_NV) {
    if (nv > NV * 32)
      return launch_rows<TI, I + 1>(x, w, y, rows, nv, eps, s);
  }
  const auto kernel = rmsnorm_rows_kernel<TI, NV>;
  unsigned grid = 0;
  const cudaError_t err = persistent_grid(kernel, RT, 0, (rows + RW - 1) / RW,
                                          &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, RT, 0, s>>>(x, w, y, rows, nv, eps);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch(const void* x, const void* w, void* y, int64_t rows,
                   int64_t D, float eps, cudaStream_t s) {
  constexpr int n = Vec<TI>::n;
  const bool vec = D % n == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const TI* xp = static_cast<const TI*>(x);
  const float* wp = static_cast<const float*>(w);
  TI* yp = static_cast<TI*>(y);
  if (vec && D / n <= 32 * ROWS_NV[N_ROWS_NV - 1])
    return launch_rows<TI>(xp, wp, yp, rows, (int)(D / n), eps, s);
  const unsigned grid = (unsigned)((rows + ROWS - 1) / ROWS);
  if (vec)
    rmsnorm_kernel<TI, true><<<grid, NT, 0, s>>>(xp, wp, yp, rows, D, eps);
  else
    rmsnorm_kernel<TI, false><<<grid, NT, 0, s>>>(xp, wp, yp, rows, D, eps);
  return cudaGetLastError();
}

// -- the backward -------------------------------------------------------------

constexpr int BWD_BT = 256;               // the most threads of a CTA
constexpr int BWD_MAX_D = 8192;
// the grid: one CTA per BWD_MIN_ROWS rows, at most BWD_CTAS (two on each
// of the H100's 132 SMs) for rows of BWD_WIDE_D or more elements, and up
// to BWD_SPREAD times as many for narrower rows (their CTAs are narrower)
constexpr int64_t BWD_MIN_ROWS = 8;
constexpr int64_t BWD_CTAS = 264;
constexpr int64_t BWD_WIDE_D = 2048;
constexpr int64_t BWD_SPREAD = 8;
// dw's sum over the P partials: min(P, DW_SLICES) slices; the dw kernel's
// CTA takes DW_COLS columns
constexpr int DW_COLS = 16, DW_SLICES = 16, DW_T = DW_COLS * DW_SLICES;

// the CTAs of the backward's grid, and so the rows of its dw scratch
inline int64_t bwd_grid(int64_t rows, int64_t D) {
  int64_t spread = BWD_WIDE_D / D;
  spread = spread < 1 ? 1 : spread > BWD_SPREAD ? BWD_SPREAD : spread;
  const int64_t by_rows = (rows + BWD_MIN_ROWS - 1) / BWD_MIN_ROWS;
  return by_rows < BWD_CTAS * spread ? by_rows : BWD_CTAS * spread;
}

// threads of a backward CTA for rows of nv loads: enough for one row, up
// to BWD_BT, a whole number of warps
inline int bwd_threads(int nv) {
  return nv >= BWD_BT ? BWD_BT : (nv + 31) / 32 * 32;
}

// the rows of CTA b of G: b, b + G, b + 2G, ... (first + i * step for 0 <=
// i < count), so that the grid sweeps x, g and dx together, as one stream
struct RowRun {
  int64_t first, step, count;
  __device__ __forceinline__ int64_t row(int64_t i) const {
    return first + i * step;
  }
};
__device__ __forceinline__ RowRun bwd_rows(int64_t rows) {
  const int64_t G = gridDim.x, b = blockIdx.x;
  return {b, G, b < rows ? (rows - b + G - 1) / G : 0};
}

// the per-row sums of the threads (x*x and x*g*w) added across the CTA:
// a xor butterfly per warp, then the warps' partials in warp order by
// every thread.  One barrier a row: the slot alternates with the parity
// of the CTA's row count i, and a warp writes a slot again only after
// every warp has passed the barrier between.
__device__ __forceinline__ float2 bwd_row_sums(float ss, float sg,
                                               float2 (&red)[2][BWD_BT / 32],
                                               int64_t i) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    ss += __shfl_xor_sync(FULL, ss, off);
    sg += __shfl_xor_sync(FULL, sg, off);
  }
  float2* slot = red[i & 1];
  if (threadIdx.x % 32 == 0) slot[threadIdx.x / 32] = make_float2(ss, sg);
  __syncthreads();
  ss = 0.f;
  sg = 0.f;
  for (int i = 0; i < (int)blockDim.x / 32; ++i) {
    ss += slot[i].x;
    sg += slot[i].y;
  }
  return make_float2(ss, sg);
}

// the slices of dw's sum over P partials
__host__ __device__ __forceinline__ int dw_slices(int64_t P) {
  return P < DW_SLICES ? (int)P : DW_SLICES;
}

// columns of dw a CTA of the fused launch sums: an even share of D over
// the G CTAs, rounded up to a multiple of DW_COLS
__host__ __device__ __forceinline__ int dw_share(int D, int64_t G) {
  const int64_t share = (D + G - 1) / G;
  return (int)((share + DW_COLS - 1) / DW_COLS * DW_COLS);
}

// dw[c] for the W columns c0 <= c < c0 + W: with SL = dw_slices(P), slice
// s of column c adds partial[p, c] over p = s, s + SL, ... in order (into
// s_[s * W + c - c0]), then the SL slices are added in order.  The CTA's
// threads take the SL * W (slice, column) pairs in turn, so the order is
// a function of P alone.  Loads through L2 (ld.cg): the partials may have
// been written by other CTAs of the same launch.
__device__ __forceinline__ void dw_sum(const float* __restrict__ partial,
                                       float* __restrict__ dw, int64_t P,
                                       int D, int c0, int W, float* s_) {
  const int SL = dw_slices(P);
  for (int v = threadIdx.x; v < SL * W; v += blockDim.x) {
    const int c = c0 + v % W;
    float a = 0.f;
    if (c < D) {
#pragma unroll 16
      for (int64_t p = v / W; p < P; p += SL)
        a += __ldcg(partial + p * D + c);
    }
    s_[v] = a;
  }
  __syncthreads();
  for (int col = threadIdx.x; col < W; col += blockDim.x) {
    if (c0 + col >= D) break;
    float total = 0.f;
    for (int i = 0; i < SL; ++i) total += s_[i * W + col];
    dw[c0 + col] = total;
  }
}

// the dw sum as a launch of its own: DW_COLS columns a CTA
__global__ void __launch_bounds__(DW_T) rmsnorm_bwd_dw_kernel(
    const float* __restrict__ partial, float* __restrict__ dw, int64_t P,
    int D) {
  __shared__ float s_[DW_SLICES * DW_COLS];
  dw_sum(partial, dw, P, D, blockIdx.x * DW_COLS, DW_COLS, s_);
}

// 16 bytes from device memory into shared memory, through L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the most dynamic shared memory a backward CTA asks for: the largest ring
// (NV 4 bf16: 2 stages of x and g, w) is 96 KB, the fused sum's slices
// (D + 16 * DW_SLICES floats at most) 33 KB
constexpr int BWD_SMEM = 96 * 1024;

// the ring's stages for NV 16-byte loads a thread: S - 1 rows in flight
// behind the one being reduced, a ring of at most 64 KB at 256 threads
__host__ __device__ constexpr int ring_stages(int NV) {
  return NV == 1 ? 6 : NV == 2 ? 4 : 2;
}

// a thread's 16-byte vectors k = t, t + BT, ... of row `row` of x and of g
// into stage `st` of the ring ([S][x, g][nv] vectors)
template <typename TI, int NV>
__device__ __forceinline__ void ring_fill(uint4* ring, int st, int nv,
                                          const TI* x, const TI* g,
                                          int64_t row, int D) {
  const uint4* xs = reinterpret_cast<const uint4*>(x + row * D);
  const uint4* gs = reinterpret_cast<const uint4*>(g + row * D);
  uint4* dst = ring + (size_t)st * 2 * nv;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = threadIdx.x + j * blockDim.x;
    if (k < nv) {
      cp_async16(dst + k, xs + k);
      cp_async16(dst + nv + k, gs + k);
    }
  }
}

// the backward for rows of whole 16-byte vectors with 16-byte aligned
// operands: a CTA streams its run of rows through a ring of S stages in
// shared memory, S - 1 rows ahead (cp.async; a thread copies and reads
// back only its own vectors, so the ring needs no barrier), w staged once
// as float4 planes (as the forward's), its dw partial in registers, one
// barrier a row.  With `fused` (a cooperative launch: every CTA resident)
// the CTAs then meet at a grid barrier and sum the partials into dw.
template <typename TI, int NV, int S>
__global__ void __launch_bounds__(BWD_BT, 2) rmsnorm_bwd_ring_kernel(
    const TI* __restrict__ x, const float* __restrict__ w,
    const TI* __restrict__ g, TI* __restrict__ dx,
    float* __restrict__ partial, float* __restrict__ dw, int64_t rows, int D,
    float eps, int fused) {
  constexpr int n = Vec<TI>::n;
  constexpr int P = n / 4;                 // float4s of w per vector
  // where the registers allow (16 values a thread), a row's values are
  // unpacked once and g * w kept from the sums for dx; else unpacked again
  // and w read again
  constexpr bool KEEP = NV * n <= 16;
  extern __shared__ uint4 ring[];          // [S][2][nv], then w [P][nv]
  __shared__ float2 red[2][BWD_BT / 32];
  const int t = threadIdx.x, BT = blockDim.x, nv = D / n;
  float4* w_s = reinterpret_cast<float4*>(ring + (size_t)S * 2 * nv);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  for (int i = t; i < D / 4; i += BT) w_s[(i % P) * nv + i / P] = w4[i];
  __syncthreads();

  const RowRun run = bwd_rows(rows);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < run.count) ring_fill<TI, NV>(ring, s, nv, x, g, run.row(s), D);
    cp_async_commit();
  }
  float acc[NV][n];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < n; ++i) acc[j][i] = 0.f;
  int st = 0;                              // the stage of row i
  for (int64_t i = 0; i < run.count; ++i) {
    const int64_t row = run.row(i);
    // the stage of the row before, read back by this thread already
    if (i + S - 1 < run.count)
      ring_fill<TI, NV>(ring, st == 0 ? S - 1 : st - 1, nv, x, g,
                        run.row(i + S - 1), D);
    cp_async_commit();
    cp_async_wait<S - 1>();                // this row's group has landed
    const uint4* xs = ring + (size_t)st * 2 * nv;
    const uint4* gs = xs + nv;
    uint4 cx[NV], cg[NV];
    float xk[KEEP ? NV : 1][n], gk[KEEP ? NV : 1][n], gwk[KEEP ? NV : 1][n];
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = t + j * BT;
      if (k >= nv) break;
      cx[j] = xs[k];
      cg[j] = gs[k];
#pragma unroll
      for (int h = 0; h < P; ++h) {
        const float4 wv = w_s[h * nv + k];
        const float wh[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = 4 * h + q;
          const float f = elem<TI>(cx[j], e), gv = elem<TI>(cg[j], e);
          const float gw = gv * wh[q];
          ss = fmaf(f, f, ss);
          sg = fmaf(f, gw, sg);
          if constexpr (KEEP) {
            xk[j][e] = f;
            gk[j][e] = gv;
            gwk[j][e] = gw;
          }
        }
      }
    }
    const float2 sums = bwd_row_sums(ss, sg, red, i);
    const float r = rsqrtf(sums.x / (float)D + eps);
    const float c = (sums.y / (float)D) * r * r * r;
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * D);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = t + j * BT;
      if (k >= nv) break;
      float o[n];
#pragma unroll
      for (int h = 0; h < P; ++h) {
        float wh[4];
        if constexpr (!KEEP) {
          const float4 wv = w_s[h * nv + k];
          wh[0] = wv.x;
          wh[1] = wv.y;
          wh[2] = wv.z;
          wh[3] = wv.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = 4 * h + q;
          float f, gv, gw;
          if constexpr (KEEP) {
            f = xk[j][e];
            gv = gk[j][e];
            gw = gwk[j][e];
          } else {
            f = elem<TI>(cx[j], e);
            gv = elem<TI>(cg[j], e);
            gw = gv * wh[q];
          }
          o[e] = r * gw - f * c;
          acc[j][e] = fmaf(gv, f * r, acc[j][e]);
        }
      }
      dxr[k] = pack(o, TI());
    }
    st = st + 1 == S ? 0 : st + 1;
  }
  float4* pr = reinterpret_cast<float4*>(partial + (int64_t)blockIdx.x * D);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = t + j * BT;
    if (k >= nv) break;
#pragma unroll
    for (int h = 0; h < P; ++h)
      pr[k * P + h] = make_float4(acc[j][4 * h], acc[j][4 * h + 1],
                                  acc[j][4 * h + 2], acc[j][4 * h + 3]);
  }
  if (!fused) return;
  // every CTA's partial written (and every copy of the ring landed): the
  // ring's shared memory holds the slices of this CTA's share of dw
  cooperative_groups::this_grid().sync();
  const int W = dw_share(D, gridDim.x);
  if ((int64_t)blockIdx.x * W < D)
    dw_sum(partial, dw, gridDim.x, D, blockIdx.x * W, W,
           reinterpret_cast<float*>(ring));
}

// the backward for every other row (D not whole vectors, or an operand
// not 16-byte aligned): one element a load, thread t taking the columns
// t, t + BT, ... (NV of them at most), w staged in shared memory, the dw
// partial in registers, the next row loaded before the current one is
// reduced where the registers allow; the dw sum is a launch of its own
template <typename TI, int NV>
__global__ void __launch_bounds__(BWD_BT) rmsnorm_bwd_scalar_kernel(
    const TI* __restrict__ x, const float* __restrict__ w,
    const TI* __restrict__ g, TI* __restrict__ dx,
    float* __restrict__ partial, int64_t rows, int D, float eps) {
  constexpr bool PREFETCH = NV <= 16;
  __shared__ float2 red[2][BWD_BT / 32];
  __shared__ float w_s[BWD_MAX_D];
  const int t = threadIdx.x, BT = blockDim.x;
  for (int k = t; k < D; k += BT) w_s[k] = w[k];
  __syncthreads();
  const RowRun run = bwd_rows(rows);

  float acc[NV], cx[NV], cg[NV], nx[NV], ng[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = 0.f;
  const auto load = [&](float (&a)[NV], float (&b)[NV], int64_t row) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = t + j * BT;
      if (k < D) {
        a[j] = to_f(x[row * D + k]);
        b[j] = to_f(g[row * D + k]);
      }
    }
  };
  if (run.count > 0) load(cx, cg, run.row(0));
  for (int64_t i = 0; i < run.count; ++i) {
    const int64_t row = run.row(i);
    if (PREFETCH && i + 1 < run.count) load(nx, ng, run.row(i + 1));
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = t + j * BT;
      if (k >= D) break;
      ss = fmaf(cx[j], cx[j], ss);
      sg = fmaf(cx[j], cg[j] * w_s[k], sg);
    }
    const float2 sums = bwd_row_sums(ss, sg, red, i);
    const float r = rsqrtf(sums.x / (float)D + eps);
    const float c = (sums.y / (float)D) * r * r * r;
    TI* dxr = dx + row * D;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = t + j * BT;
      if (k >= D) break;
      put(dxr + k, r * (cg[j] * w_s[k]) - cx[j] * c);
      acc[j] = fmaf(cg[j], cx[j] * r, acc[j]);
    }
    if (PREFETCH) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        cx[j] = nx[j];
        cg[j] = ng[j];
      }
    } else if (i + 1 < run.count) {
      load(cx, cg, run.row(i + 1));
    }
  }
  float* pr = partial + (int64_t)blockIdx.x * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = t + j * BT;
    if (k >= D) break;
    pr[k] = acc[j];
  }
}

// loads per thread: 16-byte vectors up to 4 (D <= 8192 bf16, 4096
// float32), single elements up to 32 (D <= 8192)
constexpr int BWD_NV_VEC[] = {1, 2, 4};
constexpr int BWD_NV_ONE[] = {1, 2, 4, 8, 16, 32};

// how the last backward launched on this host thread ran: 0 scalar rows +
// the dw sum, 1 the ring + the dw sum, 2 the ring with the dw sum fused
thread_local int last_route = -1;

cudaError_t launch_dw(const float* partial, float* dw, int64_t P, int D,
                      cudaStream_t s) {
  rmsnorm_bwd_dw_kernel<<<(unsigned)((D + DW_COLS - 1) / DW_COLS), DW_T, 0,
                          s>>>(partial, dw, P, D);
  return cudaGetLastError();
}

template <typename TI, int I = 0>
cudaError_t launch_ring(const TI* x, const float* w, const TI* g, TI* dx,
                        float* partial, float* dw, int64_t rows, int D,
                        float eps, bool fuse, cudaStream_t s) {
  constexpr int NV = BWD_NV_VEC[I], S = ring_stages(NV);
  constexpr int n = Vec<TI>::n;
  const int nv = D / n, bt = bwd_threads(nv);
  if constexpr (I + 1 < 3) {
    if (nv > NV * bt)
      return launch_ring<TI, I + 1>(x, w, g, dx, partial, dw, rows, D, eps,
                                    fuse, s);
  }
  const auto kernel = rmsnorm_bwd_ring_kernel<TI, NV, S>;
  const int64_t grid = bwd_grid(rows, D);
  // the ring and w, or the fused sum's slices where they take more
  const size_t ring_bytes = (size_t)(2 * S + n / 4) * nv * sizeof(uint4);
  const size_t sum_bytes =
      (size_t)dw_slices(grid) * dw_share(D, grid) * sizeof(float);
  const size_t smem = ring_bytes > sum_bytes ? ring_bytes : sum_bytes;
  // the largest ring of this instantiation, allowed once per device, and
  // the CTAs the device holds at once at the last (threads, bytes) asked
  thread_local uint64_t raised = 0;
  thread_local int seen_dev = -1, seen_bt = 0;
  thread_local size_t seen_smem = 0;
  thread_local int64_t resident = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && !(raised >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
    if (err != cudaSuccess) return err;
    raised |= 1ull << dev;
  }
  if (fuse && (dev != seen_dev || bt != seen_bt || smem != seen_smem)) {
    int n_sm = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, bt, smem)) != cudaSuccess)
      return err;
    seen_dev = dev;
    seen_bt = bt;
    seen_smem = smem;
    resident = (int64_t)n_sm * per_sm;
  }
  // fused where the grid is the wide rows' (the narrow rows' larger grid
  // leaves the sum few columns to share out) and the card holds it at once
  if (fuse && grid <= BWD_CTAS && grid <= resident) {
    int fused = 1;
    void* args[] = {&x, &w, &g, &dx, &partial, &dw, &rows, &D, &eps, &fused};
    last_route = 2;
    return cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)grid),
                                       dim3(bt), args, smem, s);
  }
  kernel<<<(unsigned)grid, bt, smem, s>>>(x, w, g, dx, partial, dw, rows, D,
                                          eps, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  last_route = 1;
  return launch_dw(partial, dw, grid, D, s);
}

template <typename TI, int I = 0>
cudaError_t launch_scalar(const TI* x, const float* w, const TI* g, TI* dx,
                          float* partial, float* dw, int64_t rows, int D,
                          float eps, cudaStream_t s) {
  constexpr int NV = BWD_NV_ONE[I];
  const int bt = bwd_threads(D);
  if constexpr (I + 1 < 6) {
    if (D > NV * bt)
      return launch_scalar<TI, I + 1>(x, w, g, dx, partial, dw, rows, D, eps,
                                      s);
  }
  if (D > NV * bt) return cudaErrorInvalidValue;
  const int64_t grid = bwd_grid(rows, D);
  rmsnorm_bwd_scalar_kernel<TI, NV><<<(unsigned)grid, bt, 0, s>>>(
      x, w, g, dx, partial, rows, D, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  last_route = 0;
  return launch_dw(partial, dw, grid, D, s);
}

template <typename TI>
cudaError_t launch_backward(const void* x, const void* w, const void* g,
                            void* dx, void* dw, void* partial, int64_t rows,
                            int64_t D, float eps, bool fuse, cudaStream_t s) {
  constexpr int n = Vec<TI>::n;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const TI* xp = static_cast<const TI*>(x);
  const TI* gp = static_cast<const TI*>(g);
  const float* wp = static_cast<const float*>(w);
  TI* dxp = static_cast<TI*>(dx);
  float* pp = static_cast<float*>(partial);
  float* dwp = static_cast<float*>(dw);
  if (D % n == 0 && D / n <= BWD_BT * BWD_NV_VEC[2] && aligned(x) &&
      aligned(g) && aligned(dx) && aligned(w) && aligned(partial))
    return launch_ring<TI>(xp, wp, gp, dxp, pp, dwp, rows, (int)D, eps, fuse,
                           s);
  return launch_scalar<TI>(xp, wp, gp, dxp, pp, dwp, rows, (int)D, eps, s);
}

}  // namespace

extern "C" {

// rows of the backward's dw scratch (float32, (rows of it, D)) for a
// (rows, D) x: the CTAs of its grid
int64_t rmsnorm_bwd_partials(int64_t rows, int64_t D) {
  return rows < 1 || D < 1 ? 0 : bwd_grid(rows, D);
}

// x, g, dx: contiguous (rows, D) of one dtype (bf16 != 0: bfloat16, else
// float32); w, dw: (D,) float32; partial: (rmsnorm_bwd_partials(rows, D),
// D) float32 scratch.  D <= 8192.  fuse != 0: one cooperative launch where
// the device holds the whole grid at once (the ring's rows, a grid
// barrier, the dw sum); otherwise, and for the scalar rows, two launches
// on the stream, the rows and then the dw sum, in the same order.
int rmsnorm_bwd_launch(const void* x, const void* w, const void* g, void* dx,
                       void* dw, void* partial, int64_t rows, int64_t D,
                       int64_t bf16, float eps, int64_t fuse, void* stream) {
  if (rows < 1 || D < 1 || D > BWD_MAX_D) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_backward<__nv_bfloat16>(x, w, g, dx, dw, partial,
                                                     rows, D, eps, fuse != 0,
                                                     s)
                    : launch_backward<float>(x, w, g, dx, dw, partial, rows,
                                             D, eps, fuse != 0, s));
}

// the route of this host thread's last backward launch: 0 scalar rows and
// the dw sum, 1 the ring and the dw sum, 2 the ring with the sum fused
int rmsnorm_bwd_last_route(void) { return last_route; }

// x, y: contiguous (rows, D); w: (D,) float32.  bf16 != 0 means bfloat16
// x/y, else float32.  Rows of whole 16-byte vectors (up to 1024 of them)
// with 16-byte aligned operands take the persistent rows kernel; the rest
// ceil(rows / 8) CTAs of 8 warps.
int rmsnorm_launch(const void* x, const void* w, void* y, int64_t rows,
                   int64_t D, int64_t bf16, float eps, void* stream) {
  if (rows < 1 || D < 1 || (rows + ROWS - 1) / ROWS > 2147483647)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<__nv_bfloat16>(x, w, y, rows, D, eps, s)
                    : launch<float>(x, w, y, rows, D, eps, s));
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
