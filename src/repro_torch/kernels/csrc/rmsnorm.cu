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
// rmsnorm_bwd_kernel: a CTA of BT threads (32 <= BT <= 256, enough for one
// row) takes a contiguous run of rows, one row at a time.  Thread t holds
// the loads k = t, t + BT, ... of a row -- 16-byte vectors where D and the
// pointers allow, else single elements -- and keeps its columns of w and
// of the CTA's dw partial in registers for the whole run.  Per row the two
// sums (x*x and x*g*w) meet in a xor butterfly per warp, then the warps'
// partials in shared memory are added in warp order by every thread; the
// next row's x and g are loaded before the current one is reduced (where
// the registers allow).  Each CTA writes its dw partial to one row of a
// (grid, D) float32 scratch.  rmsnorm_dw_kernel sums that scratch over
// the CTAs in a fixed order.  No atomics: a repeat launch is bitwise
// identical, and the grid is a function of rows and D alone
// (rmsnorm_bwd_partials), so the order is the same on any card.

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
constexpr int64_t BWD_MIN_ROWS = 8;       // rows a CTA takes at least
constexpr int64_t BWD_PARTIAL = 1 << 21;  // the dw scratch's floats, at most
constexpr int BWD_MAX_D = 8192;

// V elements of TI from one load: a 16-byte vector (V = 16 / sizeof(TI))
// or, below, a single element (V = 1)
template <typename TI, int V>
struct Chunk {
  uint4 u;
  __device__ __forceinline__ void load(const TI* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float at(int i) const { return elem<TI>(u, i); }
};
template <typename TI>
struct Chunk<TI, 1> {
  float f;
  __device__ __forceinline__ void load(const TI* p) { f = to_f(*p); }
  __device__ __forceinline__ float at(int) const { return f; }
};

// a thread's loads k = t, t + bt, ... of one row of x and of g
template <typename TI, int V, int NV>
__device__ __forceinline__ void load_bwd_row(Chunk<TI, V> (&a)[NV],
                                             Chunk<TI, V> (&b)[NV],
                                             const TI* xr, const TI* gr,
                                             int t, int bt, int nv) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = t + j * bt;
    if (k < nv) {
      a[j].load(xr + (int64_t)k * V);
      b[j].load(gr + (int64_t)k * V);
    }
  }
}

// the CTAs of the backward's grid, and so the rows of its dw scratch
inline int64_t bwd_grid(int64_t rows, int64_t D) {
  const int64_t by_rows = (rows + BWD_MIN_ROWS - 1) / BWD_MIN_ROWS;
  const int64_t by_scratch = BWD_PARTIAL / D > 1 ? BWD_PARTIAL / D : 1;
  return by_rows < by_scratch ? by_rows : by_scratch;
}

template <typename TI, int V, int NV>
__global__ void __launch_bounds__(BWD_BT) rmsnorm_bwd_kernel(
    const TI* __restrict__ x, const float* __restrict__ w,
    const TI* __restrict__ g, TI* __restrict__ dx,
    float* __restrict__ partial, int64_t rows, int D, int64_t chunk,
    float eps) {
  constexpr bool PREFETCH = NV * (V > 1 ? 4 : 1) <= 16;
  __shared__ float2 red[2][BWD_BT / 32];
  const int t = threadIdx.x, BT = blockDim.x, nw = BT / 32;
  const int nv = D / V;
  const int64_t r0 = (int64_t)blockIdx.x * chunk;
  const int64_t r1 = r0 + chunk < rows ? r0 + chunk : rows;

  float wr[NV][V], acc[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = t + j * BT;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      wr[j][i] = k < nv ? w[k * V + i] : 0.f;
      acc[j][i] = 0.f;
    }
  }
  Chunk<TI, V> cx[NV], cg[NV], nx[NV], ng[NV];
  if (r0 < r1) load_bwd_row(cx, cg, x + r0 * D, g + r0 * D, t, BT, nv);
  for (int64_t row = r0; row < r1; ++row) {
    if (PREFETCH && row + 1 < r1)
      load_bwd_row(nx, ng, x + (row + 1) * D, g + (row + 1) * D, t, BT, nv);
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (t + j * BT >= nv) break;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = cx[j].at(i);
        ss = fmaf(f, f, ss);
        sg = fmaf(f, cg[j].at(i) * wr[j][i], sg);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      ss += __shfl_xor_sync(FULL, ss, off);
      sg += __shfl_xor_sync(FULL, sg, off);
    }
    // one barrier a row: the slot alternates, and a warp writes a slot
    // again only after every warp has passed the barrier between
    float2* slot = red[row & 1];
    if (t % 32 == 0) slot[t / 32] = make_float2(ss, sg);
    __syncthreads();
    ss = 0.f;
    sg = 0.f;
    for (int i = 0; i < nw; ++i) {
      ss += slot[i].x;
      sg += slot[i].y;
    }
    const float r = rsqrtf(ss / (float)D + eps);
    const float c = (sg / (float)D) * r * r * r;
    TI* dxr = dx + row * D;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = t + j * BT;
      if (k >= nv) break;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = cx[j].at(i), gv = cg[j].at(i);
        o[i] = r * (gv * wr[j][i]) - f * c;
        acc[j][i] = fmaf(gv, f * r, acc[j][i]);
      }
      if constexpr (V > 1)
        *reinterpret_cast<uint4*>(dxr + (int64_t)k * V) = pack(o, TI());
      else
        put(dxr + k, o[0]);
    }
    if (PREFETCH) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        cx[j] = nx[j];
        cg[j] = ng[j];
      }
    } else if (row + 1 < r1) {
      load_bwd_row(cx, cg, x + (row + 1) * D, g + (row + 1) * D, t, BT, nv);
    }
  }
  float* pr = partial + (int64_t)blockIdx.x * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = t + j * BT;
    if (k >= nv) break;
#pragma unroll
    for (int i = 0; i < V; ++i) pr[(int64_t)k * V + i] = acc[j][i];
  }
}

// dw[c] = sum over p of partial[p, c]: 8 slices of a 32-column tile sum
// p = s, s + 8, ... in order, then slice 0 adds the 8 slices in order
constexpr int DW_COLS = 32, DW_SLICES = 8;

__global__ void __launch_bounds__(DW_COLS * DW_SLICES) rmsnorm_dw_kernel(
    const float* __restrict__ partial, float* __restrict__ dw, int64_t P,
    int D) {
  __shared__ float s[DW_SLICES][DW_COLS];
  const int lane = threadIdx.x % DW_COLS, sl = threadIdx.x / DW_COLS;
  const int c = blockIdx.x * DW_COLS + lane;
  float a = 0.f;
  if (c < D) {
#pragma unroll 4
    for (int64_t p = sl; p < P; p += DW_SLICES) a += partial[p * D + c];
  }
  s[sl][lane] = a;
  __syncthreads();
  if (sl == 0 && c < D) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < DW_SLICES; ++i) total += s[i][lane];
    dw[c] = total;
  }
}

// loads per thread of the backward: 16-byte vectors up to 4 (D <= 8192
// bf16, 4096 float32), single elements up to 32 (D <= 8192)
constexpr int BWD_NV_VEC[] = {1, 2, 4};
constexpr int BWD_NV_ONE[] = {1, 2, 4, 8, 16, 32};

template <typename TI, int V, int I = 0>
cudaError_t launch_bwd(const TI* x, const float* w, const TI* g, TI* dx,
                       float* partial, int64_t rows, int D, float eps,
                       cudaStream_t s) {
  constexpr int N = V > 1 ? 3 : 6;
  constexpr int NV = V > 1 ? BWD_NV_VEC[I < 3 ? I : 2] : BWD_NV_ONE[I];
  const int nv = D / V;
  const int bt = nv >= BWD_BT ? BWD_BT : (nv + 31) / 32 * 32;
  if constexpr (I + 1 < N) {
    if (nv > NV * bt)
      return launch_bwd<TI, V, I + 1>(x, w, g, dx, partial, rows, D, eps, s);
  }
  if (nv > NV * bt) return cudaErrorInvalidValue;
  const int64_t grid = bwd_grid(rows, D);
  const int64_t chunk = (rows + grid - 1) / grid;
  rmsnorm_bwd_kernel<TI, V, NV><<<(unsigned)grid, bt, 0, s>>>(
      x, w, g, dx, partial, rows, D, chunk, eps);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch_backward(const void* x, const void* w, const void* g,
                            void* dx, void* dw, void* partial, int64_t rows,
                            int64_t D, float eps, cudaStream_t s) {
  constexpr int n = Vec<TI>::n;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const TI* xp = static_cast<const TI*>(x);
  const TI* gp = static_cast<const TI*>(g);
  const float* wp = static_cast<const float*>(w);
  TI* dxp = static_cast<TI*>(dx);
  float* pp = static_cast<float*>(partial);
  cudaError_t err;
  if (D % n == 0 && D / n <= BWD_BT * BWD_NV_VEC[2] && aligned(x) &&
      aligned(g) && aligned(dx))
    err = launch_bwd<TI, n>(xp, wp, gp, dxp, pp, rows, (int)D, eps, s);
  else
    err = launch_bwd<TI, 1>(xp, wp, gp, dxp, pp, rows, (int)D, eps, s);
  if (err != cudaSuccess) return err;
  rmsnorm_dw_kernel<<<(unsigned)((D + DW_COLS - 1) / DW_COLS),
                      DW_COLS * DW_SLICES, 0, s>>>(
      pp, static_cast<float*>(dw), bwd_grid(rows, D), (int)D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rows of the backward's dw scratch (float32, (rows of it, D)) for a
// (rows, D) x: the wrapper allocates it
int64_t rmsnorm_bwd_partials(int64_t rows, int64_t D) {
  return rows < 1 || D < 1 ? 0 : bwd_grid(rows, D);
}

// x, g, dx: contiguous (rows, D) of one dtype (bf16 != 0: bfloat16, else
// float32); w, dw: (D,) float32; partial: (rmsnorm_bwd_partials(rows, D),
// D) float32 scratch.  D <= 8192.  Two launches on the stream: the rows
// kernel, then the dw sum.
int rmsnorm_bwd_launch(const void* x, const void* w, const void* g, void* dx,
                       void* dw, void* partial, int64_t rows, int64_t D,
                       int64_t bf16, float eps, void* stream) {
  if (rows < 1 || D < 1 || D > BWD_MAX_D) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_backward<__nv_bfloat16>(x, w, g, dx, dw, partial,
                                                     rows, D, eps, s)
                    : launch_backward<float>(x, w, g, dx, dw, partial, rows,
                                             D, eps, s));
}

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
