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
// row count and any D: 2048 and 4096 in Mamba2's block and gate norms, 128
// for a qk-norm.
//
// Bound on this card: bytes.  It reads x once, w once and writes y once,
// with ~4 operations per element: at the LM-scoring shape (22 528 rows of
// one shard, bf16) the block norm (D = 2048) moves 184.5 MB, 0.055 ms at
// 3.35 TB/s, and the gate norm (D = 4096) 369 MB, 0.110 ms.
//
// Design: one warp per row, 8 rows per CTA of 256 threads.  The warp reads
// its row with 16-byte loads (8 bf16 or 4 float32 per lane) where the row
// length and the pointers allow it, else element by element; squares are
// summed in float32 per lane and reduced with warp shuffles in a fixed
// order, so a repeat launch is bitwise identical.  A second pass over the
// row (from L1/L2: a CTA's 8 rows are at most 128 KB) scales and writes
// it.  The entry point takes raw pointers, launches on the given stream
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;  // rows (warps) per CTA
constexpr int NT = 32 * ROWS;

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
        ss += f * f;
      }
    }
  } else {
    for (int64_t k = lane; k < D; k += 32) {
      const float f = to_f(xr[k]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / (float)D + eps);
  if (VEC) {
    const Vec<TI>* xv = reinterpret_cast<const Vec<TI>*>(xr);
    Vec<TI>* yv = reinterpret_cast<Vec<TI>*>(yr);
    for (int64_t k = lane; k < D / V; k += 32) {
      const Vec<TI> t = xv[k];
      Vec<TI> o;
#pragma unroll
      for (int i = 0; i < V; ++i)
        put(&o.v[i], (to_f(t.v[i]) * inv) * w[k * V + i]);
      yv[k] = o;
    }
  } else {
    for (int64_t k = lane; k < D; k += 32)
      put(yr + k, (to_f(xr[k]) * inv) * w[k]);
  }
}

template <typename TI>
cudaError_t launch(const void* x, const void* w, void* y, int64_t rows,
                   int64_t D, float eps, cudaStream_t s) {
  const bool vec = D % Vec<TI>::n == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const unsigned grid = (unsigned)((rows + ROWS - 1) / ROWS);
  const TI* xp = static_cast<const TI*>(x);
  const float* wp = static_cast<const float*>(w);
  TI* yp = static_cast<TI*>(y);
  if (vec)
    rmsnorm_kernel<TI, true><<<grid, NT, 0, s>>>(xp, wp, yp, rows, D, eps);
  else
    rmsnorm_kernel<TI, false><<<grid, NT, 0, s>>>(xp, wp, yp, rows, D, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: contiguous (rows, D); w: (D,) float32.  bf16 != 0 means bfloat16
// x/y, else float32.  Grid: ceil(rows / 8) CTAs of 8 warps.
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
