// Flash attention (K5) for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:76
// (flash_attention_pallas, body _flash_kernel).  It computes what that
// kernel computes, per (batch, head):
//
//     o = softmax(q k^T * D^-1/2, masked k_pos <= q_pos when causal) v
//
// with q, k, v (B, S, H, D) in float32 or bfloat16 (kv already repeated to
// H), all arithmetic in float32: scores, the running max m, the running
// denominator l and the accumulator.  Masked scores take the reference's
// value -1e30, the denominator is floored at 1e-30 before the division, and
// the output is written in q's dtype (bfloat16 rounds to nearest even).
// Key tiles entirely above the diagonal are never visited.
//
// Bound on this card: operations.  At the LM-scoring shape (a shard of 11
// rows x 2048 tokens, 16 heads of 128, bf16) one launch does
// 4*B*H*D*S(S+1)/2 ~ 1.9e11 operations against 4*B*S*H*D*2 ~ 369 MB of
// inputs and output: ~500 operations per byte, above the card's bf16 ridge
// (~295), so arithmetic is the limit.  The roofline in repro_torch.perf.roofline
// prices it at the bf16 tensor-core peak, 0.19 ms.
//
// Design: the first, simple version -- right before fast.  It runs in
// float32 on the CUDA cores (no tensor cores yet: bf16 mma would round the
// softmax weights p to bf16, which the reference does not do), so it is
// bounded by the FP32 FMA rate, far above the tensor-core bound.
//   * One CTA of 256 threads (16 x 16) owns one (b, h) and a 64-row q tile;
//     the q tile stays in shared memory (float32) for the whole key loop.
//     Tiles are launched heaviest first (the last q tile has the most keys
//     under a causal mask).
//   * Per 64-key tile: K is staged in shared memory, each thread computes a
//     4 x 4 block of scores (rows ty*4+i, keys tx+16c; float4 reads along
//     D, conflict-free with a row pitch of D+4), scales and masks them, and
//     the 16 threads of a row group agree on the row max with shuffles.
//     The weights p = exp(s - m) go to shared memory, V replaces K in the
//     same buffer, and each thread adds p v into its 4 x D/16 accumulator.
//     One K/V buffer (not two) keeps shared memory at 83 KB at D = 128, so
//     two CTAs share an SM and one hides the other's loads.
//   * The denominator is kept per thread over its own keys and summed over
//     the row group once at the end.
//   * Ragged edges: q and key rows past the end load as 0, their scores are
//     masked, and rows past Sq are not stored; any S works.
// The summation order is fixed by the tiling, so a repeat launch is
// bitwise identical.  The entry point takes raw pointers, element strides
// of the (B, S, H) axes (D must be contiguous) and the CUDA stream, launches
// on that stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;     // q rows per CTA
constexpr int BK = 64;     // keys per tile
constexpr int NT = 256;    // threads: 16 row groups x 16 lanes
constexpr float NEG = -1e30f;
constexpr float L_FLOOR = 1e-30f;

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

template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int64_t rs, int64_t row0,
                                          int64_t n) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      raw = *reinterpret_cast<const uint4*>(src + (row0 + r) * rs + c * 8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
    float* d = dst + r * (D + 4) + c * 8;
    *reinterpret_cast<float4*>(d) = make_float4(f0.x, f0.y, f1.x, f1.y);
    *reinterpret_cast<float4*>(d + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
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

template <int VW>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* x) {
  if constexpr (VW >= 2) {
#pragma unroll
    for (int e = 0; e < VW; e += 2)
      reinterpret_cast<__nv_bfloat162*>(p)[e / 2] =
          __floats2bfloat162_rn(x[e], x[e + 1]);
  } else {
    p[0] = __float2bfloat16(x[0]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

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

  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = fmaxf(lt, L_FLOOR);
    const int64_t qp = q0 + ty * 4 + i;
    if (qp < Sq) {
      T* orow = ob + qp * o_ss + tx * VW;
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t B, int64_t H, int64_t Sq, int64_t Skv,
                   const int64_t* st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Sq, Skv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int64_t B, int64_t H, int64_t Sq, int64_t Skv,
                     int64_t D, const int64_t* st, float scale, int causal,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, Sq, Skv, st, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, Sq, Skv, st, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Sq, Skv, st, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Sq, Skv, st, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (B, S, H, D) with element strides (batch, seq, head) each and
// a contiguous D in {16, 32, 64, 128}; bf16 != 0 means bfloat16 operands,
// else float32.  Grid: (ceil(Sq / 64), B * H).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int64_t B, int64_t H, int64_t Sq,
                           int64_t Skv, int64_t D,
                           int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t o_sb, int64_t o_ss, int64_t o_sh,
                           int64_t bf16, int64_t causal, float scale,
                           void* stream) {
  if (B * H > 65535 || B * H < 1 || Sq < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, B, H, Sq, Skv, D, st, scale,
                                     causal != 0, s)
           : launch_d<float>(q, k, v, o, B, H, Sq, Skv, D, st, scale,
                             causal != 0, s);
  return (int)err;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
