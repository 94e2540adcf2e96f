// Causal (optionally sliding-window) GQA flash-attention forward for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (_attn_kernel, launched by flash_attention_kernel and wrapped by
// ops.flash_attention). It computes what repro/kernels/flash_attention/
// ref.py:attention_ref computes, for q (B, Sq, H, hd) against k, v
// (B, Sk, KV, hd), all contiguous:
//   s[i, j] = (q_i . k_j) * scale                       (float32)
//   valid   = j < Sk, j <= q_offset + i (causal), j > q_offset + i - window
//   o_i     = softmax_j(s[i, valid]) @ v[valid]         (float32, online)
// written in the input dtype (float32 or bfloat16). A row with no valid key
// gives zeros. Query head h reads kv head h / (H / KV) directly: the GQA
// repeat is never materialised.
//
// Bound. At the serving shape (qwen2-0.5b prefill, B=4, S=2048, H=14,
// KV=2, hd=64, bf16) one call does 3.0e10 causal FLOPs on 34 MB of
// operands, ~900 FLOPs a byte: far above the card's ~295 FLOP/byte balance
// point, so the bound is the tensor cores' bf16 rate (~0.030 ms at 989
// TFLOP/s). This first kernel runs its products on the CUDA cores in
// float32 (67 TFLOP/s), so its own ceiling is ~0.45 ms; tensor-core
// products (mma/wgmma) and TMA copies are the next step.
//
// Design. One block of 128 threads owns a tile of 64 query rows of one
// (batch, head) and streams 64-row K/V tiles through shared memory,
// converted to float32 on load. Tiles wholly past the causal diagonal or
// wholly before the window are never visited (the loop bounds), so causal
// work is half of the dense work; only the tiles that straddle a boundary,
// and the ragged last tile when S is not a multiple of 64, are masked
// element by element. Thread (rg, cg), rg in 0..15 and cg in 0..7, owns
// query rows rg + 16 i (i < 4): it computes scores for key columns
// cg + 8 j (j < 8) and output columns cg*4 + 32 c (4 wide, c < hd/32). The 8
// threads of a row are neighbouring lanes, so the running max and sum are
// reduced with three warp shuffles. Each row keeps (m, l, acc) in registers
// across tiles (online softmax); P goes through shared memory for the PV
// product. Q and K rows are padded by 4 floats and P rows by 8 so that the
// float4 reads of 8 neighbouring rows fall in distinct banks.
//
// Precise expf and IEEE division (no fast math), so float32 output stays
// within a few ulps of the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // key rows a tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kPStride = kBK + 8;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);  // round to nearest even
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Rows [r0, r0 + 64) of a (rows, row_stride) operand into a float32 tile of
// `dst_stride` floats a row; rows at or past n_rows are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride,
                                          const T* src, size_t row_stride,
                                          int r0, int n_rows) {
  constexpr int kVecPerRow = HD / 4;
  for (int i = threadIdx.x; i < kBQ * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < n_rows) val = load4(src + (r0 + r) * row_stride + c);
    store4(dst + r * dst_stride + c, val);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * kBQ * (HD + 4) + kBK * HD + kBQ * kPStride);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
          int KV, int q_offset, int causal, int window, float scale) {
  constexpr int kQStride = HD + 4;
  constexpr int kChunks = HD / 32;  // float4 output columns a thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kQStride;
  float* Vs = Ks + kBK * kQStride;
  float* Ps = Vs + kBK * HD;

  const int cg = threadIdx.x & 7;
  const int rg = threadIdx.x >> 3;
  // Longest causal tiles first, so the short ones fill the tail of the grid.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_row = static_cast<size_t>(H) * HD;
  const size_t kv_row = static_cast<size_t>(KV) * HD;
  const T* qb = q + static_cast<size_t>(b) * Sq * q_row + h * HD;
  const T* kb = k + static_cast<size_t>(b) * Sk * kv_row + kvh * HD;
  const T* vb = v + static_cast<size_t>(b) * Sk * kv_row + kvh * HD;
  T* ob = o + static_cast<size_t>(b) * Sq * q_row + h * HD;

  load_tile<T, HD>(Qs, kQStride, qb, q_row, q0, Sq);

  // The keys this tile's queries can see: [k_begin, k_end).
  const int p_lo = q_offset + q0;
  const int p_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, p_hi + 1) : Sk;
  int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;

  float m[4], l[4], acc[4][4 * kChunks];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kChunks; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's K, V and P are no longer read
    load_tile<T, HD>(Ks, kQStride, kb, kv_row, k0, Sk);
    load_tile<T, HD>(Vs, HD, vb, kv_row, k0, Sk);
    __syncthreads();

    // S = Q K^T on this thread's 4 x 8 scores.
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = load4(Qs + (rg + 16 * i) * kQStride + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = load4(Ks + (cg + 8 * j) * kQStride + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv.x, t);
          t = fmaf(qv[i].y, kv.y, t);
          t = fmaf(qv[i].z, kv.z, t);
          t = fmaf(qv[i].w, kv.w, t);
          s[i][j] = t;
        }
      }
    }

    // Mask, then the online softmax update of each row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = p_lo + rg + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.0f;
      float sum = 0.0f;
      if (m_new == -INFINITY) {  // no valid key for this row yet
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
      } else {
        alpha = expf(m[i] - m_new);  // 0 while m[i] is still -inf
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          sum += s[i][j];
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kChunks; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Ps[(rg + 16 * i) * kPStride + cg + 8 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V on this thread's 4 rows x (4 * kChunks) columns.
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = load4(Ps + (rg + 16 * i) * kPStride + kk);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float* vc = Vs + kk * HD + cg * 4 + 32 * c;
        const float4 v0 = load4(vc);
        const float4 v1 = load4(vc + HD);
        const float4 v2 = load4(vc + 2 * HD);
        const float4 v3 = load4(vc + 3 * HD);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* a = acc[i] + 4 * c;
          a[0] = fmaf(p4[i].w, v3.x, fmaf(p4[i].z, v2.x,
                 fmaf(p4[i].y, v1.x, fmaf(p4[i].x, v0.x, a[0]))));
          a[1] = fmaf(p4[i].w, v3.y, fmaf(p4[i].z, v2.y,
                 fmaf(p4[i].y, v1.y, fmaf(p4[i].x, v0.y, a[1]))));
          a[2] = fmaf(p4[i].w, v3.z, fmaf(p4[i].z, v2.z,
                 fmaf(p4[i].y, v1.z, fmaf(p4[i].x, v0.z, a[2]))));
          a[3] = fmaf(p4[i].w, v3.w, fmaf(p4[i].z, v2.w,
                 fmaf(p4[i].y, v1.w, fmaf(p4[i].x, v0.w, a[3]))));
        }
      }
    }
  }

  // o = acc / l; rows that never saw a valid key (l == 0) are zero.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= Sq) continue;
    const bool any = l[i] > 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const float* a = acc[i] + 4 * c;
      const float4 out = any ? make_float4(a[0] / l[i], a[1] / l[i],
                                           a[2] / l[i], a[3] / l[i])
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      store4(ob + row * q_row + cg * 4 + 32 * c, out);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int q_offset, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, q_offset,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int Sq, int Sk, int H, int KV, int q_offset, int causal,
              int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, q_offset, causal,
                           window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, q_offset, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, q_offset, causal,
                            window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); contiguous, 16-byte aligned,
// one dtype: 0 = float32, 1 = bfloat16. hd in {32, 64, 128}, H % KV == 0,
// window <= 0 for none. Launches on `stream` and returns cudaGetLastError()
// (0 when the launch was accepted).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Sq, int Sk, int H, int KV,
                                      int hd, int q_offset, int causal,
                                      int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                            causal, window, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, H, KV,
                                    q_offset, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
