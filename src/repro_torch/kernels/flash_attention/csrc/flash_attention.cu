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
// repeat is never materialised. Two kernels, chosen by dtype in the
// launcher; neither ever stands in for the other.
//
// Bound. At the serving shape (qwen2-0.5b prefill, B=4, S=2048, H=14,
// KV=2, hd=64, bf16, causal) one call does 3.0e10 FLOPs on 34 MB of
// operands, ~900 FLOPs a byte: far above the card's ~295 FLOP/byte balance
// point, so the bound is the tensor cores' dense bf16 rate: 0.0304 ms at
// 989 TFLOP/s.
//
// bfloat16: flash_fwd_sm90, tensor cores. A block of 288 threads owns 128
// query rows of one (batch, head): two consumer warpgroups of 64 rows each
// and one producer warp.
//  - The producer's lane 0 loads the block's Q tile once, then streams K
//    and V tiles into a ring of kStages = 2 shared-memory stages with TMA
//    (cp.async.bulk.tensor, 4-D tensor maps over the (B, S, heads, hd)
//    layout, so nothing is padded, repeated or transposed). Each stage has
//    a "full" mbarrier (expect_tx of the whole box: TMA counts a box's
//    zero-filled rows past S as bytes too) and an "empty" mbarrier on which
//    the 8 consumer warps arrive once their products have read the stage.
//    So tile j+1 loads while tile j's products run.
//  - Each consumer warpgroup computes S = Q K^T with wgmma (m64 x kBK x 16
//    steps, both operands K-major in shared memory, float32 accumulators),
//    masks, runs the online softmax in float32 registers, rounds P to bf16
//    straight from the S accumulator fragment into wgmma's A-register
//    fragment (the two layouts coincide for 16-bit A), and accumulates
//    O += P V with wgmma (A from registers, V as an MN-major B operand:
//    keys x hd with hd contiguous, the transpose bit set).
//  - Swizzle: each TMA box row is one swizzle atom row and the wgmma
//    descriptors use the same mode. A tile is split by columns into panels
//    (one TMA box each): 64 columns (128 B rows, SWIZZLE_128B) where hd is a
//    multiple of 64 (one panel at 64, two at 128, four at 256); 32 columns
//    (64 B, SWIZZLE_64B) at hd = 32; 16 columns (32 B, SWIZZLE_32B) at
//    hd = 80, five panels, so no column past hd is loaded or multiplied.
//    The K-major descriptors step panel by panel (a K step inside a 128 B
//    or 64 B row is +32 B on the address); V's descriptor spans the panels
//    of one PV product with its leading byte offset. Every panel starts on
//    a 1024 B boundary, so the descriptors' base offset is 0.
//  - Tiles. kBK = 128 keys below hd = 128; 64 from hd = 128 up, where the S
//    and O accumulators (kBK / 2 + hd / 2 floats a thread) would crowd the
//    registers, and where at hd = 256 two stages of 128-key K and V tiles
//    (256 KB) would not fit the 227 KB of shared memory a block may use. At
//    most 193 KB a block (hd = 256: Q 64 KB + 2 stages x (K + V) 128 KB).
//  - PV products: one wgmma of N = hd up to hd = 128 (N = 80 at hd = 80),
//    two of N = 128 at hd = 256, each over its own half of O.
//  - Accumulator layout: thread t of a warpgroup holds rows
//    16 (t / 32) + (t % 32) / 4 and +8, columns 8 j + 2 (t % 4) + {0, 1};
//    a row lives on the 4 threads of a quad, so the row max takes 2
//    shuffles and the row sum is reduced once, after the last tile.
//  - Masking and tile skipping as in the float32 kernel: the loop bounds
//    skip tiles past the causal diagonal or before the window; element
//    masks apply only on straddling tiles and on the ragged last tile
//    (whose zero-filled rows would score 0, not -inf); a warpgroup that
//    sees no key of a tile skips its products. Longest causal tiles first.
//  - Numerics: products of bf16 operands are exact in float32, so S keeps
//    the float32 kernel's precision. The softmax uses exp2f on scores
//    scaled by scale * log2(e) (precise exp2f, no fast math). One stated
//    change: P is rounded to bf16 before the PV product, as the
//    reference's plain path rounds its probabilities to q's dtype.
//  Left for later: warp specialisation with setmaxnreg (the producer warp
//  holds as many registers as a consumer), a persistent grid, and
//  intra-warpgroup overlap of one tile's softmax with the next tile's
//  QK^T (here the two products of a tile run back to back; only the other
//  warpgroup fills the tensor cores meanwhile).
//
// float32: flash_fwd, CUDA cores (float32 has no exact tensor-core path:
// TF32 keeps ~3 decimal digits). One block owns a tile of 64 query rows of
// one (batch, head) and streams 64-row K/V tiles through shared memory.
// Tiles wholly past the causal diagonal or wholly before the window are
// never visited (the loop bounds), so causal work is half of the dense
// work; only the tiles that straddle a boundary, and the ragged last tile
// when S is not a multiple of 64, are masked element by element. Thread
// (rg, cg), cg in 0..7, owns kRows query rows rg + (64 / kRows) i: it
// computes scores for key columns cg + 8 j (j < 8) and output columns
// cg*4 + 32 c (4 wide, c < ceil(hd / 32); at hd = 80 the lanes whose third
// chunk lies past hd skip it). kRows = 4 (128 threads) up to hd = 128 and
// 2 (256 threads) at hd = 256, where four rows' 4 x 32 output floats would
// not fit in a thread's registers. The 8 threads of a row are neighbouring
// lanes, so the running max and sum are reduced with three warp shuffles.
// Each row keeps (m, l, acc) in registers across tiles (online softmax); P
// goes through shared memory for the PV product. Q and K rows are padded
// by 4 floats and P rows by 8 so that the float4 reads of 8 neighbouring
// rows fall in distinct banks. Its products run as scalar FMAs
// (67 TFLOP/s), a ceiling of ~0.45 ms at the serving shape. At hd = 256 it
// takes 217,088 B of shared memory, one block an SM.
//
// Precise expf/exp2f and IEEE division (no fast math), so float32 output
// stays within a few ulps of the plain version.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached
                   // through cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // key rows a tile
constexpr int kPStride = kBK + 8;

// A thread's share of the block's work at head dim HD (see the note above).
template <int HD>
struct F32Tile {
  static constexpr int kRows = HD > 128 ? 2 : 4;   // query rows a thread
  static constexpr int kRowGroups = kBQ / kRows;   // threads a column lane
  static constexpr int kThreads = 8 * kRowGroups;  // 8 column lanes a row
  static constexpr int kChunks = (HD + 31) / 32;   // float4 output columns
  static constexpr int kQStride = HD + 4;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * kBQ * kQStride + kBK * HD + kBQ * kPStride);
  static_assert(HD % 4 == 0, "rows are read as float4");
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
};

// Whether output chunk c of column lane cg (columns 32 c + 4 cg .. + 3)
// lies inside the head: false only for the last chunk when HD is not a
// multiple of 32 (hd = 80: lanes 4..7 of chunk 2).
template <int HD>
__device__ __forceinline__ bool chunk_in_head(int c, int cg) {
  return HD % 32 == 0 || c < HD / 32 || 32 * c + 4 * cg < HD;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Rows [r0, r0 + 64) of a (rows, row_stride) operand into a float32 tile of
// `dst_stride` floats a row; rows at or past n_rows are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride,
                                          const T* src, size_t row_stride,
                                          int r0, int n_rows) {
  constexpr int kVecPerRow = HD / 4;
  for (int i = threadIdx.x; i < kBQ * kVecPerRow;
       i += F32Tile<HD>::kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < n_rows) val = load4(src + (r0 + r) * row_stride + c);
    store4(dst + r * dst_stride + c, val);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(F32Tile<HD>::kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
          int KV, int q_offset, int causal, int window, float scale) {
  using F = F32Tile<HD>;
  constexpr int kRows = F::kRows;
  constexpr int kRG = F::kRowGroups;  // row i of a thread: rg + kRG * i
  constexpr int kQStride = F::kQStride;
  constexpr int kChunks = F::kChunks;
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

  float m[kRows], l[kRows], acc[kRows][4 * kChunks];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
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

    // S = Q K^T on this thread's kRows x 8 scores.
    float s[kRows][8];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = load4(Qs + (rg + kRG * i) * kQStride + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = load4(Ks + (cg + 8 * j) * kQStride + d);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
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
    for (int i = 0; i < kRows; ++i) {
      const int qpos = p_lo + rg + kRG * i;
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
        Ps[(rg + kRG * i) * kPStride + cg + 8 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V on this thread's kRows rows x (4 * kChunks) columns.
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        p4[i] = load4(Ps + (rg + kRG * i) * kPStride + kk);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (!chunk_in_head<HD>(c, cg)) continue;
        const float* vc = Vs + kk * HD + cg * 4 + 32 * c;
        const float4 v0 = load4(vc);
        const float4 v1 = load4(vc + HD);
        const float4 v2 = load4(vc + 2 * HD);
        const float4 v3 = load4(vc + 3 * HD);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
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
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg + kRG * i;
    if (row >= Sq) continue;
    const bool any = l[i] > 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (!chunk_in_head<HD>(c, cg)) continue;
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
  using F = F32Tile<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(F::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, HD><<<grid, F::kThreads, F::kSmemBytes, stream>>>(
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
    case 80:
      return launch<T, 80>(q, k, v, o, B, Sq, Sk, H, KV, q_offset, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, q_offset, causal,
                            window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, KV, q_offset, causal,
                            window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: Hopper kernel (wgmma + TMA)
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                         // query rows a warpgroup
constexpr int kConsumers = 2;                       // consumer warpgroups
constexpr int kBQ90 = kWgRows * kConsumers;         // query rows a block
constexpr int kStages = 2;                          // K/V ring depth
constexpr int kThreads90 = 128 * kConsumers + 32;   // + one producer warp
constexpr int kProducerWarp = 4 * kConsumers;
// A nonzero return of the launcher is a cudaError_t, or this plus the
// CUresult of a tensor map that could not be encoded.
constexpr int kTensorMapError = 30000;

template <int HD>
struct Tile {
  // Keys a tile: 128, or 64 from hd = 128 up (registers; shared memory at
  // hd = 256).
  static constexpr int kBK = HD >= 128 ? 64 : 128;
  // Columns a panel (one TMA box): 64 where hd is a multiple of 64, else 32
  // (hd = 32) or 16 (hd = 80).
  static constexpr int kPanelCols = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static constexpr int kPanels = HD / kPanelCols;
  static constexpr int kRowBytes = 2 * kPanelCols;  // one atom row
  // wgmma descriptor swizzle: 1 = 128 B, 2 = 64 B, 3 = 32 B.
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kSBO = 8 * kRowBytes;  // 8-row groups (one atom)
  static constexpr int kQPanelBytes = kBQ90 * kRowBytes;
  static constexpr int kKVPanelBytes = kBK * kRowBytes;
  static constexpr int kQBytes = kPanels * kQPanelBytes;
  static constexpr int kKVBytes = kPanels * kKVPanelBytes;  // one K or V tile
  // Output columns of one PV product (its wgmma N) and the products a tile.
  static constexpr int kPVCols = HD > 128 ? 128 : HD;
  static constexpr int kPVGroups = HD / kPVCols;
  static constexpr int kPVPanels = kPVCols / kPanelCols;  // panels a product
  // 1024 B of slack to align the tiles, and the 2 kStages + 1 mbarriers.
  static constexpr int kSmemBytes =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (2 * kStages + 1);
  static_assert(HD % 16 == 0 && kPanels * kPanelCols == HD,
                "hd must be a multiple of 16");
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 4-D tensor map into shared memory at `dst`, completing
// its bytes on `bar`. Coordinates innermost first: (col, head, row, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16 B units), swizzle layout (1 = 128 B, 2 = 64 B, 3 = 32 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (no instruction is emitted).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define FA_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FA_F16(i) FA_F4(i), FA_F4(i + 4), FA_F4(i + 8), FA_F4(i + 12)

// d (64 x 64, float32) = or += A (64 x 16) B (16 x 64): A and B K-major
// bf16 in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FA_F16(0), FA_F16(16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same with N = 128.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : FA_F16(0), FA_F16(16), FA_F16(32), FA_F16(48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, float32) += A (64 x 16, bf16 registers) B (16 x 32): B
// MN-major (transposed) bf16 in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : FA_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same with N = 64.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : FA_F16(0), FA_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same with N = 80.
__device__ __forceinline__ void wgmma_rs(float (&d)[40],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
      "}\n"
      : FA_F16(0), FA_F16(16), FA_F4(32), FA_F4(36)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same with N = 128.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n"
      "}\n"
      : FA_F16(0), FA_F16(16), FA_F16(32), FA_F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FA_F16
#undef FA_F4

// S (64 x kBK) = Q K^T for one warpgroup: q_tile holds its 64 query rows
// (each panel's rows at a stride of one atom row), k_tile one K stage.
template <int HD>
__device__ __forceinline__ void qk_product(float (&s)[Tile<HD>::kBK / 2],
                                           uint32_t q_tile, uint32_t k_tile) {
  using T = Tile<HD>;
  constexpr int kStepsPerPanel = T::kPanelCols / 16;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t col = (ks % kStepsPerPanel) * 32;  // bytes in the row
    const uint32_t panel = ks / kStepsPerPanel;
    wgmma_ss(s,
             gmma_desc(q_tile + panel * T::kQPanelBytes + col, 16, T::kSBO,
                       T::kLayout),
             gmma_desc(k_tile + panel * T::kKVPanelBytes + col, 16, T::kSBO,
                       T::kLayout),
             ks > 0);
  }
  wgmma_commit_and_wait();
  fence_regs(s);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// O (64 x HD) += P V for one warpgroup. P is the S accumulator fragment
// rounded to bf16: columns 16 kk .. 16 kk + 15 of S (its n8 chunks 2 kk and
// 2 kk + 1) are exactly the A-register fragment of the kk-th K step. O is
// held as kPVGroups accumulators of kPVCols columns, one wgmma each a step.
template <int HD>
__device__ __forceinline__ void pv_product(
    float (&o)[Tile<HD>::kPVGroups][Tile<HD>::kPVCols / 2],
    const float (&p)[Tile<HD>::kBK / 2], uint32_t v_tile) {
  using T = Tile<HD>;
  uint32_t a[T::kBK / 16][4];
#pragma unroll
  for (int kk = 0; kk < T::kBK / 16; ++kk) {
    a[kk][0] = pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);  // row g,   k 2t
    a[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);  // row g+8, k 2t
    a[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);  // row g,   k 2t+8
    a[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);  // row g+8, k 2t+8
  }
#pragma unroll
  for (int g = 0; g < T::kPVGroups; ++g) fence_regs(o[g]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::kBK / 16; ++kk)
#pragma unroll
    for (int g = 0; g < T::kPVGroups; ++g)
      // V rows 16 kk .. 16 kk + 15 (two 8-row atom groups, kSBO apart) of
      // the product's kPVPanels panels (kKVPanelBytes apart: the leading
      // byte offset).
      wgmma_rs(o[g], a[kk],
               gmma_desc(v_tile + g * T::kPVPanels * T::kKVPanelBytes +
                             kk * 16 * T::kRowBytes,
                         T::kKVPanelBytes, T::kSBO, T::kLayout));
  wgmma_commit_and_wait();
#pragma unroll
  for (int g = 0; g < T::kPVGroups; ++g) fence_regs(o[g]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads90, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int KV,
               int q_offset, int causal, int window, float scale_log2) {
  using T = Tile<HD>;
  constexpr int kTileK = T::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + T::kQBytes;             // stage s: + s * kKVBytes
  const uint32_t sv = sk + kStages * T::kKVBytes;  // stage s: + s * kKVBytes
  const uint32_t bar_full = sv + kStages * T::kKVBytes;  // 8 B a barrier
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_q = bar_empty + 8 * kStages;

  // Longest causal tiles first, so the short ones fill the tail of the grid.
  const int n_qt = (Sq + kBQ90 - 1) / kBQ90;
  const int h = blockIdx.x % H;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / H) * kBQ90;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  // The keys this block's queries can see: [k_begin, k_end).
  const int p_lo = q_offset + q0;
  const int p_hi = q_offset + min(q0 + kBQ90, Sq) - 1;
  const int k_end = causal ? min(Sk, p_hi + 1) : Sk;
  int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  k_begin = (k_begin / kTileK) * kTileK;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kTileK - 1) / kTileK : 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * kConsumers);  // lane 0 of each warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, T::kQBytes);
      for (int p = 0; p < T::kPanels; ++p)
        tma_load(sq + p * T::kQPanelBytes, &tm_q, bar_q, p * T::kPanelCols,
                 h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        // Reuse a stage once both warpgroups have released its last use.
        if (i >= kStages) mbar_wait(bar_empty + 8 * s, ((i / kStages) + 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * T::kKVBytes);
        const int k0 = k_begin + i * kTileK;
        for (int p = 0; p < T::kPanels; ++p) {
          const uint32_t off = s * T::kKVBytes + p * T::kKVPanelBytes;
          tma_load(sk + off, &tm_k, full, p * T::kPanelCols, kvh, k0, b);
          tma_load(sv + off, &tm_v, full, p * T::kPanelCols, kvh, k0, b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows q0 + 64 wg + [0, 64). This thread
  // holds rows row_a and row_a + 8 of them.
  const int wg = warp / 4;
  const int t4 = lane % 4;
  const int row_a = q0 + wg * kWgRows + (warp % 4) * 16 + lane / 4;
  const int pos_a = q_offset + row_a;
  const int pos_b = pos_a + 8;
  const int wp_lo = q_offset + q0 + wg * kWgRows;  // the warpgroup's rows
  const int wp_hi = wp_lo + kWgRows - 1;
  const uint32_t q_tile = sq + wg * kWgRows * T::kRowBytes;

  // O's columns 8 j + 2 t4 + {0, 1} (rows a, b) of PV group j / kJ lie in
  // o_acc[j / kJ][4 (j % kJ) + {0, 1} ({2, 3})].
  constexpr int kJ = T::kPVCols / 8;
  float s_acc[kTileK / 2];
  float o_acc[T::kPVGroups][T::kPVCols / 2];
#pragma unroll
  for (int i = 0; i < kTileK / 2; ++i) s_acc[i] = 0.0f;
#pragma unroll
  for (int g = 0; g < T::kPVGroups; ++g)
#pragma unroll
    for (int i = 0; i < T::kPVCols / 2; ++i) o_acc[g][i] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max, raw score units
  float l_a = 0.0f, l_b = 0.0f;  // this thread's share of the row sums

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int k0 = k_begin + i * kTileK;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
    const bool sees_keys = !(causal && k0 > wp_hi) &&
                           !(window > 0 && k0 + kTileK - 1 <= wp_lo - window);
    if (sees_keys) {
      qk_product<HD>(s_acc, q_tile, sk + s * T::kKVBytes);

      const bool straddles = k0 + kTileK > Sk ||
                             (causal && k0 + kTileK - 1 > wp_lo) ||
                             (window > 0 && k0 <= wp_hi - window);
      if (straddles) {
#pragma unroll
        for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
            const int qpos = e < 2 ? pos_a : pos_b;
            const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            if (!ok) s_acc[4 * j + e] = -INFINITY;
          }
      }

      // Online softmax of rows a and b, each spread over a quad.
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s_acc[4 * j], s_acc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s_acc[4 * j + 2], s_acc[4 * j + 3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      // A row with no valid key yet keeps p = 0 and alpha = 0.
      const float mu_a = mx_a == -INFINITY ? 0.0f : mx_a;
      const float mu_b = mx_b == -INFINITY ? 0.0f : mx_b;
      const float alpha_a = exp2f((m_a - mu_a) * scale_log2);
      const float alpha_b = exp2f((m_b - mu_b) * scale_log2);
      const float nb_a = -mu_a * scale_log2;
      const float nb_b = -mu_b * scale_log2;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
        s_acc[4 * j] = exp2f(fmaf(s_acc[4 * j], scale_log2, nb_a));
        s_acc[4 * j + 1] = exp2f(fmaf(s_acc[4 * j + 1], scale_log2, nb_a));
        s_acc[4 * j + 2] = exp2f(fmaf(s_acc[4 * j + 2], scale_log2, nb_b));
        s_acc[4 * j + 3] = exp2f(fmaf(s_acc[4 * j + 3], scale_log2, nb_b));
        sum_a += s_acc[4 * j] + s_acc[4 * j + 1];
        sum_b += s_acc[4 * j + 2] + s_acc[4 * j + 3];
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
      m_a = mx_a;
      m_b = mx_b;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        float* oj = o_acc[j / kJ] + 4 * (j % kJ);
        oj[0] *= alpha_a;
        oj[1] *= alpha_a;
        oj[2] *= alpha_b;
        oj[3] *= alpha_b;
      }
      pv_product<HD>(o_acc, s_acc, sv + s * T::kKVBytes);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  // o = acc / l; rows that never saw a valid key (l == 0) are zero.
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = l_a > 0.0f ? 1.0f / l_a : 0.0f;
  const float inv_b = l_b > 0.0f ? 1.0f / l_b : 0.0f;
  const size_t q_row = static_cast<size_t>(H) * HD;
  __nv_bfloat16* ob = o + static_cast<size_t>(b) * Sq * q_row + h * HD + 2 * t4;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const float* oj = o_acc[j / kJ] + 4 * (j % kJ);
    if (row_a < Sq)
      *reinterpret_cast<uint32_t*>(ob + row_a * q_row + 8 * j) =
          pack_bf16(oj[0] * inv_a, oj[1] * inv_a);
    if (row_a + 8 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (row_a + 8) * q_row + 8 * j) =
          pack_bf16(oj[2] * inv_b, oj[3] * inv_b);
  }
}

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once.
EncodeTiledFn encode_tiled(int* rc) {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      *rc = err != cudaSuccess ? static_cast<int>(err)
                               : static_cast<int>(cudaErrorSymbolNotFound);
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a contiguous bf16 (B, S, heads, HD) tensor whose box is
// `rows` rows of `cols` columns of one head of one batch row. Rows past S
// are filled with zeros.
int encode_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
               int HD, int cols, int rows, CUtensorMapSwizzle swizzle) {
  int rc = 0;
  EncodeTiledFn encode = encode_tiled(&rc);
  if (encode == nullptr) return rc;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * HD;  // bytes
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(res);
}

template <int HD>
int launch_sm90(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Sk, int H, int KV, int q_offset, int causal,
                int window, float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  constexpr CUtensorMapSwizzle kSwizzle =
      T::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = encode_map(&tm_q, q, B, Sq, H, HD, T::kPanelCols, kBQ90, kSwizzle);
  if (rc == 0)
    rc = encode_map(&tm_k, k, B, Sk, KV, HD, T::kPanelCols, T::kBK, kSwizzle);
  if (rc == 0)
    rc = encode_map(&tm_v, v, B, Sk, KV, HD, T::kPanelCols, T::kBK, kSwizzle);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((Sq + kBQ90 - 1) / kBQ90) * H, 1, B);
  const float scale_log2 =
      static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  flash_fwd_sm90<HD><<<grid, kThreads90, T::kSmemBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KV,
      q_offset, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); contiguous, 16-byte aligned,
// one dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the wgmma +
// TMA kernel). hd in {32, 64, 80, 128, 256} in both, H % KV == 0, window
// <= 0 for none; any other hd returns cudaErrorInvalidValue.
// Launches on `stream` and returns 0 when the launch was accepted, else a
// cudaError_t, or kTensorMapError (30000) + the CUresult of a tensor map
// that could not be encoded.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Sq, int Sk, int H, int KV,
                                      int hd, int q_offset, int causal,
                                      int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                            causal, window, scale, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch_sm90<32>(q, k, v, o, B, Sq, Sk, H, KV, q_offset, causal,
                             window, scale, s);
    case 64:
      return launch_sm90<64>(q, k, v, o, B, Sq, Sk, H, KV, q_offset, causal,
                             window, scale, s);
    case 80:
      return launch_sm90<80>(q, k, v, o, B, Sq, Sk, H, KV, q_offset, causal,
                             window, scale, s);
    case 128:
      return launch_sm90<128>(q, k, v, o, B, Sq, Sk, H, KV, q_offset, causal,
                              window, scale, s);
    case 256:
      return launch_sm90<256>(q, k, v, o, B, Sq, Sk, H, KV, q_offset, causal,
                              window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
