// Batched float32 matrix product whose every output is a left fold over k,
// for Hopper (sm_90a).
//
//   C[z] = A[z] @ B[z]     A (batch, M, K), B (batch, K, N) at any strides
//                          (a stride of 0 broadcasts), C (batch, M, N)
//                          contiguous
//
// The contract, the same on every route, tile and shape:
//   * every output is fmaf folded from +0 over k = 0..K-1 in ascending
//     order: C[z,m,n] = fma(A[z,m,K-1], B[z,K-1,n], ... fma(A[z,m,0],
//     B[z,0,n], +0));
//   * it then takes exactly one fmaf(0, 0, acc) if K % 16 != 0 (the zeros
//     that pad K to a multiple of 16: it turns a -0 sum into +0 and changes
//     nothing else);
//   * nothing of it depends on M, on the batch, on the route or on the tile.
// So a row of C depends only on its row of A and on B, and zeros appended
// to K (a batch padded with zero-cotangent samples, when K runs over
// samples) leave every output as it was: fmaf(0, 0, acc) is acc up to the
// sign of a zero, and the tail rule fixes that sign.
//
// Replaces the XLA dot products of the reference's CNN (repro/models/cnn.py:
// `_ps_matmul` and the dense layers), which its Study relies on to keep a
// padded member bit-identical to its run alone. There is no Pallas kernel
// behind them. A library GEMM does not give that: cuBLAS and cuDNN pick
// another algorithm (tile, split-K, Winograd) for another batch or row
// count, and a split or re-associated K sum rounds differently. Here each
// output is one thread's chain of fmaf: no split of K, no tensor cores (TF32
// rounds the inputs), every fma written out, and the build has no
// --use_fast_math, so nothing re-associates.
//
// Bound, on an H100: operations for the large products (2 M N K float32
// operations at the card's 67 TFLOP/s outside the tensor cores), bytes for
// the skinny ones, and for long K with few outputs the chain itself: K
// dependent fmas of about 4 cycles each, whatever the card's width.
//
// Three routes, one set of bits (ops.route_for picks one from the shape):
//   rows   one thread an output, K walked straight from device memory
//          (`fold_matmul_rows_kernel`). For short K: FedAvg's client sum,
//          a bias sum over one batch. It is also the bitwise oracle the
//          other routes are held against.
//   tiles  a register-tiled SGEMM (`fold_tile`): a BM x BN output tile a
//          block, TM x TN outputs a thread, K through a ring of STAGES
//          shared-memory stages of BK k filled by cp.async, so the copy of
//          stage t + STAGES - 1 overlaps the math of stage t. 128 x 64 with
//          8 x 4 a thread for the convs' forward, weight and input
//          gradients (64 x 64 with 4 x 4 where its waves fill the card
//          better); 16 x 64 with 2 x 4 for the dense layers at a batch of
//          16 or 32 rows.
//   panel  the same kernel with deep stages (64-256 k) and small slabs, for
//          long K with few outputs (bias gradients, conv1's weight
//          gradient, fc2's forward): a slab of one batch entry's outputs in
//          registers, sized so that batch x slabs nears the card's 132 SMs,
//          and few outputs a thread, so the 4-cycle chain rather than the
//          issue rate binds.
// A stage keeps both operands k-major (As[k][m], Bs[k][n]), so a thread
// reads its rows and columns as float4 / float2 vectors. A copy is 16 bytes
// where the operand's unit stride runs along m (A) or n (B) and the base
// and other strides are 16-byte aligned; else 4 bytes (k-contiguous
// operands, the transposed views with strides of 25, 10 and 800 floats,
// stride-0 broadcasts, sliced bases). Entries past M, N or K are zero-filled
// by the copy itself (src-size 0); the k loop runs to K rounded up to 16,
// so the zeros past K are the tail rule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKStep = 16;  // the tail rule's multiple

// ---------------------------------------------------------------- rows ----

constexpr int kRowThreads = 256;

__global__ void __launch_bounds__(kRowThreads)
fold_matmul_rows_kernel(const float* __restrict__ A,
                        const float* __restrict__ B, float* __restrict__ C,
                        int M, int N, int K, int64_t sAz, int64_t sAm,
                        int64_t sAk, int64_t sBz, int64_t sBk, int64_t sBn) {
  const int n = blockIdx.x * kRowThreads + threadIdx.x;
  const int m = blockIdx.y;
  const int64_t z = blockIdx.z;
  if (n >= N) return;
  const float* a = A + z * sAz + m * sAm;
  const float* b = B + z * sBz + n * sBn;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) acc = fmaf(a[k * sAk], b[k * sBk], acc);
  if (K % kKStep) acc = fmaf(0.0f, 0.0f, acc);  // the tail rule
  C[(z * M + m) * static_cast<int64_t>(N) + n] = acc;
}

// ------------------------------------------------------ cp.async helpers ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `bytes` (0..16) from src and zero-fills the rest of the 16.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// How a stage copies an operand, chosen on the host from its strides.
enum CopyMode : int {
  kVec16 = 0,  // unit stride along m (A) or n (B), 16-byte aligned
  kKFast = 1,  // unit stride along k: 4-byte copies, k fastest
  kXFast = 2,  // anything else: 4-byte copies, m (A) or n (B) fastest
};

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Copies one operand's X x BK tile (x = m for A, n for B; from x0 and k0)
// into a k-major stage s[kk * S + xx]; entries with x >= Xn or k >= K are
// zero-filled by the copy. Each thread owns a fixed (xt, kt) and copies a
// grid of units from it at compile-time steps, so a copy costs a few
// instructions and no branch. Units are 16 bytes along x (kVec16) or one
// float; the threads run along x first, except in kKFast, where 8 or more
// run along k (a warp reads runs of 32 bytes or more of a k-contiguous
// operand, and writes distinct banks: the stage's row stride is 4 x an
// odd number of floats).
template <int X, int BK, int S, int kThreads, int kMode>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          int64_t sx, int64_t sk, int x0,
                                          int Xn, int k0, int K) {
  constexpr int kV = kMode == kVec16 ? 4 : 1;  // floats a unit
  constexpr int kXU = X / kV;                  // units along x
  constexpr int kTK = kMode == kKFast
                          ? cmax(cmin(8, kThreads), kThreads / kXU)
                          : kThreads / cmin(kXU, kThreads);
  constexpr int kTX = kThreads / kTK;
  constexpr int kPX = (kXU + kTX - 1) / kTX, kPK = (BK + kTK - 1) / kTK;
  static_assert(kXU >= 1 && kThreads % kTK == 0, "copy layout");
  const int tid = threadIdx.x;
  const int xt = kMode == kKFast ? tid / kTK : tid % kTX;
  const int kt = kMode == kKFast ? tid % kTK : tid / kTX;
  const float* p = g + static_cast<int64_t>(x0 + xt * kV) * sx +
                   static_cast<int64_t>(k0 + kt) * sk;
  float* d = s + kt * S + xt * kV;
#pragma unroll
  for (int ix = 0; ix < kPX; ++ix) {
    if (kXU % kTX != 0 && xt + ix * kTX >= kXU) break;
    const int left = Xn - (x0 + (xt + ix * kTX) * kV);  // x left in range
#pragma unroll
    for (int ik = 0; ik < kPK; ++ik) {
      if (BK % kTK != 0 && kt + ik * kTK >= BK) break;
      const bool kin = k0 + kt + ik * kTK < K;
      const float* src = p + static_cast<int64_t>(ix * kTX * kV) * sx +
                         static_cast<int64_t>(ik * kTK) * sk;
      float* dst = d + ik * kTK * S + ix * kTX * kV;
      if constexpr (kMode == kVec16) {
        const int bytes = kin && left > 0 ? 4 * cmin(left, 4) : 0;
        cp_async16(dst, bytes ? src : g, bytes);
      } else {
        const bool in = kin && left > 0;
        cp_async4(dst, in ? src : g, in ? 4 : 0);
      }
    }
  }
}

// One operand's tile by its copy mode (uniform across the block).
template <int X, int BK, int S, int kThreads>
__device__ __forceinline__ void load_operand(float* s, const float* g,
                                             int64_t sx, int64_t sk, int x0,
                                             int Xn, int k0, int K,
                                             int mode) {
  if (X >= 4 && mode == kVec16)
    load_tile<X, BK, S, kThreads, (X >= 4 ? kVec16 : kXFast)>(s, g, sx, sk,
                                                             x0, Xn, k0, K);
  else if (mode == kKFast)
    load_tile<X, BK, S, kThreads, kKFast>(s, g, sx, sk, x0, Xn, k0, K);
  else
    load_tile<X, BK, S, kThreads, kXFast>(s, g, sx, sk, x0, Xn, k0, K);
}

template <int V>
__device__ __forceinline__ void load_frag(float* r, const float* p) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x; r[1] = v.y;
  } else {
    r[0] = *p;
  }
}

// ------------------------------------------------------- tiles and panel ----

template <int BM, int BN, int TM, int TN, int BK, int STAGES>
struct Tile {
  static constexpr int kTY = BM / TM, kTX = BN / TN;
  // Threads that own outputs. A block has at least 4 warps: the warps and
  // lanes past the owners only copy stages, so a small slab's compute warp
  // issues a few of its copies, and each copy instruction has 32 lanes.
  static constexpr int kOwners = kTY * kTX;
  static constexpr int kThreads = kOwners < 128 ? 128 : kOwners;
  // Row strides of the k-major stages: 4 floats of padding (16-byte rows,
  // and conflict-free k-fast copies); none for a single row.
  static constexpr int kSA = BM < 4 ? BM : BM + 4;
  static constexpr int kSB = BN < 4 ? BN : BN + 4;
  static constexpr int kStage = BK * (kSA + kSB);  // floats
  static constexpr int kSmemBytes = STAGES * kStage * 4;
  // A thread's rows: TM / kVA groups of kVA consecutive rows (one vector
  // read each), the groups BM / kGA apart; the same for its columns.
  static constexpr int kVA = TM < 4 ? TM : 4, kGA = TM / kVA;
  static constexpr int kVB = TN < 4 ? TN : 4, kGB = TN / kVB;
  // A warp's lanes cover a kWY x kWX patch of the thread grid, so its
  // vector reads of a stage are a few distinct addresses, broadcast.
  static constexpr int kWX = kTX < 8 ? kTX : 8;
  static constexpr int kWY = 32 / kWX < kTY ? 32 / kWX : kTY;
  static constexpr int kMinBlocks = kThreads >= 256 ? 2 : 1;
  static_assert(BM % TM == 0 && BN % TN == 0, "tile");
  static_assert(TM % kVA == 0 && TN % kVB == 0, "vector groups");
  static_assert(BK % kKStep == 0 && BK % 8 == 0, "k stage");
  static_assert(BM == 1 || BM % 4 == 0, "rows");
  static_assert(BN % 4 == 0, "columns");
  static_assert(kTX % kWX == 0 && kTY % kWY == 0, "warp patch");
  static_assert(STAGES >= 2, "ring");
};

template <int BM, int BN, int TM, int TN, int BK, int STAGES>
__global__ void __launch_bounds__(
    (Tile<BM, BN, TM, TN, BK, STAGES>::kThreads),
    (Tile<BM, BN, TM, TN, BK, STAGES>::kMinBlocks))
fold_tile(const float* __restrict__ A, const float* __restrict__ B,
          float* __restrict__ C, int M, int N, int K, int64_t sAz,
          int64_t sAm, int64_t sAk, int64_t sBz, int64_t sBk, int64_t sBn,
          int a_mode, int b_mode) {
  using T = Tile<BM, BN, TM, TN, BK, STAGES>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tiles_m = (M + BM - 1) / BM;
  const int m0 = static_cast<int>(blockIdx.x % tiles_m) * BM;
  const int n0 = static_cast<int>(blockIdx.x / tiles_m) * BN;
  const int64_t z = blockIdx.y;
  const float* a = A + z * sAz;
  const float* b = B + z * sBz;

  const int tid = threadIdx.x;
  const int patch = tid / (T::kWX * T::kWY), lane = tid % (T::kWX * T::kWY);
  const int ty = (patch / (T::kTX / T::kWX)) * T::kWY + lane / T::kWX;
  const int tx = (patch % (T::kTX / T::kWX)) * T::kWX + lane % T::kWX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int n_stages = (K + BK - 1) / BK;
  auto load_stage = [&](int t) {
    float* s = smem + (t % STAGES) * T::kStage;
    const int k0 = t * BK;
    load_operand<BM, BK, T::kSA, T::kThreads>(s, a, sAm, sAk, m0, M, k0, K,
                                              a_mode);
    load_operand<BN, BK, T::kSB, T::kThreads>(s + BK * T::kSA, b, sBn, sBk,
                                              n0, N, k0, K, b_mode);
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_stages) load_stage(t);
    cp_async_commit();
  }

  for (int t = 0; t < n_stages; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage t landed; every thread is done with t - 1
    if (t + STAGES - 1 < n_stages) load_stage(t + STAGES - 1);
    cp_async_commit();

    if (tid >= T::kOwners) continue;
    const float* as = smem + (t % STAGES) * T::kStage;
    const float* bs = as + BK * T::kSA;
    // The stage's k, rounded up to 16: the zeros past K are the tail rule.
    const int left = K - t * BK;
    const int kn = left >= BK ? BK : (left + kKStep - 1) / kKStep * kKStep;
    for (int k16 = 0; k16 < kn; k16 += kKStep) {
#pragma unroll
      for (int u = 0; u < kKStep; ++u) {
        const int kk = k16 + u;
        float ra[TM], rb[TN];
        if constexpr (BM == 1) {
          // One row of A is contiguous along k: one read for 4 k.
          float a4[4];
          load_frag<4>(a4, as + k16 + (u & ~3));
          ra[0] = a4[u & 3];
        } else {
#pragma unroll
          for (int g = 0; g < T::kGA; ++g)
            load_frag<T::kVA>(ra + g * T::kVA,
                              as + kk * T::kSA + g * (BM / T::kGA) +
                                  ty * T::kVA);
        }
#pragma unroll
        for (int g = 0; g < T::kGB; ++g)
          load_frag<T::kVB>(rb + g * T::kVB,
                            bs + kk * T::kSB + g * (BN / T::kGB) +
                                tx * T::kVB);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  if (tid >= T::kOwners) return;

  float* c = C + z * static_cast<int64_t>(M) * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / T::kVA) * (BM / T::kGA) + ty * T::kVA + i % T::kVA;
    if (m >= M) continue;
    float* row = c + static_cast<int64_t>(m) * N;
#pragma unroll
    for (int g = 0; g < T::kGB; ++g) {
      const int n = n0 + g * (BN / T::kGB) + tx * T::kVB;
      const float* v = acc[i] + g * T::kVB;
      if (T::kVB == 4 && (N & 3) == 0 && n + 3 < N) {
        *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < T::kVB; ++j)
          if (n + j < N) row[n + j] = v[j];
      }
    }
  }
}

bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The copy mode of an operand whose x (m or n) and k strides are sx, sk.
int copy_mode(const float* p, int64_t sz, int64_t sx, int64_t sk) {
  if (sx == 1 && aligned16(p) && sk % 4 == 0 && sz % 4 == 0) return kVec16;
  return (sk == 1 && sx != 1) ? kKFast : kXFast;
}

template <int BM, int BN, int TM, int TN, int BK, int STAGES>
int launch_tile(const float* A, const float* B, float* C, int batch, int M,
                int N, int K, int64_t sAz, int64_t sAm, int64_t sAk,
                int64_t sBz, int64_t sBk, int64_t sBn, cudaStream_t stream) {
  using T = Tile<BM, BN, TM, TN, BK, STAGES>;
  auto kernel = fold_tile<BM, BN, TM, TN, BK, STAGES>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t blocks = static_cast<int64_t>((M + BM - 1) / BM) *
                         ((N + BN - 1) / BN);
  if (blocks > 0x7fffffff || batch > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(blocks), batch);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      A, B, C, M, N, K, sAz, sAm, sAk, sBz, sBk, sBn,
      copy_mode(A, sAz, sAm, sAk), copy_mode(B, sBz, sBn, sBk));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The instances, by id: (BM, BN, TM, TN, BK, STAGES). ops.INSTANCES holds
// the same table with each one's name; ops.instance_for picks one.
#define FOLD_INSTANCES(X)      \
  X(0, 128, 64, 8, 4, 32, 3)   \
  X(1, 16, 64, 2, 4, 32, 4)    \
  X(2, 64, 64, 4, 4, 64, 3)    \
  X(3, 32, 8, 2, 2, 128, 4)    \
  X(4, 1, 8, 1, 1, 256, 3)

extern "C" int fold_matmul_tile_launch(int instance, const float* A,
                                       const float* B, float* C, int batch,
                                       int M, int N, int K, int64_t sAz,
                                       int64_t sAm, int64_t sAk, int64_t sBz,
                                       int64_t sBk, int64_t sBn,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (instance) {
#define FOLD_CASE(id, BM, BN, TM, TN, BK, ST)                                \
  case id:                                                                   \
    return launch_tile<BM, BN, TM, TN, BK, ST>(A, B, C, batch, M, N, K, sAz, \
                                               sAm, sAk, sBz, sBk, sBn, s);
    FOLD_INSTANCES(FOLD_CASE)
#undef FOLD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fold_matmul_rows_launch(const float* A, const float* B,
                                       float* C, int batch, int M, int N,
                                       int K, int64_t sAz, int64_t sAm,
                                       int64_t sAk, int64_t sBz, int64_t sBk,
                                       int64_t sBn, void* stream) {
  dim3 grid((N + kRowThreads - 1) / kRowThreads, M, batch);
  fold_matmul_rows_kernel<<<grid, kRowThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      A, B, C, M, N, K, sAz, sAm, sAk, sBz, sBk, sBn);
  return static_cast<int>(cudaGetLastError());
}
