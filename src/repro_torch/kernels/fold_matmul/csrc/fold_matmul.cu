// Batched float32 matrix product whose every output is a left fold over k,
// for Hopper (sm_90a).
//
//   C[z] = A[z] @ B[z]     A (batch, M, K), B (batch, K, N) at any strides
//                          (a stride of 0 broadcasts), C (batch, M, N)
//                          contiguous
//   C[z, m, n] = fma(A[z,m,K-1], B[z,K-1,n], ... fma(A[z,m,0], B[z,0,n], 0))
//
// Replaces the XLA dot products of the reference's CNN (repro/models/cnn.py:
// `_ps_matmul` and the dense layers), which its Study relies on to keep a
// padded member bit-identical to its run alone. There is no Pallas kernel
// behind them. A library GEMM does not give that: cuBLAS and cuDNN pick
// another algorithm (tile, split-K, Winograd) for another batch or row
// count, and a split or re-associated K sum rounds differently. Here each
// output is one thread's chain of fmaf over k = 0..K-1 in order, whatever
// the shapes, so:
//   * a row of C depends only on its row of A and on B: the number of rows,
//     of batch entries and of blocks never changes it;
//   * zeros appended to K (a batch padded with zero-cotangent samples, when
//     K runs over samples) leave every output as it was: fmaf(0, 0, acc) is
//     acc.
//
// Two routes, the same bits. `tiles`: a 64 x 64 output tile a block of 256
// threads, each thread 4 x 4 outputs strided by 16 so a warp's shared-memory
// reads are broadcasts or consecutive; K walks in steps of 16 through shared
// memory, loaded with the operand's unit stride innermost across threads
// (either layout of A and of B); a tile past M, N or K reads zeros. `rows`:
// one thread an output, K walked straight from device memory, for products
// with few rows or too few tiles to fill the card (a bias gradient, FedAvg's
// sum over clients, a first conv's weight gradient), where a 64 x 64 tile
// would compute mostly padding or leave most SMs idle. Both run the same
// fmaf chain from 0 over k = 0..K-1; the tile route's zeros past K add +0
// to it, which the row route repeats once (it turns a -0 sum into +0 and
// changes nothing else), so the route may follow the shape without moving
// a bit. No split of K, ever: that is the contract, and it is what makes a
// weight gradient over a long K (B * H * W rows) slower than a library's.
//
// Bound: operations for the large products (2 M N K float32 FMAs counted as
// 2 operations at the card's 67 TFLOP/s non-tensor float32 peak; the
// tensor cores' TF32 would round the inputs), bytes for the skinny ones.
// Build without --use_fast_math (fmaf is exact IEEE either way; the point is
// that nothing re-associates the chain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fold_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K,
                   int64_t sAz, int64_t sAm, int64_t sAk,
                   int64_t sBz, int64_t sBk, int64_t sBn) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t z = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  A += z * sAz;
  B += z * sBz;
  C += z * static_cast<int64_t>(M) * N;
  // Which index runs fastest across threads when a tile is loaded: the one
  // with unit stride, so neighbouring threads read neighbouring floats.
  const bool a_k_fast = (sAk == 1);
  const bool b_n_fast = (sBn == 1) || (sBk != 1);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + kThreads * r;
      int mm, kk;
      if (a_k_fast) { kk = e & 15; mm = e >> 4; }
      else          { mm = e & 63; kk = e >> 6; }
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? A[m * sAm + k * sAk] : 0.0f;
      int nn;
      if (b_n_fast) { nn = e & 63; kk = e >> 6; }
      else          { kk = e & 15; nn = e >> 4; }
      const int n = n0 + nn, kb = k0 + kk;
      Bs[kk][nn] = (n < N && kb < K) ? B[kb * sBk + n * sBn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) C[static_cast<int64_t>(m) * N + n] = acc[i][j];
    }
  }
}

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
  if (K % kBK) acc = fmaf(0.0f, 0.0f, acc);  // the tile route's zero tail
  C[(z * M + m) * static_cast<int64_t>(N) + n] = acc;
}

}  // namespace

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

extern "C" int fold_matmul_launch(const float* A, const float* B, float* C,
                                  int batch, int M, int N, int K,
                                  int64_t sAz, int64_t sAm, int64_t sAk,
                                  int64_t sBz, int64_t sBk, int64_t sBn,
                                  void* stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  fold_matmul_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      A, B, C, M, N, K, sAz, sAm, sAk, sBz, sBk, sBn);
  return static_cast<int>(cudaGetLastError());
}
