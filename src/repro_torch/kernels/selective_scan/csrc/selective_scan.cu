// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/selective_scan/kernel.py
// (_scan_kernel, launched by selective_scan_kernel and wrapped by
// ops.selective_scan). It computes what repro/kernels/selective_scan/
// ref.py:selective_scan_sequential computes, for x, dt (B, S, D), A (D, N),
// B, C (B, S, N), D (D,) and an optional h0 (B, D, N), all float32:
//   dA  = exp(dt_t * A)                      (B, D, N)
//   h_t = dA * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = sum_n h_t * C_t + D * x_t
// and writes y (B, S, D) and the final h (B, D, N), float32.
//
// Bound. At the falcon-mamba-7b prefill (B=4, S=2048, D=8192, N=16) one call
// moves 809 MB (x, dt and y dominate, 268 MB each) and does 6.5e9 FLOPs and
// 1.07e9 exps: 0.24 ms at the card's 3.35 TB/s, 0.10 ms of float32 FLOPs,
// and about 0.26 ms of exps on the special-function units (16 a clock an
// SM). This first kernel is latency-bound, far from either: each thread
// walks all S steps of one channel in order.
//
// Design. One thread owns one (batch, channel) and keeps its N states and
// its row of A in registers (N is a template parameter, 8 or 16). A block
// of 128 threads covers 128 neighbouring channels of one batch row, so the
// loads of x and dt and the stores of y are coalesced across the block. The
// block walks the sequence in tiles of kT steps: it stages the tile's B_t
// and C_t (shared by every channel of the row) in shared memory, and each
// thread loads its channel's kT values of x and dt into registers in one
// burst of independent loads before it runs the tile's steps in order. B
// and C may be strided views (the split of the x projection): the wrapper
// passes their batch and time strides, and their last dim is contiguous.
// A ragged S (last tile) and a ragged D (threads past D) are masked by
// bounds; nothing is padded. The final h is written once, after the last
// tile. The initial state comes from h0 when the pointer is not null.
//
// Precise expf (no fast math), so the output stays within float32
// tolerance of the plain version, which sums in another order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kT = 32;         // timesteps a tile

template <int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_fwd(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       const float* __restrict__ Dskip,
                       const float* __restrict__ h0, float* __restrict__ y,
                       float* __restrict__ h_out, int S, int Dm,
                       long long b_batch, long long b_time, long long c_batch,
                       long long c_time) {
  __shared__ __align__(16) float sB[kT][N];
  __shared__ __align__(16) float sC[kT][N];

  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < Dm;

  float a[N], h[N];
  float skip = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = 0.f;
    h[n] = 0.f;
  }
  const size_t state = (static_cast<size_t>(b) * Dm + d) * N;
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      a[n] = A[static_cast<size_t>(d) * N + n];
      if (h0 != nullptr) h[n] = h0[state + n];
    }
    skip = Dskip[d];
  }

  const size_t row = static_cast<size_t>(b) * S * Dm + d;  // x[b, 0, d]
  const float* Bb = Bm + b * b_batch;
  const float* Cb = Cm + b * c_batch;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int nt = min(kT, S - t0);
    __syncthreads();  // the previous tile's B and C are no longer read
    for (int i = threadIdx.x; i < kT * N; i += kThreads) {
      const int k = i / N;
      const int n = i % N;
      float bv = 0.f, cv = 0.f;
      if (k < nt) {
        bv = Bb[(t0 + k) * b_time + n];
        cv = Cb[(t0 + k) * c_time + n];
      }
      sB[k][n] = bv;
      sC[k][n] = cv;
    }
    float xs[kT], dts[kT];
#pragma unroll
    for (int k = 0; k < kT; ++k) {
      const bool ok = active && k < nt;
      const size_t at = row + static_cast<size_t>(t0 + k) * Dm;
      xs[k] = ok ? x[at] : 0.f;
      dts[k] = ok ? dt[at] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kT; ++k) {
      if (k < nt) {  // uniform across the block: only the last tile is short
        const float dtv = dts[k];
        const float dx = dtv * xs[k];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float dA = expf(dtv * a[n]);
          h[n] = dA * h[n] + dx * sB[k][n];
          acc += h[n] * sC[k][n];
        }
        if (active)
          y[row + static_cast<size_t>(t0 + k) * Dm] = acc + skip * xs[k];
      }
    }
  }

  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[state + n] = h[n];
  }
}

template <int N>
int launch(const float* x, const float* dt, const float* A, const float* B,
           const float* C, const float* D, const float* h0, float* y,
           float* h, int Bsz, int S, int Dm, long long b_batch,
           long long b_time, long long c_batch, long long c_time,
           cudaStream_t stream) {
  const dim3 grid((Dm + kThreads - 1) / kThreads, Bsz);
  selective_scan_fwd<N><<<grid, kThreads, 0, stream>>>(
      x, dt, A, B, C, D, h0, y, h, S, Dm, b_batch, b_time, c_batch, c_time);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the scan on `stream`; returns cudaGetLastError() (0 = launched).
// h0 may be null (a zero initial state). N must be 8 or 16.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* A, const void* B,
                                     const void* C, const void* D,
                                     const void* h0, void* y, void* h,
                                     int Bsz, int S, int Dm, int N,
                                     long long b_batch, long long b_time,
                                     long long c_batch, long long c_time,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* args[7] = {
      static_cast<const float*>(x),  static_cast<const float*>(dt),
      static_cast<const float*>(A),  static_cast<const float*>(B),
      static_cast<const float*>(C),  static_cast<const float*>(D),
      static_cast<const float*>(h0)};
  if (N == 8)
    return launch<8>(args[0], args[1], args[2], args[3], args[4], args[5],
                     args[6], static_cast<float*>(y), static_cast<float*>(h),
                     Bsz, S, Dm, b_batch, b_time, c_batch, c_time, s);
  if (N == 16)
    return launch<16>(args[0], args[1], args[2], args[3], args[4], args[5],
                      args[6], static_cast<float*>(y), static_cast<float*>(h),
                      Bsz, S, Dm, b_batch, b_time, c_batch, c_time, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
