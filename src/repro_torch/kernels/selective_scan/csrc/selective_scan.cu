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
// moves 809 MB (x, dt and y dominate, 268 MB each): 0.2415 ms at the card's
// 3.35 TB/s. Its 1.07e9 exps take 0.257 ms on the special-function units
// (16 a clock an SM), its 6.6e9 other FLOPs 0.099 ms at the float32 peak.
// Both floors need the whole card busy: B * D * N = 524,288 independent
// (channel, state) recurrences, each a chain of S dependent steps.
//
// Design, against each floor:
// - Parallelism (latency). A channel's N states are split over 4 lanes of a
//   warp, N/4 states and their slice of A in each lane's registers; a warp
//   covers 8 channels and a block of 256 threads 64 neighbouring channels of
//   one batch row. At the falcon shape that is 512 blocks of 8 warps, 4
//   blocks (at most 64 registers a thread) on each SM in one wave: ~31 warps
//   an SM. Each step a lane sums its states' h * C. The channel's 4 lanes
//   combine their partial sums of a group of 4 steps in one reduce-scatter
//   (3 shuffles, lanes xor 1 then xor 2: the butterfly's order), after
//   which lane s holds step s's sum, adds D * x and stores it: one store a
//   lane for 4 steps, no lane idle.
// - Bytes. The block walks the sequence in tiles of kT steps. A tile of x
//   and dt (kT x 64 channels) and of B and C (kT x N) lands in a 2-stage
//   ring in shared memory by cp.async (16 B a copy where rows are 16 B
//   aligned, 4 B otherwise: B and C may be strided split views whose rows
//   are not), so tile i+1 streams in while tile i's steps run. The lanes of
//   a channel read x and dt as shared-memory broadcasts, and B and C as one
//   vector load each. x, dt and y are read or written once.
// - Exps. exp(dt * A) is computed as ex2.approx.ftz(dt * (A * log2 e)): one
//   FMUL and one MUFU.EX2 a state, where expf takes several instructions.
//   Its relative error (about 2 ulp) stays far inside the 3e-5 gate held
//   against the plain version, which sums in another order.
// Rows past S (the last tile) and channels past D are zero-filled, so the
// steps run in whole groups of 4 (a zero row leaves h as it is) and the
// stores are masked; nothing is padded in device memory. The initial state
// comes from h0 when the pointer is not null; the final h is written once,
// after the last tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                     // threads a block
constexpr int kLanes = 4;                         // lanes a channel
constexpr int kChannels = kThreads / kLanes;      // channels a block: 64
constexpr int kT = 32;                            // timesteps a tile
constexpr int kBlocksPerSM = 4;                   // 64 registers a thread
constexpr float kLog2e = 1.4426950408889634f;

// One stage of the ring: x and dt (kT x 64 channels), B and C (kT x N).
template <int N>
struct Stage {
  float xdt[2][kT][kChannels];
  float bc[2][kT][N];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy, global -> shared, bypassing L1; src_bytes 0 fills zeros.
__device__ __forceinline__ void copy16(void* dst, const float* src,
                                       bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void copy4(void* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// A lane's kS states of one row of B or C, in 16-byte (or 8-byte) loads.
template <int kS>
__device__ __forceinline__ void load_states(float* v, const float* row) {
  if constexpr (kS % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kS; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + j);
      v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kS; j += 2) {
      const float2 q = *reinterpret_cast<const float2*>(row + j);
      v[j] = q.x, v[j + 1] = q.y;
    }
  }
}

// Starts the copies of the tile of steps [t0, t0 + kT) into `st`. Rows past
// S and channels past D are zero-filled: a zero row (dt = x = B = 0) leaves
// h exactly as it is (exp2(0) = 1), so the steps run in whole groups of 4.
template <int N>
__device__ __forceinline__ void stage_tile(
    Stage<N>& st, const float* x, const float* dt, const float* Bb,
    const float* Cb, int b, int d0, int t0, int S, int Dm, long long b_time,
    long long c_time, bool vec_x, bool vec_bc) {
  if (vec_x) {
    // Each thread copies the same 16-byte column chunk of kT / kRowStep
    // rows of x and of dt.
    constexpr int kQ = kChannels / 4;
    constexpr int kRowStep = kThreads / kQ;
    const int d = d0 + 4 * (threadIdx.x % kQ);
#pragma unroll
    for (int pass = 0; pass < kT / kRowStep; ++pass) {
      const int r = threadIdx.x / kQ + pass * kRowStep;
      const bool ok = t0 + r < S && d < Dm;
      const size_t at =
          ok ? (static_cast<size_t>(b) * S + t0 + r) * Dm + d : 0;
      copy16(&st.xdt[0][r][d - d0], x + at, ok);
      copy16(&st.xdt[1][r][d - d0], dt + at, ok);
    }
  } else {
    constexpr int kRowStep = kThreads / kChannels;
    const int d = d0 + threadIdx.x % kChannels;
#pragma unroll 2
    for (int pass = 0; pass < kT / kRowStep; ++pass) {
      const int r = threadIdx.x / kChannels + pass * kRowStep;
      const bool ok = t0 + r < S && d < Dm;
      const size_t at =
          ok ? (static_cast<size_t>(b) * S + t0 + r) * Dm + d : 0;
      copy4(&st.xdt[0][r][d - d0], x + at, ok);
      copy4(&st.xdt[1][r][d - d0], dt + at, ok);
    }
  }
  if (vec_bc) {
    constexpr int kQ = N / 4;
    constexpr int kChunks = 2 * kT * kQ;
#pragma unroll
    for (int pass = 0; pass < (kChunks + kThreads - 1) / kThreads; ++pass) {
      const int i = threadIdx.x + pass * kThreads;
      if (kChunks % kThreads != 0 && i >= kChunks) break;
      const int a = i / (kT * kQ), r = (i / kQ) % kT, q = i % kQ;
      const bool ok = t0 + r < S;
      const float* src = a ? Cb + (ok ? (t0 + r) * c_time : 0)
                           : Bb + (ok ? (t0 + r) * b_time : 0);
      copy16(&st.bc[a][r][4 * q], src + 4 * q, ok);
    }
  } else {
    constexpr int kChunks = 2 * kT * N;
    static_assert(kChunks % kThreads == 0, "whole passes");
#pragma unroll 2
    for (int pass = 0; pass < kChunks / kThreads; ++pass) {
      const int i = threadIdx.x + pass * kThreads;
      const int a = i / (kT * N), r = (i / N) % kT, n = i % N;
      const bool ok = t0 + r < S;
      const float* src = a ? Cb + (ok ? (t0 + r) * c_time : 0)
                           : Bb + (ok ? (t0 + r) * b_time : 0);
      copy4(&st.bc[a][r][n], src + n, ok);
    }
  }
}

// The reduce-scatter of a group of 4 steps over a channel's 4 lanes: lane
// `sub` holds its partial sums part[0..3] of the 4 steps and returns the
// channel's sum for step `sub`. Round 1 (lanes xor 1) keeps the steps whose
// bit 0 is the lane's and adds the partner's partials of them; round 2
// (lanes xor 2) does the same for bit 1. Each sum is (p0 + p1) + (p2 + p3)
// over the lanes, the order of the butterfly, in 3 shuffles for 4 steps.
__device__ __forceinline__ float reduce_scatter4(const float (&part)[4],
                                                 int sub) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool hi1 = sub & 1, hi2 = sub & 2;
  float lo = hi1 ? part[1] : part[0];  // step bit0 of steps {0, 1}
  float up = hi1 ? part[3] : part[2];  // step bit0 + 2 of steps {2, 3}
  lo += __shfl_xor_sync(kAll, hi1 ? part[0] : part[1], 1);
  up += __shfl_xor_sync(kAll, hi1 ? part[2] : part[3], 1);
  return (hi2 ? up : lo) + __shfl_xor_sync(kAll, hi2 ? lo : up, 2);
}

template <int N>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    selective_scan_fwd(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       const float* __restrict__ Dskip,
                       const float* __restrict__ h0, float* __restrict__ y,
                       float* __restrict__ h_out, int S, int Dm,
                       long long b_batch, long long b_time, long long c_batch,
                       long long c_time, bool vec_x, bool vec_bc) {
  static_assert(kLanes == 4 && kT % kLanes == 0, "4 lanes, whole groups");
  constexpr int kS = N / kLanes;  // states a lane
  __shared__ __align__(16) Stage<N> ring[2];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int ch = threadIdx.x / kLanes;  // the lane's channel in the block
  const int sub = threadIdx.x % kLanes;  // its slice of the states
  const int d = d0 + ch;
  const bool active = d < Dm;
  const float* Bb = Bm + b * b_batch;
  const float* Cb = Cm + b * c_batch;

  // Tile 0 starts landing while the registers are filled.
  stage_tile<N>(ring[0], x, dt, Bb, Cb, b, d0, 0, S, Dm, b_time, c_time,
                vec_x, vec_bc);
  commit();

  float a2[kS], h[kS];
  float skip = 0.f;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    a2[j] = 0.f;
    h[j] = 0.f;
  }
  const size_t state = (static_cast<size_t>(b) * Dm + d) * N + sub * kS;
  if (active) {
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      a2[j] = A[static_cast<size_t>(d) * N + sub * kS + j] * kLog2e;
      if (h0 != nullptr) h[j] = h0[state + j];
    }
    skip = Dskip[d];
  }

  const int tiles = (S + kT - 1) / kT;
  for (int i = 0; i < tiles; ++i) {
    wait_all();  // this thread's copies of tile i have landed
    // Every thread's copies of tile i have landed, and every thread is done
    // with tile i - 1, whose stage tile i + 1 takes: it lands while tile i's
    // steps run.
    __syncthreads();
    if (i + 1 < tiles) {
      stage_tile<N>(ring[(i + 1) & 1], x, dt, Bb, Cb, b, d0, (i + 1) * kT, S,
                    Dm, b_time, c_time, vec_x, vec_bc);
      commit();
    }

    const Stage<N>& st = ring[i & 1];
    const int t0 = i * kT;
    const int nt = min(kT, S - t0);  // uniform across the block
    // This lane stores step t0 + k0 + sub of each group: y[b, t, d].
    float* yt = y + (static_cast<size_t>(b) * S + t0 + sub) * Dm + d;
#pragma unroll 2
    for (int k0 = 0; k0 < nt; k0 += kLanes) {
      float part[kLanes], xs[kLanes];
#pragma unroll
      for (int s = 0; s < kLanes; ++s) {
        const int k = k0 + s;
        const float xv = st.xdt[0][k][ch];
        const float dtv = st.xdt[1][k][ch];
        float bv[kS], cv[kS];
        load_states<kS>(bv, &st.bc[0][k][kS * sub]);
        load_states<kS>(cv, &st.bc[1][k][kS * sub]);
        const float dx = dtv * xv;
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          h[j] = fmaf(ex2(dtv * a2[j]), h[j], dx * bv[j]);
          p = fmaf(h[j], cv[j], p);
        }
        part[s] = p;
        xs[s] = xv;
      }
      const float sum = reduce_scatter4(part, sub);
      const float xv = sub == 0 ? xs[0] : sub == 1 ? xs[1]
                     : sub == 2 ? xs[2] : xs[3];
      if (active && k0 + sub < nt) yt[k0 * Dm] = fmaf(skip, xv, sum);
    }
  }

  if (active) {
#pragma unroll
    for (int j = 0; j < kS; ++j) h_out[state + j] = h[j];
  }
}

// Shared-memory carveout set to its largest, so 4 blocks of 40 KB fit.
template <int N>
int prepare() {
  static const int rc = static_cast<int>(cudaFuncSetAttribute(
      selective_scan_fwd<N>, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared)));
  return rc;
}

template <int N>
int launch(const float* x, const float* dt, const float* A, const float* B,
           const float* C, const float* D, const float* h0, float* y,
           float* h, int Bsz, int S, int Dm, long long b_batch,
           long long b_time, long long c_batch, long long c_time,
           cudaStream_t stream) {
  const int rc = prepare<N>();
  if (rc != 0) return rc;
  const bool vec_x =
      Dm % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt)) %
       16) == 0;
  const bool vec_bc =
      (b_batch | b_time | c_batch | c_time) % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C)) %
       16) == 0;
  const dim3 grid((Dm + kChannels - 1) / kChannels, Bsz);
  selective_scan_fwd<N><<<grid, kThreads, 0, stream>>>(
      x, dt, A, B, C, D, h0, y, h, S, Dm, b_batch, b_time, c_batch, c_time,
      vec_x, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int occupancy(int Bsz, int Dm, int* out) {
  int rc = prepare<N>();
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], selective_scan_fwd<N>, kThreads, 0));
  out[1] = ((Dm + kChannels - 1) / kChannels) * Bsz;
  out[2] = kThreads / 32;
  return rc;
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

// The kernel's occupancy for a launch of Bsz x Dm channels with N states:
// out[0] = blocks an SM can hold (from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] = blocks in the
// grid, out[2] = warps a block. Returns a cudaError (0 = answered).
extern "C" int selective_scan_occupancy(int Bsz, int Dm, int N, int* out) {
  if (N == 8) return occupancy<8>(Bsz, Dm, out);
  if (N == 16) return occupancy<16>(Bsz, Dm, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
