// Rowwise int8 stochastic-rounding quantization for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/quantize/kernel.py
// (_quant_kernel, launched by quantize_kernel). Per row of x (R, D):
//   absmax = max |x|;  scale = absmax / 127 (1.0 where absmax is 0)
//   q      = clip(floor(x / scale + u), -127, 127) as int8
// with the rounding noise u (R, D) drawn by the caller, so the kernel is
// deterministic given u, exactly like the TPU kernel.
//
// Non-finite input (the reference's semantics, which this keeps): a row
// holding a NaN has scale 1.0, because absmax is NaN and NaN > 0 is false;
// a row holding an Inf has scale Inf. Any element whose floor(x/scale + u)
// is NaN gets code 0 (XLA's float->int8 conversion of NaN).
//
// Bound: memory. Each element reads 4 bytes of x and 4 of u and writes one
// code byte (plus 4 bytes of scale per row) for about 7 operations, far below
// the card's 295 ops/byte balance point. At the simulator's shape
// (16,280 rows x 1024 per round) that is ~150 MB per launch, ~45 us at
// 3.35 TB/s. The design keeps the traffic to that minimum: one block per
// row, 16-byte float4 loads of x and u by neighbouring threads, char4
// stores of the codes, and the row's absmax reduced in registers (warp
// shuffles, then one shared-memory pass) so x is read from device memory
// once; the second read of x in the rounding pass is served from cache,
// since the block's row is 4 KB.
//
// Division is IEEE round-to-nearest (__fdiv_rn), never the fast
// approximate form: the +0.5/256 noise grid keeps floor() off integer
// boundaries only when x / scale matches the reference to the ulp.
// Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int8_t code(float x, float scale, float u) {
  float q = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  if (isnan(q)) return 0;
  return static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
}

__global__ void __launch_bounds__(kThreads)
quantize_rows(const float4* __restrict__ x, const float4* __restrict__ u,
              char4* __restrict__ q, float* __restrict__ scale,
              int vec_per_row) {
  __shared__ float warp_max[kWarps];
  __shared__ int warp_nan[kWarps];
  __shared__ float row_scale;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x;  // one block per row
  const float4* xr = x + static_cast<size_t>(r) * vec_per_row;
  const float4* ur = u + static_cast<size_t>(r) * vec_per_row;
  char4* qr = q + static_cast<size_t>(r) * vec_per_row;

  // Pass 1: the row's absmax, and whether it holds a NaN (fmaxf drops
  // NaN, so it is tracked on the side).
  float m = 0.0f;
  int has_nan = 0;
  for (int i = threadIdx.x; i < vec_per_row; i += kThreads) {
    float4 v = xr[i];
    has_nan |= isnan(v.x) | isnan(v.y) | isnan(v.z) | isnan(v.w);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                       fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    has_nan |= __shfl_xor_sync(0xffffffffu, has_nan, off);
  }
  if (lane == 0) {
    warp_max[warp] = m;
    warp_nan[warp] = has_nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bm = warp_max[0];
    int bn = warp_nan[0];
    for (int w = 1; w < kWarps; ++w) {
      bm = fmaxf(bm, warp_max[w]);
      bn |= warp_nan[w];
    }
    float s = (bn || !(bm > 0.0f)) ? 1.0f : __fdiv_rn(bm, 127.0f);
    row_scale = s;
    scale[r] = s;
  }
  __syncthreads();
  const float s = row_scale;

  // Pass 2: stochastic rounding, four codes per 4-byte store.
  for (int i = threadIdx.x; i < vec_per_row; i += kThreads) {
    float4 v = xr[i];
    float4 n = ur[i];
    qr[i] = make_char4(code(v.x, s, n.x), code(v.y, s, n.y),
                       code(v.z, s, n.z), code(v.w, s, n.w));
  }
}

}  // namespace

// x, u: (rows, cols) float32, contiguous, 16-byte aligned, cols % 4 == 0.
// q: (rows, cols) int8; scale: (rows,) float32. Launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int quantize_launch(const void* x, const void* u, void* q,
                               void* scale, int rows, int cols,
                               void* stream) {
  if (rows <= 0) return 0;
  quantize_rows<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(u),
      static_cast<char4*>(q), static_cast<float*>(scale), cols / 4);
  return static_cast<int>(cudaGetLastError());
}
