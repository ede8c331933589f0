// RMSNorm forward for Hopper (sm_90a):  y = x * rsqrt(mean(x^2) + eps) * (1 + g)
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_fused (a
// Pallas grid over row blocks of 256 rows held whole in VMEM).  Here a block
// owns one row: its threads stride over the H columns, sum the squares in
// fp32, reduce with warp shuffles and one shared-memory step, then write the
// scaled row in x's dtype.  The operation order follows the reference
// ((x32 * inv) * (1 + g32), cast last) so f32 results agree to rounding.
//
// Bound: device-memory bytes.  The work is 2*N*H*sizeof(x) + H*sizeof(g)
// bytes over 3.35 TB/s against ~4*N*H fp32 operations, far below the
// operations-per-byte the card needs to be compute bound.  At decode sizes
// (N = batch = 2 rows) the launch latency of a few microseconds bounds it
// instead.  This first version is simple and right: scalar loads, one row a
// block, 256 threads.  Vectorised 16-byte loads and several rows a block are
// the obvious next steps.
//
// Plain C interface, bound with ctypes: the wrapper passes raw pointers, the
// shape, dtype codes (0 = float32, 1 = bfloat16) and the CUDA stream, and
// raises if the returned cudaGetLastError() code is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch/XLA cast
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
                   TX* __restrict__ y, int h, float eps) {
  __shared__ float warp_sums[kThreads / 32];
  const size_t row = blockIdx.x;
  const TX* xr = x + row * (size_t)h;
  TX* yr = y + row * (size_t)h;

  float ss = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {  // i < h masks the tail
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(warp_sums[0] / (float)h + eps);

  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float v = to_f32(xr[i]);
    yr[i] = from_f32<TX>((v * inv) * (1.f + to_f32(g[i])));
  }
}

template <typename TX, typename TG>
void launch(const void* x, const void* g, void* y, long long n, int h, float eps,
            cudaStream_t stream) {
  rmsnorm_fwd_kernel<TX, TG><<<(unsigned)n, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(g), static_cast<TX*>(y), h, eps);
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* g, void* y, long long n, int h,
                           int x_dtype, int g_dtype, float eps, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || h < 1 || x_dtype < 0 || x_dtype > 1 || g_dtype < 0 ||
      g_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && g_dtype == 0) launch<float, float>(x, g, y, n, h, eps, s);
  if (x_dtype == 0 && g_dtype == 1) launch<float, __nv_bfloat16>(x, g, y, n, h, eps, s);
  if (x_dtype == 1 && g_dtype == 0) launch<__nv_bfloat16, float>(x, g, y, n, h, eps, s);
  if (x_dtype == 1 && g_dtype == 1) launch<__nv_bfloat16, __nv_bfloat16>(x, g, y, n, h, eps, s);
  return (int)cudaGetLastError();
}
