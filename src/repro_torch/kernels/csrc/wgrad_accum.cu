// Weight-gradient accumulation for Hopper (sm_90a):  out = acc + a^T @ g
//
//   a (N, H) and g (N, F), both bfloat16 or both float32, row-major;
//   acc and out (H, F) float32.  The product is summed in fp32 and added to
//   acc last, in the reference's order: out = acc + (a^T g).
//
// Replaces the TPU kernel src/repro/kernels/wgrad_accum.py::wgrad_accum
// (body _kernel).  There the contraction over N is the innermost, sequential
// grid axis, and a VMEM scratch carries each (H, F) tile's partial sums from
// one grid step to the next.  Blocks on Hopper run in no order and carry
// nothing to each other, so here one block owns one output tile and loops
// over all of N itself; acc is read and the tile written once, in the
// epilogue.  Ragged edges in N, H and F are masked: out-of-range rows and
// columns load as zeros and are never stored (the TPU kernel asserts
// divisibility, but the reduced config's 48 x 96 weights do not tile).
//
// Two paths:
//  * bfloat16 inputs: tensor cores through the CUDA wmma API (mma.sync,
//    16x16x16 bf16 fragments, fp32 accumulators).  A block computes a
//    128 x 128 tile with 8 warps of 64 x 32 each; 32-row slices of a and g
//    stream through a two-stage shared-memory ring filled with 16-byte
//    cp.async copies (plain loads where H or F is not a multiple of 8).
//  * float32 inputs: plain fp32 FMA, never TF32 (the reduced f32 model is
//    held to ~1e-5 on the card).  A block computes a 64 x 64 tile, 4 x 4
//    outputs a thread, over 16-row slices in shared memory.
//
// Bound on this card at the training path's shapes (N = b*s = 1024 tokens):
// the work is 2*N*H*F operations against 8*H*F bytes of acc read + out
// written (plus 2*N*(H+F) bytes of a and g), so about N/4 = 256 operations a
// byte, under the ~295 an H100 needs to be compute bound: device-memory
// bytes bound it, narrowly.  At (H, F) = (2048, 8192) that is 155 MB, or
// 0.046 ms at 3.35 TB/s, against 0.035 ms for the 34 GFLOP at 989 TFLOP/s.
// The design keeps acc traffic at its floor (one read and one write, fused
// into the epilogue instead of a separate add over the product) and reads a
// and g once per output tile.  wgmma, TMA and warp specialisation, which
// the tensor-core side would need to approach its rate, are left to later
// work: this first version is simple and right.
//
// Plain C interface, bound with ctypes: the wrapper passes raw pointers,
// the shape, a dtype code (0 = float32, 1 = bfloat16) and the CUDA stream,
// and raises if the returned cudaGetLastError() code is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------- //
// bfloat16 path
// ---------------------------------------------------------------------- //
constexpr int kBM = 128;  // output rows (H) of a block
constexpr int kBN = 128;  // output columns (F) of a block
constexpr int kBK = 32;   // contraction rows (N) per pipeline stage
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;  // 256
constexpr int kWM = kBM / kWarpsM;                // 64 rows a warp
constexpr int kWN = kBN / kWarpsN;                // 32 columns a warp
constexpr int kFM = kWM / 16;                     // 4 fragments down
constexpr int kFN = kWN / 16;                     // 2 fragments across
constexpr int kLdA = kBM + 8;  // shared row pitch (elements): +16 B breaks bank conflicts
constexpr int kLdB = kBN + 8;

struct SmemBf16 {
  bf16 a[2][kBK * kLdA];  // a[n][h] slices, two stages
  bf16 b[2][kBK * kLdB];  // g[n][f] slices, two stages
  float stage[kThreads / 32][16 * 16];  // one accumulator fragment a warp, for the epilogue
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src_bytes = 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + kBK) x columns [col0, col0 + W) of src (rows x cols,
// row-major) into dst (pitch ld), zeros outside src.
template <bool kVec, int W>
__device__ __forceinline__ void load_slice(const bf16* __restrict__ src, int rows, int cols,
                                           int row0, int col0, bf16* dst, int ld) {
  constexpr int kChunksPerRow = W / 8;  // 8 bf16 = 16 bytes a chunk
  for (int c = threadIdx.x; c < kBK * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int cc = (c % kChunksPerRow) * 8;
    const int gr = row0 + r;
    const int gc = col0 + cc;
    bf16* d = dst + r * ld + cc;
    if (kVec) {  // cols % 8 == 0: a chunk lies wholly inside or wholly outside
      const bool in = gr < rows && gc < cols;
      cp_async16(d, in ? src + (size_t)gr * cols + gc : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (gr < rows && gc + e < cols) ? src[(size_t)gr * cols + gc + e]
                                            : __float2bfloat16(0.f);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
wgrad_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ g,
                  const float* __restrict__ acc, float* __restrict__ out, int n, int h, int f) {
  __shared__ __align__(128) SmemBf16 sm;
  const int h0 = blockIdx.y * kBM;
  const int f0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(c[i][j], 0.f);

  const int n_slices = (n + kBK - 1) / kBK;
  load_slice<kVec, kBM>(a, n, h, 0, h0, sm.a[0], kLdA);
  load_slice<kVec, kBN>(g, n, f, 0, f0, sm.b[0], kLdB);
  cp_async_commit();
  for (int kt = 0; kt < n_slices; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_slices) {  // the other stage was released by the last barrier
      load_slice<kVec, kBM>(a, n, h, (kt + 1) * kBK, h0, sm.a[cur ^ 1], kLdA);
      load_slice<kVec, kBN>(g, n, f, (kt + 1) * kBK, f0, sm.b[cur ^ 1], kLdB);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // a^T as an (H x N) col-major operand: element (h, n) at a_slice[n * ld + h]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(af[i], sm.a[cur] + kk * kLdA + wm * kWM + i * 16, kLdA);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(bfr[j], sm.b[cur] + kk * kLdB + wn * kWN + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) wmma::mma_sync(c[i][j], af[i], bfr[j], c[i][j]);
    }
    __syncthreads();
  }

  // epilogue: out = acc + sum, one fragment at a time through shared memory
  float* st = sm.stage[warp];
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(st, c[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int hb = h0 + wm * kWM + i * 16;
      const int fb = f0 + wn * kWN + j * 16;
      for (int e = lane; e < 16 * 16; e += 32) {
        const int gh = hb + (e >> 4);
        const int gf = fb + (e & 15);
        if (gh < h && gf < f) {
          const size_t o = (size_t)gh * f + gf;
          out[o] = acc[o] + st[e];
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------- //
// float32 path (FMA, no TF32)
// ---------------------------------------------------------------------- //
constexpr int kSBM = 64;
constexpr int kSBN = 64;
constexpr int kSBK = 16;
constexpr int kSThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kSThreads)
wgrad_f32_kernel(const float* __restrict__ a, const float* __restrict__ g,
                 const float* __restrict__ acc, float* __restrict__ out, int n, int h, int f) {
  __shared__ float as[kSBK][kSBM];
  __shared__ float bs[kSBK][kSBN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int h0 = blockIdx.y * kSBM;
  const int f0 = blockIdx.x * kSBN;
  float c[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kSBK) {
    for (int e = threadIdx.x; e < kSBK * kSBM; e += kSThreads) {
      const int r = e / kSBM, col = e % kSBM;
      const int gr = k0 + r, gc = h0 + col;
      as[r][col] = (gr < n && gc < h) ? a[(size_t)gr * h + gc] : 0.f;
    }
    for (int e = threadIdx.x; e < kSBK * kSBN; e += kSThreads) {
      const int r = e / kSBN, col = e % kSBN;
      const int gr = k0 + r, gc = f0 + col;
      bs[r][col] = (gr < n && gc < f) ? g[(size_t)gr * f + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSBK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gh = h0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gf = f0 + tx * 4 + j;
      if (gh < h && gf < f) {
        const size_t o = (size_t)gh * f + gf;
        out[o] = acc[o] + c[i][j];
      }
    }
  }
}

}  // namespace

extern "C" int wgrad_accum(const void* a, const void* g, const void* acc, void* out, long long n,
                           long long h, long long f, int dtype, void* stream) {
  if (n < 1 || h < 1 || f < 1 || n > 0x7fffffffLL || h > 0x7fffffffLL || f > 0x7fffffffLL ||
      dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = (int)n, hi = (int)h, fi = (int)f;
  if (dtype == 0) {
    const dim3 grid((unsigned)((f + kSBN - 1) / kSBN), (unsigned)((h + kSBM - 1) / kSBM));
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    wgrad_f32_kernel<<<grid, kSThreads, 0, s>>>(static_cast<const float*>(a),
                                                static_cast<const float*>(g),
                                                static_cast<const float*>(acc),
                                                static_cast<float*>(out), ni, hi, fi);
  } else {
    const dim3 grid((unsigned)((f + kBN - 1) / kBN), (unsigned)((h + kBM - 1) / kBM));
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    const bool vec = h % 8 == 0 && f % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0;
    const bf16* ab = static_cast<const bf16*>(a);
    const bf16* gb = static_cast<const bf16*>(g);
    const float* accf = static_cast<const float*>(acc);
    float* outf = static_cast<float*>(out);
    if (vec)
      wgrad_bf16_kernel<true><<<grid, kThreads, 0, s>>>(ab, gb, accf, outf, ni, hi, fi);
    else
      wgrad_bf16_kernel<false><<<grid, kThreads, 0, s>>>(ab, gb, accf, outf, ni, hi, fi);
  }
  return (int)cudaGetLastError();
}
