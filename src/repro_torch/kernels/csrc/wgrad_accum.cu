// Weight-gradient accumulation for Hopper (sm_90a), in place:  acc += a^T @ g
//
//   a (N, H) and g (N, F), both bfloat16 or both float32, row-major;
//   acc (H, F) float32.  The product is summed in fp32 and added to acc
//   once, last, as in the reference: acc = acc + (a^T g).
//
// Replaces the TPU kernel src/repro/kernels/wgrad_accum.py::wgrad_accum
// (body _kernel).  There the contraction over N is the innermost, sequential
// grid axis, and a VMEM scratch carries each (H, F) tile's partial sums from
// one grid step to the next.  Blocks on Hopper run in no order and carry
// nothing to each other, so here one block owns an output tile and loops
// over all of N itself; acc is read and written once per tile, at its end.
// The JAX reference returns a new array (updated in place under jit
// donation); the port updates acc in place and allocates nothing.
//
// Bound on this card at the training path's shapes (N = b*s = 1024 tokens):
// the work is 2*N*H*F operations against 8*H*F bytes of acc read and written
// back (plus 2*N*(H+F) bytes of a and g), so about N/4 = 256 operations a
// byte, under the ~295 an H100 needs to be compute bound: device-memory
// bytes bound it, narrowly.  At (H, F) = (2048, 8192) that is 155 MB, or
// 0.046 ms at 3.35 TB/s, against 0.035 ms for the 34 GFLOP at 989 TFLOP/s.
// So the kernel has to run the tensor cores near their rate AND keep acc's
// traffic at its floor (one read, one write) with device memory busy while
// the products run.
//
// Three paths, chosen by shape in the wrapper (kernels/wgrad_accum.py::
// plan_launch; a dispatch by shape, not a fallback: a launch that fails
// raises):
//  * "wgmma" -- bfloat16 with H % 8 == 0, F % 8 == 0 and 16-byte aligned
//    a, g and acc (every call of the training step).  Hopper's own design:
//      - operands through TMA (cuTensorMapEncodeTiled, 128-byte swizzle):
//        boxes of 64 contraction rows x 64 columns (128 bytes) land in a
//        6-stage ring of 32 KB stages in shared memory, each stage
//        completing on an mbarrier; TMA's out-of-bounds zero fill covers a
//        ragged N, H or F;
//      - warp specialisation: warpgroup 0 is the producer (one thread
//        issues the TMA loads, setmaxnreg.dec to 40); warpgroups 1 and 2
//        each run wgmma.mma_async m64n128k16 on a 64 x 128 half of a
//        128 x 128 tile, fp32 accumulators in registers (setmaxnreg.inc to
//        232); a consumer releases a stage once the products that read it
//        are done (wgmma.wait_group 1);
//      - both operands are MN-major (a is contiguous along H = M, g along
//        F = N), which bf16 wgmma takes through its transpose immediates;
//        the shared-memory descriptors' leading byte offset is then the
//        step between 64-column boxes and the stride byte offset the step
//        between groups of 8 contraction rows (1024 bytes);
//      - a persistent grid, one block per SM walking the tiles (F-tiles
//        fastest), so the producer fills the ring for tile t+1 while the
//        consumers finish tile t;
//      - the epilogue adds into acc through the TMA: each consumer writes
//        its fragments, 64 columns at a time, into a 128-byte-swizzled
//        staging buffer, and one thread issues
//        cp.reduce.async.bulk.tensor .add.f32 boxes onto acc.  The L2 does
//        the read-modify-write (acc crosses device memory once each way)
//        while the consumers go on to the next tile's products; they wait
//        only until the TMA has read the staging buffer.  Each element of
//        acc gets exactly one add per launch, so the result is acc + sum
//        whatever the order: no split-K, nothing changes from run to run.
//        (A first version loaded acc into registers and stored acc + sum
//        from the fragments; on the H100 it lost to torch.addmm at the
//        large training shapes: the consumers sat on device memory while
//        the tensor cores idled.)
//    A 128 x 256 tile (m64n256k16, 4 stages) ran no faster at any
//    training shape with this epilogue, and an L2 prefetch of acc ahead of
//    the reduces slowed it, so the tile is 128 x 128 and nothing is
//    prefetched.
//  * "mma_sync" -- other bfloat16 shapes: the pre-Hopper wmma API (mma.sync
//    16x16x16 bf16 fragments, fp32 accumulators), one 128 x 128 tile a
//    block with 8 warps of 64 x 32, 32-row slices of a and g through a
//    two-stage cp.async ring (plain loads where H or F is not a multiple
//    of 8).  ~10% of the tensor cores' rate; no training-step call takes it.
//  * "fma" -- float32 inputs: plain fp32 FMA, never TF32 (the reduced f32
//    model is held to ~1e-5 on the card).  A block computes a 64 x 64 tile,
//    4 x 4 outputs a thread, over 16-row slices in shared memory.
//  The mma_sync and fma paths read acc[o] and write acc[o] from the same
//  thread, so acc is not declared __restrict__ anywhere.
//
// Plain C interface, bound with ctypes: the wrapper passes raw pointers,
// the shape, the path code (0 = fma, 1 = mma_sync, 2 = wgmma) and the
// CUDA stream.  It returns
// cudaGetLastError()'s code, or -1 when the driver has no
// cuTensorMapEncodeTiled, or -2 when the driver refuses a tensor map; the
// wrapper raises on anything but 0.  cuTensorMapEncodeTiled lives in the
// driver (libcuda); it is fetched once through the runtime's driver entry
// point, so the library links nothing beyond the runtime.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------- //
// bfloat16, Hopper path: TMA + wgmma, warp-specialised, persistent
// ---------------------------------------------------------------------- //
constexpr int kWgBM = 128;                   // output rows (H) a tile
constexpr int kWgBN = 128;                   // output columns (F) a tile
constexpr int kWgBK = 64;                    // contraction rows (N) a stage
constexpr int kWgStages = 6;
constexpr int kBox = 64;                     // bf16 box: 64 columns (128 bytes) x kWgBK rows
constexpr int kBoxBytes = kBox * kWgBK * 2;  // 8 KB
constexpr int kABytes = (kWgBM / kBox) * kBoxBytes;  // 16 KB a stage
constexpr int kStageBytes = kABytes + (kWgBN / kBox) * kBoxBytes;  // 32 KB
constexpr uint32_t kRowGroupBytes = 8 * 128;  // 8 contraction rows of a box (SBO)
constexpr int kOutCols = 64;                  // acc columns a consumer stages at a time
constexpr int kOutBoxBytes = 64 * 128;        // fp32 box: 64 rows x 32 columns (128 bytes)
constexpr int kOutBytes = (kOutCols / 32) * kOutBoxBytes;  // 16 KB a consumer
constexpr int kWgThreads = 384;               // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
// ring, staging, 2 x kWgStages mbarriers, + 1 KB to align the ring to 1024
constexpr int kWgSmemBytes = kWgStages * kStageBytes + 2 * kOutBytes + 2 * kWgStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c_inner, int c_outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c_inner), "r"(c_outer)
      : "memory");
}

// global[box at (c_inner, c_outer)] += shared[src]; out-of-bounds elements
// are skipped
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map, uint32_t src,
                                                  int c_inner, int c_outer) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c_inner), "r"(c_outer)
      : "memory");
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y) : "memory");
}

// barrier over one consumer warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled, MN-major operand:
// start address, leading byte offset (step between 64-column boxes), stride
// byte offset (step between groups of 8 contraction rows), layout 1 = B128.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kBoxBytes >> 4) << 16) |
         (static_cast<uint64_t>(kRowGroupBytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define WG_F8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 fp32 fragment) += A (64 x 16) * B (16 x 128), both MN-major
// (transpose immediates 1, 1); scale-d 1: accumulate
__device__ __forceinline__ void wg_mma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56)
      : "l"(da), "l"(db), "r"(1));
}

#undef WG_F8

__global__ void __launch_bounds__(kWgThreads, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_g,
                   const __grid_constant__ CUtensorMap map_acc, int n, int h, int f) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it, so
  // the descriptors' base offset is 0
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t staging = ring + kWgStages * kStageBytes;  // 2 x kOutBytes
  const uint32_t full_bar = staging + 2 * kOutBytes;        // kWgStages x 8 bytes
  const uint32_t empty_bar = full_bar + kWgStages * 8;

  const int tiles_n = (f + kWgBN - 1) / kWgBN;
  const int tiles = ((h + kWgBM - 1) / kWgBM) * tiles_n;
  const int k_blocks = (n + kWgBK - 1) / kWgBK;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);                // the producer's expect_tx
      mbar_init(empty_bar + 8 * s, kConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The ring's stage and phase run on across tiles in both roles: the
  // parity of a stage's barrier flips each time the ring wraps, not per tile.
  if (warpgroup == 0) {
    // ------------------------------ producer ------------------------------ //
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_g))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int h0 = (t / tiles_n) * kWgBM;
        const int f0 = (t % tiles_n) * kWgBN;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(empty_bar + 8 * stage, phase ^ 1u);
          const uint32_t fb = full_bar + 8 * stage;
          mbar_expect_tx(fb, kStageBytes);  // whole boxes, zero-filled out of bounds
          const uint32_t sa = ring + stage * kStageBytes;
          const uint32_t sb = sa + kABytes;
#pragma unroll
          for (int b = 0; b < kWgBM / kBox; ++b)
            tma_load_2d(sa + b * kBoxBytes, &map_a, fb, h0 + b * kBox, kb * kWgBK);
#pragma unroll
          for (int b = 0; b < kWgBN / kBox; ++b)
            tma_load_2d(sb + b * kBoxBytes, &map_g, fb, f0 + b * kBox, kb * kWgBK);
          if (++stage == kWgStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // ------------------------------ consumers ----------------------------- //
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int half = warpgroup - 1;           // rows [64 half, 64 half + 64) of the tile
    const int warp = (threadIdx.x / 32) % 4;  // warp within the warpgroup
    const int lane = threadIdx.x % 32;
    const bool issuer = threadIdx.x % 128 == 0;  // issues the warpgroup's reduces
    const uint32_t stg = staging + half * kOutBytes;
    float d[kWgBN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int h0 = (t / tiles_n) * kWgBM;
      const int f0 = (t % tiles_n) * kWgBN;
#pragma unroll
      for (int i = 0; i < kWgBN / 2; ++i) d[i] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(full_bar + 8 * stage, phase);
        wg_fence();
        const uint32_t sa = ring + stage * kStageBytes + half * kBoxBytes;
        const uint32_t sb = ring + stage * kStageBytes + kABytes;
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk)  // 16 contraction rows = 2 row groups each
          wg_mma(d, wg_desc(sa + kk * 2 * kRowGroupBytes), wg_desc(sb + kk * 2 * kRowGroupBytes));
        wg_commit();
        wg_wait<1>();  // the previous stage's products are done: release it
        if (prev >= 0 && lane == 0) mbar_arrive(empty_bar + 8 * prev);
        prev = stage;
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
      wg_wait<0>();
      if (lane == 0) mbar_arrive(empty_bar + 8 * prev);

      // epilogue: acc += the fragments, kOutCols columns at a time.  Thread
      // (warp, lane) holds rows 16 warp + lane / 4 + {0, 8} of the half and
      // columns 8 j + 2 (lane % 4) + {0, 1}: d[4 j + 2 i + {0, 1}].
#pragma unroll
      for (int sub = 0; sub < kWgBN / kOutCols; ++sub) {
        // the staging buffer is free once the TMA has read the last reduce
        if (issuer) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        warpgroup_sync(1 + half);
#pragma unroll
        for (int j = 0; j < kOutCols / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 16 * warp + lane / 4 + 8 * i;
            const int c = 8 * j + 2 * (lane % 4);
            const int cb = c % 32;  // column within its 128-byte box row, swizzled
            const uint32_t addr = stg + (c / 32) * kOutBoxBytes + r * 128 +
                                  (((cb / 4) ^ (r % 8)) * 16) + (cb % 4) * 4;
            const int e = 4 * (sub * kOutCols / 8 + j) + 2 * i;
            st_shared_v2(addr, d[e], d[e + 1]);
          }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA
        warpgroup_sync(1 + half);
        if (issuer) {
#pragma unroll
          for (int b = 0; b < kOutCols / 32; ++b)
            tma_reduce_add_2d(&map_acc, stg + b * kOutBoxBytes, f0 + sub * kOutCols + 32 * b,
                              h0 + 64 * half);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
    // the reduces must be done with shared memory before the block exits
    if (issuer) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------- //
// bfloat16, other shapes: wmma (mma.sync)
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
wgrad_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ g, float* acc, int n,
                  int h, int f) {
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

  // epilogue: acc = acc + sum, one fragment at a time through shared memory
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
          acc[o] = acc[o] + st[e];
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
wgrad_f32_kernel(const float* __restrict__ a, const float* __restrict__ g, float* acc, int n,
                 int h, int f) {
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
        acc[o] = acc[o] + c[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------- //
// host side
// ---------------------------------------------------------------------- //
constexpr int kErrNoEncode = -1;  // the driver has no cuTensorMapEncodeTiled
constexpr int kErrEncode = -2;    // the driver refused a tensor map

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A (rows, cols) row-major matrix in boxes of box_rows x 128 bytes, 128-byte
// swizzle, zeros outside.
int encode_2d(EncodeTiledFn fn, CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
              const void* base, long long rows, long long cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

int launch_wgmma(const void* a, const void* g, float* acc, int n, int h, int f, cudaStream_t s) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  CUtensorMap map_a, map_g, map_acc;
  int err = encode_2d(fn, &map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, n, h, kWgBK);
  if (err == 0) err = encode_2d(fn, &map_g, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g, n, f, kWgBK);
  if (err == 0) err = encode_2d(fn, &map_acc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, acc, h, f, 64);
  if (err != 0) return err;
  // per device, once: the SM count and the kernel's shared-memory opt-in
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return (int)ce;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int sms = 0;
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (ce == cudaSuccess)
      ce = cudaFuncSetAttribute(wgrad_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kWgSmemBytes);
    if (ce != cudaSuccess) return (int)ce;
    sms_of[dev] = sms;
  }
  const long long tiles = ((h + kWgBM - 1LL) / kWgBM) * ((f + kWgBN - 1LL) / kWgBN);
  const int grid = (int)(tiles < sms_of[dev] ? tiles : sms_of[dev]);
  wgrad_wgmma_kernel<<<grid, kWgThreads, kWgSmemBytes, s>>>(map_a, map_g, map_acc, n, h, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wgrad_accum(const void* a, const void* g, void* acc, long long n, long long h,
                           long long f, int path, void* stream) {
  if (n < 1 || h < 1 || f < 1 || n > 0x7fffffffLL || h > 0x7fffffffLL || f > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = (int)n, hi = (int)h, fi = (int)f;
  float* accf = static_cast<float*>(acc);
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (path == 0) {  // fma
    const dim3 grid((unsigned)((f + kSBN - 1) / kSBN), (unsigned)((h + kSBM - 1) / kSBM));
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    wgrad_f32_kernel<<<grid, kSThreads, 0, s>>>(static_cast<const float*>(a),
                                                static_cast<const float*>(g), accf, ni, hi, fi);
    return (int)cudaGetLastError();
  }
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* gb = static_cast<const bf16*>(g);
  if (path == 1) {  // mma_sync
    const dim3 grid((unsigned)((f + kBN - 1) / kBN), (unsigned)((h + kBM - 1) / kBM));
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    if (h % 8 == 0 && f % 8 == 0 && aligned)
      wgrad_bf16_kernel<true><<<grid, kThreads, 0, s>>>(ab, gb, accf, ni, hi, fi);
    else
      wgrad_bf16_kernel<false><<<grid, kThreads, 0, s>>>(ab, gb, accf, ni, hi, fi);
    return (int)cudaGetLastError();
  }
  if (path == 2) {  // wgmma: TMA wants 16-byte aligned bases and row pitches
    if (h % 8 != 0 || f % 8 != 0 || !aligned || reinterpret_cast<uintptr_t>(acc) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_wgmma(ab, gb, accf, ni, hi, fi, s);
  }
  return (int)cudaErrorInvalidValue;
}
