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
// Four paths, chosen by shape in the wrapper (kernels/wgrad_accum.py::
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
//  * "thin" -- bfloat16 with F <= 16 and F % 8 != 0, H % 8 == 0 and a
//    16-byte aligned a (xlstm's mLSTM gate products mfg and mig: a (2048,
//    1024), g (2048, 4), acc (1024, 4)).  Bound: 2 N H F = 16.8 MFLOP
//    against N H 2 = 4.2 MB of a, so a's bytes bound it (1.3 us at 3.35
//    TB/s): the whole of a has to be in flight across the card at once.
//    The mma_sync path took 135 us there (8 blocks of 128 x 128 tiles, 97%
//    of each tile padding, scalar loads of a, each block walking all of N).
//    This design (kernels/wgrad_accum.py::plan_thin fixes its numbers from
//    (N, H, F, SMs) alone):
//      - a block owns kThinTileH = 64 of H's columns (128 bytes of each row
//        of a, one line), its threads kThinTileH / kThinCols = 8 across a
//        row, each 8 columns as one 16-byte load, and kThinBK = 32 rows of
//        N a step; a thread holds its 8 x F outputs in fp32 registers (F
//        padded to 4, 8 or 16, the template width; the padding's g is 0);
//      - g's rows (8 bytes at F = 4) are read straight from L1/L2 by the 8
//        threads of a row, a broadcast;
//      - N is split over a thread-block cluster of up to 8 blocks, as the
//        fma path's plan splits it (the same rule and the same slices), so
//        xlstm's (1024, 4) runs as 16 tiles x 8 = 128 blocks; each thread
//        issues the loads of kThinUnroll steps (8 rows of a and g) before
//        it multiplies any, so at N = 2048 all of a is requested at once;
//      - the reduction, in a fixed order and without atomics: the 4 rows a
//        warp holds are summed by a fixed xor-shuffle tree (fp32 addition
//        commutes exactly, so every lane holds the same bits), the 8 warps'
//        partials in warp order through shared memory, then the cluster's
//        blocks in rank order through distributed shared memory
//        (cluster_sum4, the fma path's reduction), and block q adds its
//        share of the tile into acc once.  Two launches agree bit for bit.
//  * "mma_sync" -- other bfloat16 shapes: the pre-Hopper wmma API (mma.sync
//    16x16x16 bf16 fragments, fp32 accumulators), one 128 x 128 tile a
//    block with 8 warps of 64 x 32, 32-row slices of a and g through a
//    two-stage cp.async ring (plain loads where H or F is not a multiple
//    of 8).  ~10% of the tensor cores' rate; no training-step call takes it.
//  * "fma" -- float32 inputs (the moe router's W op on the training path,
//    and every W op of the reduced f32 models): plain fp32 FMA, never TF32
//    (the reduced f32 model is held to ~1e-5 on the card).
//    Bound: at the routers' shapes (N = 1024) the operations bound
//    (H, F) = (2048, 60), 0.25 GFLOP = 3.8 us at 67 TFLOP/s against 9.6 MB
//    = 2.9 us, and bytes bound (7168, 16), 30.3 MB = 9.1 us against 3.5 us;
//    both are a few microseconds, so the walk over N and the launch are
//    what a design pays for.  The first design (one block a 64 x 64 tile over
//    all of N, 16-row steps through one shared buffer with two barriers a
//    step, 4 x 4 outputs a thread fed by scalar shared reads) took 0.128 ms
//    at both shapes on the H100: 64 exposed loads in a row on 32 or 112 blocks of 132
//    SMs, 75% of the FMAs on padding at F = 16, and one fmaf chain of 1024
//    terms an output (4.6e-5 from an fp64 sum).  This design
//    (kernels/wgrad_accum.py::plan_fp32 fixes its numbers from (N, H, F,
//    SMs) alone):
//      - the tile is 16, 32, 64 or 128 columns wide, the narrowest that
//        holds F (F = 16 pads nothing, F = 60 four columns), by 128 rows
//        (64 at 32 and 64 columns; kF32TileHs); each thread holds 8 x 4
//        outputs (8 x 8 at 128 columns) and reads shared memory as float4;
//      - where the tiles do not fill the SMs, a thread-block cluster of 2,
//        4 or 8 blocks (cudaLaunchKernelEx, cluster dimension = the split,
//        the largest the steps of N allow) computes a tile, each block
//        over its own slice of N, so the routers' N = 1024 runs as 8
//        slices of 128, on 256 blocks at (2048, 60) and 448 at (7168, 16);
//      - each block walks its slice in steps of 16 or 32 rows (kF32BKs)
//        through a ring of 4 stages filled by
//        cp.async (16-byte vectors where H, F and the bases allow, else
//        4-byte copies with the same masks), one barrier a step, so a
//        step's loads overlap the FMAs on the steps before it;
//      - the reduction: each block leaves its partial tile in its own
//        shared memory (the ring's space) and, after a cluster barrier,
//        block q sums rows [q 128/split, (q + 1) 128/split) of the tile
//        over the cluster's partials, read through distributed shared
//        memory in rank order 0 .. split-1, and adds the sum into acc
//        once; a second cluster barrier keeps every block alive until no
//        peer reads its shared memory.  No atomics and no workspace: each
//        element of acc gets one read-add-write in an order the plan
//        fixes, so two launches agree bit for bit (the vector and 4-byte
//        copies move the same numbers in the same order), and an output
//        sums runs of N / split products (128 at the routers) rather than
//        one of 1024.
//  The thin, mma_sync and fma paths read acc[o] and write acc[o] from the
//  same thread, so acc is not declared __restrict__ anywhere.
//
// Plain C interface, bound with ctypes: the wrapper passes raw pointers,
// the shape, the path code (0 = fma, 1 = mma_sync, 2 = wgmma, 3 = thin),
// the fp32 or thin plan's tile width and split (ignored by the other
// paths) and the CUDA stream.  It returns
// cudaGetLastError()'s code, or -1 when the driver has no
// cuTensorMapEncodeTiled, or -2 when the driver refuses a tensor map; the
// wrapper raises on anything but 0.  cuTensorMapEncodeTiled lives in the
// driver (libcuda); it is fetched once through the runtime's driver entry
// point, so the library links nothing beyond the runtime.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
namespace cg = cooperative_groups;
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
// float32 path: FMA (no TF32), N split across a thread-block cluster
// ---------------------------------------------------------------------- //
// Per tile width BN (16, 32, 64, 128 columns of F): the tile's rows (H) and
// a ring stage's rows (N).  Measured on the H100 (tools/wgrad_fp32_variants.py):
// at 64 columns (qwen2-moe's router) 64-row tiles on 32-row stages put two
// blocks on most SMs and beat 128 x 16 by 25%; at 16 columns (deepseek-v3's
// router, bytes-bound) and at 128 (the square shape) 128 x 16 is fastest.
constexpr int kF32Widths[4] = {16, 32, 64, 128};
constexpr int kF32TileHs[4] = {128, 64, 64, 128};
constexpr int kF32BKs[4] = {16, 32, 32, 16};
constexpr int kF32Stages = 4;    // ring stages
constexpr int kF32MaxSplit = 8;  // blocks of a cluster, at most (the portable cluster size)
constexpr int kF32TM = 8;        // output rows a thread: 4 at 4 ty and 4 at BM/2 + 4 ty

constexpr int f32_width_index(int bn) { return bn == 16 ? 0 : bn == 32 ? 1 : bn == 64 ? 2 : 3; }

// A tile of BM x BN outputs: its threads, ring stage and shared memory
template <int BN>
struct F32Tile {
  static constexpr int BM = kF32TileHs[f32_width_index(BN)];
  static constexpr int BK = kF32BKs[f32_width_index(BN)];
  static constexpr int kTN = BN == 128 ? 8 : 4;  // columns a thread: 4 at 4 tx (and 4 at BN/2 + 4 tx)
  static constexpr int kThreadsF = BN / kTN;
  static constexpr int kThreads = (BM / kF32TM) * kThreadsF;  // 64, 64, 128, 256
  static constexpr int kStageFloats = BK * (BM + BN);  // a[BK][BM], then g[BK][BN]
  static constexpr int kRingBytes = kF32Stages * kStageFloats * 4;
  static constexpr int kPartBytes = BM * BN * 4;  // the partial tile, over the ring
  static constexpr int kSmemBytes = kRingBytes > kPartBytes ? kRingBytes : kPartBytes;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src_bytes = 0 writes a zero and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// Rows [n0, n0 + BK) of src (rows < n_end and cols valid, row-major with
// pitch `cols`) at columns [c0, c0 + W) into dst[BK][W]; zeros outside.
// kVec: cols % 4 == 0 and a 16-byte aligned base, so a 4-column chunk lies
// wholly inside or wholly outside.
template <int BK, int W, int kThreads, bool kVec>
__device__ __forceinline__ void f32_load_rows(const float* __restrict__ src, int n_end, int cols,
                                              int n0, int c0, float* dst) {
  if (kVec) {
    for (int c = threadIdx.x; c < BK * W / 4; c += kThreads) {
      const int r = c / (W / 4), col = (c % (W / 4)) * 4;
      const int gr = n0 + r, gc = c0 + col;
      const bool in = gr < n_end && gc < cols;
      cp_async16(dst + r * W + col, in ? src + (size_t)gr * cols + gc : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BK * W; e += kThreads) {
      const int r = e / W, col = e % W;
      const int gr = n0 + r, gc = c0 + col;
      const bool in = gr < n_end && gc < cols;
      cp_async4(dst + r * W + col, in ? src + (size_t)gr * cols + gc : src, in ? 4 : 0);
    }
  }
}

// The sum over a cluster's `split` blocks of the float4 at `off` in each
// block's `part` (shared memory), in rank order 0 .. split-1, every peer's
// load in flight at once: the fixed order that makes two launches agree
// bit for bit (the fma and thin paths' reduction).
__device__ __forceinline__ float4 cluster_sum4(cg::cluster_group& cluster, float* part, int off,
                                               int split) {
  float4 p[kF32MaxSplit];
#pragma unroll
  for (int q = 0; q < kF32MaxSplit; ++q)
    if (q < split) p[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + off);
  float4 s = p[0];
#pragma unroll
  for (int q = 1; q < kF32MaxSplit; ++q) {
    if (q < split) {
      s.x += p[q].x;
      s.y += p[q].y;
      s.z += p[q].z;
      s.w += p[q].w;
    }
  }
  return s;
}

// One launch: grid = tiles x split blocks, clusters of split consecutive
// blocks (the cluster dimension set at launch), F-tiles fastest.
template <int BN, bool kVec>
__global__ void __launch_bounds__(F32Tile<BN>::kThreads, 2)
wgrad_f32_kernel(const float* __restrict__ a, const float* __restrict__ g, float* acc, int n,
                 int h, int f) {
  using T = F32Tile<BN>;
  constexpr int BM = T::BM, BK = T::BK;
  extern __shared__ __align__(16) float f32_smem[];
  auto cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / split;
  const int tiles_f = (f - 1) / BN + 1;
  const int h0 = (tile / tiles_f) * BM;
  const int f0 = (tile % tiles_f) * BN;
  // this block's slice of N: steps [s0, s1) of the ceil(N / BK), as the
  // wrapper's Fp32Plan.slice cuts them
  const int k_steps = (n - 1) / BK + 1;
  const int s0 = static_cast<int>(static_cast<long long>(rank) * k_steps / split);
  const int s1 = static_cast<int>(static_cast<long long>(rank + 1) * k_steps / split);
  const long long slice_end = static_cast<long long>(s1) * BK;
  const int n_end = slice_end < n ? static_cast<int>(slice_end) : n;
  const int steps = s1 - s0;
  const int tx = threadIdx.x % T::kThreadsF;
  const int ty = threadIdx.x / T::kThreadsF;

  float c[kF32TM][T::kTN];
#pragma unroll
  for (int i = 0; i < kF32TM; ++i)
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) c[i][j] = 0.f;

  // the ring: stage s holds step s0 + t for t = s (mod kF32Stages)
  auto load = [&](int t) {
    float* st = f32_smem + (t % kF32Stages) * T::kStageFloats;
    const int n0 = (s0 + t) * BK;
    f32_load_rows<BK, BM, T::kThreads, kVec>(a, n_end, h, n0, h0, st);
    f32_load_rows<BK, BN, T::kThreads, kVec>(g, n_end, f, n0, f0, st + BK * BM);
  };
#pragma unroll
  for (int t = 0; t < kF32Stages - 1; ++t) {
    if (t < steps) load(t);
    cp_async_commit();  // an empty group past the slice keeps the count uniform
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kF32Stages - 2>();  // step t has landed (this thread's copies)
    __syncthreads();  // ... everyone's; and everyone is done with step t - 1's stage
    if (t + kF32Stages - 1 < steps) load(t + kF32Stages - 1);  // into step t - 1's stage
    cp_async_commit();
    const float* as = f32_smem + (t % kF32Stages) * T::kStageFloats;
    const float* gs = as + BK * BM;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * BM + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * BM + BM / 2 + 4 * ty);
      const float av[kF32TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float gv[T::kTN];
#pragma unroll
      for (int q = 0; q < T::kTN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(gs + k * BN + q * (BN / 2) + 4 * tx);
        gv[4 * q] = v.x;
        gv[4 * q + 1] = v.y;
        gv[4 * q + 2] = v.z;
        gv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kF32TM; ++i)
#pragma unroll
        for (int j = 0; j < T::kTN; ++j) c[i][j] = fmaf(av[i], gv[j], c[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is done: its space holds the partial tile from here

  // this block's partial tile, row-major [BM][BN]
  float* part = f32_smem;
#pragma unroll
  for (int i = 0; i < kF32TM; ++i) {
    const int r = (i / 4) * (BM / 2) + 4 * ty + i % 4;
#pragma unroll
    for (int q = 0; q < T::kTN / 4; ++q)
      *reinterpret_cast<float4*>(part + r * BN + q * (BN / 2) + 4 * tx) =
          make_float4(c[i][4 * q], c[i][4 * q + 1], c[i][4 * q + 2], c[i][4 * q + 3]);
  }
  cluster.sync();  // every partial of the cluster is written and visible

  // block `rank` reduces rows [rank R, rank R + R) of the tile, R = BM / split:
  // the partials summed in rank order, then added into acc once
  const int rows = BM / split;
  for (int e = threadIdx.x; e < rows * (BN / 4); e += T::kThreads) {
    const int r = rank * rows + e / (BN / 4);
    const int col = (e % (BN / 4)) * 4;
    const float4 s = cluster_sum4(cluster, part, r * BN + col, split);
    const int gh = h0 + r, gf = f0 + col;
    if (gh >= h || gf >= f) continue;
    float* o = acc + (size_t)gh * f + gf;
    if (kVec) {  // f % 4 == 0 and acc 16-byte aligned: the chunk lies wholly inside
      float4 v = *reinterpret_cast<float4*>(o);
      v.x = v.x + s.x;
      v.y = v.y + s.y;
      v.z = v.z + s.z;
      v.w = v.w + s.w;
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gf + j < f) o[j] = o[j] + sv[j];
    }
  }
  cluster.sync();  // no block exits while a peer may still read its shared memory
}

// ---------------------------------------------------------------------- //
// bfloat16, thin path: F <= 16 and not a multiple of 8, N split across a
// thread-block cluster (measured by tools/wgrad_thin_variants.py)
// ---------------------------------------------------------------------- //
constexpr int kThinTileH = 64;    // H columns a block (acc rows of a tile)
constexpr int kThinCols = 8;      // H columns a thread: one 16-byte load of a row of a
constexpr int kThinThreads = 256;
constexpr int kThinTX = kThinTileH / kThinCols;  // threads across a row of the tile
constexpr int kThinBK = kThinThreads / kThinTX;  // rows of N a step: one a thread
constexpr int kThinUnroll = 8;    // steps whose loads a thread issues before it multiplies
constexpr int kThinMaxF = 16;     // the widest F the path takes
static_assert(kThinCols == 8, "a thread loads 16 bytes of a row");
static_assert(kThinTX <= 32 && 32 % kThinTX == 0, "a warp holds whole rows of the tile");

template <int kC>
struct ThinLoad;  // kC bf16 of a row: one aligned vector load, widened to fp32
template <>
struct ThinLoad<8> {
  using V = uint4;
  __device__ static void widen(const V& v, float* x) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[2 * q] = __uint_as_float(w[q] << 16);
      x[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
};

// One launch: grid = tiles x split blocks, clusters of split consecutive
// blocks; FP = F padded to 4, 8 or 16.  The block's slice of N is cut as
// the fma path cuts it (Fp32Plan.slice / ThinPlan.slice in the wrapper).
template <int FP>
__global__ void __launch_bounds__(kThinThreads)
wgrad_thin_kernel(const bf16* __restrict__ a, const bf16* __restrict__ g, float* acc, int n,
                  int h, int f) {
  using L = ThinLoad<kThinCols>;
  constexpr int kWarps = kThinThreads / 32;
  constexpr int kTile = kThinTileH * FP;  // floats of the tile, [column of H][FP]
  constexpr int kUnroll = kThinUnroll * 4 / FP > 0 ? kThinUnroll * 4 / FP : 1;  // registers
  __shared__ __align__(16) float warp_part[kWarps][kTile];
  __shared__ __align__(16) float part[kTile];
  auto cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h0 = (blockIdx.x / split) * kThinTileH;
  const int k_steps = (n - 1) / kThinBK + 1;
  const int s0 = static_cast<int>(static_cast<long long>(rank) * k_steps / split);
  const int s1 = static_cast<int>(static_cast<long long>(rank + 1) * k_steps / split);
  const int tx = threadIdx.x % kThinTX, ty = threadIdx.x / kThinTX;
  const int col = h0 + tx * kThinCols;  // h % kThinCols == 0: wholly inside or outside
  const bool col_in = col < h;

  float c[kThinCols][FP];
#pragma unroll
  for (int i = 0; i < kThinCols; ++i)
#pragma unroll
    for (int j = 0; j < FP; ++j) c[i][j] = 0.f;
  for (int t = s0; t < s1; t += kUnroll) {
    typename L::V av[kUnroll];
    float gv[kUnroll][FP];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load of kUnroll steps in flight at once
      const int row = (t + u) * kThinBK + ty;
      const bool in = t + u < s1 && row < n;
      av[u] = in && col_in ? __ldg(reinterpret_cast<const typename L::V*>(a + (size_t)row * h + col))
                           : typename L::V{};
#pragma unroll
      for (int j = 0; j < FP; ++j)
        gv[u][j] = in && j < f ? __bfloat162float(g[(size_t)row * f + j]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x[kThinCols];
      L::widen(av[u], x);
#pragma unroll
      for (int i = 0; i < kThinCols; ++i)
#pragma unroll
        for (int j = 0; j < FP; ++j) c[i][j] = fmaf(x[i], gv[u][j], c[i][j]);
    }
  }

  // the warp's rows (lanes tx, tx + kThinTX, ...): a fixed xor tree
#pragma unroll
  for (int i = 0; i < kThinCols; ++i)
#pragma unroll
    for (int j = 0; j < FP; ++j)
#pragma unroll
      for (int o = kThinTX; o < 32; o *= 2) c[i][j] += __shfl_xor_sync(0xffffffffu, c[i][j], o);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < kThinTX) {
#pragma unroll
    for (int i = 0; i < kThinCols; ++i)
#pragma unroll
      for (int j = 0; j < FP; j += 4)
        *reinterpret_cast<float4*>(&warp_part[warp][(tx * kThinCols + i) * FP + j]) =
            make_float4(c[i][j], c[i][j + 1], c[i][j + 2], c[i][j + 3]);
  }
  __syncthreads();
  // the block's partial: the warps in order
  for (int e = threadIdx.x; e < kTile / 4; e += kThinThreads) {
    float4 s = *reinterpret_cast<const float4*>(&warp_part[0][4 * e]);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 p = *reinterpret_cast<const float4*>(&warp_part[w][4 * e]);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    *reinterpret_cast<float4*>(&part[4 * e]) = s;
  }
  cluster.sync();  // every partial of the cluster is written and visible
  // block `rank` sums its share of the tile over the cluster, in rank
  // order, and adds it into acc once
  const int share = kTile / 4 / split;
  for (int e = rank * share + threadIdx.x; e < (rank + 1) * share; e += kThinThreads) {
    const float4 s = cluster_sum4(cluster, part, 4 * e, split);
    const int gh = h0 + (4 * e) / FP, j0 = (4 * e) % FP;
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (gh < h && j0 + q < f) {
        float* o = acc + (size_t)gh * f + j0 + q;
        *o = *o + sv[q];
      }
    }
  }
  cluster.sync();  // no block exits while a peer may still read its shared memory
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

// One launch of tiles x split blocks in clusters of `split` consecutive
// blocks (the fma and thin paths).
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), long long tiles, int split, int threads,
                            int smem, cudaStream_t s, Args... args) {
  if (tiles * split > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * split));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// One fp32 launch: clusters of `split` blocks, tiles x split blocks.
template <int BN, bool kVec>
cudaError_t launch_f32_as(const float* a, const float* g, float* acc, int n, int h, int f,
                          int split, long long tiles, cudaStream_t s) {
  using T = F32Tile<BN>;
  return launch_clusters(wgrad_f32_kernel<BN, kVec>, tiles, split, T::kThreads, T::kSmemBytes, s,
                         a, g, acc, n, h, f);
}

template <int BN, bool kVec>
cudaError_t f32_smem_opt_in() {
  return cudaFuncSetAttribute(wgrad_f32_kernel<BN, kVec>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              F32Tile<BN>::kSmemBytes);
}

// The fp32 path at the wrapper's plan (tile_f, split); vector copies where
// H, F and every base allow them.
int launch_f32(const float* a, const float* g, float* acc, int n, int h, int f, int tile_f,
               int split, cudaStream_t s) {
  if (split != 1 && split != 2 && split != 4 && split != kF32MaxSplit)
    return (int)cudaErrorInvalidValue;
  // per device, once: every instantiation's shared-memory opt-in
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return (int)ce;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    const cudaError_t opt[] = {f32_smem_opt_in<16, true>(),  f32_smem_opt_in<16, false>(),
                               f32_smem_opt_in<32, true>(),  f32_smem_opt_in<32, false>(),
                               f32_smem_opt_in<64, true>(),  f32_smem_opt_in<64, false>(),
                               f32_smem_opt_in<128, true>(), f32_smem_opt_in<128, false>()};
    for (cudaError_t e : opt)
      if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  const int bm = kF32TileHs[f32_width_index(tile_f)];
  const long long tiles = ((h + bm - 1LL) / bm) * ((f + tile_f - 1LL) / tile_f);
  const bool vec = h % 4 == 0 && f % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(acc) % 16 == 0;
  switch (tile_f * 2 + (vec ? 1 : 0)) {
    case 33: ce = launch_f32_as<16, true>(a, g, acc, n, h, f, split, tiles, s); break;
    case 32: ce = launch_f32_as<16, false>(a, g, acc, n, h, f, split, tiles, s); break;
    case 65: ce = launch_f32_as<32, true>(a, g, acc, n, h, f, split, tiles, s); break;
    case 64: ce = launch_f32_as<32, false>(a, g, acc, n, h, f, split, tiles, s); break;
    case 129: ce = launch_f32_as<64, true>(a, g, acc, n, h, f, split, tiles, s); break;
    case 128: ce = launch_f32_as<64, false>(a, g, acc, n, h, f, split, tiles, s); break;
    case 257: ce = launch_f32_as<128, true>(a, g, acc, n, h, f, split, tiles, s); break;
    case 256: ce = launch_f32_as<128, false>(a, g, acc, n, h, f, split, tiles, s); break;
    default: return (int)cudaErrorInvalidValue;  // a tile width the kernel was not built for
  }
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// The thin path at the wrapper's plan (fp = F padded to 4, 8 or 16; split).
int launch_thin(const bf16* a, const bf16* g, float* acc, int n, int h, int f, int fp, int split,
                cudaStream_t s) {
  if (split != 1 && split != 2 && split != 4 && split != kF32MaxSplit)
    return (int)cudaErrorInvalidValue;
  if (f > kThinMaxF || f % 8 == 0 || h % kThinCols != 0 || f > fp ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const bf16*, const bf16*, float*, int, int, int) =
      fp == 4 ? wgrad_thin_kernel<4> : fp == 8 ? wgrad_thin_kernel<8>
                                     : fp == 16 ? wgrad_thin_kernel<16> : nullptr;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;  // a width not built
  const long long tiles = (h + kThinTileH - 1LL) / kThinTileH;
  const cudaError_t ce = launch_clusters(kernel, tiles, split, kThinThreads, 0, s, a, g, acc, n,
                                         h, f);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wgrad_accum(const void* a, const void* g, void* acc, long long n, long long h,
                           long long f, int path, int tile_f, int split, void* stream) {
  if (n < 1 || h < 1 || f < 1 || n > 0x7fffffffLL || h > 0x7fffffffLL || f > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = (int)n, hi = (int)h, fi = (int)f;
  float* accf = static_cast<float*>(acc);
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (path == 0)  // fma
    return launch_f32(static_cast<const float*>(a), static_cast<const float*>(g), accf, ni, hi,
                      fi, tile_f, split, s);
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
  if (path == 3)  // thin
    return launch_thin(ab, gb, accf, ni, hi, fi, tile_f, split, s);
  if (path == 2) {  // wgmma: TMA wants 16-byte aligned bases and row pitches
    if (h % 8 != 0 || f % 8 != 0 || !aligned || reinterpret_cast<uintptr_t>(acc) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_wgmma(ab, gb, accf, ni, hi, fi, s);
  }
  return (int)cudaErrorInvalidValue;
}
