// RMSNorm forward for Hopper (sm_90a):  y = x * rsqrt(mean(x^2) + eps) * (1 + g)
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_fused (a
// Pallas grid over row blocks of 256 rows held whole in VMEM).  Rows of
// x (N, H) in float32 or bfloat16, g (H,) in either, fp32 arithmetic in the
// reference's order ((x32 * inv) * (1 + g32), cast to x's dtype last), so
// f32 results agree to rounding.
//
// Bound: device-memory bytes.  The work is 2*N*H*sizeof(x) + H*sizeof(g)
// bytes over 3.35 TB/s against ~4*N*H fp32 operations, far below the
// operations-per-byte the card needs to be compute bound: 0.01128 ms at
// gemma2's prefill rows (4100, 2304) bf16, 0.00282 ms at gpt3-1.5b's
// training rows (1024, 2304).  At decode sizes (N = 1 or 2 rows) the launch
// and one round trip to memory bound it instead.  The first version (one
// 256-thread block a row, scalar loads, x read twice, two __syncthreads a
// row) ran 0.01583 ms at (4100, 2304) and lost to F.rms_norm (0.01203).
//
// Three paths, chosen by shape in the wrapper (kernels/rmsnorm.py::
// plan_launch; a dispatch by shape, not a fallback: a launch that fails
// raises):
//  * "bulk" -- 16-byte aligned x and y with H*sizeof(x) % 16 == 0, more rows
//    than SMs (every prefill and training call).  Hopper's design:
//      - x crosses device memory once: a tile of `rows` consecutive rows (one
//        row at the dense widths) is one contiguous span, which one lane of
//        a producer warp brings into shared memory with cp.async.bulk (1-D,
//        no tensor map), completing on the stage's "full" mbarrier;
//      - a ring of `stages` tiles, each with a full and an "empty" mbarrier,
//        so a block's next tiles are in flight while it reduces and stores
//        one; the producer warp's lanes set the mbarriers up in parallel and
//        its copies start in the block's first cycles, while the consumer
//        warps stage (1 + g) (a named barrier, bar.arrive on the producer's
//        side, joins the two; an aligned __syncthreads after the one-lane
//        set-up let warp 0 arrive before its lane 0 was done);
//      - a persistent grid of min(tiles, 2 x SMs) blocks of 8 consumer warps
//        and 1 producer warp, each block walking tiles blockIdx.x + j * grid;
//        tile j goes to consumer group j % groups, and the stages (at most
//        16, sized to fit two blocks an SM) are a multiple of the groups,
//        so each stage serves one group in every round;
//      - a group owns a row: one warp up to 4608 bytes of row, 2, 4 or 8
//        warps for wider rows or where a block has fewer tiles than groups
//        (1024 training rows: ~4 tiles a block, two warps a row), which sum
//        their partials once in shared memory behind a named barrier of the
//        group alone.  The reduction is 16-byte shared loads and shuffles
//        in fp32; there is no __syncthreads per row;
//      - (1 + g) in fp32 is staged in shared memory once a block, from
//        16-byte loads;
//      - y leaves in 16-byte stores straight from the warps (512 contiguous
//        bytes an instruction, one cvt.rn.bf16x2 a pair in bf16).  A bulk
//        copy of each row written back into its stage measured as fast at
//        4100 rows and slower at 1024 rows, so it is not kept.
//    Measured (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 3, in
//    turns against F.rms_norm, warm / cold): (4100, 2304) 0.0101-0.0103 /
//    0.0154-0.0156 ms (72-73% of the bound cold) against 0.0122 / 0.0167;
//    (1024, 2304) 0.0042 / 0.0063 against 0.0045 / 0.0065; (1024, 2048)
//    0.0039 / 0.0059-0.0060 against 0.0041-0.0042 / 0.0059.  What holds it
//    back: at 1024 rows each SM has ~8 rows, so the run is a latency chain
//    (copy in, reduce, store) rather than a stream; a block's copies go
//    through its SM's TMA unit one after another, and issuing them from
//    one lane a stage ran no faster than from one lane.
//  * "latency" -- the same alignment, at most as many rows as SMs and
//    H <= 8192 (decode): one 256-thread block a row, the row in 16-byte
//    loads held in registers beside g, so x and g cost one round trip to
//    memory, one block-wide reduction, then 16-byte stores: 0.0017 ms at
//    (2, 2048) and 0.0019 at (1, 2304), against F.rms_norm's 0.0029 and
//    0.0032 and the first version's 0.0021 and 0.0025.
//  * "rowwise" -- everything else (a misaligned view, H*sizeof(x) not a
//    multiple of 16, a row too wide for the ring): one 256-thread block a
//    row, the row's 16-byte aligned interior read as vectors and its ends
//    as scalars, x read twice, scalar stores.
//
// Plain C interface, bound with ctypes: the wrapper passes raw pointers,
// the shape, dtype codes (0 = float32, 1 = bfloat16), the plan (path code
// 0 = rowwise, 1 = latency, 2 = bulk; grid; rows a stage, warps a row,
// stages and shared bytes of a bulk block) and the CUDA stream, and raises if the returned code is not 0.  The bulk kernel's
// shared-memory opt-in is set once per device; nothing allocates, queries
// the device's properties or synchronises per call, so a launch can be
// captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowThreads = 256;   // rowwise and latency: one block a row
constexpr int kLatMaxH = 8192;     // latency: widest row held in registers
constexpr int kConsumerWarps = 8;  // bulk: consumer warps, plus one producer warp
constexpr int kBulkThreads = (kConsumerWarps + 1) * 32;
constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may opt in to
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch/XLA cast
}

// 16 bytes of x as fp32 values, and fp32 values back to 16 bytes of x
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float (&f)[kN]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float (&f)[kN]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of the float it widens to
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pack2(float lo, float hi) {  // both rounded to nearest even
    uint32_t u;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(hi), "f"(lo));
    return u;
  }
  __device__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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

// shared[dst, dst + bytes) = global[src, src + bytes), completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// barrier `id` over `count` threads of the block (id 0 is __syncthreads): wait for all,
// or arrive without waiting; whole warps arrive, converged
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__host__ __device__ __forceinline__ uint32_t round_up(uint32_t v, uint32_t m) {
  return (v + m - 1) / m * m;
}

// The bulk block's dynamic shared memory: the ring of `stages` tiles of
// `rows` rows (each stage 128-byte aligned), (1 + g) in fp32, the full and
// empty mbarriers, and two sets of the consumer warps' partial sums.  The
// wrapper's plan computes the same (kernels/rmsnorm.py::_bulk_smem).
__host__ __device__ __forceinline__ uint32_t stage_stride(int h, int xsize, int rows) {
  return round_up(static_cast<uint32_t>(rows) * h * xsize, 128);
}
__host__ __device__ __forceinline__ uint32_t bulk_smem(int h, int xsize, int rows, int stages) {
  return stages * stage_stride(h, xsize, rows) + round_up(4u * h, 16) + 16u * stages +
         2u * kConsumerWarps * 4u;
}

// (1 + g) in fp32 into shared memory, by the block's consumer threads
// (thread index `tid` of kConsumerWarps * 32), with 16-byte loads where g
// allows: every load is in flight at once at the widths of the dense configs.
template <typename TG>
__device__ __forceinline__ void stage_gain(const TG* __restrict__ g, float* gp, int h, int tid) {
  using G = Vec<TG>;
  if (reinterpret_cast<uintptr_t>(g) % 16 == 0 && h % G::kN == 0) {
    const uint4* g4 = reinterpret_cast<const uint4*>(g);
    float4* gp4 = reinterpret_cast<float4*>(gp);
#pragma unroll 4
    for (int i = tid; i < h / G::kN; i += kConsumerWarps * 32) {
      float f[G::kN];
      G::unpack(g4[i], f);
#pragma unroll
      for (int e = 0; e < G::kN; e += 4)
        gp4[(i * G::kN + e) / 4] =
            make_float4(1.f + f[e], 1.f + f[e + 1], 1.f + f[e + 2], 1.f + f[e + 3]);
    }
  } else {
#pragma unroll 8
    for (int i = tid; i < h; i += kConsumerWarps * 32) gp[i] = 1.f + to_f32(g[i]);
  }
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(kBulkThreads, 2)
rmsnorm_bulk_kernel(const TX* __restrict__ x, const TG* __restrict__ g, TX* __restrict__ y,
                    int n, int h, int rows, int wpr, int stages, float eps) {
  using V = Vec<TX>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t row_bytes = static_cast<uint32_t>(h) * sizeof(TX);
  const uint32_t stride = stage_stride(h, sizeof(TX), rows);
  float* gp = reinterpret_cast<float*>(smem + static_cast<size_t>(stages) * stride);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(gp) +
                                               round_up(4u * h, 16));
  uint64_t* empty = full + stages;
  float* partial = reinterpret_cast<float*>(empty + stages);  // [2][kConsumerWarps]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (n + rows - 1) / rows;
  const int my_tiles = (tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                       static_cast<int>(gridDim.x);  // tiles blockIdx.x, + gridDim.x, ...

  // the producer (lane 0 of warp 0): bring local tile j, global tile blockIdx.x + j * gridDim.x,
  // into stage j % stages
  auto issue = [&](int j) {
    const int s = j % stages;
    const int r0 = (blockIdx.x + j * gridDim.x) * rows;
    const uint32_t bytes = static_cast<uint32_t>(min(rows, n - r0)) * row_bytes;
    mbar_expect_tx(smem_u32(&full[s]), bytes);
    bulk_load(smem_u32(smem + static_cast<size_t>(s) * stride), x + static_cast<size_t>(r0) * h,
              bytes, smem_u32(&full[s]));
  };
  if (warp == 0) {  // the producer warp: its lanes set up the stages this block uses
    for (int s = lane; s < min(stages, my_tiles); s += 32) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), wpr);  // one arrival per warp of the consuming group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncwarp();  // lane 0's copies complete on mbarriers the other lanes set up
    named_arrive(1, kBulkThreads);  // the consumers may wait on them; the warp goes on
    if (lane == 0) {  // one thread keeps the ring full, from the first cycles on
      for (int j = 0; j < my_tiles; ++j) {
        if (j >= stages) mbar_wait(smem_u32(&empty[j % stages]), ((j / stages) & 1) ^ 1);
        issue(j);
      }
    }
    return;
  }
  // the consumer warps: (1 + g) once a block while the first tiles are in flight, then wait
  // for the producer warp's mbarriers and each other's (1 + g)
  stage_gain(g, gp, h, threadIdx.x - 32);
  named_sync(1, kBulkThreads);

  // the consumer warps 1 .. kConsumerWarps, in groups of wpr; group q takes local tiles
  // q, q + groups, ...: with stages a multiple of groups, every round of a stage goes to one
  // group, so a group never waits on a stage two phases ahead of its last completed one
  const int cw = warp - 1;
  const int groups = kConsumerWarps / wpr;
  const int q = cw / wpr, wi = cw % wpr;
  const int nvec = row_bytes / 16;
  const float4* gp4 = reinterpret_cast<const float4*>(gp);
  int flip = 0;  // which set of partials this row's group sum uses
  for (int j = q; j < my_tiles; j += groups) {
    const int s = j % stages;
    mbar_wait(smem_u32(&full[s]), (j / stages) & 1);
    const int r0 = (blockIdx.x + j * gridDim.x) * rows, nr = min(rows, n - r0);
    const unsigned char* tile = smem + static_cast<size_t>(s) * stride;
    for (int r = 0; r < nr; ++r) {
      const uint4* xr =
          reinterpret_cast<const uint4*>(tile + static_cast<size_t>(r) * row_bytes);
      float ss = 0.f;
      for (int v = wi * 32 + lane; v < nvec; v += wpr * 32) {
        float f[V::kN];
        V::unpack(xr[v], f);
#pragma unroll
        for (int k = 0; k < V::kN; ++k) ss += f[k] * f[k];
      }
      ss = warp_sum(ss);
      if (wpr > 1) {  // the group's warps add their partials in one order
        float* p = partial + flip * kConsumerWarps + q * wpr;
        if (lane == 0) p[wi] = ss;
        named_sync(2 + q, wpr * 32);
        ss = 0.f;
        for (int k = 0; k < wpr; ++k) ss += p[k];
        flip ^= 1;  // the next row writes the other set: no wait for slow readers
      }
      const float inv = rsqrtf(ss / (float)h + eps);
      uint4* yr = reinterpret_cast<uint4*>(y + static_cast<size_t>(r0 + r) * h);
      for (int v = wi * 32 + lane; v < nvec; v += wpr * 32) {
        float f[V::kN];
        V::unpack(xr[v], f);
#pragma unroll
        for (int k = 0; k < V::kN; k += 4) {
          const float4 w = gp4[(v * V::kN + k) / 4];
          f[k] = (f[k] * inv) * w.x;
          f[k + 1] = (f[k + 1] * inv) * w.y;
          f[k + 2] = (f[k + 2] * inv) * w.z;
          f[k + 3] = (f[k + 3] * inv) * w.w;
        }
        yr[v] = V::pack(f);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));  // the stage goes back to the producer
  }
}

// Sum of the kRowThreads threads' `v`, in one fixed order, seen by all.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kRowThreads / 32; ++w) s += warp_sums[w];
  return s;
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(kRowThreads)
rmsnorm_latency_kernel(const TX* __restrict__ x, const TG* __restrict__ g, TX* __restrict__ y,
                       int h, float eps) {
  using V = Vec<TX>;
  constexpr int kMaxVec = kLatMaxH / V::kN / kRowThreads;  // 16-byte loads a thread
  __shared__ float warp_sums[kRowThreads / 32];
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(blockIdx.x) * h);
  uint4* yr = reinterpret_cast<uint4*>(y + static_cast<size_t>(blockIdx.x) * h);
  const int nvec = h / V::kN;
  uint4 u[kMaxVec];
  float gv[kMaxVec][V::kN];
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {  // every load of x and g issued before any use
    const int v = k * kRowThreads + threadIdx.x;
    if (v < nvec) {
      u[k] = xr[v];
#pragma unroll
      for (int e = 0; e < V::kN; ++e) gv[k][e] = to_f32(g[v * V::kN + e]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    if (k * kRowThreads + threadIdx.x < nvec) {
      float f[V::kN];
      V::unpack(u[k], f);
#pragma unroll
      for (int e = 0; e < V::kN; ++e) ss += f[e] * f[e];
    }
  }
  const float inv = rsqrtf(block_sum(ss, warp_sums) / (float)h + eps);
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int v = k * kRowThreads + threadIdx.x;
    if (v < nvec) {
      float f[V::kN];
      V::unpack(u[k], f);
#pragma unroll
      for (int e = 0; e < V::kN; ++e) f[e] = (f[e] * inv) * (1.f + gv[k][e]);
      yr[v] = V::pack(f);
    }
  }
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(kRowThreads)
rmsnorm_rowwise_kernel(const TX* __restrict__ x, const TG* __restrict__ g, TX* __restrict__ y,
                       int h, float eps) {
  using V = Vec<TX>;
  __shared__ float warp_sums[kRowThreads / 32];
  const TX* xr = x + static_cast<size_t>(blockIdx.x) * h;
  TX* yr = y + static_cast<size_t>(blockIdx.x) * h;
  // columns [head, tail) start on a 16-byte boundary and are read as vectors
  const int head = min(h, static_cast<int>((16 - reinterpret_cast<uintptr_t>(xr) % 16) % 16 /
                                           sizeof(TX)));
  const int nvec = (h - head) / V::kN;
  const int tail = head + nvec * V::kN;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);

  float ss = 0.f;
  for (int i = threadIdx.x; i < head; i += kRowThreads) ss += to_f32(xr[i]) * to_f32(xr[i]);
  for (int i = threadIdx.x; i < nvec; i += kRowThreads) {
    float f[V::kN];
    V::unpack(xv[i], f);
#pragma unroll
    for (int e = 0; e < V::kN; ++e) ss += f[e] * f[e];
  }
  for (int i = tail + threadIdx.x; i < h; i += kRowThreads) ss += to_f32(xr[i]) * to_f32(xr[i]);
  const float inv = rsqrtf(block_sum(ss, warp_sums) / (float)h + eps);

  for (int i = threadIdx.x; i < head; i += kRowThreads)
    yr[i] = from_f32<TX>((to_f32(xr[i]) * inv) * (1.f + to_f32(g[i])));
  for (int i = threadIdx.x; i < nvec; i += kRowThreads) {
    float f[V::kN];
    V::unpack(xv[i], f);
    const int c = head + i * V::kN;
#pragma unroll
    for (int e = 0; e < V::kN; ++e) yr[c + e] = from_f32<TX>((f[e] * inv) * (1.f + to_f32(g[c + e])));
  }
  for (int i = tail + threadIdx.x; i < h; i += kRowThreads)
    yr[i] = from_f32<TX>((to_f32(xr[i]) * inv) * (1.f + to_f32(g[i])));
}

// The bulk kernel's shared-memory opt-in, once per device.
template <typename TX, typename TG>
cudaError_t opt_in_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return ce;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    ce = cudaFuncSetAttribute(rmsnorm_bulk_kernel<TX, TG>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (ce != cudaSuccess) return ce;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename TX, typename TG>
int launch(const void* xp, const void* gp, void* yp, int n, int h, float eps, int path, int grid,
           int rows, int wpr, int stages, int smem_bytes, cudaStream_t s) {
  const TX* x = static_cast<const TX*>(xp);
  const TG* g = static_cast<const TG*>(gp);
  TX* y = static_cast<TX*>(yp);
  const bool vec = (static_cast<long long>(h) * sizeof(TX)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (path == 0) {  // rowwise
    if (grid != n) return (int)cudaErrorInvalidValue;
    rmsnorm_rowwise_kernel<TX, TG><<<grid, kRowThreads, 0, s>>>(x, g, y, h, eps);
  } else if (path == 1) {  // latency
    if (grid != n || !vec || h > kLatMaxH) return (int)cudaErrorInvalidValue;
    rmsnorm_latency_kernel<TX, TG><<<grid, kRowThreads, 0, s>>>(x, g, y, h, eps);
  } else if (path == 2) {  // bulk
    const long long tiles = (n + rows - 1LL) / rows;
    if (!vec || rows < 1 || stages < 2 || stages > 64 || grid < 1 || grid > tiles ||
        !(wpr == 1 || wpr == 2 || wpr == 4 || wpr == 8) || stages % (kConsumerWarps / wpr) ||
        static_cast<long long>(rows) * h * sizeof(TX) > kMaxSmem || smem_bytes > kMaxSmem ||
        smem_bytes != static_cast<int>(bulk_smem(h, sizeof(TX), rows, stages)))
      return (int)cudaErrorInvalidValue;
    const cudaError_t ce = opt_in_smem<TX, TG>();
    if (ce != cudaSuccess) return (int)ce;
    rmsnorm_bulk_kernel<TX, TG><<<grid, kBulkThreads, smem_bytes, s>>>(x, g, y, n, h, rows, wpr,
                                                                       stages, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* g, void* y, long long n, int h,
                           int x_dtype, int g_dtype, float eps, int path, int grid, int rows,
                           int wpr, int stages, int smem_bytes, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || h < 1 || x_dtype < 0 || x_dtype > 1 || g_dtype < 0 ||
      g_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n);
  auto go = [&](auto tx, auto tg) {
    return launch<decltype(tx), decltype(tg)>(x, g, y, ni, h, eps, path, grid, rows, wpr,
                                              stages, smem_bytes, s);
  };
  if (x_dtype == 0) return g_dtype == 0 ? go(float{}, float{}) : go(float{}, bf16{});
  return g_dtype == 0 ? go(bf16{}, float{}) : go(bf16{}, bf16{});
}
