// sLSTM time loop, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this loop as a `lax.scan`
// (src/repro/models/modules.py::apply_slstm), which XLA compiles.  The port
// needs a kernel for it because the loop is s steps of elementwise work on
// (b, h) channels: as PyTorch ops it is ~14 launches a step forward and
// about twice that backward, ~4M launches a training step of xlstm-350m
// (6 sLSTM layers x 2048 steps x 8 microbatches), and no CUDA graph of
// sensible size holds them.
//
// What bounds it: every channel is an independent chain of s dependent
// steps, so the time is the s-step chain's latency unless the bytes take
// longer.  Only a few operations a step carry the state: forward
// m_t = max(f_t + m_{t-1}, i_t) (add, max) and c_t = fe c_{t-1} + ie z,
// n_t = fe n_{t-1} + ie (mul, add each); backward the dc and dn carries
// (add, mul each) and dm (sub, sub, mul, add).  Everything else -- the
// exponentials once m is known, h = c / max(n, 1), the backward's di, df,
// dz, every load and store -- does not depend on the carry.  Bytes: the
// forward reads i, f, z and writes h and the state c, n, m of every step,
// the backward reads i, f, z, dh and that state and writes di, df, dz: 17
// (b, s, h) fp32 arrays, ~0.043 ms at xlstm's (1, 2048, 1024) at 3.35 TB/s.
//
// Design (a first kernel ran one thread a channel, one warp a block, every
// step's loads, exponentials, division and stores in that thread: ~500 ns
// a step, 1.4% of the byte bound).  Here everything off the chain goes to
// other warps, and the chain threads run only the carried operations:
//  - a block owns kChannels = 8 channels of one batch row (32 bytes a step
//    of each array: one sector, coalesced), so xlstm's 1024 channels run
//    on 128 blocks, one an SM, not 32;
//  - the steps go in chunks of kChunk through a ring of kFwdRing /
//    kBwdRing chunk slots in shared memory, filled by cp.async (16-byte
//    copies where h and the bases allow, else 4-byte) kFwdAhead /
//    kBwdAhead chunks ahead of their use: a DRAM round trip is a few
//    chunks at the chain's rate;
//  - one tick a chunk, all warps then a barrier; a chunk moves one stage a
//    tick.  Forward: warp 0 runs the m chain over chunk j; the stage group
//    (kStageWarps warps) computes ie, fe and ie z over chunk j - 1 in
//    parallel (m is known there); warp 1 runs the c and n chains over
//    chunk j - 2; the load group (the other workers) issues the loads and
//    computes h = c / max(n, 1) of chunk j - 3 and writes h, c, n, m out as
//    whole chunk rows.  Backward, chunks in reverse: the stage group
//    recomputes ie, fe and precomputes dh / d, the share of dd to n and the
//    max shares of chunk j; warp 0 runs the dc and dn chains over chunk
//    j - 1; the load group forms the gate gradients gi, gf and dz of chunk
//    j - 2; warp 1 runs the dm chain over chunk j - 3; the load group forms
//    di of chunk j - 4 and writes di, df, dz out;
//  - a worker reads all of its elements of a stage before it computes any,
//    and the two worker groups run their stages side by side, so a tick
//    costs one element's latency rather than a sum of them (a first layout,
//    every worker through every stage of 32-step chunks, 8 warps, took
//    0.169 ms for the pair at xlstm's shape, ~1 us a tick whatever the
//    chunk: tools/slstm_variants.py);
//  - a chain thread holds kSub steps of its inputs in registers, loaded
//    before the kSub steps ahead of them run, so no shared-memory load is
//    on the chain.
//
// Numerics: the JAX step, in fp32, product by product without contraction
// into fused multiply-adds (__fmul_rn / __fadd_rn), each op the same IEEE
// op on the same operands as in that one-thread loop (only where it
// runs changed: a recomputed `f + m_{t-1}` is the same add), so the kernel
// gives the bits of the plain PyTorch loop (kernels/ref.py::slstm_scan_ref)
// on the card: the same expf, the same division.  The backward is autodiff
// of that step as written, including the halved gradient at a tie of
// either max: at t = 0 the state m = -1e30 makes m_0 = i_0, so the input
// gate is 1, the forget gate 0, and n_0 is exactly 1, the tie of max(n,
// 1), in every channel.  The forward stores c, n, m of every step; the
// backward reads them and recomputes the gates.  No atomics, and every
// value is computed by one thread in a fixed order: two launches give the
// same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kChannels = 8;  // channels a block: 32 bytes of a step of each array
constexpr int kChunk = 64;    // steps a chunk: a tick of the pipeline
constexpr int kFwdRing = 12;  // chunk slots of the forward's ring
constexpr int kBwdRing = 8;   // ... and of the backward's
constexpr int kWarps = 16;    // warp 0 and 1 the chains, the rest two worker groups
constexpr int kSub = 8;       // steps a chain thread holds in registers ahead
constexpr int kThreads = 32 * kWarps;
constexpr int kStageWarps = (kWarps - 2) / 2;  // the gates (forward) or the prep (backward)
constexpr int kStageThreads = 32 * kStageWarps;
constexpr int kLoadThreads = kThreads - 64 - kStageThreads;  // loads, the rest and the outputs
constexpr int kFwdDepth = 4;  // ticks a chunk spends after its load: m, gates, c/n, out
constexpr int kBwdDepth = 5;  // ... prep, dc/dn, gates, dm, out
constexpr int kFwdAhead = kFwdRing - kFwdDepth;  // chunks loaded ahead of the m chain
constexpr int kBwdAhead = kBwdRing - kBwdDepth;
constexpr int kCell = kChunk * kChannels;              // floats of one array of a chunk
constexpr int kRows1 = (kChunk + 1) * kChannels;       // ... with the step before it
constexpr int kFwdSlot = 4 * kCell;                    // i, f, z, m
constexpr int kBwdSlot = 7 * kCell + 3 * kRows1;       // i, f, z, dh, r, sa_i, sa_a; c, n, m
constexpr int kFwdSmem = kFwdRing * kFwdSlot * 4;
constexpr int kBwdSmem = kBwdRing * kBwdSlot * 4;
constexpr float kMInit = -1e30f;
static_assert(kChannels % 4 == 0 && kChannels <= 32, "16-byte rows, one warp of chain lanes");
static_assert(kChunk % kSub == 0, "a chunk is whole register blocks");
static_assert(kFwdAhead >= 1 && kBwdAhead >= 1, "the ring holds the pipeline and a load");
static_assert(kStageWarps >= 1 && kLoadThreads >= 32, "a warp in each worker group");

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// the share of a max's gradient that goes to `x` in max(x, y): all of it
// where x wins, none where it loses, half at a tie (jnp.maximum and
// torch.maximum alike)
__device__ __forceinline__ float max_share(float x, float y) {
  return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src_bytes = 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// This block's channels: [c0, c0 + nc) of batch row bi; `base` is the
// offset of (bi, t = 0, c0) in a (b, s, h) array.
struct Group {
  long long base;
  int nc;
};

__device__ __forceinline__ Group group_of(int s, int h) {
  const int per_row = (h - 1) / kChannels + 1;
  const int bi = blockIdx.x / per_row, c0 = (blockIdx.x % per_row) * kChannels;
  const int left = h - c0;
  return {static_cast<long long>(bi) * s * h + c0, left < kChannels ? left : kChannels};
}

// A worker group of kGroup threads (tid in [0, kGroup)): steps [t_first,
// t_first + rows) of this block's channels of `src` into dst[rows][kChannels]
// by cp.async, zeros outside [0, s) and past the channels.  kVec: h % 4 == 0
// and 16-byte aligned bases, so a 4-channel chunk lies wholly inside or
// outside.
template <bool kVec, int kGroup>
__device__ __forceinline__ void load_rows(float* dst, const float* src, const Group& gr,
                                          int t_first, int rows, int s, int h, int tid) {
  constexpr int kV = kVec ? 4 : 1;
  for (int e = tid; e < rows * (kChannels / kV); e += kGroup) {
    const int r = e / (kChannels / kV), c = (e % (kChannels / kV)) * kV;
    const int t = t_first + r;
    const bool in = t >= 0 && t < s && c < gr.nc;
    const float* g = in ? src + gr.base + static_cast<long long>(t) * h + c : src;
    if (kVec)
      cp_async16(dst + r * kChannels + c, g, in ? 16 : 0);
    else
      cp_async4(dst + r * kChannels + c, g, in ? 4 : 0);
  }
}

// A worker group's pass over the kCell elements of a chunk, kIters a
// thread: `load(e, x)` for every element first, then `work(e, x)` (the
// arithmetic and its stores) for each, so the elements' latencies overlap
// (on a warp's in-order issue a store waits for its arithmetic, and a load
// behind it would wait too).
template <int kGroup, int kLoads, typename Load, typename Work>
__device__ __forceinline__ void per_element(int tid, Load load, Work work) {
  constexpr int kIters = (kCell + kGroup - 1) / kGroup;
  float x[kIters][kLoads];
#pragma unroll
  for (int it = 0; it < kIters; ++it)
    if (tid + it * kGroup < kCell) load(tid + it * kGroup, x[it]);
#pragma unroll
  for (int it = 0; it < kIters; ++it)
    if (tid + it * kGroup < kCell) work(tid + it * kGroup, x[it]);
}

// A worker group: the chunk's outputs to the steps [t0, t0 + kChunk) of
// dst[q], within [0, s) and the channels; `value(q, e)` gives output q at
// element e of the chunk (read from shared memory).  Every value first,
// then every store, as per_element.
template <bool kVec, int kGroup, int kOut, typename Value>
__device__ __forceinline__ void store_rows(float* const (&dst)[kOut], const Group& gr, int t0,
                                           int s, int h, int tid, Value value) {
  constexpr int kV = kVec ? 4 : 1;
  constexpr int kIters = (kCell / kV + kGroup - 1) / kGroup;
  float v[kIters][kOut][kV];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = (tid + it * kGroup) * kV;
    if (e < kCell) {
#pragma unroll
      for (int q = 0; q < kOut; ++q)
#pragma unroll
        for (int x = 0; x < kV; ++x) v[it][q][x] = value(q, e + x);
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = (tid + it * kGroup) * kV;
    const int r = e / kChannels, c = e % kChannels;
    if (e >= kCell || t0 + r >= s || c >= gr.nc) continue;
    const long long off = gr.base + static_cast<long long>(t0 + r) * h + c;
#pragma unroll
    for (int q = 0; q < kOut; ++q) {
      if (kVec)
        *reinterpret_cast<float4*>(dst[q] + off) =
            make_float4(v[it][q][0], v[it][q][1], v[it][q][2], v[it][q][3]);
      else
        dst[q][off] = v[it][q][0];
    }
  }
}

// A chain thread's walk over the steps of a chunk (forward up, kRev
// down), kSub steps at a time: the inputs of the next kSub steps are
// loaded from in[q][step * kChannels + ch] before the current ones run, so
// no shared-memory load waits on the chain; `step(x, y)` runs one step on
// its kIn inputs, carrying the state in the caller's registers, and gives
// kOut outputs, stored to out[q][...] after each kSub steps.  Steps from
// `n` on (past s, in the last chunk) are skipped where kFull is false.
template <int kIn, int kOut, bool kRev, bool kFull, typename Step>
__device__ __forceinline__ void chain_walk(const float* const (&in)[kIn], float* const (&out)[kOut],
                                           int ch, int n, Step step) {
  constexpr int kBlocks = kChunk / kSub;
  auto row = [](int blk, int u) {
    const int r = blk * kSub + u;
    return kRev ? kChunk - 1 - r : r;
  };
  float nxt[kIn][kSub];
#pragma unroll
  for (int q = 0; q < kIn; ++q)
#pragma unroll
    for (int u = 0; u < kSub; ++u) nxt[q][u] = in[q][row(0, u) * kChannels + ch];
#pragma unroll 1
  for (int blk = 0; blk < kBlocks; ++blk) {
    float cur[kIn][kSub];
#pragma unroll
    for (int q = 0; q < kIn; ++q)
#pragma unroll
      for (int u = 0; u < kSub; ++u) cur[q][u] = nxt[q][u];
    if (blk + 1 < kBlocks) {
#pragma unroll
      for (int q = 0; q < kIn; ++q)
#pragma unroll
        for (int u = 0; u < kSub; ++u) nxt[q][u] = in[q][row(blk + 1, u) * kChannels + ch];
    }
    float res[kOut][kSub];
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      float x[kIn], y[kOut];
#pragma unroll
      for (int q = 0; q < kIn; ++q) x[q] = cur[q][u];
      if (kFull || row(blk, u) < n) {
        step(x, y);
      } else {
#pragma unroll
        for (int q = 0; q < kOut; ++q) y[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < kOut; ++q) res[q][u] = y[q];
    }
#pragma unroll
    for (int q = 0; q < kOut; ++q)
#pragma unroll
      for (int u = 0; u < kSub; ++u) out[q][row(blk, u) * kChannels + ch] = res[q][u];
  }
}

// chain_walk on a whole chunk (n == kChunk) or the last, short one.
template <int kIn, int kOut, bool kRev, typename Step>
__device__ __forceinline__ void chain(const float* const (&in)[kIn], float* const (&out)[kOut],
                                      int ch, int n, Step step) {
  if (n == kChunk)
    chain_walk<kIn, kOut, kRev, true>(in, out, ch, n, step);
  else
    chain_walk<kIn, kOut, kRev, false>(in, out, ch, n, step);
}

// Forward slot of a chunk: I, F, Z, M, [kChunk][kChannels] each.  The gates
// overwrite i, f, z with ie, fe, ie z; the c/n chain overwrites ie z with c
// and ie with n.  Warps: 0 the m chain, 1 the c/n chain, the next
// kStageWarps the gates, the rest the loads and the outputs.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1) slstm_fwd_kernel(
    const float* __restrict__ ip, const float* __restrict__ fp, const float* __restrict__ zp,
    float* __restrict__ hs, float* __restrict__ cs, float* __restrict__ ns,
    float* __restrict__ ms, int s, int h) {
  extern __shared__ __align__(16) float smem[];
  const Group gr = group_of(s, h);
  const int chunks = (s - 1) / kChunk + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tid = threadIdx.x - 64 - (warp < 2 + kStageWarps ? 0 : kStageThreads);
  auto slot = [&](int k) { return smem + (k % kFwdRing) * kFwdSlot; };
  auto steps = [&](int k) { return s - k * kChunk < kChunk ? s - k * kChunk : kChunk; };
  auto load = [&](int k) {  // the loading group: chunk k's i, f, z
    if (k < chunks) {
      float* sl = slot(k);
      load_rows<kVec, kLoadThreads>(sl, ip, gr, k * kChunk, kChunk, s, h, tid);
      load_rows<kVec, kLoadThreads>(sl + kCell, fp, gr, k * kChunk, kChunk, s, h, tid);
      load_rows<kVec, kLoadThreads>(sl + 2 * kCell, zp, gr, k * kChunk, kChunk, s, h, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  const bool loads = warp >= 2 + kStageWarps;
  if (loads) {
    for (int k = 0; k < kFwdAhead; ++k) load(k);
    cp_async_wait<kFwdAhead - 1>();  // chunk 0 has landed
  }
  __syncthreads();
  float m = kMInit, c = 0.f, n = 0.f;  // the chains' carries (warps 0 and 1)
  for (int j = 0; j < chunks + kFwdDepth - 1; ++j) {
    if (warp == 0) {
      if (lane < kChannels && j < chunks) {  // m chain, chunk j
        float* sl = slot(j);
        const float* in[2] = {sl + kCell, sl};  // f, i
        float* out[1] = {sl + 3 * kCell};       // m
        chain<2, 1, false>(in, out, lane, steps(j), [&](const float* x, float* y) {
          m = fmaxf(add(x[0], m), x[1]);
          y[0] = m;
        });
      }
    } else if (warp == 1) {
      const int k = j - 2;
      if (lane < kChannels && k >= 0 && k < chunks) {  // c and n chains, chunk j - 2
        float* sl = slot(k);
        const float* in[3] = {sl + kCell, sl + 2 * kCell, sl};  // fe, ie z, ie
        float* out[2] = {sl + 2 * kCell, sl};                   // c, n
        chain<3, 2, false>(in, out, lane, steps(k), [&](const float* x, float* y) {
          c = add(mul(x[0], c), x[1]);
          n = add(mul(x[0], n), x[2]);
          y[0] = c;
          y[1] = n;
        });
      }
    } else if (!loads) {
      const int k = j - 1;
      if (k >= 0 && k < chunks) {  // the gates of chunk j - 1, its m known
        float* sl = slot(k);
        float *I = sl, *F = sl + kCell, *Z = sl + 2 * kCell;
        const float* M = sl + 3 * kCell;
        const float* m_before = k > 0 ? slot(k - 1) + 3 * kCell + (kChunk - 1) * kChannels
                                      : nullptr;
        per_element<kStageThreads, 5>(tid, [&](int e, float* x) {
          x[0] = e >= kChannels ? M[e - kChannels] : (m_before != nullptr ? m_before[e] : kMInit);
          x[1] = M[e];
          x[2] = I[e];
          x[3] = F[e];
          x[4] = Z[e];
        }, [&](int e, const float* x) {
          const float a = add(x[3], x[0]);  // the m chain's add, again
          const float ie = expf(sub(x[2], x[1]));
          I[e] = ie;
          F[e] = expf(sub(a, x[1]));
          Z[e] = mul(ie, x[4]);
        });
      }
    } else {
      load(j + kFwdAhead);
      const int k = j - 3;
      if (k >= 0 && k < chunks) {  // chunk j - 3 out: h, c, n, m
        const float* sl = slot(k);
        const float *N = sl, *C = sl + 2 * kCell, *M = sl + 3 * kCell;
        float* const dst[4] = {hs, cs, ns, ms};
        store_rows<kVec, kLoadThreads, 4>(dst, gr, k * kChunk, s, h, tid, [&](int q, int e) {
          return q == 0 ? C[e] / fmaxf(N[e], 1.f) : q == 1 ? C[e] : q == 2 ? N[e] : M[e];
        });
      }
      cp_async_wait<kFwdAhead - 1>();  // chunk j + 1 has landed (this thread's copies)
    }
    __syncthreads();  // ... everyone's; each chunk moves one stage on
  }
}

// Backward slot of a chunk, in reverse order of chunks: I, F, Z, DH, R,
// SAI, SAA [kChunk][kChannels], then C, N, M [kChunk + 1][kChannels] (row
// 0 the step before the chunk).  The prep overwrites i, f, dh with ie, fe,
// dh / d and writes R (the share of dd to n), SAI, SAA (the max shares);
// the dc/dn chain overwrites dh / d and R with dct, dnt; the gates write dz
// over z, gi over R, gf over DH; the dm chain writes dmt over DH and da
// over F.  Warps: 0 the dc/dn chain, 1 the dm chain, the next kStageWarps
// the prep, the rest the loads, the gates and the outputs.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1) slstm_bwd_kernel(
    const float* __restrict__ ip, const float* __restrict__ fp, const float* __restrict__ zp,
    const float* __restrict__ csp, const float* __restrict__ nsp, const float* __restrict__ msp,
    const float* __restrict__ dhp, float* __restrict__ dip, float* __restrict__ dfp,
    float* __restrict__ dzp, int s, int h) {
  extern __shared__ __align__(16) float smem[];
  const Group gr = group_of(s, h);
  const int chunks = (s - 1) / kChunk + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tid = threadIdx.x - 64 - (warp < 2 + kStageWarps ? 0 : kStageThreads);
  // the u-th chunk walked is chunk chunks - 1 - u
  auto slot = [&](int u) { return smem + (u % kBwdRing) * kBwdSlot; };
  auto t0_of = [&](int u) { return (chunks - 1 - u) * kChunk; };
  auto steps = [&](int u) { return s - t0_of(u) < kChunk ? s - t0_of(u) : kChunk; };
  auto load = [&](int u) {
    if (u < chunks) {
      float* sl = slot(u);
      const int t0 = t0_of(u);
      const float* const src[7] = {ip, fp, zp, dhp, csp, nsp, msp};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        load_rows<kVec, kLoadThreads>(sl + q * kCell, src[q], gr, t0, kChunk, s, h, tid);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        load_rows<kVec, kLoadThreads>(sl + 7 * kCell + q * kRows1, src[4 + q], gr, t0 - 1,
                                      kChunk + 1, s, h, tid);
    }
    cp_async_commit();
  };
  const bool loads = warp >= 2 + kStageWarps;
  if (loads) {
    for (int u = 0; u < kBwdAhead; ++u) load(u);
    cp_async_wait<kBwdAhead - 1>();
  }
  __syncthreads();
  float dc = 0.f, dn = 0.f, dm = 0.f;  // the chains' carries (warps 0 and 1)
  for (int j = 0; j < chunks + kBwdDepth - 1; ++j) {
    if (warp == 0) {
      const int u = j - 1;
      if (lane < kChannels && u >= 0 && u < chunks) {  // dc and dn chains
        float* sl = slot(u);
        const float* in[3] = {sl + 3 * kCell, sl + 4 * kCell, sl + kCell};  // dh / d, r, fe
        float* out[2] = {sl + 3 * kCell, sl + 4 * kCell};                   // dct, dnt
        chain<3, 2, true>(in, out, lane, steps(u), [&](const float* x, float* y) {
          const float dct = add(dc, x[0]);
          const float dnt = add(dn, x[1]);
          dc = mul(dct, x[2]);
          dn = mul(dnt, x[2]);
          y[0] = dct;
          y[1] = dnt;
        });
      }
    } else if (warp == 1) {
      const int u = j - 3;
      if (lane < kChannels && u >= 0 && u < chunks) {  // dm chain
        float* sl = slot(u);
        const float* in[3] = {sl + 4 * kCell, sl + 3 * kCell, sl + 6 * kCell};  // gi, gf, sa_a
        float* out[2] = {sl + 3 * kCell, sl + kCell};                           // dmt, da
        chain<3, 2, true>(in, out, lane, steps(u), [&](const float* x, float* y) {
          const float dmt = sub(sub(dm, x[0]), x[1]);
          dm = add(x[1], mul(dmt, x[2]));  // da, into m_{t-1} through a
          y[0] = dmt;
          y[1] = dm;
        });
      }
    } else if (!loads) {
      const int u = j;
      if (u < chunks) {  // prep: the forward's step recomputed, and what the chains add
        float* sl = slot(u);
        float *I = sl, *F = sl + kCell, *DH = sl + 3 * kCell, *R = sl + 4 * kCell;
        float *SAI = sl + 5 * kCell, *SAA = sl + 6 * kCell;
        const float *C = sl + 7 * kCell, *N = C + kRows1, *M = N + kRows1;
        const int t0 = t0_of(u);
        per_element<kStageThreads, 7>(tid, [&](int e, float* x) {
          const int r = e + kChannels;  // the state after this step
          x[0] = t0 + e / kChannels == 0 ? kMInit : M[e];  // m_{t-1}
          x[1] = I[e];
          x[2] = F[e];
          x[3] = DH[e];
          x[4] = C[r];
          x[5] = N[r];
          x[6] = M[r];
        }, [&](int e, const float* x) {
          const float i_t = x[1], dh = x[3], c_t = x[4], n_t = x[5], m_t = x[6];
          const float a = add(x[2], x[0]);
          const float d = fmaxf(n_t, 1.f);
          I[e] = expf(sub(i_t, m_t));
          F[e] = expf(sub(a, m_t));
          // h = c / d: dc += dh / d, dd = -dh ((c / d) / d) (torch's division
          // backward), the share of dd to n
          DH[e] = dh / d;
          R[e] = mul(mul(-dh, (c_t / d) / d), max_share(n_t, 1.f));
          SAI[e] = max_share(i_t, a);
          SAA[e] = max_share(a, i_t);
        });
      }
    } else {
      load(j + kBwdAhead);
      int u = j - 2;
      if (u >= 0 && u < chunks) {  // the gates' gradients: c = fe c_p + ie z, n = fe n_p + ie
        float* sl = slot(u);
        const float *C = sl + 7 * kCell, *N = C + kRows1;
        float *I = sl, *F = sl + kCell, *Z = sl + 2 * kCell, *DH = sl + 3 * kCell;
        float* R = sl + 4 * kCell;
        per_element<kLoadThreads, 7>(tid, [&](int e, float* x) {
          x[0] = DH[e];  // dct
          x[1] = R[e];   // dnt
          x[2] = I[e];   // ie
          x[3] = F[e];   // fe
          x[4] = C[e];   // c_{t-1}
          x[5] = N[e];   // n_{t-1}
          x[6] = Z[e];
        }, [&](int e, const float* x) {
          const float dct = x[0], dnt = x[1], ie = x[2];
          const float dfe = add(mul(dct, x[4]), mul(dnt, x[5]));
          const float die = add(mul(dct, x[6]), dnt);
          Z[e] = mul(dct, ie);     // dz
          R[e] = mul(die, ie);     // gi: ie = exp(i - m)
          DH[e] = mul(dfe, x[3]);  // gf: fe = exp(a - m)
        });
      }
      u = j - 4;
      if (u >= 0 && u < chunks) {  // di, df, dz out
        const float* sl = slot(u);
        const float *F = sl + kCell, *Z = sl + 2 * kCell, *DH = sl + 3 * kCell;
        const float *R = sl + 4 * kCell, *SAI = sl + 5 * kCell;
        float* const dst[3] = {dip, dfp, dzp};
        store_rows<kVec, kLoadThreads, 3>(dst, gr, t0_of(u), s, h, tid, [&](int q, int e) {
          return q == 0 ? add(R[e], mul(DH[e], SAI[e])) : q == 1 ? F[e] : Z[e];
        });
      }
      cp_async_wait<kBwdAhead - 1>();
    }
    __syncthreads();
  }
}

bool bad_shape(int b, int s, int h) {
  return b < 1 || s < 1 || h < 1 ||
         static_cast<long long>(b) * ((h - 1) / kChannels + 1) > 0x7fffffffLL;
}

bool vec_ok(int h, std::initializer_list<const void*> ptrs) {
  if (h % 4 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// Per device, once: each kernel's shared-memory opt-in.
cudaError_t opt_in() {
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return ce;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const cudaError_t r[] = {cudaFuncSetAttribute(slstm_fwd_kernel<true>, a, kFwdSmem),
                           cudaFuncSetAttribute(slstm_fwd_kernel<false>, a, kFwdSmem),
                           cudaFuncSetAttribute(slstm_bwd_kernel<true>, a, kBwdSmem),
                           cudaFuncSetAttribute(slstm_bwd_kernel<false>, a, kBwdSmem)};
  for (cudaError_t e : r)
    if (e != cudaSuccess) return e;
  ready[dev] = true;
  return cudaSuccess;
}

}  // namespace

// i, f, z: (b, s, h) fp32 contiguous; hs, c, n, m: (b, s, h) fp32, the
// output and the state after every step.  Returns the launch's CUDA error.
extern "C" int slstm_fwd(const void* i, const void* f, const void* z, void* hs, void* c, void* n,
                         void* m, int b, int s, int h, void* stream) {
  if (bad_shape(b, s, h)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t ce = opt_in();
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const unsigned grid = static_cast<unsigned>(b * ((h - 1LL) / kChannels + 1));
  auto st = static_cast<cudaStream_t>(stream);
  auto kernel = vec_ok(h, {i, f, z, hs, c, n, m}) ? slstm_fwd_kernel<true> : slstm_fwd_kernel<false>;
  kernel<<<grid, kThreads, kFwdSmem, st>>>(
      static_cast<const float*>(i), static_cast<const float*>(f), static_cast<const float*>(z),
      static_cast<float*>(hs), static_cast<float*>(c), static_cast<float*>(n),
      static_cast<float*>(m), s, h);
  return static_cast<int>(cudaGetLastError());
}

// i, f, z, the forward's c, n, m and dh: (b, s, h) fp32 contiguous; di, df,
// dz: (b, s, h) fp32.  Returns the launch's CUDA error.
extern "C" int slstm_bwd(const void* i, const void* f, const void* z, const void* c,
                         const void* n, const void* m, const void* dh, void* di, void* df,
                         void* dz, int b, int s, int h, void* stream) {
  if (bad_shape(b, s, h)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t ce = opt_in();
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const unsigned grid = static_cast<unsigned>(b * ((h - 1LL) / kChannels + 1));
  auto st = static_cast<cudaStream_t>(stream);
  auto kernel = vec_ok(h, {i, f, z, c, n, m, dh, di, df, dz}) ? slstm_bwd_kernel<true>
                                                               : slstm_bwd_kernel<false>;
  kernel<<<grid, kThreads, kBwdSmem, st>>>(
      static_cast<const float*>(i), static_cast<const float*>(f), static_cast<const float*>(z),
      static_cast<const float*>(c), static_cast<const float*>(n), static_cast<const float*>(m),
      static_cast<const float*>(dh), static_cast<float*>(di), static_cast<float*>(df),
      static_cast<float*>(dz), s, h);
  return static_cast<int>(cudaGetLastError());
}
