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
// longer (forward: i, f, z read, h and the per-step state c, n, m written;
// backward: i, f, z, dh and the state read, di, df, dz written: each once).
// At xlstm's (1, 2048, 1024) the 1024 channels fill 32 warps, far fewer
// than the card could run at once, so the chain bounds it.
//
// Design: one thread owns one (b, h) channel and walks t (forward up,
// backward down), with the inputs of the next kRing steps held in a ring of
// registers, loaded kRing steps before their use: they do not depend on the
// state, so their latency hides behind the chain.  Neighbouring threads own
// neighbouring channels, so each step's loads and stores are coalesced.
// One warp a block spreads the warps over the SMs.
//
// Numerics: the JAX step, in fp32, product by product without contraction
// into fused multiply-adds (__fmul_rn / __fadd_rn), so the kernel gives the
// bits of the plain PyTorch loop (kernels/ref.py::slstm_scan_ref) on the
// card.  The backward is autodiff of that step as written, including the
// halved gradient at a tie of either max: at t = 0 the state m = -1e30
// makes m_0 = i_0, so the input gate is 1, the forget gate 0, and n_0 is
// exactly 1, the tie of max(n, 1), in every channel.  The forward stores
// c, n, m of every step; the backward reads them and recomputes the gates.
// No atomics: two launches give the same bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 32;  // one warp a block
constexpr int kRing = 8;      // steps of inputs in flight ahead of the chain
constexpr float kMInit = -1e30f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void __launch_bounds__(kThreads) slstm_fwd_kernel(
    const float* __restrict__ ip, const float* __restrict__ fp, const float* __restrict__ zp,
    float* __restrict__ hs, float* __restrict__ cs, float* __restrict__ ns,
    float* __restrict__ ms, int b, int s, int h) {
  const long long ch = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (ch >= static_cast<long long>(b) * h) return;
  const long long base = (ch / h) * s * static_cast<long long>(h) + ch % h;
  float ri[kRing], rf[kRing], rz[kRing];
#pragma unroll
  for (int k = 0; k < kRing; ++k) {
    if (k < s) {
      const long long off = base + static_cast<long long>(k) * h;
      ri[k] = ip[off];
      rf[k] = fp[off];
      rz[k] = zp[off];
    }
  }
  float c = 0.f, n = 0.f, m = kMInit;
  for (int t0 = 0; t0 < s; t0 += kRing) {
#pragma unroll
    for (int k = 0; k < kRing; ++k) {
      const int t = t0 + k;
      if (t < s) {
        const float i_t = ri[k], f_t = rf[k], z_t = rz[k];
        if (t + kRing < s) {  // refill this slot with step t + kRing
          const long long nxt = base + static_cast<long long>(t + kRing) * h;
          ri[k] = ip[nxt];
          rf[k] = fp[nxt];
          rz[k] = zp[nxt];
        }
        const float a = add(f_t, m);
        const float m_new = fmaxf(a, i_t);
        const float ie = expf(sub(i_t, m_new));
        const float fe = expf(sub(a, m_new));
        c = add(mul(fe, c), mul(ie, z_t));
        n = add(mul(fe, n), ie);
        m = m_new;
        const long long off = base + static_cast<long long>(t) * h;
        hs[off] = c / fmaxf(n, 1.f);
        cs[off] = c;
        ns[off] = n;
        ms[off] = m;
      }
    }
  }
}

// the share of a max's gradient that goes to `x` in max(x, y): all of it
// where x wins, none where it loses, half at a tie (jnp.maximum and
// torch.maximum alike)
__device__ __forceinline__ float max_share(float x, float y) {
  return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

__global__ void __launch_bounds__(kThreads) slstm_bwd_kernel(
    const float* __restrict__ ip, const float* __restrict__ fp, const float* __restrict__ zp,
    const float* __restrict__ cs, const float* __restrict__ ns, const float* __restrict__ ms,
    const float* __restrict__ dhp, float* __restrict__ dip, float* __restrict__ dfp,
    float* __restrict__ dzp, int b, int s, int h) {
  const long long ch = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (ch >= static_cast<long long>(b) * h) return;
  const long long base = (ch / h) * s * static_cast<long long>(h) + ch % h;
  // ring slot k holds step t's inputs and the state after step t - 1
  float ri[kRing], rf[kRing], rz[kRing], rd[kRing], rc[kRing], rn[kRing], rm[kRing];
  auto load = [&](int k, int t) {
    const long long off = base + static_cast<long long>(t) * h;
    ri[k] = ip[off];
    rf[k] = fp[off];
    rz[k] = zp[off];
    rd[k] = dhp[off];
    if (t > 0) {
      rc[k] = cs[off - h];
      rn[k] = ns[off - h];
      rm[k] = ms[off - h];
    } else {
      rc[k] = 0.f;
      rn[k] = 0.f;
      rm[k] = kMInit;
    }
  };
#pragma unroll
  for (int k = 0; k < kRing; ++k) {
    if (k < s) load(k, s - 1 - k);
  }
  // the state after step s - 1, and the gradients carried into it
  const long long last = base + static_cast<long long>(s - 1) * h;
  float c_t = cs[last], n_t = ns[last], m_t = ms[last];
  float dc = 0.f, dn = 0.f, dm = 0.f;
  for (int r0 = 0; r0 < s; r0 += kRing) {
#pragma unroll
    for (int k = 0; k < kRing; ++k) {
      const int r = r0 + k;  // the r-th step from the end: t = s - 1 - r
      if (r < s) {
        const float i_t = ri[k], f_t = rf[k], z_t = rz[k], dh = rd[k];
        const float c_p = rc[k], n_p = rn[k], m_p = rm[k];
        if (r + kRing < s) load(k, s - 1 - r - kRing);
        // the forward's step, recomputed
        const float a = add(f_t, m_p);
        const float ie = expf(sub(i_t, m_t));
        const float fe = expf(sub(a, m_t));
        const float d = fmaxf(n_t, 1.f);
        // h = c / d: dc += dh / d, dd = -dh ((c / d) / d) (torch's division
        // backward), the share of dd to n
        const float dct = add(dc, dh / d);
        const float dd = mul(-dh, (c_t / d) / d);
        const float dnt = add(dn, mul(dd, max_share(n_t, 1.f)));
        // c = fe c_p + ie z, n = fe n_p + ie
        const float dfe = add(mul(dct, c_p), mul(dnt, n_p));
        const float die = add(mul(dct, z_t), dnt);
        const float dz = mul(dct, ie);
        dc = mul(dct, fe);
        dn = mul(dnt, fe);
        // ie = exp(i - m), fe = exp(a - m), m = max(a, i), a = f + m_p
        const float gi = mul(die, ie);
        const float gf = mul(dfe, fe);
        const float dmt = sub(sub(dm, gi), gf);
        const float di = add(gi, mul(dmt, max_share(i_t, a)));
        const float da = add(gf, mul(dmt, max_share(a, i_t)));
        dm = da;  // into m_p, through a
        const long long off = base + static_cast<long long>(s - 1 - r) * h;
        dip[off] = di;
        dfp[off] = da;
        dzp[off] = dz;
        c_t = c_p;
        n_t = n_p;
        m_t = m_p;
      }
    }
  }
}

int grid_for(int b, int h) {
  return static_cast<int>((static_cast<long long>(b) * h + kThreads - 1) / kThreads);
}

bool bad_shape(int b, int s, int h) {
  return b < 1 || s < 1 || h < 1 || static_cast<long long>(b) * h > 0x7fffffffLL * kThreads;
}

}  // namespace

// i, f, z: (b, s, h) fp32 contiguous; hs, c, n, m: (b, s, h) fp32, the
// output and the state after every step.  Returns the launch's CUDA error.
extern "C" int slstm_fwd(const void* i, const void* f, const void* z, void* hs, void* c, void* n,
                         void* m, int b, int s, int h, void* stream) {
  if (bad_shape(b, s, h)) return static_cast<int>(cudaErrorInvalidValue);
  slstm_fwd_kernel<<<grid_for(b, h), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(i), static_cast<const float*>(f), static_cast<const float*>(z),
      static_cast<float*>(hs), static_cast<float*>(c), static_cast<float*>(n),
      static_cast<float*>(m), b, s, h);
  return static_cast<int>(cudaGetLastError());
}

// i, f, z, the forward's c, n, m and dh: (b, s, h) fp32 contiguous; di, df,
// dz: (b, s, h) fp32.  Returns the launch's CUDA error.
extern "C" int slstm_bwd(const void* i, const void* f, const void* z, const void* c,
                         const void* n, const void* m, const void* dh, void* di, void* df,
                         void* dz, int b, int s, int h, void* stream) {
  if (bad_shape(b, s, h)) return static_cast<int>(cudaErrorInvalidValue);
  slstm_bwd_kernel<<<grid_for(b, h), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(i), static_cast<const float*>(f), static_cast<const float*>(z),
      static_cast<const float*>(c), static_cast<const float*>(n), static_cast<const float*>(m),
      static_cast<const float*>(dh), static_cast<float*>(di), static_cast<float*>(df),
      static_cast<float*>(dz), b, s, h);
  return static_cast<int>(cudaGetLastError());
}
