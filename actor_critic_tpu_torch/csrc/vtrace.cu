// V-trace reverse scan for NVIDIA Hopper (sm_90a).
//
// Replaces: actor_critic_tpu/ops/pallas_scan.py::_vtrace_kernel (launched
// by `vtrace` through `pl.pallas_call`), which walks T in reverse inside one
// Pallas program with the env batch tiled across 128 VMEM lanes.
//
// Computes, for each env column e, in reverse over t with float32 carries
// (acc_T = 0, v_T = vs_T = bootstrap[e]):
//   raw   = expf(min(tlp - blp, 20))        (the log-ratio cap, then the exp)
//   rho   = min(rho_bar, raw)
//   c     = lam * min(c_bar, raw)           (c clips the RAW ratio, not rho)
//   disc  = gamma * (1 - d)
//   delta = rho * ((r + disc * v_next) - v)
//   acc   = fma(disc * c, acc, delta)
//   vs    = acc + v
//   pg    = rho * ((r + disc * vs_next) - v)
// and writes vs, pg and rho at [t, e].
//
// Bound on the card: memory. Each of the five [T,E] inputs is read once,
// the three [T,E] outputs written once, plus the [E] bootstrap:
// (8*T*E + E)*4 bytes, 41,216 B at the preset's T=20, E=64 (about 0.012 us
// at 3.35 TB/s), against about 20 float operations and one exp per element. At
// the preset's E=64 the grid is one block of 64 live threads, so the
// launch, not the bound, sets the time.
//
// Design: one thread per env column, the carries in registers. At each t
// the threads of a warp touch neighbouring columns of one row, so every
// load and store is coalesced across E; there is no shared memory and
// nothing carries between blocks, so blocks run in any order. The ragged
// tail block is masked. The TPU kernel's 128-lane zero padding, its
// VMEM-budget block picker and its lax.scan fall back have no counterpart.
//
// Numerics: expf (never __expf; the build uses no --use_fast_math), the cap
// applied before the exp, and every other operation pinned with the
// round-to-nearest intrinsics in the order of the plain PyTorch version
// (ops/returns.py::vtrace), so nvcc contracts nothing on its own. The one
// fused multiply-add is the trace carry, where the plain version uses
// addcmul and XLA on the CPU contracts the JAX reference's line. The
// minimums propagate a NaN input as torch.clamp and jnp.minimum do.
//
// Built by actor_critic_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes through the plain C launcher below.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kLogRatioCap = 20.0f;

// min(x, cap) that returns x when x is NaN.
__device__ __forceinline__ float capped(float x, float cap) { return cap < x ? cap : x; }

__global__ void __launch_bounds__(kThreads)
vtrace_kernel(const float* __restrict__ target_log_probs,
              const float* __restrict__ behaviour_log_probs,
              const float* __restrict__ rewards, const float* __restrict__ values,
              const float* __restrict__ dones, const float* __restrict__ bootstrap,
              float* __restrict__ vs_out, float* __restrict__ pg_out,
              float* __restrict__ rho_out, int T, int E, float gamma, float rho_bar,
              float c_bar, float lam) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  float acc = 0.0f;
  float v_next = bootstrap[e];
  float vs_next = v_next;
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * E + e;
    const float raw =
        expf(capped(__fsub_rn(target_log_probs[i], behaviour_log_probs[i]), kLogRatioCap));
    const float rho = capped(raw, rho_bar);
    const float c = __fmul_rn(lam, capped(raw, c_bar));
    const float disc = __fmul_rn(gamma, __fsub_rn(1.0f, dones[i]));
    const float r = rewards[i];
    const float v = values[i];
    const float delta = __fmul_rn(rho, __fsub_rn(__fadd_rn(r, __fmul_rn(disc, v_next)), v));
    acc = __fmaf_rn(__fmul_rn(disc, c), acc, delta);
    const float vs = __fadd_rn(acc, v);
    vs_out[i] = vs;
    pg_out[i] = __fmul_rn(rho, __fsub_rn(__fadd_rn(r, __fmul_rn(disc, vs_next)), v));
    rho_out[i] = rho;
    v_next = v;
    vs_next = vs;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), allocates nothing and
// does not synchronise. Returns cudaGetLastError() after the launch; the
// Python wrapper raises if it is not 0.
extern "C" int vtrace_launch(const float* target_log_probs, const float* behaviour_log_probs,
                             const float* rewards, const float* values, const float* dones,
                             const float* bootstrap, float* vs_out, float* pg_out,
                             float* rho_out, int T, int E, float gamma, float rho_bar,
                             float c_bar, float lam, void* stream) {
  if (T <= 0 || E <= 0) return 0;
  const int blocks = (E + kThreads - 1) / kThreads;
  vtrace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      target_log_probs, behaviour_log_probs, rewards, values, dones, bootstrap, vs_out, pg_out,
      rho_out, T, E, gamma, rho_bar, c_bar, lam);
  return static_cast<int>(cudaGetLastError());
}
