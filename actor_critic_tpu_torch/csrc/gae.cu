// GAE reverse scan for NVIDIA Hopper (sm_90a).
//
// Replaces: actor_critic_tpu/ops/pallas_scan.py::_gae_kernel (launched by
// `gae` through `pl.pallas_call`), which walks T in reverse inside one
// Pallas program with the env batch tiled across 128 VMEM lanes.
//
// Computes, for each env column e, in reverse over t with float32 carries
// (adv_T = 0, v_T = bootstrap[e]):
//   nonterm = 1 - d[t,e]
//   delta   = r[t,e] + gamma * v_next * nonterm - v[t,e]
//   adv     = fma((gamma*lam) * nonterm, adv, delta)
//   adv[t,e] = adv,  ret[t,e] = adv + v[t,e],  v_next = v[t,e]
//
// Bound on the card: memory. Each of the three [T,E] inputs is read once,
// the two [T,E] outputs written once, plus the [E] bootstrap: 5*T*E*4 + 4E
// bytes (5.2 MB at T=64, E=4096, about 1.6 us at 3.35 TB/s) against ~8
// flops per element. At the trainer's shape the launch itself dominates.
//
// Design: one thread per env column, the carry in registers. At each t the
// threads of a warp touch neighbouring columns of one row, so every load
// and store is coalesced across E; there is no shared memory and nothing
// carries between blocks, so blocks run in any order. The ragged tail
// block is masked. The TPU kernel's 128-lane zero padding, its VMEM-budget
// block picker and its lax.scan fall back have no counterpart here.
//
// The arithmetic uses the round-to-nearest intrinsics in the order of the
// plain PyTorch version (ops/returns.py::gae), so nvcc contracts nothing on
// its own: the one fused multiply-add is the advantage carry, where the
// plain version uses addcmul and XLA contracts the JAX reference's line.
// The three then agree bit for bit on 0/1 dones.
//
// Built by actor_critic_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes through the plain C launcher below.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
gae_kernel(const float* __restrict__ rewards, const float* __restrict__ values,
           const float* __restrict__ dones, const float* __restrict__ bootstrap,
           float* __restrict__ adv_out, float* __restrict__ ret_out, int T, int E,
           float gamma, float gamma_lam) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  float adv = 0.0f;
  float v_next = bootstrap[e];
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * E + e;
    const float v = values[i];
    const float nonterm = __fsub_rn(1.0f, dones[i]);
    const float delta =
        __fsub_rn(__fadd_rn(rewards[i], __fmul_rn(__fmul_rn(gamma, v_next), nonterm)), v);
    adv = __fmaf_rn(__fmul_rn(gamma_lam, nonterm), adv, delta);
    adv_out[i] = adv;
    ret_out[i] = __fadd_rn(adv, v);
    v_next = v;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), allocates nothing and
// does not synchronise. Returns cudaGetLastError() after the launch; the
// Python wrapper raises if it is not 0.
extern "C" int gae_launch(const float* rewards, const float* values, const float* dones,
                          const float* bootstrap, float* adv_out, float* ret_out, int T,
                          int E, float gamma, float gamma_lam, void* stream) {
  if (T <= 0 || E <= 0) return 0;
  const int blocks = (E + kThreads - 1) / kThreads;
  gae_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rewards, values, dones, bootstrap, adv_out, ret_out, T, E, gamma, gamma_lam);
  return static_cast<int>(cudaGetLastError());
}
