// GAE reverse scan for NVIDIA Hopper (sm_90a).
//
// Replaces: actor_critic_tpu/ops/pallas_scan.py::_gae_kernel (launched by
// `gae` through `pl.pallas_call`), which walks T in reverse inside one
// Pallas program with the env batch tiled across 128 VMEM lanes.
//
// Computes, for each env column e, in reverse over t with float32 carries
// (adv_T = 0, v_T = bootstrap[e]):
//   nonterm = 1 - d[t,e]
//   delta   = r[t,e] + gamma * v[t+1,e] * nonterm - v[t,e]
//   adv     = fma((gamma*lam) * nonterm, adv, delta)
//   adv[t,e] = adv,  ret[t,e] = adv + v[t,e]
//
// Bound on the card: memory. Each of the three [T,E] inputs is read once,
// the two [T,E] outputs written once, plus the [E] bootstrap: 5*T*E*4 + 4E
// bytes (5.26 MB at T=64, E=4096, 1.57 us at 3.35 TB/s) against ~8 flops per
// element. There is no matrix product, so the tensor cores do not apply.
// Below that, every launch pays the card's launch floor (the time of an
// empty kernel) and one round trip to L2 before any work can start.
//
// Design: the only serial dependency is one FMA a step, the advantage
// carry; delta and the carry's coefficient depend on the data alone (v[t+1]
// is a load, not a carry). So a block takes a strip of kColumns env columns
// over all T rows (256 blocks at E=4096: every SM has work) and walks T in
// chunks of at most kChunk rows (csrc/scan_tile.cuh):
//   0. every thread issues its cp.async copies of the chunk's three planes
//      (16 B a copy where E % 4 == 0 and the bases allow, else 4 B; the
//      ragged strip zero-filled) and the bootstrap, and waits once;
//   1. every thread computes delta and (gamma*lam)*nonterm for its rows of
//      the chunk, in place: all its loads first, then the arithmetic, then
//      the stores;
//   2. one thread per column runs only the FMA carry, from shared memory
//      into a shared array of its own, in batches of rows loaded into
//      registers ahead of the FMAs;
//   3. every thread stores adv and ret = adv + v for its rows, coalesced.
// Where T takes more than one chunk, the next chunk down in T is copied into
// the second buffer while this one is computed; v at the top of a chunk
// comes from the chunk above, kept in `v_next`. Blocks share nothing and
// run in any order. The geometry comes from the Python wrapper
// (ops/_scan_args.py::scan_geometry); the launcher checks it against the
// compiled tile shape.
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

#include "scan_tile.cuh"

namespace {

using scan_tile::kColumns;
using scan_tile::kPassRows;
using scan_tile::kRowStep;

template <int kBytes>
__global__ void __launch_bounds__(scan_tile::kThreads)
gae_kernel(scan_tile::Planes<3> in, const float* __restrict__ bootstrap,
           float* __restrict__ adv_out, float* __restrict__ ret_out, int T, int E, int chunk,
           float gamma, float gamma_lam) {
  // [2][3][chunk][kColumns]: rewards (then delta), values, dones (then the
  // carry's coefficient); the second buffer only where T > chunk.
  extern __shared__ __align__(16) float tiles[];
  __shared__ float adv_s[scan_tile::kChunk * kColumns];  // the carry's output
  __shared__ float v_next[kColumns];                     // values at the row above the chunk
  const int tile = chunk * kColumns;
  const int col0 = blockIdx.x * kColumns;
  const int col = threadIdx.x % kColumns;  // this thread's column in the parallel passes
  const int row0 = threadIdx.x / kColumns;
  const int e = col0 + col;
  const bool chain = threadIdx.x < kColumns;  // runs the carry of column `col`
  if (chain) scan_tile::copy_async<4>(&v_next[col], bootstrap + (e < E ? e : 0), e < E);
  float adv = 0.0f;

  scan_tile::load_chunk<3, kBytes>(tiles, in, max(0, T - chunk), T, chunk, col0, E);
  for (int k = 0, hi = T; hi > 0; ++k) {
    const int lo = max(0, hi - chunk);
    const int rows = hi - lo;
    float* r = tiles + (k & 1) * 3 * tile;
    float* v = r + tile;
    float* d = v + tile;
    if (lo > 0) {  // the next chunk down in T goes in flight behind this one
      scan_tile::load_chunk<3, kBytes>(tiles + ((k + 1) & 1) * 3 * tile, in, max(0, lo - chunk),
                                       lo, chunk, col0, E);
      scan_tile::wait_copies<1>();
    } else {
      scan_tile::wait_copies<0>();
    }
    __syncthreads();

    // Each parallel pass loads all of a thread's rows, then computes, then
    // stores the rows that exist: loads of rows past the chunk's end are
    // clamped to its last row, so no load waits behind a branch or a store.
    {
      const float v_above = v_next[col];
      float rv[kPassRows], vv[kPassRows], dv[kPassRows], vn[kPassRows];
#pragma unroll
      for (int j = 0; j < kPassRows; ++j) {
        const int row = min(row0 + j * kRowStep, rows - 1);
        const int i = row * kColumns + col;
        rv[j] = r[i];
        vv[j] = v[i];
        dv[j] = d[i];
        vn[j] = row + 1 < rows ? v[i + kColumns] : v_above;
      }
#pragma unroll
      for (int j = 0; j < kPassRows; ++j) {
        const float nonterm = __fsub_rn(1.0f, dv[j]);
        rv[j] = __fsub_rn(__fadd_rn(rv[j], __fmul_rn(__fmul_rn(gamma, vn[j]), nonterm)), vv[j]);
        dv[j] = __fmul_rn(gamma_lam, nonterm);
      }
#pragma unroll
      for (int j = 0; j < kPassRows; ++j) {
        const int row = row0 + j * kRowStep;
        if (row < rows) {
          r[row * kColumns + col] = rv[j];  // delta
          d[row * kColumns + col] = dv[j];  // (gamma*lam)*nonterm
        }
      }
    }
    __syncthreads();

    if (chain) {
      adv = scan_tile::carry_column(d, r, adv_s, rows, col, adv);
      v_next[col] = v[col];
    }
    __syncthreads();

    {
      float av[kPassRows], vv[kPassRows];
#pragma unroll
      for (int j = 0; j < kPassRows; ++j) {
        const int i = min(row0 + j * kRowStep, rows - 1) * kColumns + col;
        av[j] = adv_s[i];
        vv[j] = v[i];
      }
#pragma unroll
      for (int j = 0; j < kPassRows; ++j) {
        const int row = row0 + j * kRowStep;
        if (row < rows && e < E) {
          const size_t g = static_cast<size_t>(lo + row) * E + e;
          adv_out[g] = av[j];
          ret_out[g] = __fadd_rn(av[j], vv[j]);
        }
      }
    }
    __syncthreads();  // the buffer is free for the copies of the chunk after next
    hi = lo;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) with the geometry that
// ops/_scan_args.py::scan_geometry computed, allocates nothing and does not
// synchronise. Returns cudaErrorInvalidValue for a geometry the kernel
// cannot run, else cudaGetLastError() after the launch; the Python wrapper
// raises if it is not 0.
extern "C" int gae_launch(const float* rewards, const float* values, const float* dones,
                          const float* bootstrap, float* adv_out, float* ret_out, int T, int E,
                          float gamma, float gamma_lam, int blocks, int threads, int columns,
                          int chunk, int smem_bytes, int copy_bytes, void* stream) {
  if (T <= 0 || E <= 0) return 0;
  const scan_tile::Planes<3> in{{rewards, values, dones}};
  if (!scan_tile::geometry_fits(T, E, 3, 0, blocks, threads, columns, chunk, smem_bytes,
                                copy_bytes) ||
      (copy_bytes == 16 && !scan_tile::aligned16(in))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int allowed[2] = {0, 0};
  auto* kernel = copy_bytes == 16 ? gae_kernel<16> : gae_kernel<4>;
  const cudaError_t err = scan_tile::allow_shared(kernel, smem_bytes, allowed[copy_bytes == 16]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      in, bootstrap, adv_out, ret_out, T, E, chunk, gamma, gamma_lam);
  return static_cast<int>(cudaGetLastError());
}
