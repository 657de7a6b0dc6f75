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
//   delta = rho * ((r + disc * v[t+1]) - v)
//   acc   = fma(disc * c, acc, delta)
//   vs    = acc + v
//   pg    = rho * ((r + disc * vs[t+1]) - v)
// and writes vs, pg and rho at [t, e].
//
// Bound on the card: memory. Each of the five [T,E] inputs is read once,
// the three [T,E] outputs written once, plus the [E] bootstrap:
// (8*T*E + E)*4 bytes, 41,216 B at the preset's T=20, E=64 (0.0123 us at
// 3.35 TB/s), against about 20 float operations and one exp per element.
// There is no matrix product, so the tensor cores do not apply. At the
// preset's shape the bytes are nothing: the card's launch floor (the time
// of an empty kernel) and one round trip to L2 set the floor instead.
//
// Design: the only serial dependency is one FMA a step, the trace carry;
// everything else depends on the data alone (v[t+1] is a load) or, for pg,
// on vs one row down in time. So a block takes a strip of kColumns env
// columns over all T rows and walks T in chunks of at most kChunk rows
// (csrc/scan_tile.cuh):
//   0. every thread issues its cp.async copies of the chunk's five planes
//      (16 B a copy where E % 4 == 0 and the bases allow, else 4 B; the
//      ragged strip zero-filled) and the bootstrap, and waits once;
//   1. every thread, for its rows of the chunk: raw, rho, c, disc, delta
//      and disc*c, in place (rho over tlp, disc*c over blp, disc over d,
//      delta in a scratch plane), all its loads first, then the arithmetic,
//      then the stores; rho is stored to global here;
//   2. one thread per column runs only the FMA carry, from shared memory
//      into a shared array of its own, in batches of rows loaded into
//      registers ahead of the FMAs;
//   3. every thread stores vs = acc + v and pg from vs one row down in time.
// Stores are coalesced across the strip. Where T takes more than one chunk,
// the next chunk down in T is copied into the second buffer while this one
// is computed; v and vs at the top of a chunk come from the chunk above,
// kept in `v_next` and `vs_next`. Blocks share nothing and run in any
// order. The geometry comes from the Python wrapper
// (ops/_scan_args.py::scan_geometry); the launcher checks it against the
// compiled tile shape.
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

#include "scan_tile.cuh"

namespace {

using scan_tile::kColumns;
using scan_tile::kPassRows;
using scan_tile::kRowStep;

constexpr float kLogRatioCap = 20.0f;

// min(x, cap) that returns x when x is NaN.
__device__ __forceinline__ float capped(float x, float cap) { return cap < x ? cap : x; }

template <int kBytes>
__global__ void __launch_bounds__(scan_tile::kThreads)
vtrace_kernel(scan_tile::Planes<5> in, const float* __restrict__ bootstrap,
              float* __restrict__ vs_out, float* __restrict__ pg_out,
              float* __restrict__ rho_out, int T, int E, int chunk, float gamma, float rho_bar,
              float c_bar, float lam) {
  // [chunk][kColumns] scratch (delta), then [2][5][chunk][kColumns]: tlp
  // (then rho), blp (then disc*c), rewards, values, dones (then disc); the
  // second buffer only where T > chunk.
  extern __shared__ __align__(16) float smem[];
  __shared__ float acc_s[scan_tile::kChunk * kColumns];  // the carry's output
  __shared__ float v_next[kColumns];                     // values at the row above the chunk
  __shared__ float vs_next[2][kColumns];                 // vs there, by chunk parity
  const int tile = chunk * kColumns;
  float* delta_s = smem;
  float* tiles = smem + tile;
  const int col0 = blockIdx.x * kColumns;
  const int col = threadIdx.x % kColumns;  // this thread's column in the parallel passes
  const int row0 = threadIdx.x / kColumns;
  const int e = col0 + col;
  const bool chain = threadIdx.x < kColumns;  // runs the carry of column `col`
  if (chain) {
    const float* b = bootstrap + (e < E ? e : 0);
    scan_tile::copy_async<4>(&v_next[col], b, e < E);
    scan_tile::copy_async<4>(&vs_next[0][col], b, e < E);
  }
  float acc = 0.0f;

  scan_tile::load_chunk<5, kBytes>(tiles, in, max(0, T - chunk), T, chunk, col0, E);
  for (int k = 0, hi = T; hi > 0; ++k) {
    const int lo = max(0, hi - chunk);
    const int rows = hi - lo;
    float* tlp = tiles + (k & 1) * 5 * tile;
    float* blp = tlp + tile;
    float* r = blp + tile;
    float* v = r + tile;
    float* d = v + tile;
    if (lo > 0) {  // the next chunk down in T goes in flight behind this one
      scan_tile::load_chunk<5, kBytes>(tiles + ((k + 1) & 1) * 5 * tile, in, max(0, lo - chunk),
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
      float tl[kPassRows], bl[kPassRows], rv[kPassRows], vv[kPassRows], dv[kPassRows],
          vn[kPassRows], delta[kPassRows];
#pragma unroll
      for (int j = 0; j < kPassRows; ++j) {
        const int row = min(row0 + j * kRowStep, rows - 1);
        const int i = row * kColumns + col;
        tl[j] = tlp[i];
        bl[j] = blp[i];
        rv[j] = r[i];
        vv[j] = v[i];
        dv[j] = d[i];
        vn[j] = row + 1 < rows ? v[i + kColumns] : v_above;
      }
#pragma unroll
      for (int j = 0; j < kPassRows; ++j) {
        const float raw = expf(capped(__fsub_rn(tl[j], bl[j]), kLogRatioCap));
        const float rho = capped(raw, rho_bar);
        const float c = __fmul_rn(lam, capped(raw, c_bar));
        const float disc = __fmul_rn(gamma, __fsub_rn(1.0f, dv[j]));
        delta[j] = __fmul_rn(rho, __fsub_rn(__fadd_rn(rv[j], __fmul_rn(disc, vn[j])), vv[j]));
        tl[j] = rho;
        bl[j] = __fmul_rn(disc, c);
        dv[j] = disc;
      }
#pragma unroll
      for (int j = 0; j < kPassRows; ++j) {
        const int row = row0 + j * kRowStep;
        if (row < rows) {
          const int i = row * kColumns + col;
          delta_s[i] = delta[j];
          tlp[i] = tl[j];  // rho
          blp[i] = bl[j];  // disc*c
          d[i] = dv[j];    // disc
          if (e < E) rho_out[static_cast<size_t>(lo + row) * E + e] = tl[j];
        }
      }
    }
    __syncthreads();

    if (chain) {
      acc = scan_tile::carry_column(blp, delta_s, acc_s, rows, col, acc);
      v_next[col] = v[col];
      vs_next[(k + 1) & 1][col] = __fadd_rn(acc, v[col]);
    }
    __syncthreads();

    {
      const float vs_above = vs_next[k & 1][col];
      float av[kPassRows], vv[kPassRows], an[kPassRows], vn[kPassRows], rho[kPassRows],
          rv[kPassRows], disc[kPassRows];
      bool top[kPassRows];  // the chunk's top row: vs above it is the chunk above's
#pragma unroll
      for (int j = 0; j < kPassRows; ++j) {
        const int row = min(row0 + j * kRowStep, rows - 1);
        const int i = row * kColumns + col;
        top[j] = row + 1 == rows;
        const int up = top[j] ? i : i + kColumns;
        av[j] = acc_s[i];
        vv[j] = v[i];
        an[j] = acc_s[up];
        vn[j] = v[up];
        rho[j] = tlp[i];
        rv[j] = r[i];
        disc[j] = d[i];
      }
#pragma unroll
      for (int j = 0; j < kPassRows; ++j) {
        const int row = row0 + j * kRowStep;
        if (row < rows && e < E) {
          const size_t g = static_cast<size_t>(lo + row) * E + e;
          const float vsn = top[j] ? vs_above : __fadd_rn(an[j], vn[j]);
          vs_out[g] = __fadd_rn(av[j], vv[j]);
          pg_out[g] = __fmul_rn(rho[j], __fsub_rn(__fadd_rn(rv[j], __fmul_rn(disc[j], vsn)), vv[j]));
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
extern "C" int vtrace_launch(const float* target_log_probs, const float* behaviour_log_probs,
                             const float* rewards, const float* values, const float* dones,
                             const float* bootstrap, float* vs_out, float* pg_out,
                             float* rho_out, int T, int E, float gamma, float rho_bar,
                             float c_bar, float lam, int blocks, int threads, int columns,
                             int chunk, int smem_bytes, int copy_bytes, void* stream) {
  if (T <= 0 || E <= 0) return 0;
  const scan_tile::Planes<5> in{{target_log_probs, behaviour_log_probs, rewards, values, dones}};
  if (!scan_tile::geometry_fits(T, E, 5, 1, blocks, threads, columns, chunk, smem_bytes,
                                copy_bytes) ||
      (copy_bytes == 16 && !scan_tile::aligned16(in))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int allowed[2] = {0, 0};
  auto* kernel = copy_bytes == 16 ? vtrace_kernel<16> : vtrace_kernel<4>;
  const cudaError_t err = scan_tile::allow_shared(kernel, smem_bytes, allowed[copy_bytes == 16]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      in, bootstrap, vs_out, pg_out, rho_out, T, E, chunk, gamma, rho_bar, c_bar, lam);
  return static_cast<int>(cudaGetLastError());
}
