// Pieces shared by the reverse-scan kernels (gae.cu, vtrace.cu): the tile
// of one block, its asynchronous copy into shared memory, the serial carry,
// and the launchers' check of the geometry that the Python wrapper computes
// (actor_critic_tpu_torch/ops/_scan_args.py::scan_geometry).
//
// A block owns a strip of kColumns env columns over all T rows. It walks T
// in reverse in chunks of at most kChunk rows; each chunk of every input
// plane is laid out in shared memory as [plane][chunk][kColumns], and the
// next chunk down in T is copied while the current one is computed. The
// strip's width, the block's threads and the largest chunk are constants,
// so that every shared-memory address in the passes is a register plus a
// constant: the Python geometry uses the same numbers (a CPU test reads
// them from this file) and the launchers check what they are given.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace scan_tile {

constexpr int kColumns = 16;                     // env columns of a block's strip
constexpr int kThreads = 256;                    // threads of a block
constexpr int kChunk = 64;                       // most rows of T in shared memory at once
constexpr int kRowStep = kThreads / kColumns;    // rows a parallel pass covers at once
constexpr int kPassRows = kChunk / kRowStep;     // rows of a chunk one thread covers
static_assert(kThreads % kColumns == 0 && kChunk % kRowStep == 0, "even passes");
static_assert(kColumns % 4 == 0, "a strip's rows are whole 16-byte copies");

// The [T, E] input planes of a kernel, passed by value as one parameter.
template <int kPlanes>
struct Planes {
  const float* p[kPlanes];
};

// One asynchronous copy of kBytes from global to shared memory: 16 B with
// cp.async.cg (through L2 only), 4 B with cp.async.ca. With `valid` false
// nothing is read and the destination is zero-filled.
template <int kBytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  static_assert(kBytes == 16 || kBytes == 4, "16- or 4-byte copies");
  const unsigned dst_addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_bytes = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst_addr), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst_addr), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  }
}

// Waits until at most kPending of this thread's commit groups are in flight.
// A __syncthreads() after it makes every thread's copies visible.
template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issues, from every thread of the block, the copies of rows [lo, hi) of
// columns [col0, col0 + kColumns) of each plane into `dst`, laid out
// [kPlanes][chunk][kColumns], and commits them (with any copy this thread
// issued before) as one group. A thread keeps one column offset and walks
// rows at a constant stride, so its copies issue back to back. Columns at
// or past E are zero-filled and never read; with 16-B copies E % 4 == 0, so
// each copy is wholly inside or wholly outside the strip.
template <int kPlanes, int kBytes>
__device__ __forceinline__ void load_chunk(float* dst, const Planes<kPlanes>& src, int lo, int hi,
                                           int chunk, int col0, int E) {
  constexpr int kFloats = kBytes / 4;
  constexpr int kPerRow = kColumns / kFloats;      // copies a row of the strip takes
  constexpr int kRowsAtOnce = kThreads / kPerRow;  // rows one copy from every thread covers
  static_assert(kThreads % kPerRow == 0, "whole rows per sweep");
  const int col = threadIdx.x % kPerRow * kFloats;
  const int row = threadIdx.x / kPerRow;
  const bool in_strip = col0 + col < E;
  const size_t step = static_cast<size_t>(kRowsAtOnce) * E;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const float* g = src.p[p] + (static_cast<size_t>(lo + row) * E + col0 + col);
    float* s = dst + (p * chunk + row) * kColumns + col;
#pragma unroll
    for (int n = 0; n * kRowsAtOnce < kChunk; ++n) {
      if (row + n * kRowsAtOnce < hi - lo) {
        copy_async<kBytes>(s + n * kRowsAtOnce * kColumns, in_strip ? g + n * step : src.p[p],
                           in_strip);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The one serial dependency of both scans, for column `col` of a chunk:
// x = fma(a[t], x, b[t]) in reverse over rows [0, rows), each x written to
// out[t]; returns the carry after row 0. `out` is a shared array of its own,
// apart from the tiles that hold `a` and `b`, so the compiler may load ahead
// of the stores. Rows go in batches of kBatch, loaded into registers before
// their FMAs, which then run back to back: full batches from the top, then
// the rows % kBatch bottom rows from the window of rows [0, kBatch), which
// lies inside the chunk when it has kBatch rows or more. A shorter chunk
// goes row by row.
template <int kBatch = 16>
__device__ __forceinline__ float carry_column(const float* a, const float* b, float* out,
                                              int rows, int col, float x) {
  float ra[kBatch], rb[kBatch];
  int row = rows - 1;
  for (; row >= kBatch - 1; row -= kBatch) {
    const int base = (row - kBatch + 1) * kColumns + col;  // the batch's lowest row
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      ra[j] = a[base + (kBatch - 1 - j) * kColumns];
      rb[j] = b[base + (kBatch - 1 - j) * kColumns];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      x = __fmaf_rn(ra[j], x, rb[j]);
      out[base + (kBatch - 1 - j) * kColumns] = x;
    }
  }
  if (row >= 0 && rows >= kBatch) {  // rows [0, row] are left, at the window's bottom
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      ra[j] = a[(kBatch - 1 - j) * kColumns + col];
      rb[j] = b[(kBatch - 1 - j) * kColumns + col];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (kBatch - 1 - j <= row) {
        x = __fmaf_rn(ra[j], x, rb[j]);
        out[(kBatch - 1 - j) * kColumns + col] = x;
      }
    }
  } else {
    for (; row >= 0; --row) {
      x = __fmaf_rn(a[row * kColumns + col], x, b[row * kColumns + col]);
      out[row * kColumns + col] = x;
    }
  }
  return x;
}

// True when the kernels can run this geometry: the block's shape is the
// compiled one, the strips cover E, and the dynamic shared memory holds
// `scratch_planes` plus one buffer of `planes` planes, or two where T takes
// more than one chunk.
inline bool geometry_fits(int T, int E, int planes, int scratch_planes, int blocks, int threads,
                          int columns, int chunk, int smem_bytes, int copy_bytes) {
  const long long buffers = T > chunk ? 2 : 1;
  const long long needed =
      (buffers * planes + scratch_planes) * chunk * kColumns * static_cast<long long>(sizeof(float));
  return threads == kThreads && columns == kColumns && chunk > 0 && chunk <= kChunk &&
         static_cast<long long>(blocks) * kColumns >= E && smem_bytes >= needed &&
         (copy_bytes == 4 || (copy_bytes == 16 && E % 4 == 0));
}

template <int kPlanes>
inline bool aligned16(const Planes<kPlanes>& planes) {
  for (const float* p : planes.p) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

// Each kernel counts the launches that ran in a __device__ counter of its own
// library: block 0's first thread adds one. A launch replayed from a CUDA
// graph then counts like one made through the wrapper, and a capture, which
// runs no kernel, counts none. The kernels call it once their first chunk's
// copies are issued, so that the atomic goes out behind them (on an H100 it
// then adds ~0.08 us at launch-bound shapes, ~0.12 us as the first thing).
__device__ __forceinline__ void count_launch(unsigned long long* counter) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(counter, 1ull);
}

// Copies a kernel's launch counter (a __device__ symbol) on the current
// device to *out, then zeroes it where `reset` is set. The caller first waits
// for the work that may launch the kernel.
inline cudaError_t read_launches(const unsigned long long& counter, unsigned long long* out,
                                 bool reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, counter, sizeof(*out));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(counter, &zero, sizeof(zero));
  }
  return err;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB it must
// ask); `allowed` keeps the most granted so far, so the call is made once.
template <typename Kernel>
inline cudaError_t allow_shared(Kernel* kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace scan_tile
