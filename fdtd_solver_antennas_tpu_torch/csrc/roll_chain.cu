// The roll-calibration kernel for Hopper (sm_90a): a chain of dependent
// circular shifts of rows held in shared memory, bound to Python with
// ctypes.
//
// Replaces: examples/chunk_roofline.py::calibrate_rolls (the TPU roll
// calibration, K5). K5 holds a (R, C) array in VMEM and runs `iters`
// times the chain
//
//   x = roll(x, 1, 1) + a
//   x = roll(x, 128, 1) * 0.9999f
//   x = roll(x, C - 1, 1) + a
//   x = roll(x, C - 128, 1) * 0.9999f
//
// with roll(x, s, 1)[j] = x[(j - s) mod C], to time the lane-shift unit
// that bounds the TPU's chunk kernel. On the card the counterpart of a
// lane shift is a neighbour read from shared memory, which is what a tile
// kernel taking its stencil reads from shared memory pays. So each of the
// four shifts here is a real, dependent, circular shift: one block per
// row, the row double-buffered in dynamic shared memory (2 x C floats,
// 56,320 B at C = 7,040, above the 48 KB default and so opted in), each
// thread holding its columns of `a` in registers, __syncthreads() between
// shifts, one global read and one global write of the row. It is not the
// algebraically folded chain: the point is the shift rate.
//
// What bounds it on the card: at most the shared-memory bandwidth of the
// SMs that hold a row, 128 bytes per clock each. On an H100 it ran at
// about a third of that (PERF.md): with one 1,024-thread block per SM and
// a barrier after every shift, each element's index wrap, load, operation
// and store wait on issue and latency. One block per row means R of the
// 132 SMs work (56 at the default 56 x 7,040): the rate is that of R SMs,
// and the entry point reports R beside it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py). Each
// shift adds or multiplies once, as the plain twin does, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPer = 16;  // columns per thread: C <= kThreads * kMaxPer
constexpr float kDecay = 0.9999f;

}  // namespace

__global__ void __launch_bounds__(kThreads)
roll_chain_kernel(const float* __restrict__ a, float* __restrict__ out,
                  const int C, const int iters) {
  extern __shared__ float buf[];  // two rows: [0, C) and [C, 2C)
  const int64_t row = (int64_t)blockIdx.x * C;
  float av[kMaxPer];
#pragma unroll
  for (int q = 0; q < kMaxPer; ++q) {
    const int j = threadIdx.x + q * kThreads;
    av[q] = j < C ? a[row + j] : 0.f;
    if (j < C) buf[j] = av[q];
  }
  float* src = buf;
  float* dst = buf + C;
  const int shifts[4] = {1, 128, C - 1, C - 128};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      __syncthreads();  // the previous shift's row is complete
      const int s = shifts[r];
#pragma unroll
      for (int q = 0; q < kMaxPer; ++q) {
        const int j = threadIdx.x + q * kThreads;
        if (j < C) {
          int from = j - s;
          if (from < 0) from += C;
          const float v = src[from];
          dst[j] = (r & 1) ? v * kDecay : v + av[q];
        }
      }
      float* t = src;
      src = dst;
      dst = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kMaxPer; ++q) {
    const int j = threadIdx.x + q * kThreads;
    if (j < C) out[row + j] = src[j];
  }
}

extern "C" {

int roll_chain_max_cols() { return kThreads * kMaxPer; }

const char* roll_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// out = the chain applied `iters` times to the (rows, C) array a.
int roll_chain_launch(const float* a, float* out, int rows, int C, int iters,
                      void* stream) {
  if (rows < 1 || C < 128 || C > kThreads * kMaxPer || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = 2 * C * (int)sizeof(float);
  static int opted = 0;  // dynamic shared memory the kernel is opted in to
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        roll_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  roll_chain_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(a, out, C,
                                                                    iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
