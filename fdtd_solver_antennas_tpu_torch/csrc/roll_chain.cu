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
// kernel taking its stencil reads from shared memory pays.
//
// THE RULE this kernel keeps, so that it measures shifts: every one of the
// four shifts of every iteration moves every element of the row through
// shared memory, a store and a load, in order. A shuffle may carry one
// neighbouring value across lanes, but no shift is a renaming of which
// register holds which column, and the chain is not folded: the net shift
// of an iteration is 1 + 128 + (C - 1) + (C - 128) = 2C, nothing, so a
// kernel that only tracked the offset would compute the same output
// without moving data and would measure nothing. Each shift adds or
// multiplies once, as the plain twin does, so the output is bit-equal.
//
// Design (C a multiple of 4), one block a row:
//  (a) 128-bit shared accesses. A thread owns whole float4s of columns.
//      The shifts by 128 and C - 128 load the float4 128 columns away; the
//      shifts by 1 and C - 1 load the thread's own aligned float4 and take
//      the one missing value from the neighbouring lane by shuffle (from
//      shared memory at a warp's edge). Each element is stored once and
//      loaded once a shift.
//  (b) No wrap test. Each row buffer carries kGhost = 128 ghost columns at
//      each end; with each shift the threads that own the columns the next
//      shift reads across the wrap also store them into the ghost (4
//      columns for a shift by 1, 128 for a shift by 128): 264 more stores
//      an iteration, 0.9% at C = 7,040, and every read is in range.
// The row is double-buffered (a shift reads one buffer and writes the
// other), so one __syncthreads() a shift orders both the reads before the
// next writes and the writes before the next reads.
//
// What bounds it on the card: shared-memory bandwidth, 128 bytes per clock
// an SM: 2 x 4 B per element per shift, R x C x 4 x iters element-shifts
// (chip_smoke.py prints this bound over all the card's SMs, and beside it
// over the R SMs that hold a row each). The float32 operations (one per
// element-shift) are a far smaller bound. What it pays on top is one
// barrier a shift and the latency of its load, shuffle and store chain,
// which the block's warps do not hide across the barrier. PERF.md keeps
// the times of the parts alone and of a two-block cluster a row, which
// measured slower than this design on an H100.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPer = 4;     // float4s a thread a shift
constexpr int kGhost = 128;    // ghost columns at each end of a row buffer
constexpr int kMinCols = 128;  // columns a row holds at least
constexpr float kDecay = 0.9999f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// One shift of kind kKind (0: by 1, then + a; 1: by 128, then * decay;
// 2: by C - 1, + a; 3: by C - 128, * decay) from src into dst, the
// thread's float4 q at buffer position kGhost + 4q (C columns a row).
// Then the ghost the next shift reads across the wrap: the row's first or
// last columns into the ghost at its other end.
template <int kKind, int kPer>
__device__ __forceinline__ void shift(const float* src, float* dst,
                                      const float4 (&av)[kPer], const int C,
                                      const int lane) {
  constexpr int kNext = (kKind + 1) & 3;
  constexpr bool kNextLeft = kNext < 2;            // it reads j - 1 or j - 128
  constexpr int kNextReach = (kNext & 1) ? 128 : 4;  // columns it reads across
  const int n4 = C >> 2;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int q = threadIdx.x + p * blockDim.x;
    const bool on = q < n4;
    const int u = kGhost + 4 * q;
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kKind == 1 || kKind == 3) {
      if (on) d = ld4(src + u + (kKind == 1 ? -128 : 128));
    } else {
      const float4 x = on ? ld4(src + u) : d;
      if constexpr (kKind == 0) {  // d = (x[u - 1], x.x, x.y, x.z)
        float left = __shfl_up_sync(kFull, x.w, 1);
        if (lane == 0 && on) left = src[u - 1];
        d = make_float4(left, x.x, x.y, x.z);
      } else {  // d = (x.y, x.z, x.w, x[u + 4])
        float right = __shfl_down_sync(kFull, x.x, 1);
        if ((lane == 31 || q + 1 == n4) && on) right = src[u + 4];
        d = make_float4(x.y, x.z, x.w, right);
      }
    }
    if (!on) continue;
    if constexpr ((kKind & 1) == 0) {
      d.x = d.x + av[p].x; d.y = d.y + av[p].y;
      d.z = d.z + av[p].z; d.w = d.w + av[p].w;
    } else {
      d.x = d.x * kDecay; d.y = d.y * kDecay;
      d.z = d.z * kDecay; d.w = d.w * kDecay;
    }
    st4(dst + u, d);
    if constexpr (kNextLeft) {
      if (4 * q >= C - kNextReach) st4(dst + u - C, d);
    } else {
      if (4 * q < kNextReach) st4(dst + u + C, d);
    }
  }
}

}  // namespace

// Block r holds row r in two buffers of C + 2 * kGhost floats each.
template <int kPer>
__global__ void __launch_bounds__(kMaxThreads)
roll_chain_kernel(const float* __restrict__ a, float* __restrict__ out,
                  const int C, const int iters) {
  extern __shared__ float4 smem[];
  float* buf0 = reinterpret_cast<float*>(smem);
  float* buf1 = buf0 + C + 2 * kGhost;
  const int64_t base = (int64_t)blockIdx.x * C;
  const int n4 = C >> 2;
  const int lane = threadIdx.x & 31;
  float4 av[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int q = threadIdx.x + p * blockDim.x;
    av[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < n4) {
      av[p] = ld4(a + base + 4 * q);
      st4(buf0 + kGhost + 4 * q, av[p]);
      // the first shift (by 1) reads column -1
      if (4 * q >= C - 4) st4(buf0 + kGhost + 4 * q - C, av[p]);
    }
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    shift<0, kPer>(buf0, buf1, av, C, lane);
    __syncthreads();
    shift<1, kPer>(buf1, buf0, av, C, lane);
    __syncthreads();
    shift<2, kPer>(buf0, buf1, av, C, lane);
    __syncthreads();
    shift<3, kPer>(buf1, buf0, av, C, lane);
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int q = threadIdx.x + p * blockDim.x;
    if (q < n4) st4(out + base + 4 * q, ld4(buf0 + kGhost + 4 * q));
  }
}

namespace {

// by float4s a thread (1 .. 4)
const void* const kKernels[kMaxPer] = {
    (const void*)roll_chain_kernel<1>, (const void*)roll_chain_kernel<2>,
    (const void*)roll_chain_kernel<3>, (const void*)roll_chain_kernel<4>};
static_assert(kMaxPer == 4, "one kernel per float4s a thread");

constexpr int kMaxCols = 4 * kMaxThreads * kMaxPer;

}  // namespace

extern "C" {

// The widest row the design takes.
int roll_chain_max_cols() { return kMaxCols; }

const char* roll_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The launch of a (rows, C) array: out = {blocks, threads a block, float4s
// a thread, dynamic shared bytes a block}.
int roll_chain_plan(int rows, int C, int* out) {
  if (rows < 1 || C % 4 != 0 || C < kMinCols || C > kMaxCols)
    return (int)cudaErrorInvalidValue;
  const int n4 = C / 4;
  const int per = (n4 + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((n4 + per - 1) / per + 31) / 32 * 32;
  out[0] = rows;
  out[1] = threads;
  out[2] = per;
  out[3] = 2 * (C + 2 * kGhost) * (int)sizeof(float);
  return (int)cudaSuccess;
}

// out = the chain applied `iters` times to the (rows, C) array a. a and
// out 16-byte aligned.
int roll_chain_launch(const float* a, float* out, int rows, int C, int iters,
                      void* stream) {
  int plan[4];
  cudaError_t err = (cudaError_t)roll_chain_plan(rows, C, plan);
  if (err != cudaSuccess || iters < 0 || ((uintptr_t)a & 15) != 0 ||
      ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const void* fn = kKernels[plan[2] - 1];
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan[3]);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&a, (void*)&out, (void*)&C, (void*)&iters};
  err = cudaLaunchKernel(fn, dim3((unsigned)plan[0]), dim3((unsigned)plan[1]),
                         args, (size_t)plan[3], (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
