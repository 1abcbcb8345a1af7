// The interval stepper for Hopper (sm_90a): the D = probe_decim leapfrog
// steps of one probe interval of a whole grid in one launch, no probes,
// bound to Python with ctypes.
//
// Replaces: fdtd_solver_antennas_tpu/ops/fdtd_pallas.py::build_pallas_stepper
// (the TPU interval kernel, K4). K4 is one pallas_call per probe interval
// that keeps the six fields and the coefficients resident in VMEM and runs
// D steps of H, E with ca/cb and the port-source FMA, then the MUR walls
// x -> y -> z (or nothing under PEC). Here the same D steps are one
// cooperative launch (cudaLaunchCooperativeKernel) of a persistent kernel
// whose step is an H pass and an E pass with the MUR walls fused into it,
// a grid barrier after each: 2 barriers a step under MUR and PEC alike.
// The device code, the two storage forms (operands resident in shared
// memory, or streamed from memory for grids that do not fit) and the plan
// that picks one are in csrc/yee_persist.cuh, shared with K3
// (csrc/fdtd_shard.cu). The source samples of the interval are a float32
// array on the device, so D has no limit. CPML is not K4's: the wrapper
// refuses it, as the JAX package's build_pallas_stepper does.
//
// What bounds it on the card: at the canonical patch (56 x 55 x 50 =
// 154,000 cells, 0.62 MB per array) a launch must move 19 arrays once
// (E, H in and out, ca/cb, the source stamp), about 3.5 us over HBM, and
// do 89 steps x 48 float32 operations per cell, about 9.8 us at the
// float32 peak: operations bound it. The live fields (about 4 MB) sit in
// the 50 MB L2 for the whole launch, and in the resident form (there one
// cell a thread, two blocks of 640 threads an SM, 27 KB of shared memory a
// block) the coefficients never leave the SM. What it pays on top is the
// two grid barriers a step and each pass's latency to L2. The first design
// of this kernel paid 5 barriers a step under MUR on ~600 blocks and
// re-read every operand each pass: 16 us a step (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py). No fused
// multiply-add, so each cell rounds like the plain PyTorch twin.

#include "yee_persist.cuh"

namespace cg = cooperative_groups;

// Mirrored field for field by ops/fdtd_steps.py::_StepsArgs (ctypes).
struct StepsArgs {
  persist::Ops o;
};

template <int kCells, int kFlav>
__global__ void __launch_bounds__(persist::threads(kCells),
                                  persist::min_blocks(kCells))
interval_steps_kernel(const StepsArgs a, int p, const int d_steps,
                      const float* __restrict__ wf) {
  cg::grid_group grid = cg::this_grid();
  const persist::Range r = persist::block_range(a.o);
  persist::load_operands<kCells>(a.o, r);
  for (int s = 0; s < d_steps; ++s) {
    persist::h_pass<kCells, kFlav>(a.o, p, r);
    grid.sync();
    persist::e_pass<kCells, kFlav>(a.o, p, r, wf[s]);  // MUR walls fused in
    grid.sync();
    p ^= 1;
  }
}

// An empty persistent launch: n grid barriers and nothing else, the floor
// under the stepper's 2 barriers a step at the same block count.
__global__ void __launch_bounds__(persist::kThreads, 1)
grid_barriers_kernel(const int n) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < n; ++s) grid.sync();
}

namespace {

// by boundary (row: PEC, MUR, CPML) and form (column); K4 has no CPML
// kernels (the wrapper refuses CPML)
#define PERSIST_FORMS(F)                                                \
  {(const void*)interval_steps_kernel<0, F>,                            \
   (const void*)interval_steps_kernel<1, F>,                            \
   (const void*)interval_steps_kernel<2, F>,                            \
   (const void*)interval_steps_kernel<3, F>,                            \
   (const void*)interval_steps_kernel<4, F>}
const void* const kKernels[persist::kFlavours][persist::kMaxCells + 1] = {
    PERSIST_FORMS(persist::kPec), PERSIST_FORMS(persist::kMur),
    {nullptr, nullptr, nullptr, nullptr, nullptr}};
#undef PERSIST_FORMS
static_assert(persist::kMaxCells == 4, "one kernel per resident form");

}  // namespace

extern "C" {

int fdtd_steps_args_size() { return (int)sizeof(StepsArgs); }

const char* fdtd_steps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Blocks the card keeps resident at once for the streamed form (the most
// any form launches).
int fdtd_steps_grid_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kKernels[0][0], persist::threads(0), 0);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return (int)err;
}

// The launch plan of a, out = {cells a thread (0: streamed), blocks,
// shared bytes, threads a block}; request -1 either form, 0 streamed, 1
// resident.
int fdtd_steps_plan(const StepsArgs* a, int request, int* out) {
  return (int)persist::plan(a->o, kKernels[persist::flavour(a->o)], request,
                            out);
}

// d steps from e[p] by the planned form, the source sample of step s at
// wf[s] (device memory).
int fdtd_steps_interval(const StepsArgs* a, int p, int d, const float* wf,
                        int cells, int blocks, void* stream) {
  if (d < 1 || wf == nullptr) return (int)cudaErrorInvalidValue;
  StepsArgs args = *a;
  void* params[] = {(void*)&args, (void*)&p, (void*)&d, (void*)&wf};
  return (int)persist::launch(args.o, kKernels[persist::flavour(args.o)], cells,
                              blocks, params, stream);
}

// n grid barriers on `blocks` blocks of `threads` threads.
int fdtd_steps_barriers(int blocks, int threads, int n, void* stream) {
  if (blocks < 1 || threads < 1 || threads > persist::kThreads || n < 0)
    return (int)cudaErrorInvalidValue;
  void* params[] = {(void*)&n};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)grid_barriers_kernel, dim3(blocks), dim3(threads), params,
      0, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // extern "C"
