// The shard stepper for Hopper (sm_90a): K leapfrog steps of one rank's
// x-slab per launch, bound to Python with ctypes.
//
// Replaces: fdtd_solver_antennas_tpu/ops/fdtd_pallas.py::build_pallas_shard_stepper
// (the TPU shard kernel, K3). K3 is one pallas_call per K steps that keeps
// one rank's halo-extended slab (m = n + 2W rows) resident in VMEM; the
// explicit multi-device run restocks the W halo rows from the neighbours
// between calls. Here the same K steps are one cooperative launch
// (cudaLaunchCooperativeKernel) of a persistent kernel whose step is an H
// pass and an E pass with the MUR walls fused into it, a grid barrier after
// each: 2 barriers a step under MUR, PEC and CPML alike. The MUR x walls
// sit at the slab rows x_wall (global rows 0 and Qx-1), which may lie
// outside the slab: a wall outside holds no cell, and a neighbour outside
// reads 0. The device code, the two storage forms (operands resident in
// shared memory, or streamed from memory for slabs that do not fit) and
// the plan that picks one are in csrc/yee_persist.cuh, shared with K4
// (csrc/fdtd_steps.cu). The twelve CPML psi arrays are read-write state
// and stay in device memory; their 1-D b/c profiles go on chip with the
// spacings.
//
// Layout and edge semantics are K1's (csrc/fdtd_chunk.cu): contiguous
// (m, Py, Pz) float32 arrays, z fastest; a neighbour outside the slab
// reads 0 (the TPU kernel's roll wraps instead). Both only change halo
// rows, which the caller overwrites: after k <= W steps the owned rows
// [W, W+n) are exact.
//
// What bounds it on the card: at the canonical patch on one rank the slab
// is 120 x 55 x 50 (330,000 cells, 1.32 MB per array). Under MUR a launch
// needs E, H, ca/cb and the source in and E, H out, about 21 MB (37 MB
// with CPML's twelve psi), which fits the 50 MB L2 for all k steps. The
// bound is those bytes once over HBM (about 7.5 us per 32-step launch
// under MUR). The resident form holds the slab's coefficients on chip (one
// block of 1,024 threads an SM, three cells a thread, 124 KB of shared
// memory a block), so a step pays its two grid barriers and each pass's
// latency to L2 for the fields. The first design of this kernel paid 5
// barriers a step under MUR on ~600 blocks and re-read every operand each
// pass: 20 us a step (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py). No fused
// multiply-add, so each cell rounds like the plain PyTorch twin.

#include "yee_persist.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 64;  // steps per launch; the samples ride in the args

}  // namespace

// Mirrored field for field by ops/fdtd_shard.py::_ShardArgs (ctypes).
struct ShardArgs {
  persist::Ops o;     // x walls at wall_lo[0], wall_hi[0] (slab rows)
  float wf[kMaxK];    // source sample of each step of the launch
};

template <int kCells, int kFlav>
__global__ void __launch_bounds__(persist::threads(kCells),
                                  persist::min_blocks(kCells))
shard_steps_kernel(const ShardArgs a, int p, const int k) {
  cg::grid_group grid = cg::this_grid();
  const persist::Range r = persist::block_range(a.o);
  persist::load_operands<kCells>(a.o, r);
  for (int s = 0; s < k; ++s) {
    persist::h_pass<kCells, kFlav>(a.o, p, r);
    grid.sync();
    persist::e_pass<kCells, kFlav>(a.o, p, r, a.wf[s]);  // MUR walls fused in
    grid.sync();
    p ^= 1;
  }
}

namespace {

// by boundary (row: PEC, MUR, CPML) and form (column)
#define PERSIST_FORMS(F)                                                \
  {(const void*)shard_steps_kernel<0, F>,                               \
   (const void*)shard_steps_kernel<1, F>,                               \
   (const void*)shard_steps_kernel<2, F>,                               \
   (const void*)shard_steps_kernel<3, F>,                               \
   (const void*)shard_steps_kernel<4, F>}
const void* const kKernels[persist::kFlavours][persist::kMaxCells + 1] = {
    PERSIST_FORMS(persist::kPec), PERSIST_FORMS(persist::kMur),
    PERSIST_FORMS(persist::kCpml)};
#undef PERSIST_FORMS
static_assert(persist::kMaxCells == 4, "one kernel per resident form");

}  // namespace

extern "C" {

int fdtd_shard_args_size() { return (int)sizeof(ShardArgs); }

int fdtd_shard_max_k() { return kMaxK; }

const char* fdtd_shard_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Blocks the card keeps resident at once for the streamed form (the most
// any form launches).
int fdtd_shard_grid_blocks(int* blocks) {
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
int fdtd_shard_plan(const ShardArgs* a, int request, int* out) {
  return (int)persist::plan(a->o, kKernels[persist::flavour(a->o)], request,
                            out);
}

// k steps from e[p] by the planned form.
int fdtd_shard_steps(const ShardArgs* a, int p, int k, int cells, int blocks,
                     void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  ShardArgs args = *a;
  void* params[] = {(void*)&args, (void*)&p, (void*)&k};
  return (int)persist::launch(args.o, kKernels[persist::flavour(args.o)], cells,
                              blocks, params, stream);
}

}  // extern "C"
