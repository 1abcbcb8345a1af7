// The interval stepper for Hopper (sm_90a): the D = probe_decim leapfrog
// steps of one probe interval of a whole grid in one launch, no probes,
// bound to Python with ctypes.
//
// Replaces: fdtd_solver_antennas_tpu/ops/fdtd_pallas.py::build_pallas_stepper
// (the TPU interval kernel, K4). K4 is one pallas_call per probe interval
// that keeps the six fields and the coefficients resident in VMEM and runs
// D steps of H, E with ca/cb and the port-source FMA, then the MUR walls
// x -> y -> z (or nothing under PEC). Here the same D steps are one
// cooperative launch (cudaLaunchCooperativeKernel) of a persistent kernel:
//
//   for each of the D steps:
//     H pass   every cell: H -= dt/mu0 * curl E
//     -- grid barrier --
//     E pass   every cell: E' = ca*E + cb*curl H + src * wf[step], from the
//              current E buffer into the other
//     -- grid barrier --
//     MUR      the walls of x, then y, then z, a barrier after each: each
//              wall reads the old E and the new E of the walls fixed
//              before it
//     p ^= 1   the new E buffer becomes current
//
// Each pass is a grid-stride loop over the grid, so one launch of as many
// blocks as the card keeps resident covers any grid. The host flips its
// parity D times. CPML is not K4's: the wrapper refuses it, as the JAX
// builder does.
//
// Layout and edge semantics are K1's (csrc/fdtd_chunk.cu): contiguous
// (Px, Py, Pz) float32 arrays, z fastest; a neighbour outside the grid
// reads 0 (the TPU kernel's roll wraps onto cells whose coefficients are
// zero, which gives the same values). The source samples of the interval
// are a float32 array on the device, so D has no limit.
//
// What bounds it on the card: at the canonical patch (56 x 55 x 50 =
// 154,000 cells, 0.62 MB per array) a launch must move 19 arrays once
// (E, H in and out, ca/cb, the source stamp), about 3.5 us over HBM, and
// do 89 steps x 48 float32 operations per cell, about 9.8 us at the
// float32 peak: operations bound it. The live operands (about 10 MB) sit
// in the 50 MB L2 for the whole launch. What this first design pays on
// top is 5 grid barriers per step under MUR (2 under PEC) and two passes
// per step that read their operands from L2 again; it does nothing about
// either, and on an H100 the barriers set its time (16 us per step under
// MUR, 7.7 under PEC; PERF.md). A grid larger than the L2 is still
// right, only slower.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py). No fused
// multiply-add, so each cell rounds like the plain PyTorch twin.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

}  // namespace

// Mirrored field for field by ops/fdtd_steps.py::_StepsArgs (ctypes).
struct StepsArgs {
  float* e[2][3];          // E double buffer: e[p] current, e[1-p] next
  float* h[3];
  const float* ca[3];
  const float* cb[3];
  const float* src[3];     // per-component source stamp, or null
  const float* inv_p[3];   // 1 / primary spacing, per axis
  const float* inv_d[3];   // 1 / dual spacing, per axis
  int nx, ny, nz;          // padded shape (Px, Py, Pz)
  int qx, qy, qz;          // grid planes that place the MUR walls
  int has_mur;
  float dtmu;              // dt / mu0
  float mur_c[3][2];       // MUR coefficient per axis and side
};

__device__ __forceinline__ void h_cell(const StepsArgs& a, const int p,
                                       const int64_t c) {
  const int64_t sy = a.nz;
  const int64_t sx = (int64_t)a.ny * a.nz;
  const int k = (int)(c % a.nz);
  const int j = (int)((c / sy) % a.ny);
  const int i = (int)(c / sx);
  const float* Ex = a.e[p][0];
  const float* Ey = a.e[p][1];
  const float* Ez = a.e[p][2];
  const float ex = Ex[c], ey = Ey[c], ez = Ez[c];
  // forward differences; the missing neighbour past the last index is 0
  const float ez_yp = j + 1 < a.ny ? Ez[c + sy] : 0.f;
  const float ey_zp = k + 1 < a.nz ? Ey[c + 1] : 0.f;
  const float ex_zp = k + 1 < a.nz ? Ex[c + 1] : 0.f;
  const float ez_xp = i + 1 < a.nx ? Ez[c + sx] : 0.f;
  const float ey_xp = i + 1 < a.nx ? Ey[c + sx] : 0.f;
  const float ex_yp = j + 1 < a.ny ? Ex[c + sy] : 0.f;
  const float ipx = a.inv_p[0][i], ipy = a.inv_p[1][j], ipz = a.inv_p[2][k];
  const float dEz_y = (ez_yp - ez) * ipy;
  const float dEy_z = (ey_zp - ey) * ipz;
  const float dEx_z = (ex_zp - ex) * ipz;
  const float dEz_x = (ez_xp - ez) * ipx;
  const float dEy_x = (ey_xp - ey) * ipx;
  const float dEx_y = (ex_yp - ex) * ipy;
  a.h[0][c] = a.h[0][c] - a.dtmu * (dEz_y - dEy_z);
  a.h[1][c] = a.h[1][c] - a.dtmu * (dEx_z - dEz_x);
  a.h[2][c] = a.h[2][c] - a.dtmu * (dEy_x - dEx_y);
}

__device__ __forceinline__ void e_cell(const StepsArgs& a, const int p,
                                       const int64_t c, const float s) {
  const int64_t sy = a.nz;
  const int64_t sx = (int64_t)a.ny * a.nz;
  const int k = (int)(c % a.nz);
  const int j = (int)((c / sy) % a.ny);
  const int i = (int)(c / sx);
  const float* Hx = a.h[0];
  const float* Hy = a.h[1];
  const float* Hz = a.h[2];
  const float hx = Hx[c], hy = Hy[c], hz = Hz[c];
  // backward differences; the missing neighbour before index 0 is 0
  const float hz_ym = j > 0 ? Hz[c - sy] : 0.f;
  const float hy_zm = k > 0 ? Hy[c - 1] : 0.f;
  const float hx_zm = k > 0 ? Hx[c - 1] : 0.f;
  const float hz_xm = i > 0 ? Hz[c - sx] : 0.f;
  const float hy_xm = i > 0 ? Hy[c - sx] : 0.f;
  const float hx_ym = j > 0 ? Hx[c - sy] : 0.f;
  const float idx_ = a.inv_d[0][i], idy = a.inv_d[1][j], idz = a.inv_d[2][k];
  const float cu[3] = {
      (hz - hz_ym) * idy - (hy - hy_zm) * idz,
      (hx - hx_zm) * idz - (hz - hz_xm) * idx_,
      (hy - hy_xm) * idx_ - (hx - hx_ym) * idy,
  };
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    float v = a.ca[m][c] * a.e[p][m][c] + a.cb[m][c] * cu[m];
    if (a.src[m] != nullptr) v = v + a.src[m][c] * s;
    a.e[1 - p][m][c] = v;
  }
}

// Wall cell t of axis b: (side, component, plane cell) over 2 sides x the
// 2 components tangential to the wall x the padded wall plane.
//   E'[wall] = E[nb] + c * (E'[nb] - E[wall])
// E is the old buffer e[p], E' the new one; the walls sit at the grid
// planes 0 and q-1 of the axis, their inner neighbours at 1 and q-2
// (q >= 3, checked by the wrapper).
__device__ __forceinline__ void mur_cell(const StepsArgs& a, const int p,
                                         const int b, const int64_t t) {
  const int dims[3] = {a.nx, a.ny, a.nz};
  const int qs[3] = {a.qx, a.qy, a.qz};
  const int ua = (b + 1) % 3, va = (b + 2) % 3;
  const int u_ax = ua < va ? ua : va;  // the other two axes, ascending
  const int v_ax = ua < va ? va : ua;
  const int64_t plane = (int64_t)dims[u_ax] * dims[v_ax];
  const int q = (int)(t / plane);
  const int64_t r = t % plane;
  const int side = q >> 1;
  const int comp = (q & 1) ? v_ax : u_ax;
  const int wall = side ? qs[b] - 1 : 0;
  const int nb = side ? qs[b] - 2 : 1;
  const int u = (int)(r / dims[v_ax]);
  const int v = (int)(r % dims[v_ax]);
  const int64_t strides[3] = {(int64_t)a.ny * a.nz, a.nz, 1};
  const int64_t base = u * strides[u_ax] + v * strides[v_ax];
  const int64_t cw = base + wall * strides[b];
  const int64_t cn = base + nb * strides[b];
  const float* Eo = a.e[p][comp];
  float* En = a.e[1 - p][comp];
  En[cw] = Eo[cn] + a.mur_c[b][side] * (En[cn] - Eo[cw]);
}

__global__ void __launch_bounds__(kThreads)
interval_steps_kernel(const StepsArgs a, int p, const int d_steps,
                      const float* __restrict__ wf) {
  cg::grid_group grid = cg::this_grid();
  const int64_t cells = (int64_t)a.nx * a.ny * a.nz;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t wall_cells[3] = {4 * (int64_t)a.ny * a.nz,
                                 4 * (int64_t)a.nx * a.nz,
                                 4 * (int64_t)a.nx * a.ny};
  for (int s = 0; s < d_steps; ++s) {
    for (int64_t c = first; c < cells; c += stride) h_cell(a, p, c);
    grid.sync();
    const float sample = wf[s];
    for (int64_t c = first; c < cells; c += stride) e_cell(a, p, c, sample);
    grid.sync();
    if (a.has_mur) {
      for (int b = 0; b < 3; ++b) {
        for (int64_t t = first; t < wall_cells[b]; t += stride)
          mur_cell(a, p, b, t);
        grid.sync();
      }
    }
    p ^= 1;
  }
}

extern "C" {

int fdtd_steps_args_size() { return (int)sizeof(StepsArgs); }

int fdtd_steps_threads() { return kThreads; }

const char* fdtd_steps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Blocks of one cooperative launch: every block must be resident at once,
// so the most the current device keeps per SM times its SMs.
int fdtd_steps_grid_blocks(int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, interval_steps_kernel, kThreads, 0);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return (int)err;
}

// d steps from e[p], the source sample of step s at wf[s] (device memory).
int fdtd_steps_interval(const StepsArgs* a, int p, int d, const float* wf,
                        void* stream) {
  if (d < 1 || wf == nullptr) return (int)cudaErrorInvalidValue;
  static int resident = 0;  // blocks the device keeps resident at once
  if (resident == 0) {
    const int err = fdtd_steps_grid_blocks(&resident);
    if (err != 0) {
      resident = 0;
      return err;
    }
  }
  const int64_t cells = (int64_t)a->nx * a->ny * a->nz;
  const int64_t need = (cells + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(need < resident ? need : resident);
  StepsArgs args = *a;
  void* params[] = {(void*)&args, (void*)&p, (void*)&d, (void*)&wf};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)interval_steps_kernel, dim3(blocks), dim3(kThreads), params,
      0, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // extern "C"
