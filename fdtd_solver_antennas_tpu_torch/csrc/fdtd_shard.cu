// The shard stepper for Hopper (sm_90a): K leapfrog steps of one rank's
// x-slab per launch, bound to Python with ctypes.
//
// Replaces: fdtd_solver_antennas_tpu/ops/fdtd_pallas.py::build_pallas_shard_stepper
// (the TPU shard kernel, K3). K3 is one pallas_call per K steps that keeps
// one rank's halo-extended slab (m = n + 2W rows) resident in VMEM; the
// explicit multi-device run restocks the W halo rows from the neighbours
// between calls. Here the same K steps are one cooperative launch
// (cudaLaunchCooperativeKernel) of a persistent kernel:
//
//   for each of the k steps:
//     H pass   every cell: H -= dt/mu0 * curl E (+ 6 CPML psi_h)
//     -- grid barrier --
//     E pass   every cell: E' = ca*E + cb*curl H (+ 6 CPML psi_e)
//              + src * wf[step], from the current E buffer into the other
//     -- grid barrier --
//     MUR      x walls (the slab rows of global rows 0 and Qx-1, which may
//              lie outside the slab), then y, then z, a barrier after each
//     p ^= 1   the new E buffer becomes current
//
// Each pass is a grid-stride loop over the slab, so one launch of as many
// blocks as the card keeps resident covers any slab size. The walls read
// the old E (the other buffer of the ping-pong) and the new E at the inner
// neighbour, as K1's mur_faces does. The host flips its parity k times.
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
// under MUR); in practice each step pays 2 grid barriers (5 under MUR)
// and re-reads its operands from L2. This first design does nothing about
// either: it is the simple, exact version.
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
constexpr int kMaxK = 64;  // steps per launch; the samples ride in the args

}  // namespace

// Mirrored field for field by ops/fdtd_shard.py::_ShardArgs (ctypes).
struct ShardArgs {
  float* e[2][3];          // E double buffer: e[p] current, e[1-p] next
  float* h[3];
  float* psi_e[6];         // CPML psi, order xy xz yz yx zx zy
  float* psi_h[6];
  const float* ca[3];
  const float* cb[3];
  const float* src[3];     // per-component source stamp, or null
  const float* inv_p[3];   // 1 / primary spacing, per axis (x: slab rows)
  const float* inv_d[3];   // 1 / dual spacing, per axis
  const float* bh[3];      // CPML b, c at half positions (H side)
  const float* ch[3];
  const float* be[3];      // CPML b, c at node positions (E side)
  const float* ce[3];
  int nx, ny, nz;          // slab shape (m, Py, Pz)
  int qy, qz;              // grid planes that place the y and z MUR walls
  int x_wall[2];           // slab rows of the x walls (may be outside)
  int has_pml, has_mur;
  float dtmu;              // dt / mu0
  float mur_c[3][2];       // MUR coefficient per axis and side
  float wf[kMaxK];         // source sample of each step of the launch
};

__device__ __forceinline__ void h_cell(const ShardArgs& a, const int p,
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
  if (a.has_pml) {
    const float bx = a.bh[0][i], by = a.bh[1][j], bz = a.bh[2][k];
    const float cx = a.ch[0][i], cy = a.ch[1][j], cz = a.ch[2][k];
    float* const* P = a.psi_h;
    const float pxy = by * P[0][c] + cy * dEz_y;
    const float pxz = bz * P[1][c] + cz * dEy_z;
    const float pyz = bz * P[2][c] + cz * dEx_z;
    const float pyx = bx * P[3][c] + cx * dEz_x;
    const float pzx = bx * P[4][c] + cx * dEy_x;
    const float pzy = by * P[5][c] + cy * dEx_y;
    P[0][c] = pxy; P[1][c] = pxz; P[2][c] = pyz;
    P[3][c] = pyx; P[4][c] = pzx; P[5][c] = pzy;
    a.h[0][c] = a.h[0][c] - a.dtmu * ((dEz_y + pxy) - (dEy_z + pxz));
    a.h[1][c] = a.h[1][c] - a.dtmu * ((dEx_z + pyz) - (dEz_x + pyx));
    a.h[2][c] = a.h[2][c] - a.dtmu * ((dEy_x + pzx) - (dEx_y + pzy));
  } else {
    a.h[0][c] = a.h[0][c] - a.dtmu * (dEz_y - dEy_z);
    a.h[1][c] = a.h[1][c] - a.dtmu * (dEx_z - dEz_x);
    a.h[2][c] = a.h[2][c] - a.dtmu * (dEy_x - dEx_y);
  }
}

__device__ __forceinline__ void e_cell(const ShardArgs& a, const int p,
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
  const float dHz_y = (hz - hz_ym) * idy;
  const float dHy_z = (hy - hy_zm) * idz;
  const float dHx_z = (hx - hx_zm) * idz;
  const float dHz_x = (hz - hz_xm) * idx_;
  const float dHy_x = (hy - hy_xm) * idx_;
  const float dHx_y = (hx - hx_ym) * idy;
  float cux, cuy, cuz;  // curl H, with the CPML convolution terms
  if (a.has_pml) {
    const float bx = a.be[0][i], by = a.be[1][j], bz = a.be[2][k];
    const float cx = a.ce[0][i], cy = a.ce[1][j], cz = a.ce[2][k];
    float* const* P = a.psi_e;
    const float pxy = by * P[0][c] + cy * dHz_y;
    const float pxz = bz * P[1][c] + cz * dHy_z;
    const float pyz = bz * P[2][c] + cz * dHx_z;
    const float pyx = bx * P[3][c] + cx * dHz_x;
    const float pzx = bx * P[4][c] + cx * dHy_x;
    const float pzy = by * P[5][c] + cy * dHx_y;
    P[0][c] = pxy; P[1][c] = pxz; P[2][c] = pyz;
    P[3][c] = pyx; P[4][c] = pzx; P[5][c] = pzy;
    cux = (dHz_y + pxy) - (dHy_z + pxz);
    cuy = (dHx_z + pyz) - (dHz_x + pyx);
    cuz = (dHy_x + pzx) - (dHx_y + pzy);
  } else {
    cux = dHz_y - dHy_z;
    cuy = dHx_z - dHz_x;
    cuz = dHy_x - dHx_y;
  }
  const float cu[3] = {cux, cuy, cuz};
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    float v = a.ca[m][c] * a.e[p][m][c] + a.cb[m][c] * cu[m];
    if (a.src[m] != nullptr) v = v + a.src[m][c] * s;
    a.e[1 - p][m][c] = v;
  }
}

// Wall cell t of axis b: (side, component, plane cell) over 2 sides x the
// 2 components tangential to the wall x the wall plane.
//   E'[wall] = E[nb] + c * (E'[nb] - E[wall])
// E is the old buffer e[p], E' the new one. The x walls sit at the slab
// rows x_wall[side]; a wall outside the slab is skipped and a neighbour
// outside it reads 0. The y and z walls are those of the grid.
__device__ __forceinline__ void mur_cell(const ShardArgs& a, const int p,
                                         const int b, const int64_t t) {
  const int dims[3] = {a.nx, a.ny, a.nz};
  const int ua = (b + 1) % 3, va = (b + 2) % 3;
  const int u_ax = ua < va ? ua : va;  // the other two axes, ascending
  const int v_ax = ua < va ? va : ua;
  const int64_t plane = (int64_t)dims[u_ax] * dims[v_ax];
  const int q = (int)(t / plane);
  const int64_t r = t % plane;
  const int side = q >> 1;
  const int comp = (q & 1) ? v_ax : u_ax;
  int wall, nb;
  if (b == 0) {
    wall = a.x_wall[side];
    if (wall < 0 || wall >= a.nx) return;
    nb = side ? wall - 1 : wall + 1;
  } else {
    const int qb = b == 1 ? a.qy : a.qz;
    wall = side ? qb - 1 : 0;
    nb = side ? qb - 2 : 1;
  }
  const int u = (int)(r / dims[v_ax]);
  const int v = (int)(r % dims[v_ax]);
  const int64_t strides[3] = {(int64_t)a.ny * a.nz, a.nz, 1};
  const int64_t base = u * strides[u_ax] + v * strides[v_ax];
  const int64_t cw = base + wall * strides[b];
  const int64_t cn = base + nb * strides[b];
  const bool nb_in = nb >= 0 && nb < dims[b];
  const float* Eo = a.e[p][comp];
  float* En = a.e[1 - p][comp];
  const float eo_nb = nb_in ? Eo[cn] : 0.f;
  const float en_nb = nb_in ? En[cn] : 0.f;
  En[cw] = eo_nb + a.mur_c[b][side] * (en_nb - Eo[cw]);
}

__global__ void __launch_bounds__(kThreads)
shard_steps_kernel(const ShardArgs a, int p, const int k) {
  cg::grid_group grid = cg::this_grid();
  const int64_t cells = (int64_t)a.nx * a.ny * a.nz;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t wall_cells[3] = {4 * (int64_t)a.ny * a.nz,
                                 4 * (int64_t)a.nx * a.nz,
                                 4 * (int64_t)a.nx * a.ny};
  for (int s = 0; s < k; ++s) {
    for (int64_t c = first; c < cells; c += stride) h_cell(a, p, c);
    grid.sync();
    const float sample = a.wf[s];
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

int fdtd_shard_args_size() { return (int)sizeof(ShardArgs); }

int fdtd_shard_max_k() { return kMaxK; }

int fdtd_shard_threads() { return kThreads; }

const char* fdtd_shard_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Blocks of one cooperative launch: every block must be resident at once,
// so the most the current device keeps per SM times its SMs.
int fdtd_shard_grid_blocks(int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, shard_steps_kernel, kThreads, 0);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return (int)err;
}

int fdtd_shard_steps(const ShardArgs* a, int p, int k, void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  static int resident = 0;  // blocks the device keeps resident at once
  if (resident == 0) {
    const int err = fdtd_shard_grid_blocks(&resident);
    if (err != 0) {
      resident = 0;
      return err;
    }
  }
  const int64_t cells = (int64_t)a->nx * a->ny * a->nz;
  const int64_t need = (cells + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(need < resident ? need : resident);
  ShardArgs args = *a;
  void* params[] = {(void*)&args, (void*)&p, (void*)&k};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)shard_steps_kernel, dim3(blocks), dim3(kThreads), params,
      0, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // extern "C"
