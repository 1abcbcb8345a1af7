// Yee-grid leapfrog kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: fdtd_solver_antennas_tpu/ops/fdtd_pallas.py::build_pallas_chunk_stepper
// (the TPU chunk kernel, K1). K1 advances n_sub probe intervals of D
// leapfrog steps in one pallas_call with every array resident in VMEM, and
// extracts the port V/I and Huygens-face samples in the kernel. Here the
// same computation is four kernels that the host launches in order, on
// PyTorch's current stream:
//
//   h_update      one thread per cell: H -= dt/mu0 * curl E (+ 6 CPML psi_h)
//   e_update      one thread per cell: E' = ca*E + cb*curl H (+ 6 CPML psi_e)
//                 + src * s(t), from the old E buffer into the new one
//   mur_faces     launched once per axis, x then y then z: first-order MUR
//                 on the two wall planes of that axis
//   probe_gather  one thread per probe row: a weighted gather over the six
//                 field arrays, written to row j of the staging buffer
//
// Layout: the plain contiguous (Px, Py, Pz) float32 arrays, z fastest, the
// layout of the port's plain PyTorch twins (ops/fdtd_cuda.py). None of
// K1's TPU layout (lane packing, rolls, one-hot selection matmuls, SMEM
// probe buffers) is carried over.
//
// Edge semantics follow the XLA path (ops/fdtd.py::_fdiff/_bdiff): a
// neighbour outside the array reads as 0. Nothing wraps.
//
// E is double-buffered: e_update reads e[p] and writes e[1-p], so the MUR
// update still sees the old E on the wall and neighbour planes; the host
// flips p after each step.
//
// What bounds it on the card: at the canonical patch (56x55x50 = 145,530
// cells) the fields, psi and coefficients are about 10 MB and sit in the
// 50 MB L2, and each kernel runs for 3-5 us. The step is then bound by
// launch latency (five launches per step under MUR) and by the host that
// issues them, not by bytes or FLOPs (on an H100 the device idles about
// two thirds of the canonical run). This first design does nothing about
// that: it is the simple, exact version. Fusing the step into fewer
// launches, capturing a chunk in a CUDA graph, and temporal blocking in
// shared memory are the next steps. On grids that spill L2 (millions of
// cells) the kernels are bound by device memory bandwidth: per cell
// h_update moves 9 float arrays and e_update 16, each 12 more with CPML
// (six psi read and written). On an H100 at 3.05M cells they reach 67%
// (h_update) and 82% (e_update) of the HBM peak.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py). No
// fused multiply-add, so each cell's arithmetic rounds like the plain
// PyTorch twin, one operation at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

}  // namespace

// Mirrored field for field by ops/fdtd_cuda.py::_YeeArgs (ctypes).
struct YeeArgs {
  float* e[2][3];          // E double buffer: e[p] current, e[1-p] next
  float* h[3];
  float* psi_e[6];         // CPML psi, order xy xz yz yx zx zy
  float* psi_h[6];
  const float* ca[3];
  const float* cb[3];
  const float* src[3];     // per-component source stamp, or null
  const float* inv_p[3];   // 1 / primary spacing, per axis
  const float* inv_d[3];   // 1 / dual spacing, per axis
  const float* bh[3];      // CPML b, c at half positions (H side)
  const float* ch[3];
  const float* be[3];      // CPML b, c at node positions (E side)
  const float* ce[3];
  const int* probe_idx;    // (rows, k) flat index into [Ex Ey Ez Hx Hy Hz]
  const float* probe_w;    // (rows, k) weights
  int nx, ny, nz;          // array shape
  int qx, qy, qz;          // grid shape that places the MUR wall planes
  int has_pml;
  int probe_rows, probe_k;
  float dtmu;              // dt / mu0
  float mur_c[3][2];       // MUR coefficient per axis and side
};

__global__ void h_update_kernel(const YeeArgs a, const int p) {
  const int64_t n = (int64_t)a.nx * a.ny * a.nz;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
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

__global__ void e_update_kernel(const YeeArgs a, const int p, const float s) {
  const int64_t n = (int64_t)a.nx * a.ny * a.nz;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
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

// One launch per wall axis b. Thread t covers (side, component, plane
// cell): 2 sides x the 2 components tangential to the wall x the wall
// plane. The plane index comes from the grid shape q (the wall), the
// plane extent from the array shape.
//   E'[wall] = E[nb] + c * (E'[nb] - E[wall])
// E is the old buffer, E' the new one, which already holds the walls of
// the axes before b (order x, y, z). For q >= 3 the planes written and
// the planes read are disjoint, so threads do not race.
__global__ void mur_faces_kernel(const YeeArgs a, const int p, const int b) {
  const int dims[3] = {a.nx, a.ny, a.nz};
  const int qs[3] = {a.qx, a.qy, a.qz};
  const int ua = (b + 1) % 3, va = (b + 2) % 3;
  const int u_ax = ua < va ? ua : va;  // the other two axes, ascending
  const int v_ax = ua < va ? va : ua;
  const int64_t plane = (int64_t)dims[u_ax] * dims[v_ax];
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 4 * plane) return;
  const int q = (int)(t / plane);
  const int64_t r = t % plane;
  const int side = q >> 1;
  const int comp = (q & 1) ? v_ax : u_ax;
  const int u = (int)(r / dims[v_ax]);
  const int v = (int)(r % dims[v_ax]);
  const int wall = side ? qs[b] - 1 : 0;
  const int nb = side ? qs[b] - 2 : 1;
  const int64_t strides[3] = {(int64_t)a.ny * a.nz, a.nz, 1};
  const int64_t base = u * strides[u_ax] + v * strides[v_ax];
  const int64_t cw = base + wall * strides[b];
  const int64_t cn = base + nb * strides[b];
  const float* Eo = a.e[p][comp];
  float* En = a.e[1 - p][comp];
  const float cm = a.mur_c[b][side];
  En[cw] = Eo[cn] + cm * (En[cn] - Eo[cw]);
}

__global__ void probe_gather_kernel(const YeeArgs a, const int p,
                                    float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.probe_rows) return;
  const int64_t n = (int64_t)a.nx * a.ny * a.nz;
  const float* f[6] = {a.e[p][0], a.e[p][1], a.e[p][2],
                       a.h[0], a.h[1], a.h[2]};
  float acc = 0.f;
  for (int m = 0; m < a.probe_k; ++m) {
    const int64_t g = a.probe_idx[(int64_t)r * a.probe_k + m];
    const int comp = (int)(g / n);
    acc = acc + f[comp][g % n] * a.probe_w[(int64_t)r * a.probe_k + m];
  }
  out[r] = acc;
}

static unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

extern "C" {

int fdtd_args_size() { return (int)sizeof(YeeArgs); }

const char* fdtd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int fdtd_h_update(const YeeArgs* a, int p, void* stream) {
  const int64_t n = (int64_t)a->nx * a->ny * a->nz;
  h_update_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*a, p);
  return (int)cudaGetLastError();
}

int fdtd_e_update(const YeeArgs* a, int p, float s, void* stream) {
  const int64_t n = (int64_t)a->nx * a->ny * a->nz;
  e_update_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*a, p, s);
  return (int)cudaGetLastError();
}

int fdtd_mur_faces(const YeeArgs* a, int p, int axis, void* stream) {
  const int64_t dims[3] = {a->nx, a->ny, a->nz};
  const int64_t plane = dims[(axis + 1) % 3] * dims[(axis + 2) % 3];
  mur_faces_kernel<<<blocks_for(4 * plane), kThreads, 0,
                     (cudaStream_t)stream>>>(*a, p, axis);
  return (int)cudaGetLastError();
}

int fdtd_probe_gather(const YeeArgs* a, int p, float* out, void* stream) {
  probe_gather_kernel<<<blocks_for(a->probe_rows), kThreads, 0,
                        (cudaStream_t)stream>>>(*a, p, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
