// The stream stepper for Hopper (sm_90a): T leapfrog steps per launch,
// bound to Python with ctypes.
//
// Replaces: fdtd_solver_antennas_tpu/ops/fdtd_pallas.py::build_pallas_stream_stepper
// (the TPU stream kernel, K2). K2 streams blocks of whole y-z planes
// through 128 MB of VMEM and advances T steps per fetch with trapezoidal
// halo recompute. On the H100 one y-z plane of the 4.2M-cell mixed scene
// is 122 KB per field, so six fields do not fit the 227 KB of shared
// memory a block may use. This kernel tiles in 3-D instead:
//
//   - each block owns a core tile (host-chosen, e.g. 8x8x16 cells) and
//     loads the tile plus a halo of T cells on each side of each axis
//     (clipped to the grid) into dynamic shared memory: E, H, under MUR a
//     second E buffer, under CPML the twelve psi arrays;
//   - it runs T H/E half-step pairs in shared memory. H reads E at +1 and
//     E reads H at -1, so the valid region shrinks by one cell per side
//     per step; each half-step computes only the cells that can still be
//     valid, and after T steps exactly the core (and H one cell below it)
//     is valid;
//   - it writes the core of every field to a second set of arrays (the
//     launch reads one set and writes the other, so no block sees another
//     block's output).
//
// ca, cb, the source stamps and the 1-D profiles are read from global
// memory (L2) at every step. None of K2's TPU layout (x*ZT row interleave,
// 128-lane rows, the z tile-seam fix, the y<->z swap, the VMEM pickers)
// is carried over; the arrays stay the plain contiguous (Px, Py, Pz)
// float32 layout of the port's plain twins (ops/fdtd_cuda.py).
//
// Semantics are those of T calls of ops/fdtd_cuda.py::leapfrog_step:
//   - a neighbour outside the grid reads 0 (never wraps or clamps); a
//     neighbour outside the loaded region also reads 0, which only ever
//     feeds cells outside the valid region;
//   - the source FMA uses sample k of the launch at inner step k, before
//     the MUR walls;
//   - MUR walls go x, then y, then z, after the E update of each step.
//     Every block applies the fix to every wall cell it computes, core or
//     halo. The y wall reads the x-fixed new E, the z wall the x- and
//     y-fixed one; every wall reads the old E at the wall and neighbour
//     planes from the second E buffer, which keeps it until the next step.
//     A wall cell needs its neighbour's new E, so no core may be a lone
//     last plane: the host shifts the tiling by one cell where it would be;
//   - CPML: psi_h updates with H over H's region, psi_e with E over E's.
//
// What bounds it on the card: a launch must read every field, coefficient
// and source once and write every field once, ((6 + 6 + n_src) in + 6 out)
// x 4 B per cell under MUR, 344 MB on the mixed scene, >= 103 us at
// 3.35 TB/s, or 26 us per step at T = 4. This first design is the simple,
// exact version: the halo reloads and the halo recompute (a 6144-cell
// region for a 1024-cell core at T = 4) and the per-step coefficient
// reads cost more than that floor. Fewer recomputed cells (larger cores
// through TMA-fed pipelines), coefficients in shared memory and fewer
// integer divisions are the next steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py). No
// fused multiply-add, so each cell's arithmetic rounds like the plain
// PyTorch twin, one operation at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxT = 8;

}  // namespace

// Mirrored field for field by ops/fdtd_stream.py::_StreamArgs (ctypes).
struct StreamArgs {
  const float* e_in[3];    // fields the launch starts from
  const float* h_in[3];
  const float* pe_in[6];   // CPML psi, order xy xz yz yx zx zy
  const float* ph_in[6];
  float* e_out[3];         // fields after T steps (another set of arrays)
  float* h_out[3];
  float* pe_out[6];
  float* ph_out[6];
  const float* ca[3];
  const float* cb[3];
  const float* src[3];     // per-component source stamp, or null
  const float* inv_p[3];   // 1 / primary spacing, per axis
  const float* inv_d[3];   // 1 / dual spacing, per axis
  const float* bh[3];      // CPML b, c at half positions (H side)
  const float* ch[3];
  const float* be[3];      // CPML b, c at node positions (E side)
  const float* ce[3];
  int n[3];                // array shape
  int q[3];                // grid shape that places the MUR wall planes
  int core[3];             // core tile extent per axis
  int origin[3];           // tile b covers [b*core - origin, (b+1)*core - origin)
  int tiles[3];            // tiles per axis
  int has_pml;
  int has_mur;
  float dtmu;              // dt / mu0
  float mur_c[3][2];       // MUR coefficient per axis and side
};

struct Samples {
  float s[kMaxT];          // source samples of the T inner steps
};

// A box of local (region) cells: [lo, hi) per axis.
struct Box {
  int lo[3], hi[3];
};

// The tile's geometry in shared memory: the region [r0, r0 + L) of the
// grid, z fastest, and where each array starts.
struct Region {
  int r0[3], L[3];
  int sx, sy, ncell;
  int e0, e1, h, pe, ph;   // float offsets into shared memory
};

__device__ __forceinline__ void cell_of(const Box& b, int idx, int& li,
                                        int& lj, int& lk) {
  const int dz = b.hi[2] - b.lo[2];
  const int dy = b.hi[1] - b.lo[1];
  lk = b.lo[2] + idx % dz;
  const int r = idx / dz;
  lj = b.lo[1] + r % dy;
  li = b.lo[0] + r / dy;
}

__device__ __forceinline__ int box_cells(const Box& b) {
  return (b.hi[0] - b.lo[0]) * (b.hi[1] - b.lo[1]) * (b.hi[2] - b.lo[2]);
}

__device__ __forceinline__ int64_t global_index(const StreamArgs& a,
                                                const Region& g, int li,
                                                int lj, int lk) {
  return ((int64_t)(g.r0[0] + li) * a.n[1] + (g.r0[1] + lj)) * a.n[2] +
         (g.r0[2] + lk);
}

// H half-step over the box, from E at `ecur`; psi_h under CPML.
__device__ void h_phase(const StreamArgs& a, const Region& g, const Box& b,
                        float* sm, int ecur) {
  const float* Ex = sm + ecur;
  const float* Ey = Ex + g.ncell;
  const float* Ez = Ey + g.ncell;
  float* Hx = sm + g.h;
  float* Hy = Hx + g.ncell;
  float* Hz = Hy + g.ncell;
  const int count = box_cells(b);
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
    int li, lj, lk;
    cell_of(b, idx, li, lj, lk);
    const int c = li * g.sx + lj * g.sy + lk;
    const int gi = g.r0[0] + li, gj = g.r0[1] + lj, gk = g.r0[2] + lk;
    const float ex = Ex[c], ey = Ey[c], ez = Ez[c];
    // forward differences; a neighbour outside the region reads 0
    const float ez_yp = lj + 1 < g.L[1] ? Ez[c + g.sy] : 0.f;
    const float ey_zp = lk + 1 < g.L[2] ? Ey[c + 1] : 0.f;
    const float ex_zp = lk + 1 < g.L[2] ? Ex[c + 1] : 0.f;
    const float ez_xp = li + 1 < g.L[0] ? Ez[c + g.sx] : 0.f;
    const float ey_xp = li + 1 < g.L[0] ? Ey[c + g.sx] : 0.f;
    const float ex_yp = lj + 1 < g.L[1] ? Ex[c + g.sy] : 0.f;
    const float ipx = a.inv_p[0][gi], ipy = a.inv_p[1][gj], ipz = a.inv_p[2][gk];
    const float dEz_y = (ez_yp - ez) * ipy;
    const float dEy_z = (ey_zp - ey) * ipz;
    const float dEx_z = (ex_zp - ex) * ipz;
    const float dEz_x = (ez_xp - ez) * ipx;
    const float dEy_x = (ey_xp - ey) * ipx;
    const float dEx_y = (ex_yp - ex) * ipy;
    if (a.has_pml) {
      const float bx = a.bh[0][gi], by = a.bh[1][gj], bz = a.bh[2][gk];
      const float cx = a.ch[0][gi], cy = a.ch[1][gj], cz = a.ch[2][gk];
      float* P = sm + g.ph + c;
      const int n = g.ncell;
      const float pxy = by * P[0] + cy * dEz_y;
      const float pxz = bz * P[n] + cz * dEy_z;
      const float pyz = bz * P[2 * n] + cz * dEx_z;
      const float pyx = bx * P[3 * n] + cx * dEz_x;
      const float pzx = bx * P[4 * n] + cx * dEy_x;
      const float pzy = by * P[5 * n] + cy * dEx_y;
      P[0] = pxy; P[n] = pxz; P[2 * n] = pyz;
      P[3 * n] = pyx; P[4 * n] = pzx; P[5 * n] = pzy;
      Hx[c] = Hx[c] - a.dtmu * ((dEz_y + pxy) - (dEy_z + pxz));
      Hy[c] = Hy[c] - a.dtmu * ((dEx_z + pyz) - (dEz_x + pyx));
      Hz[c] = Hz[c] - a.dtmu * ((dEy_x + pzx) - (dEx_y + pzy));
    } else {
      Hx[c] = Hx[c] - a.dtmu * (dEz_y - dEy_z);
      Hy[c] = Hy[c] - a.dtmu * (dEx_z - dEz_x);
      Hz[c] = Hz[c] - a.dtmu * (dEy_x - dEx_y);
    }
  }
}

// E half-step over the box, from E at `ecur` into E at `enext` (the same
// buffer without MUR: each cell reads and writes only its own E), with
// the source sample s; psi_e under CPML.
__device__ void e_phase(const StreamArgs& a, const Region& g, const Box& b,
                        float* sm, int ecur, int enext, float s) {
  const float* Hx = sm + g.h;
  const float* Hy = Hx + g.ncell;
  const float* Hz = Hy + g.ncell;
  const int count = box_cells(b);
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
    int li, lj, lk;
    cell_of(b, idx, li, lj, lk);
    const int c = li * g.sx + lj * g.sy + lk;
    const int gi = g.r0[0] + li, gj = g.r0[1] + lj, gk = g.r0[2] + lk;
    const float hx = Hx[c], hy = Hy[c], hz = Hz[c];
    // backward differences; a neighbour outside the region reads 0
    const float hz_ym = lj > 0 ? Hz[c - g.sy] : 0.f;
    const float hy_zm = lk > 0 ? Hy[c - 1] : 0.f;
    const float hx_zm = lk > 0 ? Hx[c - 1] : 0.f;
    const float hz_xm = li > 0 ? Hz[c - g.sx] : 0.f;
    const float hy_xm = li > 0 ? Hy[c - g.sx] : 0.f;
    const float hx_ym = lj > 0 ? Hx[c - g.sy] : 0.f;
    const float idx_ = a.inv_d[0][gi], idy = a.inv_d[1][gj], idz = a.inv_d[2][gk];
    const float dHz_y = (hz - hz_ym) * idy;
    const float dHy_z = (hy - hy_zm) * idz;
    const float dHx_z = (hx - hx_zm) * idz;
    const float dHz_x = (hz - hz_xm) * idx_;
    const float dHy_x = (hy - hy_xm) * idx_;
    const float dHx_y = (hx - hx_ym) * idy;
    float cu[3];  // curl H, with the CPML convolution terms
    if (a.has_pml) {
      const float bx = a.be[0][gi], by = a.be[1][gj], bz = a.be[2][gk];
      const float cx = a.ce[0][gi], cy = a.ce[1][gj], cz = a.ce[2][gk];
      float* P = sm + g.pe + c;
      const int n = g.ncell;
      const float pxy = by * P[0] + cy * dHz_y;
      const float pxz = bz * P[n] + cz * dHy_z;
      const float pyz = bz * P[2 * n] + cz * dHx_z;
      const float pyx = bx * P[3 * n] + cx * dHz_x;
      const float pzx = bx * P[4 * n] + cx * dHy_x;
      const float pzy = by * P[5 * n] + cy * dHx_y;
      P[0] = pxy; P[n] = pxz; P[2 * n] = pyz;
      P[3 * n] = pyx; P[4 * n] = pzx; P[5 * n] = pzy;
      cu[0] = (dHz_y + pxy) - (dHy_z + pxz);
      cu[1] = (dHx_z + pyz) - (dHz_x + pyx);
      cu[2] = (dHy_x + pzx) - (dHx_y + pzy);
    } else {
      cu[0] = dHz_y - dHy_z;
      cu[1] = dHx_z - dHz_x;
      cu[2] = dHy_x - dHx_y;
    }
    const int64_t gc = global_index(a, g, li, lj, lk);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float v = a.ca[m][gc] * sm[ecur + m * g.ncell + c] + a.cb[m][gc] * cu[m];
      if (a.src[m] != nullptr) v = v + a.src[m][gc] * s;
      sm[enext + m * g.ncell + c] = v;
    }
  }
}

// First-order MUR on both walls of axis W, for the wall cells in the box:
//   E'[wall] = E[nb] + c * (E'[nb] - E[wall])
// with E the old buffer and E' the new one, which already holds the walls
// of the axes before W. Written and read planes are disjoint for q >= 3.
template <int W>
__device__ void mur_phase(const StreamArgs& a, const Region& g, const Box& b,
                          float* sm, int eold, int enew) {
  constexpr int UA = W == 0 ? 1 : 0;  // the other two axes, ascending
  constexpr int VA = W == 2 ? 1 : 2;
  const int stride[3] = {g.sx, g.sy, 1};
  const int nu = b.hi[UA] - b.lo[UA];
  const int nv = b.hi[VA] - b.lo[VA];
  const int plane = nu * nv;
  for (int t = threadIdx.x; t < 4 * plane; t += blockDim.x) {
    const int qd = t / plane;
    const int r = t % plane;
    const int side = qd >> 1;
    const int comp = (qd & 1) ? VA : UA;
    const int lw = (side ? a.q[W] - 1 : 0) - g.r0[W];
    const int ln = (side ? a.q[W] - 2 : 1) - g.r0[W];
    if (lw < b.lo[W] || lw >= b.hi[W]) continue;  // wall not computed here
    const int base = (b.lo[UA] + r / nv) * stride[UA] +
                     (b.lo[VA] + r % nv) * stride[VA];
    const int cw = base + lw * stride[W];
    const int cn = base + ln * stride[W];
    const float* Eo = sm + eold + comp * g.ncell;
    float* En = sm + enew + comp * g.ncell;
    En[cw] = Eo[cn] + a.mur_c[W][side] * (En[cn] - Eo[cw]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
stream_kernel(const StreamArgs a, const int T, const Samples wf) {
  extern __shared__ float sm[];
  int bid = blockIdx.x;
  const int bt2 = bid % a.tiles[2];
  bid /= a.tiles[2];
  const int bt1 = bid % a.tiles[1];
  const int bt0 = bid / a.tiles[1];
  const int bt[3] = {bt0, bt1, bt2};
  int c0[3], c1[3];
  Region g;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    c0[d] = max(0, bt[d] * a.core[d] - a.origin[d]);
    c1[d] = min(a.n[d], (bt[d] + 1) * a.core[d] - a.origin[d]);
    g.r0[d] = max(0, c0[d] - T);
    g.L[d] = min(a.n[d], c1[d] + T) - g.r0[d];
  }
  if (c0[0] >= c1[0] || c0[1] >= c1[1] || c0[2] >= c1[2]) return;
  g.sy = g.L[2];
  g.sx = g.L[1] * g.L[2];
  g.ncell = g.L[0] * g.sx;
  // shared memory: E (3), H (3), [second E (3) under MUR], [psi (12)]
  g.e0 = 0;
  g.h = 3 * g.ncell;
  int next = 6 * g.ncell;
  g.e1 = g.e0;
  if (a.has_mur) {
    g.e1 = next;
    next += 3 * g.ncell;
  }
  g.pe = next;
  g.ph = next + 6 * g.ncell;

  const Box all = {{0, 0, 0}, {g.L[0], g.L[1], g.L[2]}};
  for (int idx = threadIdx.x; idx < g.ncell; idx += blockDim.x) {
    int li, lj, lk;
    cell_of(all, idx, li, lj, lk);
    const int64_t gc = global_index(a, g, li, lj, lk);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      sm[g.e0 + m * g.ncell + idx] = a.e_in[m][gc];
      sm[g.h + m * g.ncell + idx] = a.h_in[m][gc];
    }
    if (a.has_pml) {
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        sm[g.pe + m * g.ncell + idx] = a.pe_in[m][gc];
        sm[g.ph + m * g.ncell + idx] = a.ph_in[m][gc];
      }
    }
  }
  __syncthreads();

  int ecur = g.e0;
  for (int t = 1; t <= T; ++t) {
    // H is computed over [c0 - T + t - 1, c1 + T - t), E over
    // [c0 - T + t, c1 + T - t), both clipped to the region (local coords)
    Box hb, eb;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int hi = min(c1[d] + T - t, g.r0[d] + g.L[d]) - g.r0[d];
      hb.lo[d] = max(c0[d] - T + t - 1, g.r0[d]) - g.r0[d];
      eb.lo[d] = max(c0[d] - T + t, g.r0[d]) - g.r0[d];
      hb.hi[d] = hi;
      eb.hi[d] = hi;
    }
    h_phase(a, g, hb, sm, ecur);
    __syncthreads();
    const int enext = ecur == g.e0 ? g.e1 : g.e0;
    e_phase(a, g, eb, sm, ecur, enext, wf.s[t - 1]);
    __syncthreads();
    if (a.has_mur) {
      mur_phase<0>(a, g, eb, sm, ecur, enext);
      __syncthreads();
      mur_phase<1>(a, g, eb, sm, ecur, enext);
      __syncthreads();
      mur_phase<2>(a, g, eb, sm, ecur, enext);
      __syncthreads();
    }
    ecur = enext;
  }

  // write the core back
  Box core;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    core.lo[d] = c0[d] - g.r0[d];
    core.hi[d] = c1[d] - g.r0[d];
  }
  const int count = box_cells(core);
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
    int li, lj, lk;
    cell_of(core, idx, li, lj, lk);
    const int c = li * g.sx + lj * g.sy + lk;
    const int64_t gc = global_index(a, g, li, lj, lk);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      a.e_out[m][gc] = sm[ecur + m * g.ncell + c];
      a.h_out[m][gc] = sm[g.h + m * g.ncell + c];
    }
    if (a.has_pml) {
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        a.pe_out[m][gc] = sm[g.pe + m * g.ncell + c];
        a.ph_out[m][gc] = sm[g.ph + m * g.ncell + c];
      }
    }
  }
}

// Shared memory one block needs: the largest region (core + 2T per axis,
// clipped to the array) times the arrays it holds.
static int64_t smem_bytes(const StreamArgs* a, int T) {
  int64_t cells = 1;
  for (int d = 0; d < 3; ++d) {
    const int64_t ext = a->core[d] + 2 * (int64_t)T;
    cells *= ext < a->n[d] ? ext : a->n[d];
  }
  const int arrays = 6 + (a->has_mur ? 3 : 0) + (a->has_pml ? 12 : 0);
  return cells * arrays * (int64_t)sizeof(float);
}

extern "C" {

int fdtd_stream_args_size() { return (int)sizeof(StreamArgs); }

int fdtd_stream_max_t() { return kMaxT; }

long long fdtd_stream_smem_bytes(const StreamArgs* a, int T) {
  return (long long)smem_bytes(a, T);
}

const char* fdtd_stream_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int fdtd_stream_steps(const StreamArgs* a, const float* wf, int T,
                      void* stream) {
  if (T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  Samples s = {};
  for (int k = 0; k < T; ++k) s.s[k] = wf[k];
  const int64_t bytes = smem_bytes(a, T);
  cudaError_t err = cudaFuncSetAttribute(
      stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)a->tiles[0] * a->tiles[1] * a->tiles[2];
  stream_kernel<<<blocks, kThreads, (size_t)bytes, (cudaStream_t)stream>>>(
      *a, T, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
