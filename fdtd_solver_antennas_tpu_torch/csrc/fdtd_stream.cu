// The stream stepper for Hopper (sm_90a): T leapfrog steps per launch,
// bound to Python with ctypes. Two kernels share one argument struct:
//
//   - march_kernel (MUR and PEC walls; fdtd_stream_march): a y-z tile
//     marching along x with T time levels of a few planes in shared
//     memory (2.5-D temporal blocking), described below at its code;
//   - stream_kernel (CPML; fdtd_stream_steps): a 3-D tile with a halo of
//     T cells on every side, E, H and the twelve psi in shared memory.
//
// Both run a whole grid (ops/fdtd_stream.py::stream_steps) or one rank's
// halo-extended x-slab of the explicit run (stream_shard_steps): the
// slab is an array like a grid, its out-of-domain rows zero-coupled, the
// march given the slab's own x walls (x_lo, x_hi, below). Both also run B
// design variants of one grid in one launch (stream_steps_batch; the
// kBatch instances below), as K2's coef_ops_from form runs under
// jax.vmap in a geometry sweep: the fields, psi, ca and cb of each variant
// are (B, n0, n1, n2) arrays, variant b's at b * vstride; the source
// stamps, the profiles, the MUR coefficients and the samples are shared.
// A block's variant is blockIdx.y, so the x cut of the march counts the
// blocks of the whole batch (ops/fdtd_stream.py::march_plan). A device int
// array active[B] says which variants step: a frozen variant's blocks
// return before any load, and its fields stay in the set they are in. The
// single-variant kernels are the same bodies with kBatch false: variant
// offset 0, no mask.
//
// Replaces: fdtd_solver_antennas_tpu/ops/fdtd_pallas.py::build_pallas_stream_stepper
// (the TPU stream kernel, K2): its single-chip form, its shard= form and
// its coef_ops_from form (ca/cb as operands, vmapped over variants).
// K2 streams blocks of whole y-z planes through 128 MB of VMEM and
// advances T steps per fetch with trapezoidal halo recompute. On the H100 one y-z plane of the 4.2M-cell mixed scene
// is 122 KB per field, so six fields do not fit the 227 KB of shared
// memory a block may use: the march streams planes of a y-z tile
// instead, the tile kernel tiles in 3-D:
//
//   - each block owns a core tile (host-chosen, 4x8x8 cells under CPML)
//     and loads the tile plus a halo of T cells on each side of each axis
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
// Semantics of both kernels are those of T calls of
// ops/fdtd_cuda.py::leapfrog_step:
//   - a neighbour outside the grid reads 0 (never wraps or clamps); a
//     neighbour outside the loaded region also reads 0, which only ever
//     feeds cells outside the valid region;
//   - the source FMA uses sample k of the launch at inner step k, before
//     the MUR walls;
//   - MUR walls go x, then y, then z, after the E update of each step.
//     Every block applies the fix to every wall cell it computes, core or
//     halo. The y wall reads the x-fixed new E, the z wall the x- and
//     y-fixed one; every wall reads the old E at the wall and neighbour
//     planes (the tile kernel keeps a second E buffer until the next
//     step). A wall cell needs its neighbour's new E, so no core may be a
//     lone last plane: the host shifts the tiling by one cell where it
//     would be;
//   - CPML: psi_h updates with H over H's region, psi_e with E over E's.
//
// What bounds it on the card: a launch must read every field, coefficient
// and source once and write every field once, ((6 + 6 + n_src) in + 6 out)
// x 4 B per cell under MUR, 344 MB on the mixed scene, >= 103 us at
// 3.35 TB/s, or 26 us per step at T = 4. The tile kernel's halo reloads
// and halo recompute (a 6144-cell region for a 1024-cell core at T = 4)
// cost more than that floor; the march reads each value about once per
// launch times its y-z halo ratio and recomputes no x halo. A batched
// launch moves each variant's fields, ca and cb and the shared stamps once:
// at the 8-variant sweep (100 x 109 x 50 cells a variant) about 316 MB,
// >= 94 us.
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
  // the march's plan (ops/fdtd_stream.py::march_plan), MUR/PEC only
  int m_core[2];           // y-z core tile
  int m_origin[2];         // tile b covers [b*core - origin, (b+1)*core - origin)
  int m_tiles[2];
  int m_seg;               // x segment length, origin and count, as a tile
  int m_seg_origin;
  int m_segs;
  // the march's x walls (MUR): 1 where plane 0 is the lower wall, and the
  // plane of the upper wall or -1 (ops/fdtd_stream.py::march_view)
  int x_lo;
  int x_hi;
  // a batch of variants (the kBatch kernels only): active[b] != 0 steps
  // variant b, whose fields, psi, ca and cb start at b * vstride floats
  const int* active;
  long long vstride;
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
  int64_t vo;              // the variant's offset into fields, psi, ca, cb
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
      float v = a.ca[m][gc + g.vo] * sm[ecur + m * g.ncell + c] +
                a.cb[m][gc + g.vo] * cu[m];
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

template <bool kBatch>
__global__ void __launch_bounds__(kThreads, 1)
stream_kernel(const StreamArgs a, const int T, const Samples wf) {
  if (kBatch && __ldg(a.active + blockIdx.y) == 0) return;  // frozen variant
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
  g.vo = kBatch ? (int64_t)blockIdx.y * a.vstride : 0;
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
    const int64_t gc = global_index(a, g, li, lj, lk) + g.vo;
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
    const int64_t gc = global_index(a, g, li, lj, lk) + g.vo;
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

// ---------------------------------------------------------------------------
// The march (MUR and PEC walls): a y-z tile marching along x
// ---------------------------------------------------------------------------
//
// Each block owns a y-z core tile (m_core: 16x16 under MUR, 14x14 under
// PEC) of one x
// segment (m_seg planes) and holds a region of the core plus T cells on
// each side in y and z, clipped to the array. One thread owns one region
// cell (j, k) of every plane. The block marches along x: iteration p
// loads plane p (E and H, level 0) and then advances every level t =
// 1..T by one plane, level t working on plane p - t, one plane behind
// level t - 1 (2.5-D temporal blocking):
//
//   - H at level t, plane x, reads level t-1's E at x and x+1; E at level
//     t, plane x, reads level t's H at x-1 and x and its own old E. Both
//     update in place: each plane's slot of the ring holds the highest
//     level reached, and T + 2 planes are alive at once (the loaded one
//     down to the plane below level T's);
//   - level t covers planes [x0 - T + t - 1, x1 + T - t) and the y-z box
//     [c0 - T + t - 1, c1 + T - t) (clipped), the cone the core needs, as
//     in stream_kernel; after level T the core of plane x is written to
//     the other field set;
//   - the MUR walls, per level: the y and z fixes of plane x follow its E
//     (they read the old E of plane x, which the E phase saves in `O`).
//     The lower x wall (plane 0 where x_lo is set) needs plane 1's new E,
//     so plane 0's E phase waits for plane 1's step, which then updates
//     plane 0 from its own H and old E (still in the ring), fixes it (x)
//     from plane 1's new and old E and fixes its y and z walls beside
//     plane 1's. The upper x wall, plane u = x_hi (-1: none), needs plane
//     u-1's new E before its y and z fixes: plane u-1's step computes the
//     x-fixed y and z components of plane u into `W`, from the old E of
//     plane u (still level t-1 in the ring), and plane u's step takes them
//     from there. A whole grid has x_lo = 1, x_hi = q0 - 1;
//   - a rank's x-slab (the explicit run; K2's shard= form) has its walls
//     anywhere, or none: the lower one at slab row W on rank 0, the upper
//     one at global row Qx-1 on the last rank, possibly its first owned
//     row, or in a neighbour's halo. The host passes the upper wall's
//     plane, which may sit anywhere but on a segment's first plane (the
//     cut shifts), and launches rank 0 on the view of its rows from the
//     lower wall up, so that the wall is plane 0 again. That keeps the
//     deferral above as it is: a lower wall anywhere else would need its
//     plane and the one above in the same block at every level, a cut
//     that depends on T. The rows below the wall are out of the domain
//     (zero ca, cb and spacings) and nothing an owned row depends on reads
//     them: the wall plane's x-neighbour terms feed only its Ey and Ez,
//     which the wall's fix overwrites. The slab's own edge rows are never
//     walls; a neighbour past them reads 0, as past a grid's;
//   - ca, cb and the source stamps are read from device memory at every
//     level, issued before the H phase; a plane's values stay in L2
//     between its T levels. The per-axis spacings of y and z sit in
//     registers.
//
// Every value of E and H is read from device memory once per launch,
// times the y-z halo ratio (24x24 region for a 16x16 core at T = 4:
// 2.25) and the segment's trapezoid ((m_seg + 2T) / m_seg). No block
// sees another block's output. Shared memory: E and H rings 6 (T+2)
// floats per region cell, under MUR 6 more for `O` and 2 for `W`:
// 101,376 B at T = 4 (MUR), so two blocks fit one SM.

// One thread per region cell, at most a 24x24 region (T = 4 under MUR with
// a 16x16 core, T = 5 under PEC with 14x14), and two blocks an SM: 56
// registers a thread at most.
constexpr int kMarchThreads = 576;

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Region cells of one plane at T (the largest block's), and floats per cell.
__host__ __device__ inline int march_cells(const StreamArgs& a, int T) {
  return imin(a.n[1], a.m_core[0] + 2 * T) * imin(a.n[2], a.m_core[1] + 2 * T);
}

__host__ __device__ inline int march_floats(const StreamArgs& a, int T) {
  return 6 * (T + 2) + (a.has_mur ? 8 : 0);
}

// Curl of H at region cell c of plane x (backward differences; a
// neighbour outside the region or the grid reads 0). H holds plane x,
// Hm plane x-1 (null at x = 0); components at stride P.
__device__ __forceinline__ void march_curl_h(const float* H, const float* Hm,
                                             int P, int c, int Lz, bool ym,
                                             bool zm, float idx_, float idy,
                                             float idz, float cu[3]) {
  const float hx = H[c], hy = H[P + c], hz = H[2 * P + c];
  const float hz_ym = ym ? H[2 * P + c - Lz] : 0.f;
  const float hy_zm = zm ? H[P + c - 1] : 0.f;
  const float hx_zm = zm ? H[c - 1] : 0.f;
  const float hz_xm = Hm ? Hm[2 * P + c] : 0.f;
  const float hy_xm = Hm ? Hm[P + c] : 0.f;
  const float hx_ym = ym ? H[c - Lz] : 0.f;
  const float dHz_y = (hz - hz_ym) * idy;
  const float dHy_z = (hy - hy_zm) * idz;
  const float dHx_z = (hx - hx_zm) * idz;
  const float dHz_x = (hz - hz_xm) * idx_;
  const float dHy_x = (hy - hy_xm) * idx_;
  const float dHx_y = (hx - hx_ym) * idy;
  cu[0] = dHz_y - dHy_z;
  cu[1] = dHx_z - dHz_x;
  cu[2] = dHy_x - dHx_y;
}

// ca, cb and the source stamps of one cell (device memory index g, the
// variant's ca and cb at g + vo); the stamp is 0 where a component has none
// (and then not added).
struct Coef {
  float ca[3], cb[3], src[3];
};

__device__ __forceinline__ Coef march_coef(const StreamArgs& a, int64_t g,
                                           int64_t vo) {
  Coef k;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    k.ca[m] = __ldg(a.ca[m] + g + vo);
    k.cb[m] = __ldg(a.cb[m] + g + vo);
    k.src[m] = a.src[m] != nullptr ? __ldg(a.src[m] + g) : 0.f;
  }
  return k;
}

// E at region cell c of one plane: E' = ca E + cb curl (+ src s), the old
// E saved to O (under MUR). Returns the new values; the caller stores.
__device__ __forceinline__ void march_e_cell(const StreamArgs& a,
                                             const float* E, float* O, int P,
                                             int c, const Coef& k,
                                             const float cu[3], float s,
                                             float out[3]) {
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float old = E[m * P + c];
    if (O) O[m * P + c] = old;
    float v = k.ca[m] * old + k.cb[m] * cu[m];
    if (a.src[m] != nullptr) v = v + k.src[m] * s;
    out[m] = v;
  }
}

// MUR on one wall cell of a y-z plane: E'[w] = Eo[nb] + c (E'[nb] - Eo[w])
// for the two components m0, m1 (the axes other than the wall's).
__device__ __forceinline__ void march_fix(float* E, const float* O, int P,
                                          int c, int cn, float coef, int m0,
                                          int m1) {
  E[m0 * P + c] = O[m0 * P + cn] + coef * (E[m0 * P + cn] - O[m0 * P + c]);
  E[m1 * P + c] = O[m1 * P + cn] + coef * (E[m1 * P + cn] - O[m1 * P + c]);
}

template <bool kBatch>
__global__ void __launch_bounds__(kMarchThreads, 2)
march_kernel(const StreamArgs a, const int T, const Samples wf) {
  if (kBatch && __ldg(a.active + blockIdx.y) == 0) return;  // frozen variant
  extern __shared__ float sm[];
  int bid = blockIdx.x;
  const int tz = bid % a.m_tiles[1];
  bid /= a.m_tiles[1];
  const int ty = bid % a.m_tiles[0];
  const int seg = bid / a.m_tiles[0];
  const int n0 = a.n[0], n1 = a.n[1], n2 = a.n[2];
  const int q1 = a.q[1], q2 = a.q[2];
  const int cy0 = max(0, ty * a.m_core[0] - a.m_origin[0]);
  const int cy1 = min(n1, (ty + 1) * a.m_core[0] - a.m_origin[0]);
  const int cz0 = max(0, tz * a.m_core[1] - a.m_origin[1]);
  const int cz1 = min(n2, (tz + 1) * a.m_core[1] - a.m_origin[1]);
  const int x0 = max(0, seg * a.m_seg - a.m_seg_origin);
  const int x1 = min(n0, (seg + 1) * a.m_seg - a.m_seg_origin);
  if (cy0 >= cy1 || cz0 >= cz1 || x0 >= x1) return;
  const int ry = max(0, cy0 - T), rz = max(0, cz0 - T);
  const int Ly = min(n1, cy1 + T) - ry, Lz = min(n2, cz1 + T) - rz;
  const int P = Ly * Lz;
  const int R = T + 2;
  const bool mur = a.has_mur != 0;
  // shared memory: E ring [R][3][P], H ring [R][3][P]; under MUR the old
  // E of the planes a step fixes, O [2][3][P] (by plane parity), and the
  // upper x wall's x-fixed Ey, Ez, W [2][P]
  float* Er = sm;
  float* Hr = Er + 3 * R * P;
  float* O = Hr + 3 * R * P;
  float* W = O + 6 * P;
  const int total = P * (6 * R + (mur ? 8 : 0));
  for (int i = threadIdx.x; i < total; i += blockDim.x) sm[i] = 0.f;

  const int c = threadIdx.x;  // this thread's region cell
  const bool live = c < P;
  const int j = live ? c / Lz : 0;
  const int k = live ? c - j * Lz : 0;
  const int gy = ry + j, gz = rz + k;
  const int64_t plane = (int64_t)n1 * n2;
  const int64_t cell = (int64_t)gy * n2 + gz;
  // the variant's offset, and this cell's index into its own arrays
  const int64_t vo = kBatch ? (int64_t)blockIdx.y * a.vstride : 0;
  const int64_t vcell = cell + vo;
  const bool yp = j + 1 < Ly, zp = k + 1 < Lz, ym = j > 0, zm = k > 0;
  const float ipy = live ? __ldg(a.inv_p[1] + gy) : 0.f;
  const float ipz = live ? __ldg(a.inv_p[2] + gz) : 0.f;
  const float idy = live ? __ldg(a.inv_d[1] + gy) : 0.f;
  const float idz = live ? __ldg(a.inv_d[2] + gz) : 0.f;
  const bool core = live && gy >= cy0 && gy < cy1 && gz >= cz0 && gz < cz1;
  // MUR walls of y and z at this cell: side (0 low, 1 high) or -1, and the
  // neighbour's region cell (the fix is skipped where it lies outside)
  int yside = -1, zside = -1, yn = 0, zn = 0;
  if (mur && live) {
    if (gy == 0 && yp) { yside = 0; yn = c + Lz; }
    if (gy == q1 - 1 && ym) { yside = 1; yn = c - Lz; }
    if (gz == 0 && zp) { zside = 0; zn = c + 1; }
    if (gz == q2 - 1 && zm) { zside = 1; zn = c - 1; }
  }
  const bool has_yw = mur && (ry == 0 || (ry <= q1 - 1 && q1 - 1 < ry + Ly));
  const bool has_zw = mur && (rz == 0 || (rz <= q2 - 1 && q2 - 1 < rz + Lz));

  const int xs = max(0, x0 - T);   // planes loaded: [xs, xl)
  const int xl = min(n0, x1 + T);
  float pre[6];                    // the next plane, in flight
  if (live) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      pre[m] = __ldg(a.e_in[m] + xs * plane + vcell);
      pre[3 + m] = __ldg(a.h_in[m] + xs * plane + vcell);
    }
  }
  __syncthreads();  // the zeroed shared memory

  for (int p = xs; p <= x1 - 1 + T; ++p) {
    if (p < xl) {
      const int s = p % R;
      if (live) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          Er[(s * 3 + m) * P + c] = pre[m];
          Hr[(s * 3 + m) * P + c] = pre[3 + m];
        }
        if (p + 1 < xl) {
          const int64_t g = (p + 1) * plane + vcell;
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            pre[m] = __ldg(a.e_in[m] + g);
            pre[3 + m] = __ldg(a.h_in[m] + g);
          }
        }
      }
    }
    __syncthreads();

    for (int t = 1; t <= T; ++t) {
      const int x = p - t;
      const int lo = max(0, x0 - T + t - 1);
      if (x < lo || x >= min(n0, x1 + T - t)) continue;
      const float s = wf.s[t - 1];
      float* E = Er + (x % R) * 3 * P;
      float* H = Hr + (x % R) * 3 * P;
      const float* Hm = x > 0 ? Hr + ((x - 1) % R) * 3 * P : nullptr;
      const bool act =
          live && gy >= max(cy0 - T + t - 1, ry) && gy < min(cy1 + T - t, ry + Ly) &&
          gz >= max(cz0 - T + t - 1, rz) && gz < min(cz1 + T - t, rz + Lz);
      // the lower x wall's plane waits for plane 1 (see above)
      const bool defer0 = mur && a.x_lo && x == 0;
      const bool with0 = mur && a.x_lo && x == 1 && lo == 0;
      // this plane's coefficients, in flight during the H phase
      Coef coef;
      if (act && !defer0) coef = march_coef(a, x * plane + cell, vo);

      // H at level t from level t-1's E at x and x+1
      if (act) {
        const float* Ep = x + 1 < n0 ? Er + ((x + 1) % R) * 3 * P : nullptr;
        const float ex = E[c], ey = E[P + c], ez = E[2 * P + c];
        const float ez_yp = yp ? E[2 * P + c + Lz] : 0.f;
        const float ey_zp = zp ? E[P + c + 1] : 0.f;
        const float ex_zp = zp ? E[c + 1] : 0.f;
        const float ez_xp = Ep ? Ep[2 * P + c] : 0.f;
        const float ey_xp = Ep ? Ep[P + c] : 0.f;
        const float ex_yp = yp ? E[c + Lz] : 0.f;
        const float ipx = __ldg(a.inv_p[0] + x);
        const float dEz_y = (ez_yp - ez) * ipy;
        const float dEy_z = (ey_zp - ey) * ipz;
        const float dEx_z = (ex_zp - ex) * ipz;
        const float dEz_x = (ez_xp - ez) * ipx;
        const float dEy_x = (ey_xp - ey) * ipx;
        const float dEx_y = (ex_yp - ex) * ipy;
        H[c] = H[c] - a.dtmu * (dEz_y - dEy_z);
        H[P + c] = H[P + c] - a.dtmu * (dEx_z - dEz_x);
        H[2 * P + c] = H[2 * P + c] - a.dtmu * (dEy_x - dEx_y);
      }
      __syncthreads();

      // E at level t (and plane 0's, held back from the step before)
      if (act && !defer0) {
        float* Ox = mur ? O + (x & 1) * 3 * P : nullptr;
        float cu[3], v[3];
        march_curl_h(H, Hm, P, c, Lz, ym, zm, __ldg(a.inv_d[0] + x), idy, idz,
                     cu);
        march_e_cell(a, E, Ox, P, c, coef, cu, s, v);
        E[c] = v[0];
        if (mur && x == a.x_hi) {  // x-fixed by plane x_hi-1's step
          E[P + c] = W[c];
          E[2 * P + c] = W[P + c];
        } else {
          E[P + c] = v[1];
          E[2 * P + c] = v[2];
        }
        if (mur && x == a.x_hi - 1) {  // the upper x wall from this new E
          const float* Ew = Er + ((x + 1) % R) * 3 * P;  // still level t-1
          const float cx = a.mur_c[0][1];
          W[c] = Ox[P + c] + cx * (v[1] - Ew[P + c]);
          W[P + c] = Ox[2 * P + c] + cx * (v[2] - Ew[2 * P + c]);
        }
        if (with0) {  // plane 0: E from its own H and old E, then x-fixed
          float* E0 = Er;
          float* O0 = O;
          float cu0[3], v0[3];
          march_curl_h(Hr, nullptr, P, c, Lz, ym, zm, __ldg(a.inv_d[0]), idy,
                       idz, cu0);
          march_e_cell(a, E0, O0, P, c, march_coef(a, cell, vo), cu0, s, v0);
          const float cx = a.mur_c[0][0];
          E0[c] = v0[0];
          E0[P + c] = Ox[P + c] + cx * (v[1] - O0[P + c]);
          E0[2 * P + c] = Ox[2 * P + c] + cx * (v[2] - O0[2 * P + c]);
        }
      }
      __syncthreads();

      // the y, then z walls of plane x (and of plane 0 with plane 1)
      if (has_yw) {
        if (act && yside >= 0) {
          const float cy = a.mur_c[1][yside];
          if (!defer0) march_fix(E, O + (x & 1) * 3 * P, P, c, yn, cy, 0, 2);
          if (with0) march_fix(Er, O, P, c, yn, cy, 0, 2);
        }
        __syncthreads();
      }
      if (has_zw) {
        if (act && zside >= 0) {
          const float cz = a.mur_c[2][zside];
          if (!defer0) march_fix(E, O + (x & 1) * 3 * P, P, c, zn, cz, 0, 1);
          if (with0) march_fix(Er, O, P, c, zn, cz, 0, 1);
        }
        __syncthreads();
      }

      // after level T the core is final: write it to the other field set
      if (t == T && core) {
        if (!defer0 && x >= x0 && x < x1) {
          const int64_t g = x * plane + vcell;
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            a.e_out[m][g] = E[m * P + c];
            a.h_out[m][g] = H[m * P + c];
          }
        }
        if (with0 && x0 == 0) {
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            a.e_out[m][vcell] = Er[m * P + c];
            a.h_out[m][vcell] = Hr[m * P + c];
          }
        }
      }
    }
  }
}

static int64_t march_smem_bytes(const StreamArgs* a, int T) {
  return (int64_t)march_cells(*a, T) * march_floats(*a, T) * (int64_t)sizeof(float);
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

// The checks of a batched launch: a device mask, a stride that holds one
// variant's arrays, and at most 65,535 variants (the grid's y extent).
static bool batch_ok(const StreamArgs* a, int batch) {
  return batch >= 1 && batch <= 65535 && a->active != nullptr &&
         a->vstride >= (long long)a->n[0] * a->n[1] * a->n[2];
}

template <bool kBatch>
static int tile_launch(const StreamArgs* a, const float* wf, int T, int batch,
                       void* stream) {
  if (T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  if (kBatch && !batch_ok(a, batch)) return (int)cudaErrorInvalidValue;
  Samples s = {};
  for (int k = 0; k < T; ++k) s.s[k] = wf[k];
  const int64_t bytes = smem_bytes(a, T);
  cudaError_t err = cudaFuncSetAttribute(
      stream_kernel<kBatch>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)a->tiles[0] * a->tiles[1] * a->tiles[2],
                    kBatch ? (unsigned)batch : 1u);
  stream_kernel<kBatch><<<blocks, kThreads, (size_t)bytes,
                          (cudaStream_t)stream>>>(*a, T, s);
  return (int)cudaGetLastError();
}

template <bool kBatch>
static int march_launch(const StreamArgs* a, const float* wf, int T, int batch,
                        void* stream) {
  if (T < 1 || T > kMaxT || a->has_pml) return (int)cudaErrorInvalidValue;
  if (kBatch && !batch_ok(a, batch)) return (int)cudaErrorInvalidValue;
  const int threads = (march_cells(*a, T) + 31) / 32 * 32;
  if (threads > kMarchThreads) return (int)cudaErrorInvalidConfiguration;
  Samples s = {};
  for (int k = 0; k < T; ++k) s.s[k] = wf[k];
  const int64_t bytes = march_smem_bytes(a, T);
  cudaError_t err = cudaFuncSetAttribute(
      march_kernel<kBatch>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)a->m_tiles[0] * a->m_tiles[1] * a->m_segs,
                    kBatch ? (unsigned)batch : 1u);
  march_kernel<kBatch><<<blocks, threads, (size_t)bytes,
                         (cudaStream_t)stream>>>(*a, T, s);
  return (int)cudaGetLastError();
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
  return tile_launch<false>(a, wf, T, 1, stream);
}

// T steps of every variant b with active[b] != 0 (a->active: `batch` ints
// on the device) through the tile kernel.
int fdtd_stream_steps_batch(const StreamArgs* a, const float* wf, int T,
                            int batch, void* stream) {
  return tile_launch<true>(a, wf, T, batch, stream);
}

long long fdtd_march_smem_bytes(const StreamArgs* a, int T) {
  return (long long)march_smem_bytes(a, T);
}

int fdtd_stream_march(const StreamArgs* a, const float* wf, int T,
                      void* stream) {
  return march_launch<false>(a, wf, T, 1, stream);
}

// T steps of every variant b with active[b] != 0 through the march.
int fdtd_stream_march_batch(const StreamArgs* a, const float* wf, int T,
                            int batch, void* stream) {
  return march_launch<true>(a, wf, T, batch, stream);
}

}  // extern "C"
