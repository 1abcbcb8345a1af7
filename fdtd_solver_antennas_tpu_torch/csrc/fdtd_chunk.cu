// The chunk stepper for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: fdtd_solver_antennas_tpu/ops/fdtd_pallas.py::build_pallas_chunk_stepper
// (the TPU chunk kernel, K1). K1 advances one termination chunk, n_sub
// probe intervals of D leapfrog steps, in one pallas_call with every array
// resident in VMEM, and extracts the port V/I and Huygens-face samples in
// the kernel. Here the same chunk is one cooperative launch
// (cudaLaunchCooperativeKernel) of chunk_steps_kernel:
//
//   load      each block's operands on chip (resident form only)
//   for j in 0 .. n_sub-1:
//     for s in 0 .. D-1:
//       H pass                                          -- grid barrier --
//       E pass, src * wf[n0 + j*D + s], MUR walls x -> y -> z fused in
//                                                       -- grid barrier --
//       p ^= 1
//     probe gather of every row into out[j, :], grid-stride over all threads
//                                   -- grid barrier (not after the last) --
//
// The H and E passes, the two storage forms (operands resident in shared
// memory, or streamed from memory for grids that do not fit), the boundary
// flavours (PEC, MUR, CPML with its twelve psi) and the plan that picks a
// form from the shape are the device code of K3 and K4
// (csrc/yee_persist.cuh). The gather reads e[p] after the flip, the new E,
// and H as the last H pass left it, half a step earlier (what the DFT
// flush, ops/fdtd.py::ProbeDFT, assumes). The barrier after it keeps the
// next H pass from overwriting H while another block still samples it. A
// row sums its k terms m = 0 .. k-1, one rounding each, as probe_gather
// does (probe_row of csrc/probe_rows.cuh, the same code), so the samples
// are bit-equal to the per-step route. The source
// samples are one float32 array on the device per run, read at offset n0;
// a chunk that runs past n_steps_max reads the zeros padded there. The
// energy check and the DFT flush stay outside, once per chunk in PyTorch,
// as the JAX package keeps them outside its kernel.
//
// A launch is long: at the canonical patch 445 steps (about 3 ms), on a
// 4.2M-cell grid run in chunk mode about 500 steps of ~200 us (0.1 s).
// That is fine on a card that drives no display (no watchdog).
//
// The batched chunk (chunk_batch_kernel; replaces the same pallas_call under
// jax.vmap in fdtd_solver_antennas_tpu/solvers/sweep.py::_make_vmapped_run,
// where Mosaic's batching rule makes the design variant an outer parallel
// grid dimension). One cooperative launch steps B variants of one grid
// through the same chunk: the fields, the psi and ca/cb of each variant are
// (B, nx, ny, nz) arrays, its cells at vo = b * nx*ny*nz; the source stamps,
// the profiles, the probe table and the source samples are shared (every
// variant is driven by the same excitation, as the JAX sweep binds its
// source operands once, in_axes=None). A device int array active[B] says
// which variants step: a frozen one (converged, as a batched while_loop
// leaves a member whose condition is false) is neither stepped nor sampled,
// but its blocks still reach every grid barrier. Every active variant shares
// the parity p (they have all stepped the same chunks). After each interval
// each active variant gathers the same probe rows at its own offset into
// out[b, j, :]. The passes are the shared ones with a variant offset
// (csrc/yee_persist.cuh): the streamed form walks the flattened (variant,
// cell) space, the resident form gives each variant an equal share of the
// blocks, so a block's shared memory holds only its variant's coefficients.
// At the 8-variant canonical sweep (about 4.2M cells a step) the operands
// do not fit on chip and these passes read every operand from memory every
// step; a third form of the same chunk, the marched form in
// csrc/fdtd_chunk_march.cu, reuses each variant's planes across T steps
// there (ops/fdtd_cuda.py::chunk_launch_plan picks between them). The
// unbatched chunk_steps_kernel is compiled from the same passes with vo = 0.
//
// What bounds it on the card: at the canonical patch (56 x 55 x 50 =
// 154,000 cells, 0.62 MB per array) a launch must move the fields in and
// out once, ca/cb and the source once (about 12 MB, 3.5 us over HBM) and
// do 445 steps x 48 float32 operations per cell, about 49 us at the
// float32 peak: operations bound it. The live fields sit in the 50 MB L2
// for the whole launch, and in the resident form the coefficients never
// leave the SM. What it pays on top is K4's: two grid barriers a step and
// each pass's rounds of dependent L2 loads, plus one barrier and one
// gather per probe interval. On grids that spill L2 (the streamed form)
// every pass reads its operands from memory, and bytes bound it.
//
// The first design of K1, four kernels the host launched step by step
// (five launches a step under MUR), stays in this library:
//
//   h_update      one thread per cell: H -= dt/mu0 * curl E (+ 6 CPML psi_h)
//   e_update      one thread per cell: E' = ca*E + cb*curl H (+ 6 CPML psi_e)
//                 + src * s(t), from the old E buffer into the new one
//   mur_faces     launched once per axis, x then y then z: first-order MUR
//                 on the two wall planes of that axis, at the array's own
//                 rows (a rank's slab or block places them where the
//                 global walls fall)
//   e_update_mur  e_update and the three mur_faces launches in one: every
//                 cell's E update with the MUR walls of all three axes
//                 fused in, bit for bit what the four launches write (the
//                 walk's E half-step wherever no wall straddles a rank)
//   probe_gather  one thread per probe row: a weighted gather over the six
//                 field arrays, written to row j of the staging buffer
//                 (redesigned for Hopper; see "The probe table" below)
//   probe_gather_batch
//                 the same rows of every active variant of a batch, one
//                 thread a (variant, row) pair, into row j of each
//                 variant's staging buffer: the batched stream stepper's
//                 gather, one launch an interval for the whole sweep
//
// h_update, e_update and mur_faces step the per-step route
// (ops/fdtd_cuda.py::step_kernels), kept to time beside chunk_steps and as
// a second holder in the card tests. The explicit path's per-step walk
// (parallel/explicit.py, use_kernel=False: a rank's slab or x-y block with
// one halo plane per split axis, the halos exchanged between the half-
// steps) launches h_update and e_update_mur a step; a rank that takes part
// in a straddled wall's exchange, which must fall between the axes' walls,
// launches e_update and the three mur_faces instead. probe_gather samples
// the stream stepper's (K2), the explicit path's (K3 and the walk) runs
// between their launches.
// Each of these kernels runs for 3-5 us at the canonical patch, so that
// route is bound by launch latency and the host that issues the launches;
// on the tall grid (3.05M cells) h_update and e_update reach 67% and 82%
// of the HBM peak.
//
// Layout: the plain contiguous (Px, Py, Pz) float32 arrays, z fastest, the
// layout of the port's plain PyTorch twins (ops/fdtd_cuda.py). None of
// K1's TPU layout (lane packing, rolls, one-hot selection matmuls, SMEM
// probe buffers) is carried over. A neighbour outside the array reads as
// 0, as on the XLA path (ops/fdtd.py::_fdiff/_bdiff); nothing wraps. E is
// double-buffered: a step reads e[p] and writes e[1-p], so the MUR walls
// still see the old E.
//
// The probe table (ops/fdtd_cuda.py::ProbeTable). The rows come in four
// blocks, each of its own width k: port V (one row a port; rows of
// different lengths pad with weight 0 to the longest, 70 terms at the
// horn of the 4.2M-cell mixed scene), port I (4), face E (2) and face H
// (4), the four gathers of the JAX package's sample_probes. Each block is
// stored term-major, (k, rows): the m-th terms of neighbouring rows, which
// neighbouring threads read, lie side by side, so a warp's 32 loads of a
// term are one or two cache lines. An entry's code holds the cell and the
// component, cell << 3 | comp, decided on the host: no divide a term.
// What bounds the gather: the bytes of the entries it uses (code, weight
// and the field value, 12 B) and of the samples it writes, 6.85 us over
// HBM at the mixed scene's 1.72M entries; the field values are gathers,
// coalesced only where a face row's neighbours are neighbouring cells.
// A row's terms are summed m = 0 .. k-1, one rounding each (no warp
// reduction, which would change the order); its loads go out ahead of
// the dependent adds, kGatherUnroll terms at a time, so the two 70-term
// rows take about 70 / kGatherUnroll rounds of memory latency, not 70.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py). No
// fused multiply-add, so each cell's arithmetic rounds like the plain
// PyTorch twin, one operation at a time.

#include "probe_rows.cuh"
#include "yee_persist.cuh"

namespace {

constexpr int kThreads = 256;
// e_update_mur_kernel's block: at its 56 registers a thread the register
// file holds 36 warps an SM, which 128-thread blocks fill (256-thread
// blocks: 32).
constexpr int kWallThreads = 128;
// terms loaded ahead of their adds: the standalone gather (whose mixed
// scene has 70-term rows) and the chunk kernel's (canonical rows <= 8,
// inside a kernel held to 48 registers)
constexpr int kGatherUnroll = 8;
constexpr int kChunkGatherUnroll = 4;

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
  ProbeTable probes;
  int nx, ny, nz;          // array shape
  int has_pml;
  float dtmu;              // dt / mu0
  float mur_c[3][2];       // MUR coefficient per axis and side
  int mur_wall[3][2];      // MUR wall plane per axis and side, in the
                           // array's own indices (a block's, or the
                           // grid's 0 and q-1); outside [0, n) no wall
                           // (-1 without MUR)
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

// The E update of the cell (i, j, k) (flat index c) from e[p] into v:
// E' = ca*E + cb*curl H (+ the six CPML psi_e, updated in place) + src*s;
// eo gets the cell's old E.
__device__ __forceinline__ void e_interior(const YeeArgs& a, const int p,
                                           const float s, const int64_t c,
                                           const int i, const int j,
                                           const int k, float (&v)[3],
                                           float (&eo)[3]) {
  const int64_t sy = a.nz;
  const int64_t sx = (int64_t)a.ny * a.nz;
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
    eo[m] = a.e[p][m][c];
    float x = a.ca[m][c] * eo[m] + a.cb[m][c] * cu[m];
    if (a.src[m] != nullptr) x = x + a.src[m][c] * s;
    v[m] = x;
  }
}

__global__ void e_update_kernel(const YeeArgs a, const int p, const float s) {
  const int64_t n = (int64_t)a.nx * a.ny * a.nz;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int k = (int)(c % a.nz);
  const int j = (int)((c / a.nz) % a.ny);
  const int i = (int)(c / ((int64_t)a.ny * a.nz));
  float v[3], eo[3];
  e_interior(a, p, s, c, i, j, k, v, eo);
#pragma unroll
  for (int m = 0; m < 3; ++m) a.e[1 - p][m][c] = v[m];
}

// YeeArgs' walls and dual spacings for the wall arithmetic of
// csrc/yee_persist.cuh (persist::mur_fix and persist::e_at find these by
// argument-dependent lookup): the planes of mur_wall, a plane outside the
// array never matching; the spacings from memory.
__device__ __forceinline__ int wall_side(const YeeArgs& a, const int b,
                                         const int x) {
  return x == a.mur_wall[b][0] ? 0 : (x == a.mur_wall[b][1] ? 1 : -1);
}

template <bool kOnChip>
__device__ __forceinline__ float inv_dual(const YeeArgs& a, const int ax,
                                          const int idx) {
  return a.inv_d[ax][idx];
}

// e_update_kernel, then mur_faces_kernel for x, y and z, in one launch, one
// thread a cell.
// The recipe of K1's, K3's and K4's E pass (csrc/yee_persist.cuh): the
// thread that owns a wall cell writes the fix of the last wall axis it sits
// on, recomputing its inner neighbour's update (and, where the neighbour
// sits on an earlier wall axis too, that axis's fix from the diagonal
// cell) from H and the old E, which no thread writes in the pass. The
// inner neighbour of a z wall cell, (i, j, 1) or (i, j, qz-2), is the next
// or previous cell, so usually the next or previous lane's: its final Ex
// and Ey and its old ones come over by warp shuffle, and only a wall cell
// at the warp's edge recomputes. Nothing reads what another thread writes,
// so the result is bit for bit the four launches' (built without FMA, the
// recomputed updates round as e_update's). x and y walls cover whole
// planes of cells, so their warps run uniformly. Blocks of kWallThreads;
// a lane is c mod 32 whatever the block. Indices in the wall arithmetic
// are int: the host refuses arrays of 2^31 cells or more.
__global__ void e_update_mur_kernel(const YeeArgs a, const int p,
                                    const float s) {
  const int64_t n = (int64_t)a.nx * a.ny * a.nz;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < n;  // every lane of a warp reaches the shuffles
  float v[3] = {0.f, 0.f, 0.f}, eo[3] = {0.f, 0.f, 0.f};
  int zside = -1;
  bool lane_z = false;
  if (live) {
    const int k = (int)(c % a.nz);
    const int j = (int)((c / a.nz) % a.ny);
    const int i = (int)(c / ((int64_t)a.ny * a.nz));
    e_interior(a, p, s, c, i, j, k, v, eo);
    const int lane = threadIdx.x & 31;
    zside = wall_side(a, 2, k);
    lane_z = zside == 0 ? lane < 31 && c + 1 < n : zside == 1 && lane > 0;
    if (zside >= 0 || wall_side(a, 0, i) >= 0 || wall_side(a, 1, j) >= 0) {
#pragma unroll
      for (int m = 0; m < 3; ++m)
        if (!(lane_z && m < 2))
          v[m] = persist::mur_fix<false>(a, m, i, j, k, (int)c, v[m], s,
                                         a.h[0], a.h[1], a.h[2], a.e[p][m],
                                         0);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float up = __shfl_down_sync(0xffffffffu, v[m], 1);
    const float dn = __shfl_up_sync(0xffffffffu, v[m], 1);
    const float eup = __shfl_down_sync(0xffffffffu, eo[m], 1);
    const float edn = __shfl_up_sync(0xffffffffu, eo[m], 1);
    if (lane_z) {
      const float eo_nb = zside == 0 ? eup : edn;
      const float en_nb = zside == 0 ? up : dn;
      v[m] = eo_nb + a.mur_c[2][zside] * (en_nb - eo[m]);
    }
  }
  if (live) {
#pragma unroll
    for (int m = 0; m < 3; ++m) a.e[1 - p][m][c] = v[m];
  }
}

// One launch per wall axis b. Thread t covers (side, component, plane
// cell): 2 sides x the 2 components tangential to the wall x the wall
// plane.
//   E'[wall] = E[nb] + c * (E'[nb] - E[wall]),   nb the inward neighbour
// E is the old buffer, E' the new one, which already holds the walls of
// the axes before b (order x, y, z). The wall planes are the array's own
// (mur_wall): on a whole grid 0 and q-1 of the grid shape q; on a rank's
// slab or block the rows where the global walls fall, a wall outside the
// array written by no thread and a neighbour outside it read as 0 (a
// neighbour on another rank is copied into the halo row first). For
// q >= 3 the planes written and the planes read are disjoint, so threads
// do not race.
__global__ void mur_faces_kernel(const YeeArgs a, const int p, const int b) {
  const int dims[3] = {a.nx, a.ny, a.nz};
  const int ua = (b + 1) % 3, va = (b + 2) % 3;
  const int u_ax = ua < va ? ua : va;  // the other two axes, ascending
  const int v_ax = ua < va ? va : ua;
  const int64_t plane = (int64_t)dims[u_ax] * dims[v_ax];
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 4 * plane) return;
  const int q = (int)(t / plane);
  const int64_t r = t % plane;
  const int side = q >> 1;
  const int wall = a.mur_wall[b][side];
  if (wall < 0 || wall >= dims[b]) return;
  const int nb = side ? wall - 1 : wall + 1;
  const bool nb_in = nb >= 0 && nb < dims[b];
  const int comp = (q & 1) ? v_ax : u_ax;
  const int u = (int)(r / dims[v_ax]);
  const int v = (int)(r % dims[v_ax]);
  const int64_t strides[3] = {(int64_t)a.ny * a.nz, a.nz, 1};
  const int64_t base = u * strides[u_ax] + v * strides[v_ax];
  const int64_t cw = base + wall * strides[b];
  const int64_t cn = base + nb * strides[b];
  const float* Eo = a.e[p][comp];
  float* En = a.e[1 - p][comp];
  const float cm = a.mur_c[b][side];
  const float eo_nb = nb_in ? Eo[cn] : 0.f;
  const float en_nb = nb_in ? En[cn] : 0.f;
  En[cw] = eo_nb + cm * (en_nb - Eo[cw]);
}

__global__ void probe_gather_kernel(const YeeArgs a, const int p,
                                    float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.probes.rows) return;
  out[r] = probe_row<kGatherUnroll>(a.probes.code, a.probes.w, a.probes.meta,
                                    r, a.e[p][0], a.e[p][1], a.e[p][2],
                                    a.h[0], a.h[1], a.h[2]);
}

namespace cg = cooperative_groups;

// Mirrored field for field by ops/fdtd_cuda.py::_ChunkArgs (ctypes).
struct ChunkArgs {
  persist::Ops o;
  ProbeTable probes;
};

// Every probe row of the fields (E, H) into out, rows spread over all
// threads of the launch; a row is probe_gather_kernel's probe_row, with
// fewer terms loaded ahead. Not inlined, and the kernel's steps one flat
// loop: the one-cell resident form runs at 48 registers, where every value
// the step loop keeps live counts; on an H100 this layout stepped the
// canonical patch fastest under MUR and CPML of the four tried (gather
// inlined or not, loop nested by interval or flat), slowest under PEC. The
// table's block layout comes as a device array (meta), so the call passes
// pointers only: of the three calls timed on an H100 (the table by value,
// the kernel's arguments by address as a __grid_constant__, pointers
// only), only this one left the canonical MUR launch no slower than with
// the padded table's gather.
__device__ __noinline__ void gather_rows(
    const float* ex, const float* ey, const float* ez, const float* hx,
    const float* hy, const float* hz, const int* __restrict__ code,
    const float* __restrict__ w, const int* __restrict__ meta,
    float* __restrict__ out) {
  const int stride = gridDim.x * blockDim.x;
  const int rows = __ldg(meta + kMetaRow0 + kProbeBlocks);
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += stride)
    out[r] = probe_row<kChunkGatherUnroll>(code, w, meta, r, ex, ey, ez, hx,
                                           hy, hz);
}

// One termination chunk: n_sub intervals of d_steps steps from e[p], the
// source sample of step t at wf[t], interval j's samples into
// out[j * probe rows ...].
template <int kCells, int kFlav>
__global__ void __launch_bounds__(persist::threads(kCells),
                                  persist::min_blocks(kCells))
chunk_steps_kernel(const ChunkArgs a, int p, const float* __restrict__ wf,
                   const int n_sub, const int d_steps, float* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  const persist::Range r = persist::block_range(a.o);
  persist::load_operands<kCells>(a.o, r);
  const int steps = n_sub * d_steps;
  for (int t = 0; t < steps; ++t) {
    persist::h_pass<kCells, kFlav>(a.o, p, r);
    grid.sync();
    persist::e_pass<kCells, kFlav>(a.o, p, r, wf[t]);
    grid.sync();
    p ^= 1;
    if ((t + 1) % d_steps == 0) {
      gather_rows(a.o.e[p][0], a.o.e[p][1], a.o.e[p][2], a.o.h[0], a.o.h[1],
                  a.o.h[2], a.probes.code, a.probes.w, a.probes.meta,
                  out + (int64_t)(t / d_steps) * a.probes.rows);
      if (t + 1 < steps) grid.sync();  // the next H pass overwrites what it read
    }
  }
}

// The probe rows of every active variant of bt into out (variant b's row r
// at out[b * out_stride + r]), (variant, row) pairs spread over all threads;
// variant b's fields at vo = b * cells from the pointers given.
__device__ __noinline__ void gather_rows_batch(
    const float* ex, const float* ey, const float* ez, const float* hx,
    const float* hy, const float* hz, const int* __restrict__ code,
    const float* __restrict__ w, const int* __restrict__ meta,
    float* __restrict__ out, const int64_t out_stride, const int cells,
    const persist::Batch bt) {
  const int stride = gridDim.x * blockDim.x;
  const int rows = __ldg(meta + kMetaRow0 + kProbeBlocks);
  const int total = rows * bt.n;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < total; g += stride) {
    const int b = g / rows;
    if (__ldg(bt.active + b) == 0) continue;
    const int r = g - b * rows;
    const int64_t vo = (int64_t)b * cells;
    out[b * out_stride + r] = probe_row<kChunkGatherUnroll>(
        code, w, meta, r, ex + vo, ey + vo, ez + vo, hx + vo, hy + vo, hz + vo);
  }
}

// Mirrored field for field by ops/fdtd_cuda.py::_GatherBatchArgs (ctypes).
struct GatherBatchArgs {
  const float* f[6];     // Ex Ey Ez Hx Hy Hz of variant 0, (B, nx, ny, nz)
  ProbeTable probes;
  const int* active;     // B ints on the device
  int batch;
  int cells;             // nx * ny * nz
  long long out_stride;  // floats between two variants' rows in out
  float* out;
};

// The batched gather between the launches of the batched stream stepper
// (ops/fdtd_cuda.py::probe_gather_batch): every probe row of every active
// variant in one launch, (variant, row) pairs one a thread.
__global__ void probe_gather_batch_kernel(const GatherBatchArgs a) {
  gather_rows_batch(a.f[0], a.f[1], a.f[2], a.f[3], a.f[4], a.f[5],
                    a.probes.code, a.probes.w, a.probes.meta, a.out,
                    a.out_stride, a.cells, persist::Batch{a.active, a.batch});
}

// One termination chunk of every active variant of bt: n_sub intervals of
// d_steps steps from e[p], the source sample of step t at wf[t], variant b's
// interval j samples into out[(b * n_sub + j) * probe rows ...].
template <int kCells, int kFlav>
__global__ void __launch_bounds__(persist::threads(kCells),
                                  persist::min_blocks(kCells))
chunk_batch_kernel(const ChunkArgs a, int p, const float* __restrict__ wf,
                   const int n_sub, const int d_steps, float* __restrict__ out,
                   const persist::Batch bt) {
  cg::grid_group grid = cg::this_grid();
  const int cells = a.o.nx * a.o.ny * a.o.nz;
  // the resident form: this block's variant, its offset and its cells in it
  // (gridDim.x is a multiple of bt.n); the streamed form walks them all
  int vo = 0;
  bool on = true;
  persist::Range r = {0, 0};
  if constexpr (kCells > 0) {
    const unsigned share = gridDim.x / (unsigned)bt.n;
    const unsigned v = blockIdx.x / share;
    r = persist::block_range(a.o, share, blockIdx.x - v * share);
    vo = (int)v * cells;
    on = __ldg(bt.active + v) != 0;
    if (on) persist::load_operands<kCells>(a.o, r, vo);
  }
  const int steps = n_sub * d_steps;
  const int rows = a.probes.rows;
  for (int t = 0; t < steps; ++t) {
    if (on) persist::h_pass<kCells, kFlav, true>(a.o, p, r, vo, bt);
    grid.sync();
    if (on) persist::e_pass<kCells, kFlav, true>(a.o, p, r, wf[t], vo, bt);
    grid.sync();
    p ^= 1;
    if ((t + 1) % d_steps == 0) {
      gather_rows_batch(a.o.e[p][0], a.o.e[p][1], a.o.e[p][2], a.o.h[0],
                        a.o.h[1], a.o.h[2], a.probes.code, a.probes.w,
                        a.probes.meta, out + (int64_t)(t / d_steps) * rows,
                        (int64_t)n_sub * rows, cells, bt);
      if (t + 1 < steps) grid.sync();  // the next H pass overwrites what it read
    }
  }
}

namespace {

// by boundary (row: PEC, MUR, CPML) and form (column)
#define PERSIST_FORMS(K, F)                                             \
  {(const void*)K<0, F>, (const void*)K<1, F>, (const void*)K<2, F>,    \
   (const void*)K<3, F>, (const void*)K<4, F>}
const void* const kKernels[persist::kFlavours][persist::kMaxCells + 1] = {
    PERSIST_FORMS(chunk_steps_kernel, persist::kPec),
    PERSIST_FORMS(chunk_steps_kernel, persist::kMur),
    PERSIST_FORMS(chunk_steps_kernel, persist::kCpml)};
const void* const kBatchKernels[persist::kFlavours][persist::kMaxCells + 1] = {
    PERSIST_FORMS(chunk_batch_kernel, persist::kPec),
    PERSIST_FORMS(chunk_batch_kernel, persist::kMur),
    PERSIST_FORMS(chunk_batch_kernel, persist::kCpml)};
#undef PERSIST_FORMS
static_assert(persist::kMaxCells == 4, "one kernel per resident form");

}  // namespace

static unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

extern "C" {

int fdtd_args_size() { return (int)sizeof(YeeArgs); }

int fdtd_chunk_args_size() { return (int)sizeof(ChunkArgs); }

int fdtd_probe_table_size() { return (int)sizeof(ProbeTable); }

const char* fdtd_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Blocks the card keeps resident at once for the streamed form of
// chunk_steps (the most any form launches).
int fdtd_chunk_grid_blocks(int* blocks) {
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

// The launch plan of chunk_steps for a, out = {cells a thread (0:
// streamed), blocks, shared bytes, threads a block}; request -1 either
// form, 0 streamed, 1 resident.
int fdtd_chunk_plan(const ChunkArgs* a, int request, int* out) {
  return (int)persist::plan(a->o, kKernels[persist::flavour(a->o)], request,
                            out);
}

// One chunk, n_sub intervals of d steps from e[p], by the planned form:
// the source sample of step s of interval j at wf[n0 + j*d + s] (device
// memory), interval j's probe samples into out[j * probe rows ...].
int fdtd_chunk_steps(const ChunkArgs* a, int p, const float* wf, int n0,
                     int n_sub, int d, float* out, int cells, int blocks,
                     void* stream) {
  if (n_sub < 1 || d < 1 || n0 < 0 || wf == nullptr ||
      (a->probes.rows > 0 && out == nullptr))
    return (int)cudaErrorInvalidValue;
  ChunkArgs args = *a;
  const float* w = wf + n0;
  void* params[] = {(void*)&args, (void*)&p,     (void*)&w,
                    (void*)&n_sub, (void*)&d, (void*)&out};
  return (int)persist::launch(args.o, kKernels[persist::flavour(args.o)], cells,
                              blocks, params, stream);
}

// The launch plan of chunk_steps_batch for `batch` variants of a's grid
// (a's per-variant pointers at variant 0), as fdtd_chunk_plan.
int fdtd_chunk_batch_plan(const ChunkArgs* a, int request, int batch,
                          int* out) {
  return (int)persist::plan(a->o, kBatchKernels[persist::flavour(a->o)],
                            request, out, batch);
}

// One chunk of every variant b with active[b] != 0 (active: `batch` ints on
// the device), n_sub intervals of d steps from e[p], by the planned form:
// the source sample of step s of interval j at wf[n0 + j*d + s], variant b's
// interval j samples into out[(b * n_sub + j) * probe rows ...].
int fdtd_chunk_batch_steps(const ChunkArgs* a, int p, const float* wf, int n0,
                           int n_sub, int d, float* out, const int* active,
                           int batch, int cells, int blocks, void* stream) {
  if (n_sub < 1 || d < 1 || n0 < 0 || wf == nullptr || active == nullptr ||
      batch < 1 || (a->probes.rows > 0 && out == nullptr))
    return (int)cudaErrorInvalidValue;
  ChunkArgs args = *a;
  const float* w = wf + n0;
  persist::Batch bt = {active, batch};
  void* params[] = {(void*)&args, (void*)&p,     (void*)&w,  (void*)&n_sub,
                    (void*)&d,    (void*)&out,   (void*)&bt};
  return (int)persist::launch(args.o,
                              kBatchKernels[persist::flavour(args.o)], cells,
                              blocks, params, stream, batch);
}

int fdtd_gather_batch_args_size() { return (int)sizeof(GatherBatchArgs); }

// Every probe row of every variant b with active[b] != 0 into
// out[b * out_stride + row].
int fdtd_probe_gather_batch(const GatherBatchArgs* a, void* stream) {
  if (a->batch < 1 || a->active == nullptr || a->cells < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)a->probes.rows * a->batch;
  if (n == 0) return (int)cudaSuccess;
  probe_gather_batch_kernel<<<blocks_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
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

// e_update, then mur_faces x, y and z, in one launch: the walls of
// mur_wall that lie inside the array fused into the E update; with none
// (no MUR: the host packs -1) e_update_kernel alone.
int fdtd_e_update_mur(const YeeArgs* a, int p, float s, void* stream) {
  const int64_t n = (int64_t)a->nx * a->ny * a->nz;
  if (n >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const int dims[3] = {a->nx, a->ny, a->nz};
  bool walls = false;
  for (int b = 0; b < 3; ++b)
    for (int side = 0; side < 2; ++side)
      walls |= a->mur_wall[b][side] >= 0 && a->mur_wall[b][side] < dims[b];
  cudaStream_t st = (cudaStream_t)stream;
  if (walls)
    e_update_mur_kernel<<<(unsigned)((n + kWallThreads - 1) / kWallThreads),
                          kWallThreads, 0, st>>>(*a, p, s);
  else
    e_update_kernel<<<blocks_for(n), kThreads, 0, st>>>(*a, p, s);
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
  const int rows = a->probes.rows;
  if (rows == 0) return (int)cudaSuccess;
  probe_gather_kernel<<<blocks_for(rows), kThreads, 0,
                        (cudaStream_t)stream>>>(*a, p, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
