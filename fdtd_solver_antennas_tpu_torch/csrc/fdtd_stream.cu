// The stream stepper for Hopper (sm_90a): T leapfrog steps per launch,
// bound to Python with ctypes. Two kernels, both a y-z tile marching along
// x with T time levels of a few planes in shared memory (2.5-D temporal
// blocking): march_kernel takes MUR and PEC walls, cpml_march_kernel takes
// CPML (the twelve psi), each described below at its code. The host picks
// by the operands (StreamArgs::has_pml; ops/fdtd_stream.py).
//
// It runs a whole grid (ops/fdtd_stream.py::stream_steps) or one rank's
// halo-extended x-slab of the explicit run (stream_shard_steps): the
// slab is an array like a grid, its out-of-domain rows zero-coupled, the
// march given the slab's own x walls (x_lo, x_hi, below). It also runs B
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
// advances T steps per fetch with trapezoidal halo recompute. On the H100
// one y-z plane of the 4.3M-cell mixed scene is 122 KB per field, so six
// fields do not fit the 227 KB of shared memory a block may use: the march
// streams planes of a y-z tile instead. None of K2's TPU layout (x*ZT row
// interleave, 128-lane rows, the z tile-seam fix, the y<->z swap, the VMEM
// pickers) is carried over; the arrays stay the plain contiguous
// (Px, Py, Pz) float32 layout of the port's plain twins (ops/fdtd_cuda.py).
//
// Semantics are those of T calls of ops/fdtd_cuda.py::leapfrog_step:
//   - a neighbour outside the grid reads 0 (never wraps or clamps); a
//     neighbour outside the loaded region also reads 0, which only ever
//     feeds cells outside the valid region;
//   - the source FMA uses sample k of the launch at inner step k, before
//     the MUR walls;
//   - MUR walls go x, then y, then z, after the E update of each step;
//   - CPML: psi_h updates with H, psi_e with E, each from its own cell's
//     differences only.
//
// The CPML invariant. Outside its slab a psi never changes: there the
// profile of its derivative's axis has b = 1 and c = 0 exactly
// (ops/fdtd.py::_cpml_profiles), so psi' = 1 psi + 0 d keeps the 0 it
// started with. The host passes, per axis and side, the run of indices
// where the profile is flat (StreamArgs::flat, from
// ops/fdtd_stream.py::flat_runs), and the kernel skips a psi's load,
// update and store there and adds 0 in its place. That equals the twin
// only while every psi is 0 in its axis's flat run, which holds from
// fdtd_cuda.new_state and from any run of either package (a resumed
// state included); tests/test_torch_stream.py checks it on the twin, and
// the wrappers raise on a state that breaks it before its first launch
// (ops/fdtd_stream.py::check_psi_flat). chip_smoke.py phase 19 times a
// mixed PML_8 launch with the skip and with the runs empty.
//
// What bounds it on the card: a launch must read every field, coefficient
// and source once and write every field once, ((6 + 6 + n_src) in + 6 out)
// x 4 B per cell under MUR, 344 MB on the mixed scene, >= 103 us at
// 3.35 TB/s, or 26 us per step at T = 4; under CPML the twelve psi in and
// out add 96 B a cell (the psi outside their slabs, which stay 0, need not
// move). The march reads each value about once per launch times its y-z
// halo ratio and recomputes no x halo. A batched launch moves each
// variant's fields, ca and cb and the shared stamps once: at the 8-variant
// sweep (100 x 109 x 50 cells a variant) about 316 MB, >= 94 us.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py). No
// fused multiply-add, so each cell's arithmetic rounds like the plain
// PyTorch twin, one operation at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  int has_pml;
  int has_mur;
  float dtmu;              // dt / mu0
  float mur_c[3][2];       // MUR coefficient per axis and side
  // CPML: per side (0: H, bh/ch; 1: E, be/ce) and axis, the run [lo, hi)
  // of indices where b = 1 and c = 0 (the header's invariant)
  int flat[2][3][2];
  // the march's plan (ops/fdtd_stream.py::march_plan)
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
  // CPML (cpml_march_kernel only): per plane, bit m set where src[m] may
  // hold a nonzero value on that plane, under this drive or another one
  // (ops/fdtd_stream.py::stamp_planes; n[0] ints on the device)
  const int* src_planes;
};

struct Samples {
  float s[kMaxT];          // source samples of the T inner steps
};

// ---------------------------------------------------------------------------
// The march: a y-z tile marching along x (MUR and PEC)
// ---------------------------------------------------------------------------
//
// Each block owns a y-z core tile (m_core: 16x16 under MUR, 14x14 under
// PEC) of one x segment (m_seg planes) and holds a region of the core plus
// T cells on each side in y and z, clipped to the array. One thread owns
// one region cell (j, k) of every plane. The block marches along x:
// iteration p loads plane p (E and H, level 0) and then advances every
// level t = 1..T by one plane, level t working on plane p - t, one plane
// behind level t - 1 (2.5-D temporal blocking):
//
//   - H at level t, plane x, reads level t-1's E at x and x+1; E at level
//     t, plane x, reads level t's H at x-1 and x and its own old E. Both
//     update in place: each plane's slot of the ring holds the highest
//     level reached, and T + 2 planes are alive at once (the loaded one
//     down to the plane below level T's);
//   - level t covers planes [x0 - T + t - 1, x1 + T - t) and the y-z box
//     [c0 - T + t - 1, c1 + T - t) (clipped), the cone the core needs;
//     after level T the core of plane x is written to the other field set;
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

// One thread per region cell, at most a 24x24 region (T = 4 under MUR
// with a 16x16 core, T = 5 under PEC with 14x14). Two blocks an SM under
// MUR and PEC (56 registers a thread at most); one under CPML
// (cpml_march_kernel), whose rings fill the shared memory (the registers
// then allow 112).
constexpr int kMarchThreads = 576;

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Region cells of one plane at T (the largest block's), and floats per cell.
__host__ __device__ inline int march_cells(const StreamArgs& a, int T) {
  return imin(a.n[1], a.m_core[0] + 2 * T) * imin(a.n[2], a.m_core[1] + 2 * T);
}

__host__ __device__ inline int march_floats(const StreamArgs& a, int T) {
  return 6 * (T + 2) + (a.has_mur ? 8 : 0);
}

// Backward differences of H at region cell c of plane x (a neighbour
// outside the region or the grid reads 0), in psi order: dHz/dy, dHy/dz,
// dHx/dz, dHz/dx, dHy/dx, dHx/dy. H holds plane x, Hm plane x-1 (null at
// x = 0); components at stride P.
__device__ __forceinline__ void march_dh(const float* H, const float* Hm,
                                         int P, int c, int Lz, bool ym,
                                         bool zm, float idx_, float idy,
                                         float idz, float d[6]) {
  const float hx = H[c], hy = H[P + c], hz = H[2 * P + c];
  const float hz_ym = ym ? H[2 * P + c - Lz] : 0.f;
  const float hy_zm = zm ? H[P + c - 1] : 0.f;
  const float hx_zm = zm ? H[c - 1] : 0.f;
  const float hz_xm = Hm ? Hm[2 * P + c] : 0.f;
  const float hy_xm = Hm ? Hm[P + c] : 0.f;
  const float hx_ym = ym ? H[c - Lz] : 0.f;
  d[0] = (hz - hz_ym) * idy;
  d[1] = (hy - hy_zm) * idz;
  d[2] = (hx - hx_zm) * idz;
  d[3] = (hz - hz_xm) * idx_;
  d[4] = (hy - hy_xm) * idx_;
  d[5] = (hx - hx_ym) * idy;
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
  const int total = P * march_floats(a, T);
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
      if (x >= lo && x < min(n0, x1 + T - t)) {
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
        const bool last = t == T;
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
          // forward differences in psi order: dEz/dy, dEy/dz, dEx/dz,
          // dEz/dx, dEy/dx, dEx/dy
          const float d[6] = {(ez_yp - ez) * ipy, (ey_zp - ey) * ipz,
                              (ex_zp - ex) * ipz, (ez_xp - ez) * ipx,
                              (ey_xp - ey) * ipx, (ex_yp - ex) * ipy};
          H[c] = H[c] - a.dtmu * (d[0] - d[1]);
          H[P + c] = H[P + c] - a.dtmu * (d[2] - d[3]);
          H[2 * P + c] = H[2 * P + c] - a.dtmu * (d[4] - d[5]);
        }
        __syncthreads();

        // E at level t (and plane 0's, held back from the step before)
        if (act && !defer0) {
          float* Ox = mur ? O + (x & 1) * 3 * P : nullptr;
          float d[6], cu[3], v[3];
          march_dh(H, Hm, P, c, Lz, ym, zm, __ldg(a.inv_d[0] + x), idy, idz, d);
          cu[0] = d[0] - d[1];
          cu[1] = d[2] - d[3];
          cu[2] = d[4] - d[5];
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
            float d0[6], cu0[3], v0[3];
            march_dh(Hr, nullptr, P, c, Lz, ym, zm, __ldg(a.inv_d[0]), idy,
                     idz, d0);
            cu0[0] = d0[0] - d0[1];
            cu0[1] = d0[2] - d0[3];
            cu0[2] = d0[4] - d0[5];
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
        if (last && core) {
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
}

// ---------------------------------------------------------------------------
// The CPML march: the same march with every operand staged a plane ahead
// ---------------------------------------------------------------------------
//
// cpml_march_kernel<kBatch, kT> runs march_kernel's planes, levels, boxes
// and x cut (no walls: CPML takes none) with the twelve psi, and T a
// template parameter (one instance per T in 1..kMaxT). What bounds it is
// not bytes: its shared memory holds one block an SM, every warp of the
// SM marches the same plane, and a level that waits on a device-memory
// read stalls the whole SM (a march that reads ca, cb, the stamps and the
// x spacings and profiles at every level runs at 6.5-9% of its bytes
// bound, about 4,000 cycles a level and plane at the microstrip q5
// grid). So no level here reads device memory for an operand of its own
// plane:
//
//   - fields: as march_kernel, plane p + 1 loaded into registers while
//     plane p's levels compute, stored into the T + 2 ring at plane p + 1's
//     entry;
//   - ca and cb: when plane p enters, its thread copies plane p's six
//     values by cp.async into the coefficient ring (T + 1 slots: planes
//     p - T .. p - 1 read, plane p in flight), each cell its thread's own;
//     first read by level 1 in the next iteration;
//   - the x scalars: with them seven threads copy plane p's 1 / primary
//     and 1 / dual spacing, its four x profile values (bh, ch, be, ce) and
//     its stamp flags (StreamArgs::src_planes) into the scalar ring X
//     [T + 1][kXs], read by every thread (a broadcast);
//   - psi: level 1 of plane x takes plane x's psi from registers loaded
//     from pe_in/ph_in during the iteration before; levels 1..T-1 store it
//     to the thread's own slot of plane x (T slots by x mod T); level T
//     writes the core's to pe_out/ph_out, and a halo cell's goes nowhere.
//     (Level 1 of plane p-1 writes its slot in the same iteration as level
//     T reads plane p-T's, so T slots, not T - 1.) A psi whose derivative's
//     axis lies in that axis's flat run is skipped (the header's
//     invariant): y and z membership is the thread's, fixed; x membership
//     the plane's. The y and z profiles and spacings of the thread's cell
//     sit in registers;
//   - the source stamps are dense arrays that hold a few nonzero values
//     (a lumped port's cells). They stay out of the rings: the host flags
//     per plane the components whose stamp may hold a nonzero value (a
//     port's column, driven now or by a later re-excitation), and only a
//     level on a flagged plane reads its stamps from device memory and
//     adds src s. Elsewhere the twin adds 0 s (the stamp is 0 there),
//     which leaves the value as it is up to the sign of a zero; -0 and +0
//     then stay equal through every later operation.
//
// The ring slots advance by counters (plane p's field slot p mod (T + 2),
// coefficient slot p mod (T + 1), psi slot p mod T) and the levels are
// unrolled, so nothing in a level divides by a run-time value. The rings
// keep a fixed stride of kP = cpml_stride(T) cells whatever the block's
// region, so a component, a z neighbour and a slot lie at constant
// offsets (a y neighbour at Lz). Shared memory per cell of the stride:
// E and H rings 6 (T + 2), ca/cb ring 6 (T + 1) in (ca, cb) pairs, psi
// slots 12 T: 114 floats at T = 4, 508 cells (a 14x14 core's 22x22
// region is 484) 231,648 B and 160 B of scalars, one block an SM
// (ops/fdtd_stream.py's plan: the core, the cut and the shared memory).
// Barriers: one after a plane's copies land, one between each level's H
// and E, and one after the last level's E. None between level t's E and
// level t + 1's H: that H (plane x - 1) reads level t's E of plane x at
// its own cell only, and the same thread wrote it.
//
// On an NVIDIA H100 80GB HBM3 at 700 W a launch of T = 4 takes 196 us at
// the microstrip q5 grid (the march before it 287 us), 946 us at the
// 8-variant sweep with all live (1,883 us), 829 us on the tall PML_8
// slab (1,088 us) and 971 us on the mixed PML_8 grid (1,281 us), a 14x14
// core: 10-13% of the bytes bound. The levels, not the bytes, still bound
// it: about 270 instructions a thread a level across 16 warps an SM,
// with each barrier draining them (PERF.md).

constexpr int kXs = 8;  // floats of one plane's x scalars: ipx, idx, bh, ch,
                        // be, ce, the stamp flags, a pad
constexpr int kSmemLimit = 232448;  // shared memory one block may use, bytes

// Floats a region cell holds in cpml_march_kernel's rings at T.
__host__ __device__ constexpr int cpml_floats(int T) {
  return 6 * (T + 2) + 6 * (T + 1) + 12 * T;
}

// cpml_march_kernel's stride at T: the rings hold kP = cpml_stride(T) cells
// a component and plane whatever the block's region (at most kP cells), so
// every offset but a y neighbour's is a constant: the most cells whose
// rings fit kSmemLimit beside the scalars, at most kMarchThreads, a
// multiple of 4 (508 at T = 4, 576 at T <= 3).
__host__ __device__ constexpr int cpml_stride(int T) {
  const int fit = (kSmemLimit / 4 - kXs * (T + 1)) / cpml_floats(T) / 4 * 4;
  return fit < kMarchThreads ? fit : kMarchThreads;
}

// One float from global to shared memory, asynchronously (cp.async; a
// 4-byte copy goes through the L1), and the group and wait of such copies.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(to), "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The derivative axis of psi m (order xy xz yz yx zx zy): its profile's.
__host__ __device__ constexpr int psi_axis(int m) {
  return m == 0 || m == 5 ? 1 : m < 3 ? 2 : 0;
}

// One side's six psi of one cell at one level, in place in p:
// p = b p + c d for a psi whose axis is on (outside its flat run), from the
// level-1 registers `in` (first) or the cell's slot S (stride P); 0 where
// the axis is off.
__device__ __forceinline__ void psi_level(const bool on[3], const float b[3],
                                          const float cf[3], bool first,
                                          const float (&in)[6], const float* S,
                                          int P, const float d[6],
                                          float p[6]) {
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    const int ax = psi_axis(m);
    p[m] = 0.f;
    if (on[ax]) p[m] = b[ax] * (first ? in[m] : S[m * P]) + cf[ax] * d[m];
  }
}

// Store one side's psi that are on: to the slot S below level T; at level
// T to the device arrays `out` (index g) where `write` (a core cell of the
// block's segment), else nowhere.
__device__ __forceinline__ void psi_store(const bool on[3], const float p[6],
                                          float* S, int P, float* const* out,
                                          int64_t g, bool last, bool write) {
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    if (!on[psi_axis(m)]) continue;
    if (!last) {
      S[m * P] = p[m];
    } else if (write) {
      out[m][g] = p[m];
    }
  }
}

// The curl from the differences d (psi order) plus the psi p:
// ((d0 + p0) - (d1 + p1), (d2 + p2) - (d3 + p3), (d4 + p4) - (d5 + p5)).
__device__ __forceinline__ void curl_psi(const float d[6], const float p[6],
                                         float cu[3]) {
  cu[0] = (d[0] + p[0]) - (d[1] + p[1]);
  cu[1] = (d[2] + p[2]) - (d[3] + p[3]);
  cu[2] = (d[4] + p[4]) - (d[5] + p[5]);
}

// Whether index i lies outside the flat run of side s and axis d.
__device__ __forceinline__ bool psi_on(const StreamArgs& a, int s, int d,
                                       int i) {
  return i < a.flat[s][d][0] || i >= a.flat[s][d][1];
}

template <bool kBatch, int kT>
__global__ void __launch_bounds__(kMarchThreads, 1)
cpml_march_kernel(const StreamArgs a, const Samples wf) {
  constexpr int R = kT + 2;   // field ring
  constexpr int Rc = kT + 1;  // coefficient and scalar rings
  constexpr int kP = cpml_stride(kT);
  if (kBatch && __ldg(a.active + blockIdx.y) == 0) return;  // frozen variant
  extern __shared__ float sm[];
  int bid = blockIdx.x;
  const int tz = bid % a.m_tiles[1];
  bid /= a.m_tiles[1];
  const int ty = bid % a.m_tiles[0];
  const int seg = bid / a.m_tiles[0];
  const int n0 = a.n[0], n1 = a.n[1], n2 = a.n[2];
  const int cy0 = max(0, ty * a.m_core[0] - a.m_origin[0]);
  const int cy1 = min(n1, (ty + 1) * a.m_core[0] - a.m_origin[0]);
  const int cz0 = max(0, tz * a.m_core[1] - a.m_origin[1]);
  const int cz1 = min(n2, (tz + 1) * a.m_core[1] - a.m_origin[1]);
  const int x0 = max(0, seg * a.m_seg - a.m_seg_origin);
  const int x1 = min(n0, (seg + 1) * a.m_seg - a.m_seg_origin);
  if (cy0 >= cy1 || cz0 >= cz1 || x0 >= x1) return;
  const int ry = max(0, cy0 - kT), rz = max(0, cz0 - kT);
  const int Ly = min(n1, cy1 + kT) - ry, Lz = min(n2, cz1 + kT) - rz;
  // shared memory, each array kP cells a component and plane: E ring
  // [R][3], H ring [R][3], the psi slots [kT][12] (psi_e 0..5, psi_h
  // 6..11), the coefficient ring [Rc][3] of (ca, cb) pairs, each cell's its
  // thread's own; then the x scalars X [Rc][kXs]
  float* Er = sm;
  float* Hr = Er + 3 * R * kP;
  float* Ps = Hr + 3 * R * kP;
  float2* C = reinterpret_cast<float2*>(Ps + 12 * kT * kP);
  float* X = reinterpret_cast<float*>(C + 3 * Rc * kP);
  constexpr int total = kP * cpml_floats(kT) + kXs * Rc;
  for (int i = threadIdx.x; i < total; i += blockDim.x) sm[i] = 0.f;

  const int c = threadIdx.x;  // this thread's region cell
  const bool live = c < Ly * Lz;
  const int j = live ? c / Lz : 0;
  const int k = live ? c - j * Lz : 0;
  const int gy = ry + j, gz = rz + k;
  const int64_t plane = (int64_t)n1 * n2;
  const int64_t cell = (int64_t)gy * n2 + gz;
  // the variant's offset, and this cell's index into its own arrays
  const int64_t vcell = cell + (kBatch ? (int64_t)blockIdx.y * a.vstride : 0);
  const bool yp = j + 1 < Ly, zp = k + 1 < Lz, ym = j > 0, zm = k > 0;
  const float ipy = live ? __ldg(a.inv_p[1] + gy) : 0.f;
  const float ipz = live ? __ldg(a.inv_p[2] + gz) : 0.f;
  const float idy = live ? __ldg(a.inv_d[1] + gy) : 0.f;
  const float idz = live ? __ldg(a.inv_d[2] + gz) : 0.f;
  // level t updates the cells with dist <= kT - t: the box
  // [c0 - kT + t - 1, c1 + kT - t) in y and z
  const int dist = max(max(cy0 - gy - 1, gy - cy1 + 1),
                       max(cz0 - gz - 1, gz - cz1 + 1));
  const bool core = live && gy >= cy0 && gy < cy1 && gz >= cz0 && gz < cz1;
  // which of this cell's y and z psi groups can change, per side (0 H,
  // 1 E; slot 0 of on/b/cf is the plane's x group, set per level), and
  // their profile values
  bool on[2][3] = {{false, false, false}, {false, false, false}};
  float pb[2][3] = {{1.f, 1.f, 1.f}, {1.f, 1.f, 1.f}};
  float pc[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  float pin[2][6];  // level 1's psi (H, E) of plane p - 1, loaded ahead
  if (live) {
#pragma unroll
    for (int sd = 0; sd < 2; ++sd) {
      const float* const* bp = sd ? a.be : a.bh;
      const float* const* cp = sd ? a.ce : a.ch;
      on[sd][1] = psi_on(a, sd, 1, gy);
      on[sd][2] = psi_on(a, sd, 2, gz);
      if (on[sd][1]) { pb[sd][1] = __ldg(bp[1] + gy); pc[sd][1] = __ldg(cp[1] + gy); }
      if (on[sd][2]) { pb[sd][2] = __ldg(bp[2] + gz); pc[sd][2] = __ldg(cp[2] + gz); }
    }
  }
  // the x scalar this thread copies a plane (threads 0..6), from its array
  const float* xsrc = nullptr;
  switch (threadIdx.x) {
    case 0: xsrc = a.inv_p[0]; break;
    case 1: xsrc = a.inv_d[0]; break;
    case 2: xsrc = a.bh[0]; break;
    case 3: xsrc = a.ch[0]; break;
    case 4: xsrc = a.be[0]; break;
    case 5: xsrc = a.ce[0]; break;
    case 6: xsrc = reinterpret_cast<const float*>(a.src_planes); break;
    default: break;
  }
  // this cell in each ring: its components kP apart, its y neighbours Lz
  float* const Ec = Er + c;
  float* const Hc = Hr + c;
  float* const Sc = Ps + c;
  float2* const Kc = C + c;

  const int xs = max(0, x0 - kT);   // planes loaded: [xs, xl)
  const int xl = min(n0, x1 + kT);
  float pre[6];                     // the next plane, in flight
  if (live) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      pre[m] = __ldg(a.e_in[m] + xs * plane + vcell);
      pre[3 + m] = __ldg(a.h_in[m] + xs * plane + vcell);
    }
  }
  __syncthreads();  // the zeroed shared memory

  // the slots of plane p: fields, coefficients and scalars, psi
  int sp = xs % R, cp = xs % Rc, pp = xs % kT;
  for (int p = xs; p <= x1 - 1 + kT; ++p) {
    if (p < xl) {
      if (live) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          Ec[(sp * 3 + m) * kP] = pre[m];
          Hc[(sp * 3 + m) * kP] = pre[3 + m];
        }
        if (p + 1 < xl) {
          const int64_t g = (p + 1) * plane + vcell;
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            pre[m] = __ldg(a.e_in[m] + g);
            pre[3 + m] = __ldg(a.h_in[m] + g);
          }
        }
        // plane p's ca and cb into its slot (plane p - T - 1's is past
        // its last level), first read in the next iteration
        float2* K = Kc + cp * 3 * kP;
        const int64_t g = p * plane + vcell;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          copy_async(&K[m * kP].x, a.ca[m] + g);
          copy_async(&K[m * kP].y, a.cb[m] + g);
        }
      }
      if (xsrc != nullptr) copy_async(X + cp * kXs + threadIdx.x, xsrc + p);
    }
    copy_commit();
    copy_wait<1>();  // all but this iteration's: plane p - 1's have landed
    __syncthreads();

#pragma unroll
    for (int t = 1; t <= kT; ++t) {
      const int x = p - t;
      const int lo = max(0, x0 - kT + t - 1);
      if (x >= lo && x < min(n0, x1 + kT - t)) {
        const float s = wf.s[t - 1];
        // the slots of planes x, x - 1 and x + 1, of x's coefficients and
        // scalars, and of x's psi (t <= kT < R and t < Rc: one wrap each)
        const int sx = sp - t < 0 ? sp - t + R : sp - t;
        const int sxm = sx == 0 ? R - 1 : sx - 1;
        const int sxp = sx == R - 1 ? 0 : sx + 1;
        const int cx = cp - t < 0 ? cp - t + Rc : cp - t;
        const int px = pp - t < 0 ? pp - t + kT : pp - t;
        float* const E = Ec + sx * 3 * kP;
        float* const H = Hc + sx * 3 * kP;
        const float* const Hm = Hc + sxm * 3 * kP;
        const float* const Ep = Ec + sxp * 3 * kP;
        const bool xm = x > 0, xp = x + 1 < n0;
        const float* const Xp = X + cx * kXs;
        float* const S = Sc + px * 12 * kP;
        const bool act = live && dist <= kT - t;
        const bool last = t == kT;
        const bool wout = core && x >= x0 && x < x1;
        const int64_t gx = x * plane + vcell;
#pragma unroll
        for (int sd = 0; sd < 2; ++sd) {
          on[sd][0] = psi_on(a, sd, 0, x);
          pb[sd][0] = Xp[2 + 2 * sd];
          pc[sd][0] = Xp[3 + 2 * sd];
        }

        // H at level t from level t-1's E at x and x+1
        if (act) {
          const float ex = E[0], ey = E[kP], ez = E[2 * kP];
          const float ez_yp = yp ? E[2 * kP + Lz] : 0.f;
          const float ey_zp = zp ? E[kP + 1] : 0.f;
          const float ex_zp = zp ? E[1] : 0.f;
          const float ez_xp = xp ? Ep[2 * kP] : 0.f;
          const float ey_xp = xp ? Ep[kP] : 0.f;
          const float ex_yp = yp ? E[Lz] : 0.f;
          const float ipx = Xp[0];
          // forward differences in psi order: dEz/dy, dEy/dz, dEx/dz,
          // dEz/dx, dEy/dx, dEx/dy
          const float d[6] = {(ez_yp - ez) * ipy, (ey_zp - ey) * ipz,
                              (ex_zp - ex) * ipz, (ez_xp - ez) * ipx,
                              (ey_xp - ey) * ipx, (ex_yp - ex) * ipy};
          float ps[6], cu[3];
          psi_level(on[0], pb[0], pc[0], t == 1, pin[0], S + 6 * kP, kP, d, ps);
          psi_store(on[0], ps, S + 6 * kP, kP, a.ph_out, gx, last, wout);
          curl_psi(d, ps, cu);
          H[0] = H[0] - a.dtmu * cu[0];
          H[kP] = H[kP] - a.dtmu * cu[1];
          H[2 * kP] = H[2 * kP] - a.dtmu * cu[2];
        }
        __syncthreads();

        // E at level t: E' = ca E + cb curl (+ src s on a flagged plane)
        if (act) {
          const float hx = H[0], hy = H[kP], hz = H[2 * kP];
          const float hz_ym = ym ? H[2 * kP - Lz] : 0.f;
          const float hy_zm = zm ? H[kP - 1] : 0.f;
          const float hx_zm = zm ? H[-1] : 0.f;
          const float hz_xm = xm ? Hm[2 * kP] : 0.f;
          const float hy_xm = xm ? Hm[kP] : 0.f;
          const float hx_ym = ym ? H[-Lz] : 0.f;
          const float idx_ = Xp[1];
          // backward differences in psi order: dHz/dy, dHy/dz, dHx/dz,
          // dHz/dx, dHy/dx, dHx/dy
          const float d[6] = {(hz - hz_ym) * idy, (hy - hy_zm) * idz,
                              (hx - hx_zm) * idz, (hz - hz_xm) * idx_,
                              (hy - hy_xm) * idx_, (hx - hx_ym) * idy};
          float ps[6], cu[3];
          psi_level(on[1], pb[1], pc[1], t == 1, pin[1], S, kP, d, ps);
          psi_store(on[1], ps, S, kP, a.pe_out, gx, last, wout);
          curl_psi(d, ps, cu);
          const float2* K = Kc + cx * 3 * kP;
          const int stamped = __float_as_int(Xp[6]);
          float v[3];
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            const float2 ab = K[m * kP];
            v[m] = ab.x * E[m * kP] + ab.y * cu[m];
            if (stamped >> m & 1) v[m] = v[m] + __ldg(a.src[m] + x * plane + cell) * s;
            E[m * kP] = v[m];
          }
          // after level T the core is final: write it to the other set
          if (last && wout) {
#pragma unroll
            for (int m = 0; m < 3; ++m) {
              a.e_out[m][gx] = v[m];
              a.h_out[m][gx] = H[m * kP];
            }
          }
        }
        // no barrier here (see above)
      }
      // plane p's psi, for its level 1 in the next iteration (level 1 of
      // this one has used the registers)
      if (t == 1 && live && p < xl) {
        const int64_t g = p * plane + vcell;
        const bool onx[2] = {psi_on(a, 0, 0, p), psi_on(a, 1, 0, p)};
#pragma unroll
        for (int sd = 0; sd < 2; ++sd) {
          const float* const* in = sd ? a.pe_in : a.ph_in;
#pragma unroll
          for (int m = 0; m < 6; ++m) {
            const int ax = psi_axis(m);
            const bool use = ax == 0 ? onx[sd] : on[sd][ax];
            pin[sd][m] = use ? __ldg(in[m] + g) : 0.f;
          }
        }
      }
    }
    // the last level's E before the next plane's copies reuse its slots
    __syncthreads();
    sp = sp + 1 == R ? 0 : sp + 1;
    cp = cp + 1 == Rc ? 0 : cp + 1;
    pp = pp + 1 == kT ? 0 : pp + 1;
  }
  copy_wait<0>();
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static int64_t march_smem_bytes(const StreamArgs* a, int T) {
  const int64_t cells = march_cells(*a, T);
  const int64_t floats = a->has_pml
      ? (int64_t)cpml_stride(T) * cpml_floats(T) + kXs * (T + 1)
      : cells * march_floats(*a, T);
  return floats * (int64_t)sizeof(float);
}

// The checks of a batched launch: a device mask, a stride that holds one
// variant's arrays, and at most 65,535 variants (the grid's y extent).
static bool batch_ok(const StreamArgs* a, int batch) {
  return batch >= 1 && batch <= 65535 && a->active != nullptr &&
         a->vstride >= (long long)a->n[0] * a->n[1] * a->n[2];
}

// The kernel of a T-step launch: march_kernel, or cpml_march_kernel's
// instance at T where a->has_pml.
template <bool kBatch, int kT = 1>
static const void* cpml_kernel(int T) {
  if constexpr (kT > kMaxT) {
    return nullptr;
  } else {
    return T == kT ? (const void*)cpml_march_kernel<kBatch, kT>
                   : cpml_kernel<kBatch, kT + 1>(T);
  }
}

template <bool kBatch>
static const void* kernel_of(const StreamArgs* a, int T) {
  return a->has_pml ? cpml_kernel<kBatch>(T) : (const void*)march_kernel<kBatch>;
}

template <bool kBatch>
static int march_launch(const StreamArgs* a, const Samples& s, int T,
                        int batch, void* stream) {
  const int threads = (march_cells(*a, T) + 31) / 32 * 32;
  if (threads > kMarchThreads ||
      (a->has_pml && march_cells(*a, T) > cpml_stride(T)))
    return (int)cudaErrorInvalidConfiguration;
  const int64_t bytes = march_smem_bytes(a, T);
  const void* fn = kernel_of<kBatch>(a, T);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)a->m_tiles[0] * a->m_tiles[1] * a->m_segs,
                    kBatch ? (unsigned)batch : 1u);
  StreamArgs args = *a;
  Samples samples = s;
  int steps = T;
  void* with_t[] = {(void*)&args, (void*)&steps, (void*)&samples};
  void* without_t[] = {(void*)&args, (void*)&samples};
  err = cudaLaunchKernel(fn, blocks, dim3(threads),
                         a->has_pml ? without_t : with_t, (size_t)bytes,
                         (cudaStream_t)stream);
  return err == cudaSuccess ? (int)cudaGetLastError() : (int)err;
}

// Blocks of a T-step launch one SM holds at once (the occupancy API: the
// kernel's registers, its threads and its shared memory), or a CUDA error
// code negated.
static int march_blocks_per_sm(const StreamArgs* a, int T) {
  if (T < 1 || T > kMaxT) return -(int)cudaErrorInvalidValue;
  const int threads = (march_cells(*a, T) + 31) / 32 * 32;
  const int64_t bytes = march_smem_bytes(a, T);
  const void* fn = kernel_of<false>(a, T);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads,
                                                        (size_t)bytes);
  return err == cudaSuccess ? n : -(int)err;
}

// T steps through the march: cpml_march_kernel where a->has_pml (which
// takes no MUR walls, and needs the stamp flags), else march_kernel.
template <bool kBatch>
static int march(const StreamArgs* a, const float* wf, int T, int batch,
                 void* stream) {
  if (T < 1 || T > kMaxT || (a->has_pml && a->has_mur) ||
      (a->has_pml && a->src_planes == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kBatch && !batch_ok(a, batch)) return (int)cudaErrorInvalidValue;
  Samples s = {};
  for (int k = 0; k < T; ++k) s.s[k] = wf[k];
  return march_launch<kBatch>(a, s, T, batch, stream);
}

extern "C" {

int fdtd_stream_args_size() { return (int)sizeof(StreamArgs); }

int fdtd_stream_max_t() { return kMaxT; }

const char* fdtd_stream_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

long long fdtd_march_smem_bytes(const StreamArgs* a, int T) {
  return (long long)march_smem_bytes(a, T);
}

int fdtd_march_blocks_per_sm(const StreamArgs* a, int T) {
  return march_blocks_per_sm(a, T);
}

int fdtd_stream_march(const StreamArgs* a, const float* wf, int T,
                      void* stream) {
  return march<false>(a, wf, T, 1, stream);
}

// T steps of every variant b with active[b] != 0 (a->active: `batch` ints
// on the device) through the march.
int fdtd_stream_march_batch(const StreamArgs* a, const float* wf, int T,
                            int batch, void* stream) {
  return march<true>(a, wf, T, batch, stream);
}

}  // extern "C"
