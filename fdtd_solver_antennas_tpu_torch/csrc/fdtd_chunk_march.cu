// The marched form of the batched chunk stepper for Hopper (sm_90a), bound
// to Python with ctypes (ops/chunk_march.py).
//
// Replaces: fdtd_solver_antennas_tpu/ops/fdtd_pallas.py::build_pallas_chunk_stepper
// under jax.vmap (fdtd_solver_antennas_tpu/solvers/sweep.py::_make_vmapped_run),
// K1 batched: one termination chunk, n_sub probe intervals of D leapfrog
// steps, of B design variants of one grid, with the probe samples taken in
// the kernel. csrc/fdtd_chunk.cu's chunk_batch_kernel does the same chunk
// as whole-grid passes, two grid barriers a step, reading every operand
// from memory in every pass once the batch spills the 50 MB L2. This form
// reuses each variant's planes across T = 3 steps instead:
//
//   for each round of T steps (an interval is floor(D/T) rounds of T, then
//   one of D mod T):
//     every item (variant, y-z tile, x segment) is marched along x by one
//     block with T time levels of a ring of planes in shared memory (the
//     march of csrc/fdtd_stream.cu), reading field set `set` and writing
//     the other set;
//     -- a barrier among the blocks of each variant --
//   after an interval's last round, each item's block gathers its share of
//   the variant's probe rows from the set that round wrote into
//   out[b, j, :].
//
// One cooperative launch a chunk, as chunk_batch_kernel: the blocks loop
// over the items (item i = b * items a variant + tile, block k takes i = k,
// k + blocks, ...), all resident at once.
//
// The march (per item and round) is march_kernel's under MUR and PEC, with
// the same per-cell arithmetic, order and wall order (x, then y, then z;
// the deferred lower x wall, the held-over upper x wall) and the same
// semantics: those of T calls of ops/fdtd_cuda.py::leapfrog_step. What
// differs:
//   - a fixed layout: T = 3 and a block's cells are the box of its core
//     and T cells a side (one thread a cell, at most kP = 640; the part
//     outside the round's region, the core and T cells a side clipped to
//     the grid, stays 0 and is never written), a field's components kP
//     apart whatever the core, so most shared-memory offsets are constants
//     and the levels are unrolled. The core tile is the host's
//     (ops/chunk_march.py picks it);
//   - every plane comes in by cp.async, one plane ahead, straight into its
//     ring slot: when plane p enters, its thread copies plane p + 1's six
//     field values into the field ring and plane p's ca, cb and source
//     stamps into the coefficient ring (each cell its thread's own), and
//     one thread plane p's two x profile values; the copies of plane p + 1
//     fly while plane p's T levels compute, and no register holds them.
//     Each ring has one slot more than the levels read, the one in flight:
//     the fields T + 3 (levels read planes p - T - 1 .. p), the
//     coefficients T + 2 under MUR (plane 0's are read up to plane T + 1's
//     iteration) and T + 1 under PEC. Every level reads its coefficients
//     from there; K2's march reads them from memory at every level. The
//     copies are 4 bytes (a cell a thread), which cp.async takes only
//     through the L1: the fields read are those other blocks wrote in the
//     round before, behind the acquire of the variant's counter, which
//     invalidates the SM's L1;
//   - the round's samples sit in shared memory;
//   - no launch between rounds, and no gather launch between intervals.
//
// Synchronization. A round of one variant reads only that variant's cells,
// so the blocks of one variant wait for each other and for no one else:
// bar[b] counts variant b's items done in this launch (zeroed before the
// launch); an item of round r of variant b starts when bar[b] reaches
// r * items a variant. A frozen variant (active[b] == 0) has no items to
// run and is waited on by no one. A round writes the set that the round
// before read only after every block of the variant has finished that
// round, and a gather reads a set that the next round does not write.
//
// Field sets: set 0 is the variant's current E buffer and H set, set 1 the
// other E buffer and H set (ops/fdtd_cuda.py::YeeBatch: e[p], e[1 - p], h,
// h1). After R rounds the result lies in set R mod 2; the host records it
// in each active variant's parity and H set.
//
// Shared memory per block, in floats a cell of kP: the E and H rings
// 6 (T + 3) = 36; under MUR the old E of two planes 6 and the upper x
// wall's fixed components 2; the coefficient ring 9 (T + 2) = 45 under
// MUR, 9 (T + 1) = 36 under PEC; then 2 floats a coefficient slot for the
// x profiles and T for the samples: 227,892 B under MUR, 184,364 B under
// PEC, whatever the grid; with 96 B of static shared memory one block an
// SM, 640 threads (a 96-register cap a thread; 89 used under MUR, 79
// under PEC, no spills). At the 8-variant sweep (MUR; 14 x 25 cores, 8 x 2
// tiles, one segment of 100 planes, 128 blocks) a launch of 2 x 244 steps
// takes 66.8 ms (136.8 us a step); the same march with each plane loaded
// into registers a plane ahead and stored to shared memory by its thread
// took 70.6 ms, the streamed form 81.9 ms, in the same call on an NVIDIA
// H100 80GB HBM3 at 700 W (examples/compare_builds.py --sweep; PERF.md).
// The levels are bound by the issue of their shared-memory and integer
// work and the block barriers between their phases, with 20 warps an SM
// to hide it (two cells a thread, half the warps, was slower).
//
// CPML is not taken: its twelve psi slots and the staged coefficients do
// not fit one block together (the plan keeps the streamed form there).
//
// What bounds it: per round each item reads its region's fields once and
// writes its core once, reads its coefficients once, and the variant's
// source stamps once; the y-z halo makes that about (core + 2T)^2 / core^2
// of the cells. At the sweep that is 4.19 M variant-cells moving 24 B of
// fields in and out and 28 B of coefficients per T steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py). No
// fused multiply-add, so each cell's arithmetic rounds like the plain
// PyTorch twin, one operation at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_rows.cuh"

namespace {

constexpr int kT = 3;      // steps of a full round
constexpr int kP = 640;    // a block's cells (threads) at most, and the
                           // stride of a field's components in the rings
constexpr int kR = kT + 3;  // field ring: planes p - T - 1 .. p, and p + 1
constexpr int kNco = 9;    // staged floats a cell and plane: ca, cb, stamps
constexpr int kGatherUnroll = 4;

// Coefficient ring: planes p - T .. p - 1 read, plane p in flight, and
// under MUR plane 0's held for plane 1's step.
__host__ __device__ constexpr int coef_planes(bool mur) {
  return kT + 1 + (mur ? 1 : 0);
}

}  // namespace

// Mirrored field for field by ops/chunk_march.py::_MarchArgs (ctypes).
struct MarchArgs {
  float* f[2][6];          // field sets 0 and 1: Ex Ey Ez Hx Hy Hz, each
                           // (B, n0, n1, n2)
  const float* ca[3];      // (B, n0, n1, n2)
  const float* cb[3];
  const float* src[3];     // per-component source stamp (n0, n1, n2), or null
  const float* inv_p[3];   // 1 / primary spacing, per axis
  const float* inv_d[3];   // 1 / dual spacing, per axis
  ProbeTable probes;
  const int* active;       // B ints on the device: variant b steps
  int* bar;                // B ints on the device: items done (see above)
  int n[3];                // array shape
  int q[3];                // grid shape that places the MUR wall planes
  int has_mur;
  float dtmu;              // dt / mu0
  float mur_c[3][2];       // MUR coefficient per axis and side
  int m_core[2];           // y-z core tile: (core + 2T)^2 <= kP
  int m_origin[2];         // tile b covers [b*core - origin, (b+1)*core - origin)
  int m_tiles[2];
  int m_seg;               // x segment length, origin and count, as a tile
  int m_seg_origin;
  int m_segs;
  int x_lo;                // 1 where plane 0 is the lower MUR x wall
  int x_hi;                // the upper MUR x wall's plane, or -1
  int batch;
  long long vstride;       // cells of one variant
};

// Threads of a block with this core: its cells, rounded up to warps.
__host__ __device__ inline int block_threads(const MarchArgs& a) {
  return ((a.m_core[0] + 2 * kT) * (a.m_core[1] + 2 * kT) + 31) / 32 * 32;
}

// Floats of a block's shared memory: per layout cell the E and H rings of
// kR planes, under MUR the old E of two planes and the upper x wall's two
// fixed components, the coefficient ring of kNco floats a plane; then the
// x profiles (two floats a coefficient slot) and the round's samples.
__host__ __device__ constexpr int march_floats(bool mur) {
  return kP * (6 * kR + (mur ? 8 : 0) + coef_planes(mur) * kNco) +
         2 * coef_planes(mur) + kT;
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

// MUR on one wall cell of a y-z plane: E'[w] = Eo[nb] + c (E'[nb] - Eo[w])
// for the two components m0, m1 (the axes other than the wall's); E and O
// at the cell, cn the neighbour's offset.
__device__ __forceinline__ void march_fix(float* E, const float* O, int cn,
                                          float coef, int m0, int m1) {
  E[m0 * kP] = O[m0 * kP + cn] + coef * (E[m0 * kP + cn] - O[m0 * kP]);
  E[m1 * kP] = O[m1 * kP + cn] + coef * (E[m1 * kP + cn] - O[m1 * kP]);
}

// Backward differences of H at a cell (H at the cell, Hm at its plane
// x-1's, read where xm; a neighbour outside the region or the grid reads
// 0; lz the layout's row): dHz/dy, dHy/dz, dHx/dz, dHz/dx, dHy/dx, dHx/dy.
__device__ __forceinline__ void march_dh(const float* H, const float* Hm,
                                         bool xm, bool ym, bool zm, int lz,
                                         float idx_, float idy, float idz,
                                         float d[6]) {
  const float hx = H[0], hy = H[kP], hz = H[2 * kP];
  const float hz_ym = ym ? H[2 * kP - lz] : 0.f;
  const float hy_zm = zm ? H[kP - 1] : 0.f;
  const float hx_zm = zm ? H[-1] : 0.f;
  const float hz_xm = xm ? Hm[2 * kP] : 0.f;
  const float hy_xm = xm ? Hm[kP] : 0.f;
  const float hx_ym = ym ? H[-lz] : 0.f;
  d[0] = (hz - hz_ym) * idy;
  d[1] = (hy - hy_zm) * idz;
  d[2] = (hx - hx_zm) * idz;
  d[3] = (hz - hz_xm) * idx_;
  d[4] = (hy - hy_xm) * idx_;
  d[5] = (hx - hx_ym) * idy;
}

// E at a cell from its staged coefficients K (ca at 0..2, cb at 3..5, the
// stamps at 6..8, stride kP): E' = ca E + cb curl (+ src s) for the
// components in `stamped` (a bit a component), the old E saved to O (under
// MUR).
__device__ __forceinline__ void march_e_cell(const float* E, float* O,
                                             const float* K, unsigned stamped,
                                             const float cu[3], float s,
                                             float out[3]) {
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float old = E[m * kP];
    if (O) O[m * kP] = old;
    float v = K[m * kP] * old + K[(3 + m) * kP] * cu[m];
    if (stamped >> m & 1u) v = v + K[(6 + m) * kP] * s;
    out[m] = v;
  }
}

// One item of one round: Tr <= kT steps of variant vb's tile (ty, tz) of
// segment seg, from field set `set` into the other, the source sample of
// step t at wf[t - 1]. The march of csrc/fdtd_stream.cu (its header
// describes the levels, boxes and walls) on a fixed layout: the block's
// cells are the kT-halo square around the core, cell c at (cy0 - kT + c /
// side, cz0 - kT + c % side), so every shared-memory offset is a constant;
// the round's region, the core and Tr cells a side clipped to the grid, is
// the march's, and a cell outside it stays 0 and is never written.
template <bool kMur>
__device__ __forceinline__ void march_item(const MarchArgs& a, const int vb,
                                           const int ty, const int tz,
                                           const int seg, const int Tr,
                                           const float* __restrict__ wf,
                                           const int set) {
  constexpr int Tc = coef_planes(kMur);
  extern __shared__ float sm[];
  const int n0 = a.n[0], n1 = a.n[1], n2 = a.n[2];
  const int kLz = a.m_core[1] + 2 * kT;  // the layout's row: y neighbours
  const int cy0 = max(0, ty * a.m_core[0] - a.m_origin[0]);
  const int cy1 = min(n1, (ty + 1) * a.m_core[0] - a.m_origin[0]);
  const int cz0 = max(0, tz * a.m_core[1] - a.m_origin[1]);
  const int cz1 = min(n2, (tz + 1) * a.m_core[1] - a.m_origin[1]);
  const int x0 = max(0, seg * a.m_seg - a.m_seg_origin);
  const int x1 = min(n0, (seg + 1) * a.m_seg - a.m_seg_origin);
  if (cy0 >= cy1 || cz0 >= cz1 || x0 >= x1) return;
  const int ry0 = max(0, cy0 - Tr), ry1 = min(n1, cy1 + Tr);  // the region
  const int rz0 = max(0, cz0 - Tr), rz1 = min(n2, cz1 + Tr);
  // shared memory: E ring [kR][3][kP], H ring [kR][3][kP]; under MUR the
  // old E of the planes a step fixes, O [2][3][kP] (by plane parity), and
  // the upper x wall's x-fixed Ey, Ez, W [2][kP]; then the coefficient
  // ring C [Tc][kNco][kP], each cell's its thread's own; then the x
  // profiles of the coefficient ring's planes, X[Tc] (1 / primary
  // spacing) and X[Tc + Tc] (dual), and the round's samples at X[2 Tc]
  float* Er = sm;
  float* Hr = Er + 3 * kR * kP;
  float* O = Hr + 3 * kR * kP;
  float* W = O + 6 * kP;
  float* C = kMur ? W + 2 * kP : O;
  float* X = C + Tc * kNco * kP;
  constexpr int total = march_floats(kMur);
  const int xs = max(0, x0 - Tr);  // planes loaded: [xs, xl)
  const int xl = min(n0, x1 + Tr);
  __syncthreads();  // the item before has read its shared memory
  for (int i = threadIdx.x; i < total; i += blockDim.x) sm[i] = 0.f;
  if (threadIdx.x < Tr) X[2 * Tc + threadIdx.x] = __ldg(wf + threadIdx.x);
  // this round's input and output sets, by value into a table in shared
  // memory (a.f[set] with a run-time index, or the twelve pointers in
  // registers, spill)
  __shared__ float* io[2][6];
  if (threadIdx.x < 12) {
    const int m = threadIdx.x % 6, out = threadIdx.x / 6;
    io[out][m] = (set != out) ? a.f[1][m] : a.f[0][m];
  }

  const int c = threadIdx.x;  // this thread's layout cell
  const int gy = cy0 - kT + c / kLz, gz = cz0 - kT + c % kLz;
  const bool live = gy >= ry0 && gy < ry1 && gz >= rz0 && gz < rz1;
  // level t updates the cells with d <= Tr - t: the march's box
  // [c0 - Tr + t - 1, c1 + Tr - t) in y and z
  const int d = max(max(cy0 - gy - 1, gy - cy1 + 1), max(cz0 - gz - 1, gz - cz1 + 1));
  const bool core = live && gy >= cy0 && gy < cy1 && gz >= cz0 && gz < cz1;
  const bool yp = gy + 1 < ry1, zp = gz + 1 < rz1, ym = gy > ry0, zm = gz > rz0;
  const float ipy = live ? __ldg(a.inv_p[1] + gy) : 0.f;
  const float ipz = live ? __ldg(a.inv_p[2] + gz) : 0.f;
  const float idy = live ? __ldg(a.inv_d[1] + gy) : 0.f;
  const float idz = live ? __ldg(a.inv_d[2] + gz) : 0.f;
  const int64_t plane = (int64_t)n1 * n2;
  const int64_t vcell = (int64_t)vb * a.vstride + (int64_t)gy * n2 + gz;
  const int64_t scell = (int64_t)gy * n2 + gz;  // the stamps' (shared) index
  const float dtmu = a.dtmu;
  const int x_lo = a.x_lo, x_hi = a.x_hi;
  unsigned stamped = 0;
#pragma unroll
  for (int m = 0; m < 3; ++m) stamped |= (a.src[m] != nullptr ? 1u : 0u) << m;
  // MUR walls of y and z at this cell: side (0 low, 1 high) or -1, its
  // coefficient and the neighbour's offset (the fix is skipped where the
  // neighbour lies outside the region)
  int yside = -1, zside = -1, yn = 0, zn = 0;
  float cy = 0.f, cz = 0.f;
  if (kMur && live) {
    if (gy == 0 && yp) { yside = 0; yn = kLz; }
    if (gy == a.q[1] - 1 && ym) { yside = 1; yn = -kLz; }
    if (gz == 0 && zp) { zside = 0; zn = 1; }
    if (gz == a.q[2] - 1 && zm) { zside = 1; zn = -1; }
    if (yside >= 0) cy = a.mur_c[1][yside];
    if (zside >= 0) cz = a.mur_c[2][zside];
  }
  const bool has_yw =
      kMur && (ry0 == 0 || (ry0 <= a.q[1] - 1 && a.q[1] - 1 < ry1));
  const bool has_zw =
      kMur && (rz0 == 0 || (rz0 <= a.q[2] - 1 && a.q[2] - 1 < rz1));

  // plane pl's six field values at this thread's cell into field slot
  // `slot`, in flight
  const auto fields_in = [&](const int pl, const int slot) {
    const int64_t g = pl * plane + vcell;
    float* E = Er + slot * 3 * kP + c;
    float* H = Hr + slot * 3 * kP + c;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      copy_async(E + m * kP, io[0][m] + g);
      copy_async(H + m * kP, io[0][3 + m] + g);
    }
  };
  __syncthreads();  // the zeroed shared memory, the samples and the table
  if (live) fields_in(xs, xs % kR);
  copy_commit();

  // ring slots of plane p: fields (mod kR), coefficients (mod Tc), kept
  // without a divide
  int sp = xs % kR, cp = xs % Tc;
  for (int p = xs; p <= x1 - 1 + Tr; ++p) {
    // plane p + 1's fields into the slot after plane p's (plane p - T - 2
    // is past its last level), plane p's coefficients and x profiles into
    // theirs (plane p - Tc is past its last level); both first read in the
    // next iteration
    if (p < xl) {
      if (live) {
        if (p + 1 < xl) fields_in(p + 1, sp + 1 == kR ? 0 : sp + 1);
        const int64_t g = p * plane;
        float* K = C + cp * kNco * kP + c;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          copy_async(K + m * kP, a.ca[m] + g + vcell);
          copy_async(K + (3 + m) * kP, a.cb[m] + g + vcell);
          if (stamped >> m & 1u) copy_async(K + (6 + m) * kP, a.src[m] + g + scell);
        }
      }
      if (threadIdx.x == 0) {
        copy_async(X + cp, a.inv_p[0] + p);
        copy_async(X + Tc + cp, a.inv_d[0] + p);
      }
    }
    copy_commit();
    copy_wait<1>();  // all but this iteration's: plane p's fields and
                     // plane p - 1's coefficients have landed
    __syncthreads();

#pragma unroll
    for (int t = 1; t <= kT; ++t) {
      if (t > Tr) break;
      const int x = p - t;
      const int lo = max(0, x0 - Tr + t - 1);
      if (x >= lo && x < min(n0, x1 + Tr - t)) {
        const float s = X[2 * Tc + t - 1];
        // the slots of planes x, x - 1 and x + 1 and of x's coefficients
        // (t <= Tr < kR and t < Tc, so one wrap each)
        const int sx = sp - t < 0 ? sp - t + kR : sp - t;
        const int sxm = sx == 0 ? kR - 1 : sx - 1;
        const int sxp = sx == kR - 1 ? 0 : sx + 1;
        const int cx = cp - t < 0 ? cp - t + Tc : cp - t;
        float* E = Er + sx * 3 * kP + c;
        float* H = Hr + sx * 3 * kP + c;
        const float* Hm = Hr + sxm * 3 * kP + c;
        const bool xm = x > 0, xp = x + 1 < n0;
        const bool act = live && d <= Tr - t;
        // the lower x wall's plane waits for plane 1 (see fdtd_stream.cu)
        const bool defer0 = kMur && x_lo && x == 0;
        const bool with0 = kMur && x_lo && x == 1 && lo == 0;
        const bool last = t == Tr;

        // H at level t from level t-1's E at x and x+1
        if (act) {
          const float* Ep = Er + sxp * 3 * kP + c;
          const float ex = E[0], ey = E[kP], ez = E[2 * kP];
          const float ez_yp = yp ? E[2 * kP + kLz] : 0.f;
          const float ey_zp = zp ? E[kP + 1] : 0.f;
          const float ex_zp = zp ? E[1] : 0.f;
          const float ez_xp = xp ? Ep[2 * kP] : 0.f;
          const float ey_xp = xp ? Ep[kP] : 0.f;
          const float ex_yp = yp ? E[kLz] : 0.f;
          const float ipx = X[cx];
          const float dd[6] = {(ez_yp - ez) * ipy, (ey_zp - ey) * ipz,
                               (ex_zp - ex) * ipz, (ez_xp - ez) * ipx,
                               (ey_xp - ey) * ipx, (ex_yp - ex) * ipy};
          H[0] = H[0] - dtmu * (dd[0] - dd[1]);
          H[kP] = H[kP] - dtmu * (dd[2] - dd[3]);
          H[2 * kP] = H[2 * kP] - dtmu * (dd[4] - dd[5]);
        }
        __syncthreads();

        // E at level t (and plane 0's, held back from the step before)
        if (act && !defer0) {
          float* Ox = kMur ? O + (x & 1) * 3 * kP + c : nullptr;
          float dd[6], cu[3], v[3];
          march_dh(H, Hm, xm, ym, zm, kLz, X[Tc + cx], idy, idz, dd);
          cu[0] = dd[0] - dd[1];
          cu[1] = dd[2] - dd[3];
          cu[2] = dd[4] - dd[5];
          march_e_cell(E, Ox, C + cx * kNco * kP + c, stamped, cu, s, v);
          E[0] = v[0];
          if (kMur && x == x_hi) {  // x-fixed by plane x_hi-1's step
            E[kP] = W[c];
            E[2 * kP] = W[kP + c];
          } else {
            E[kP] = v[1];
            E[2 * kP] = v[2];
          }
          if (kMur && x == x_hi - 1) {  // the upper x wall from this new E
            const float* Ew = Er + sxp * 3 * kP + c;  // still level t-1
            const float mc = a.mur_c[0][1];
            W[c] = Ox[kP] + mc * (v[1] - Ew[kP]);
            W[kP + c] = Ox[2 * kP] + mc * (v[2] - Ew[2 * kP]);
          }
          if (with0) {  // plane 0 (slot 0 of both rings): E from its own H
                        // and old E, then x-fixed
            float* E0 = Er + c;
            float* O0 = O + c;
            float d0[6], cu0[3], v0[3];
            march_dh(Hr + c, Hr + c, false, ym, zm, kLz, X[Tc], idy, idz,
                         d0);
            cu0[0] = d0[0] - d0[1];
            cu0[1] = d0[2] - d0[3];
            cu0[2] = d0[4] - d0[5];
            march_e_cell(E0, O0, C + c, stamped, cu0, s, v0);
            const float mc = a.mur_c[0][0];
            E0[0] = v0[0];
            E0[kP] = Ox[kP] + mc * (v[1] - O0[kP]);
            E0[2 * kP] = Ox[2 * kP] + mc * (v[2] - O0[2 * kP]);
          }
        }
        __syncthreads();

        // the y, then z walls of plane x (and of plane 0 with plane 1)
        if (has_yw) {
          if (act && yside >= 0) {
            if (!defer0) march_fix(E, O + (x & 1) * 3 * kP + c, yn, cy, 0, 2);
            if (with0) march_fix(Er + c, O + c, yn, cy, 0, 2);
          }
          __syncthreads();
        }
        if (has_zw) {
          if (act && zside >= 0) {
            if (!defer0) march_fix(E, O + (x & 1) * 3 * kP + c, zn, cz, 0, 1);
            if (with0) march_fix(Er + c, O + c, zn, cz, 0, 1);
          }
          __syncthreads();
        }

        // after level Tr the core is final: write it to the other field set
        if (last && core) {
          if (!defer0 && x >= x0 && x < x1) {
            const int64_t g = x * plane + vcell;
#pragma unroll
            for (int m = 0; m < 3; ++m) {
              io[1][m][g] = E[m * kP];
              io[1][3 + m][g] = H[m * kP];
            }
          }
          if (with0 && x0 == 0) {
#pragma unroll
            for (int m = 0; m < 3; ++m) {
              io[1][m][vcell] = Er[m * kP + c];
              io[1][3 + m][vcell] = Hr[m * kP + c];
            }
          }
        }
      }
    }
    sp = sp + 1 == kR ? 0 : sp + 1;
    cp = cp + 1 == Tc ? 0 : cp + 1;
  }
  copy_wait<0>();  // no copy is left in flight into the next item's rings
}

// Variant vb's probe rows that item iv of its per_v items gathers (rows iv
// * blockDim.x + thread, then every per_v * blockDim.x), from field set
// `set` into out (the variant's row of one interval).
__device__ __forceinline__ void gather_share(const MarchArgs& a, const int set,
                                             const int vb, const int iv,
                                             const int per_v,
                                             float* __restrict__ out) {
  const int64_t vo = (int64_t)vb * a.vstride;
  const float* f[6];
#pragma unroll
  for (int m = 0; m < 6; ++m) f[m] = (set ? a.f[1][m] : a.f[0][m]) + vo;
  const int rows = a.probes.rows;
  for (int r = iv * blockDim.x + threadIdx.x; r < rows;
       r += per_v * blockDim.x)
    out[r] = probe_row<kGatherUnroll, true>(a.probes.code, a.probes.w,
                                            a.probes.meta, r, f[0], f[1],
                                            f[2], f[3], f[4], f[5]);
}

// Wait until *count reaches target (thread 0 polls with acquire loads; the
// block then reads what the counted blocks wrote through the L2).
__device__ __forceinline__ void wait_count(const int* count, const int target) {
  if (threadIdx.x == 0) {
    int v;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                   : "=r"(v) : "l"(count) : "memory");
      if (v >= target) break;
      __nanosleep(32);
    }
  }
  __syncthreads();
}

// Count one item done: every thread's stores, then one release add.
__device__ __forceinline__ void signal_count(int* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1);
  }
}

// One termination chunk of every active variant: n_sub intervals of D steps
// from field set 0, the source sample of step s of interval j at
// wf[j * D + s], variant b's interval j samples into out[(b * n_sub + j) *
// probe rows ...]. Rounds of kT steps (one of D mod kT an interval).
template <bool kMur>
__global__ void __launch_bounds__(kP, 1)
chunk_march_kernel(const MarchArgs a, const float* __restrict__ wf,
                   const int n_sub, const int D, float* __restrict__ out) {
  const int tiles = a.m_tiles[0] * a.m_tiles[1];
  const int per_v = tiles * a.m_segs;
  const int items = per_v * a.batch;
  const int per_interval = (D + kT - 1) / kT;  // rounds
  const int rounds = n_sub * per_interval;
  const int rows = a.probes.rows;
  for (int r = 0; r <= rounds; ++r) {
    const int set = r & 1;  // the set round r reads and round r - 1 wrote
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int vb = it / per_v;
      if (__ldg(a.active + vb) == 0) continue;  // frozen variant
      const int iv = it - vb * per_v;
      if (r > 0) wait_count(a.bar + vb, r * per_v);
      if (r > 0 && r % per_interval == 0 && rows > 0)  // an interval ended
        gather_share(a, set, vb, iv, per_v,
                     out + ((int64_t)vb * n_sub + r / per_interval - 1) * rows);
      if (r == rounds) continue;
      const int s0 = (r % per_interval) * kT;
      const int tz = iv % a.m_tiles[1];
      const int ty = (iv / a.m_tiles[1]) % a.m_tiles[0];
      march_item<kMur>(a, vb, ty, tz, iv / tiles, min(kT, D - s0),
                       wf + (int64_t)(r / per_interval) * D + s0, set);
      signal_count(a.bar + vb);
    }
  }
}

namespace {

// by boundary: PEC, MUR
const void* const kKernels[2] = {(const void*)chunk_march_kernel<false>,
                                 (const void*)chunk_march_kernel<true>};

}  // namespace

static int64_t march_smem_bytes(const MarchArgs& a) {
  return (int64_t)march_floats(a.has_mur != 0) * (int64_t)sizeof(float);
}

static bool args_ok(const MarchArgs& a) {
  return a.batch >= 1 && a.m_core[0] >= 1 && a.m_core[1] >= 1 &&
         (a.m_core[0] + 2 * kT) * (a.m_core[1] + 2 * kT) <= kP &&
         a.active != nullptr && a.bar != nullptr &&
         a.vstride >= (long long)a.n[0] * a.n[1] * a.n[2];
}

static const void* kernel_of(const MarchArgs& a) {
  return kKernels[a.has_mur ? 1 : 0];
}

extern "C" {

int fdtd_chunk_march_args_size() { return (int)sizeof(MarchArgs); }

int fdtd_chunk_march_t() { return kT; }

int fdtd_chunk_march_cells() { return kP; }

const char* fdtd_chunk_march_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

long long fdtd_chunk_march_smem_bytes(const MarchArgs* a) {
  return (long long)march_smem_bytes(*a);
}

int fdtd_chunk_march_threads(const MarchArgs* a) { return block_threads(*a); }

// Blocks of the marched form one SM holds at once (the occupancy API on the
// kernel's registers, threads and shared memory), or a CUDA error negated.
int fdtd_chunk_march_blocks_per_sm(const MarchArgs* a) {
  if (!args_ok(*a)) return -(int)cudaErrorInvalidValue;
  const int64_t bytes = march_smem_bytes(*a);
  cudaError_t err = cudaFuncSetAttribute(
      kernel_of(*a), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel_of(*a), block_threads(*a), (size_t)bytes);
  return err == cudaSuccess ? n : -(int)err;
}

// One chunk, n_sub intervals of d steps, on `blocks` blocks (all resident:
// at most the occupancy times the SMs, at most the items): the source
// sample of step s of interval j at wf[n0 + j*d + s] (device memory),
// variant b's interval j samples into out[(b * n_sub + j) * probe rows ...].
int fdtd_chunk_march(const MarchArgs* a, const float* wf, int n0, int n_sub,
                     int d, float* out, int blocks, void* stream) {
  const int items = a->m_tiles[0] * a->m_tiles[1] * a->m_segs * a->batch;
  if (!args_ok(*a) || n_sub < 1 || d < 1 || n0 < 0 || wf == nullptr ||
      (a->probes.rows > 0 && out == nullptr) || blocks < 1 || blocks > items)
    return (int)cudaErrorInvalidValue;
  const int64_t bytes = march_smem_bytes(*a);
  cudaError_t err = cudaFuncSetAttribute(
      kernel_of(*a), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(a->bar, 0, sizeof(int) * a->batch,
                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  MarchArgs args = *a;
  const float* w = wf + n0;
  void* params[] = {(void*)&args, (void*)&w, (void*)&n_sub, (void*)&d,
                    (void*)&out};
  err = cudaLaunchCooperativeKernel(kernel_of(args), dim3(blocks),
                                    dim3(block_threads(args)), params,
                                    (size_t)bytes, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // extern "C"
