// Device code shared by the persistent steppers for Hopper (sm_90a): K1,
// csrc/fdtd_chunk.cu's chunk_steps (a termination chunk of a whole grid
// per launch, with the probe gather after each interval) and its batched
// form chunk_steps_batch (the same chunk for B design variants at once), K3,
// csrc/fdtd_shard.cu (K steps of one rank's x-slab per launch), and K4,
// csrc/fdtd_steps.cu (the D steps of one probe interval of a whole grid
// per launch). Each kernel is one cooperative launch that runs
//
//   load      each block's operands on chip (resident form only)
//   for each step:
//     H pass   each thread's cells: H -= dt/mu0 * curl E (+ 6 CPML psi_h)
//     -- grid barrier --
//     E pass   each thread's cells: E' = ca*E + cb*curl H (+ 6 CPML psi_e)
//              + src * wf[step], from e[p] into e[1-p], with the MUR walls
//              x -> y -> z fused in (below)
//     -- grid barrier --
//     p ^= 1
//
// so a step pays 2 grid barriers under every boundary. The barrier after
// H makes the new H visible to the E pass; the one after E makes the new
// E visible to the next H pass, and it is also what makes the next E pass
// safe to overwrite e[1-p], which this pass's wall threads read as e[p].
//
// The walls inside the E pass. The reference order is: every interior
// update, then the walls of x, then of y, then of z, each wall cell
//   E'[w] = E[nb] + c * (E'[nb] - E[w])
// with nb the inner neighbour across the wall, E the old buffer and E' the
// new one as the earlier walls left it. A component is tangential to two
// walls (Ex to y and z, ...), so a cell's final value is the fix of the
// last axis B (in x, y, z order) on which it sits on a wall. That fix
// reads E'[nb], which is nb's interior update or, when the cell also sits
// on a wall of the earlier axis A, nb's A fix, which reads the interior
// update of the diagonal cell: in both cases nb's own final value. The
// thread that owns a wall cell recomputes that one interior update itself
// (mur_fix and e_at, the same arithmetic as the owner of that cell) from H,
// which is complete, and the old E, which no thread writes in this pass,
// and writes only its own cell. In the resident form the
// neighbour of a z wall cell is usually the next or previous lane's cell,
// whose final value comes over by warp shuffle instead. So no E pass reads
// what another thread writes in it, and the result is bit for bit the
// sequential one. A neighbour outside the array (a slab's x walls may lie
// outside the slab) reads 0, as the plain twins do.
//
// Which cells a thread owns, and the two storage forms. The host picks
// one of two forms of the same kernel, a template parameter:
//
//   kCells in 1..kMaxCells, "resident": block b owns the contiguous cells
//     [b*per_block, (b+1)*per_block), per_block = ceil(cells / blocks), and
//     thread t the cells first + t + r*threads(kCells) for r < kCells, for
//     the whole launch; (i, j, k) is decoded once, and ca, cb, the source
//     stamp, the packed (i, j, k) and the per-axis profiles (inverse
//     spacings, CPML b/c) sit in the block's shared memory for the whole
//     launch: kWords words a cell plus the profiles. One cell a thread runs
//     as two blocks of 640 threads an SM, more as one block of 1,024;
//   kCells = 0, "streamed": a grid-stride loop over the whole grid, all
//     blocks together, (i, j, k) decoded and every operand read from
//     memory in each pass, for grids whose operands do not fit on chip.
//
// Fields (and the CPML psi) are read-write state and stay in device
// memory; at the sizes the resident form takes they sit in the 50 MB L2.
// The launch holds as many blocks as the occupancy query gives for the
// form launched, and no more than its cells need; a grid barrier's cost
// grows with blocks. The boundary (PEC, MUR or CPML) is a template
// parameter too, so no kernel carries code for another boundary.
//
// Batched launches (K1's chunk_steps_batch). B variants of one grid: the
// per-variant arrays (fields, psi, ca, cb) are (B, nx, ny, nz), variant b's
// cells at vo = b * nx*ny*nz; the source stamps and the profiles are shared.
// A cell's own index into a per-variant array is vo + c, c its index in the
// grid, which the source stamp reads. Frozen variants (Batch::active[b] == 0)
// are not stepped. The streamed form walks the flattened (variant, cell)
// space; the resident form gives each variant B-th of the blocks, so a
// block's cells lie inside one variant and its shared memory holds that
// variant's coefficients. The unbatched kernels pass vo = 0 and take the
// kBatch = false loops.
//
// Layout and edge semantics are K1's (csrc/fdtd_chunk.cu): contiguous
// (nx, ny, nz) float32 arrays, z fastest; a neighbour outside the array
// reads 0. Built with -fmad=false (ops/_build.py), so every cell rounds
// like the plain PyTorch twins.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace persist {

constexpr int kThreads = 1024;  // threads per block of every form but one:
constexpr int kThreadsOne = 640;  // the resident form with one cell a thread,
                                  // two blocks an SM (51 registers a thread)
constexpr int kMaxCells = 4;    // cells per thread of the resident form
constexpr int kWords = 10;      // words a resident cell holds on chip
constexpr int kWordIJK = 9;     // ... ca 0-2, cb 3-5, src 6-8, (i, j, k) 9
// (i, j, k) packed into one word: i < 2048, j < 2048, k < 1024
constexpr int kPackI = 2048, kPackJ = 2048, kPackK = 1024;

// 1-D profiles per axis: inverse primary and dual spacings, then the CPML
// b and c at half (H side) and node (E side) positions
enum { kIP = 0, kID, kBH, kCH, kBE, kCE, kProfs };

// The boundary a kernel is built for (a template parameter): PEC walls
// (nothing to fix), MUR walls, or CPML. MUR and CPML exclude each other.
enum { kPec = 0, kMur = 1, kCpml = 2, kFlavours };

// Mirrored field for field by ops/persist.py::PersistOps (ctypes).
struct Ops {
  float* e[2][3];                // E double buffer: e[p] current, e[1-p] next
  float* h[3];
  float* psi_e[6];               // CPML psi, order xy xz yz yx zx zy
  float* psi_h[6];
  const float* ca[3];
  const float* cb[3];
  const float* src[3];           // per-component source stamp, or null
  const float* prof[kProfs][3];  // CPML ones null without CPML
  int nx, ny, nz;                // array shape
  int wall_lo[3], wall_hi[3];    // MUR wall planes per axis (may lie outside)
  int has_pml, has_mur;
  float dtmu;                    // dt / mu0
  float mur_c[3][2];             // MUR coefficient per axis and side
};

// The variants of a batched launch: n of them, variant b stepped where
// active[b] != 0 (a device array). Unbatched launches pass {nullptr, 1}.
struct Batch {
  const int* active;
  int n;
};

// Threads per block and blocks per SM asked of the compiler, by form
// (cells a thread; 0 the streamed form).
__host__ __device__ constexpr int threads(int cells) {
  return cells == 1 ? kThreadsOne : kThreads;
}
__host__ __device__ constexpr int min_blocks(int cells) {
  return cells == 1 ? 2 : 1;
}

extern __shared__ float smem[];

// The kernel row of a's boundary.
inline int flavour(const Ops& a) {
  return a.has_pml ? kCpml : (a.has_mur ? kMur : kPec);
}

__host__ __device__ inline int profiles(const Ops& a) {
  return a.has_pml ? kProfs : 2;
}

// Dynamic shared memory of the form with `cells` cells a thread.
inline size_t smem_bytes(const Ops& a, int cells) {
  if (cells == 0) return 0;
  return sizeof(float) * ((size_t)profiles(a) * (a.nx + a.ny + a.nz) +
                          (size_t)kWords * cells * threads(cells));
}

// Profile q of axis ax at index idx: from shared memory when on chip.
template <bool kOnChip>
__device__ __forceinline__ float prof(const Ops& a, int q, int ax, int idx) {
  if (kOnChip) {
    const int base = ax == 0 ? 0 : (ax == 1 ? a.nx : a.nx + a.ny);
    return smem[q * (a.nx + a.ny + a.nz) + base + idx];
  }
  return __ldg(a.prof[q][ax] + idx);
}

// The H update of the cell (i, j, k) (flat index c).
template <bool kOnChip, bool kPml>
__device__ __forceinline__ void h_cell(const Ops& a, const int c, const int i,
                                       const int j, const int k,
                                       const float* Ex, const float* Ey,
                                       const float* Ez, float* Hx, float* Hy,
                                       float* Hz) {
  const int sy = a.nz;
  const int sx = a.ny * a.nz;
  const float ex = Ex[c], ey = Ey[c], ez = Ez[c];
  // forward differences; the missing neighbour past the last index is 0
  const float ez_yp = j + 1 < a.ny ? Ez[c + sy] : 0.f;
  const float ey_zp = k + 1 < a.nz ? Ey[c + 1] : 0.f;
  const float ex_zp = k + 1 < a.nz ? Ex[c + 1] : 0.f;
  const float ez_xp = i + 1 < a.nx ? Ez[c + sx] : 0.f;
  const float ey_xp = i + 1 < a.nx ? Ey[c + sx] : 0.f;
  const float ex_yp = j + 1 < a.ny ? Ex[c + sy] : 0.f;
  const float ipx = prof<kOnChip>(a, kIP, 0, i);
  const float ipy = prof<kOnChip>(a, kIP, 1, j);
  const float ipz = prof<kOnChip>(a, kIP, 2, k);
  const float dEz_y = (ez_yp - ez) * ipy;
  const float dEy_z = (ey_zp - ey) * ipz;
  const float dEx_z = (ex_zp - ex) * ipz;
  const float dEz_x = (ez_xp - ez) * ipx;
  const float dEy_x = (ey_xp - ey) * ipx;
  const float dEx_y = (ex_yp - ex) * ipy;
  const float hx = Hx[c], hy = Hy[c], hz = Hz[c];
  float nx, ny, nz;
  if constexpr (kPml) {
    const float bx = prof<kOnChip>(a, kBH, 0, i);
    const float by = prof<kOnChip>(a, kBH, 1, j);
    const float bz = prof<kOnChip>(a, kBH, 2, k);
    const float cx = prof<kOnChip>(a, kCH, 0, i);
    const float cy = prof<kOnChip>(a, kCH, 1, j);
    const float cz = prof<kOnChip>(a, kCH, 2, k);
    float* const* P = a.psi_h;
    const float pxy = by * P[0][c] + cy * dEz_y;
    const float pxz = bz * P[1][c] + cz * dEy_z;
    const float pyz = bz * P[2][c] + cz * dEx_z;
    const float pyx = bx * P[3][c] + cx * dEz_x;
    const float pzx = bx * P[4][c] + cx * dEy_x;
    const float pzy = by * P[5][c] + cy * dEx_y;
    P[0][c] = pxy; P[1][c] = pxz; P[2][c] = pyz;
    P[3][c] = pyx; P[4][c] = pzx; P[5][c] = pzy;
    nx = hx - a.dtmu * ((dEz_y + pxy) - (dEy_z + pxz));
    ny = hy - a.dtmu * ((dEx_z + pyz) - (dEz_x + pyx));
    nz = hz - a.dtmu * ((dEy_x + pzx) - (dEx_y + pzy));
  } else {
    nx = hx - a.dtmu * (dEz_y - dEy_z);
    ny = hy - a.dtmu * (dEx_z - dEz_x);
    nz = hz - a.dtmu * (dEy_x - dEx_y);
  }
  Hx[c] = nx;
  Hy[c] = ny;
  Hz[c] = nz;
}

// Side of the wall of axis b that coordinate x lies on: 0 low, 1 high, -1
// none.
__device__ __forceinline__ int wall_side(const Ops& a, const int b,
                                         const int x) {
  return x == a.wall_lo[b] ? 0 : (x == a.wall_hi[b] ? 1 : -1);
}

// The inverse dual spacing of axis ax at idx.
template <bool kOnChip>
__device__ __forceinline__ float inv_dual(const Ops& a, const int ax,
                                          const int idx) {
  return prof<kOnChip>(a, kID, ax, idx);
}

// e_at and mur_fix below serve any argument struct Args that has Ops'
// shape, coefficient, source and mur_c members and its own wall_side and
// inv_dual, found by argument-dependent lookup: Ops here, and the per-step
// kernels' YeeArgs in csrc/fdtd_chunk.cu (e_update_mur_kernel).

// The interior E update of component m at (i, j, k), without CPML (MUR and
// CPML exclude each other), its operands read from memory: what the owner
// of that cell computes, for the wall fix of a neighbour. Eo is the old
// buffer of component m; vo the variant's offset into the per-variant
// arrays (the source stamp is shared).
template <bool kOnChip, class Args>
__device__ __forceinline__ float e_at(const Args& a, const int m, const int i,
                                      const int j, const int k, const float s,
                                      const float* Hx, const float* Hy,
                                      const float* Hz, const float* Eo,
                                      const int vo) {
  const int sy = a.nz;
  const int sx = a.ny * a.nz;
  const int cg = i * sx + j * sy + k;  // in the grid: the source stamp's index
  const int c = vo + cg;
  float cu;
  if (m == 0) {
    const float hz_ym = j > 0 ? Hz[c - sy] : 0.f;
    const float hy_zm = k > 0 ? Hy[c - 1] : 0.f;
    cu = (Hz[c] - hz_ym) * inv_dual<kOnChip>(a, 1, j) -
         (Hy[c] - hy_zm) * inv_dual<kOnChip>(a, 2, k);
  } else if (m == 1) {
    const float hx_zm = k > 0 ? Hx[c - 1] : 0.f;
    const float hz_xm = i > 0 ? Hz[c - sx] : 0.f;
    cu = (Hx[c] - hx_zm) * inv_dual<kOnChip>(a, 2, k) -
         (Hz[c] - hz_xm) * inv_dual<kOnChip>(a, 0, i);
  } else {
    const float hy_xm = i > 0 ? Hy[c - sx] : 0.f;
    const float hx_ym = j > 0 ? Hx[c - sy] : 0.f;
    cu = (Hy[c] - hy_xm) * inv_dual<kOnChip>(a, 0, i) -
         (Hx[c] - hx_ym) * inv_dual<kOnChip>(a, 1, j);
  }
  float v = __ldg(a.ca[m] + c) * Eo[c] + __ldg(a.cb[m] + c) * cu;
  if (a.src[m] != nullptr) v = v + __ldg(a.src[m] + cg) * s;
  return v;
}

// Final E of component m at the wall cell (i, j, k) (flat index c): the
// fix of the last wall axis B it sits on,
//   E'[cell] = E[nb] + c_B * (E'[nb] - E[cell]),
// where E'[nb] is nb's interior update or, when nb sits on the earlier
// wall axis A too, nb's A fix from the diagonal cell's interior update. v
// is the cell's own update, returned when no wall of a tangential axis
// holds it; Eo is the old buffer of component m; c = vo + the cell's index
// in the grid.
template <bool kOnChip, class Args>
__device__ __forceinline__ float mur_fix(const Args& a, const int m,
                                         const int i, const int j, const int k,
                                         const int c, const float v,
                                         const float s, const float* Hx,
                                         const float* Hy, const float* Hz,
                                         const float* Eo, const int vo) {
  const int x[3] = {i, j, k};
  int B = -1, A = -1, sB = 0, sA = 0;
#pragma unroll
  for (int b = 2; b >= 0; --b) {
    if (b == m) continue;
    const int side = wall_side(a, b, x[b]);
    if (side < 0) continue;
    if (B < 0) {
      B = b;
      sB = side;
    } else {
      A = b;
      sA = side;
    }
  }
  if (B < 0) return v;
  const int n[3] = {a.nx, a.ny, a.nz};
  const int stride[3] = {a.ny * a.nz, a.nz, 1};
  // the inner neighbour across wall B, and across wall A from there
  const int dB = sB ? -1 : 1, dA = sA ? -1 : 1;
  int nB = 0, xB = 0, strB = 0, nA = 0, xA = 0, strA = 0;
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    if (b == B) {
      nB = n[b];
      xB = x[b] + dB;
      strB = stride[b];
    }
    if (b == A) {
      nA = n[b];
      xA = x[b] + dA;
      strA = stride[b];
    }
  }
  const int ni = i + (B == 0 ? dB : 0);
  const int nj = j + (B == 1 ? dB : 0);
  const int nk = k + (B == 2 ? dB : 0);
  float eo_nb = 0.f, en_nb = 0.f;
  if (xB >= 0 && xB < nB) {
    const int cn = c + dB * strB;
    eo_nb = Eo[cn];
    if (A >= 0) {  // nb sits on wall A too: its A fix, from the diagonal
      float eo_d = 0.f, en_d = 0.f;
      if (xA >= 0 && xA < nA) {
        eo_d = Eo[cn + dA * strA];
        en_d = e_at<kOnChip>(a, m, ni + (A == 0 ? dA : 0),
                             nj + (A == 1 ? dA : 0), nk + (A == 2 ? dA : 0), s,
                             Hx, Hy, Hz, Eo, vo);
      }
      en_nb = eo_d + a.mur_c[A][sA] * (en_d - eo_nb);
    } else {
      en_nb = e_at<kOnChip>(a, m, ni, nj, nk, s, Hx, Hy, Hz, Eo, vo);
    }
  }
  return eo_nb + a.mur_c[B][sB] * (en_nb - Eo[c]);
}

// The own (interior) E update of the cell (i, j, k) (flat index c) from
// its own coefficients, into v, with the CPML psi_e; eo gets its old E.
template <bool kOnChip, bool kPml>
__device__ __forceinline__ void e_own(
    const Ops& a, const int c, const int i, const int j, const int k,
    const float (&ca)[3], const float (&cb)[3], const float (&sr)[3],
    const float s, const float* Hx, const float* Hy, const float* Hz,
    const float* Ex, const float* Ey, const float* Ez, float (&v)[3],
    float (&eo)[3]) {
  const int sy = a.nz;
  const int sx = a.ny * a.nz;
  const float hx = Hx[c], hy = Hy[c], hz = Hz[c];
  // backward differences; the missing neighbour before index 0 is 0
  const float hz_ym = j > 0 ? Hz[c - sy] : 0.f;
  const float hy_zm = k > 0 ? Hy[c - 1] : 0.f;
  const float hx_zm = k > 0 ? Hx[c - 1] : 0.f;
  const float hz_xm = i > 0 ? Hz[c - sx] : 0.f;
  const float hy_xm = i > 0 ? Hy[c - sx] : 0.f;
  const float hx_ym = j > 0 ? Hx[c - sy] : 0.f;
  const float idx_ = prof<kOnChip>(a, kID, 0, i);
  const float idy = prof<kOnChip>(a, kID, 1, j);
  const float idz = prof<kOnChip>(a, kID, 2, k);
  const float dHz_y = (hz - hz_ym) * idy;
  const float dHy_z = (hy - hy_zm) * idz;
  const float dHx_z = (hx - hx_zm) * idz;
  const float dHz_x = (hz - hz_xm) * idx_;
  const float dHy_x = (hy - hy_xm) * idx_;
  const float dHx_y = (hx - hx_ym) * idy;
  float cu[3];  // curl H, with the CPML convolution terms
  if constexpr (kPml) {
    const float bx = prof<kOnChip>(a, kBE, 0, i);
    const float by = prof<kOnChip>(a, kBE, 1, j);
    const float bz = prof<kOnChip>(a, kBE, 2, k);
    const float cx = prof<kOnChip>(a, kCE, 0, i);
    const float cy = prof<kOnChip>(a, kCE, 1, j);
    const float cz = prof<kOnChip>(a, kCE, 2, k);
    float* const* P = a.psi_e;
    const float pxy = by * P[0][c] + cy * dHz_y;
    const float pxz = bz * P[1][c] + cz * dHy_z;
    const float pyz = bz * P[2][c] + cz * dHx_z;
    const float pyx = bx * P[3][c] + cx * dHz_x;
    const float pzx = bx * P[4][c] + cx * dHy_x;
    const float pzy = by * P[5][c] + cy * dHx_y;
    P[0][c] = pxy; P[1][c] = pxz; P[2][c] = pyz;
    P[3][c] = pyx; P[4][c] = pzx; P[5][c] = pzy;
    cu[0] = (dHz_y + pxy) - (dHy_z + pxz);
    cu[1] = (dHx_z + pyz) - (dHz_x + pyx);
    cu[2] = (dHy_x + pzx) - (dHx_y + pzy);
  } else {
    cu[0] = dHz_y - dHy_z;
    cu[1] = dHx_z - dHz_x;
    cu[2] = dHy_x - dHx_y;
  }
  eo[0] = Ex[c];
  eo[1] = Ey[c];
  eo[2] = Ez[c];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    v[m] = ca[m] * eo[m] + cb[m] * cu[m];
    const float with_src = v[m] + sr[m] * s;
    v[m] = a.src[m] != nullptr ? with_src : v[m];
  }
}

// Whether the cell (i, j, k) lies on a MUR wall of any axis.
__device__ __forceinline__ bool on_wall(const Ops& a, const int i,
                                        const int j, const int k) {
  return wall_side(a, 0, i) >= 0 || wall_side(a, 1, j) >= 0 ||
         wall_side(a, 2, k) >= 0;
}

// This block's cells [first, end) of the grid.
struct Range {
  int first, end;
};

// Block bidx's cells when nblocks blocks share the grid. (Unsigned, as
// gridDim.x and blockIdx.x are: signed counts cost a signed 64-bit divide.)
__device__ __forceinline__ Range block_range(const Ops& a,
                                             const unsigned nblocks,
                                             const unsigned bidx) {
  const int64_t cells = (int64_t)a.nx * a.ny * a.nz;
  const int64_t per_block = (cells + nblocks - 1) / nblocks;
  int64_t first = (int64_t)bidx * per_block;
  if (first > cells) first = cells;
  const int64_t end = first + per_block < cells ? first + per_block : cells;
  return {(int)first, (int)end};
}

__device__ __forceinline__ Range block_range(const Ops& a) {
  return block_range(a, gridDim.x, blockIdx.x);
}

// Resident word w of slot r of this thread.
template <int kCells>
__device__ __forceinline__ float& word(const Ops& a, const int w, const int r) {
  const int off = profiles(a) * (a.nx + a.ny + a.nz);
  return smem[off + (w * kCells + r) * threads(kCells) + threadIdx.x];
}

__device__ __forceinline__ void unpack(const float w, int& i, int& j, int& k) {
  const unsigned u = __float_as_uint(w);
  i = (int)(u / (kPackJ * kPackK));
  j = (int)((u / kPackK) % kPackJ);
  k = (int)(u % kPackK);
}

__device__ __forceinline__ void decode(const Ops& a, const int c, int& i,
                                       int& j, int& k) {
  k = c % a.nz;
  j = (c / a.nz) % a.ny;
  i = c / (a.ny * a.nz);
}

// Resident form: the profiles and this thread's cells' operands into
// shared memory, once per launch; vo is the block's variant's offset.
template <int kCells>
__device__ __forceinline__ void load_operands(const Ops& a, const Range r,
                                              const int vo = 0) {
  if constexpr (kCells > 0) {
    const int len = a.nx + a.ny + a.nz;
    for (int t = threadIdx.x; t < profiles(a) * len; t += blockDim.x) {
      const int q = t / len, u = t - q * len;
      const int ax = u < a.nx ? 0 : (u < a.nx + a.ny ? 1 : 2);
      const int idx = u - (ax == 0 ? 0 : (ax == 1 ? a.nx : a.nx + a.ny));
      smem[t] = a.prof[q][ax][idx];
    }
#pragma unroll
    for (int s = 0; s < kCells; ++s) {
      const int c = r.first + s * threads(kCells) + threadIdx.x;
      if (c >= r.end) continue;
      int i, j, k;
      decode(a, c, i, j, k);
      for (int m = 0; m < 3; ++m) {
        word<kCells>(a, m, s) = a.ca[m][vo + c];
        word<kCells>(a, 3 + m, s) = a.cb[m][vo + c];
        word<kCells>(a, 6 + m, s) = a.src[m] != nullptr ? a.src[m][c] : 0.f;
      }
      const unsigned u = ((unsigned)i * kPackJ + (unsigned)j) * kPackK + k;
      word<kCells>(a, kWordIJK, s) = __uint_as_float(u);
    }
    __syncthreads();
  }
}

// The streamed form's walk: element g of the flattened (variant, cell)
// space is cell c of the variant at offset vo; false for a frozen variant.
// Unbatched (kBatch false), g is the cell.
template <bool kBatch>
__device__ __forceinline__ bool batch_cell(const Batch bt, const int cells,
                                           const int g, int& c, int& vo) {
  c = g;
  vo = 0;
  if constexpr (kBatch) {
    const int b = g / cells;
    if (__ldg(bt.active + b) == 0) return false;
    vo = b * cells;
    c = g - vo;
  }
  return true;
}

// The passes take each field's components as restrict pointers: within a
// pass the old E, the new E and H never alias one another. In the resident
// form a compiler barrier stands between a thread's slots, so one slot's
// loads are not hoisted above the previous slot's stores (that would spill
// at 64 registers); vo is the block's variant's offset. The streamed form
// walks the grid (batched: the flattened variants) with a grid stride, all
// blocks together.
template <int kCells, int kFlav, bool kBatch>
__device__ __forceinline__ void h_cells(
    const Ops& a, const Range r, const int vo, const Batch bt,
    const float* __restrict__ Ex, const float* __restrict__ Ey,
    const float* __restrict__ Ez, float* __restrict__ Hx,
    float* __restrict__ Hy, float* __restrict__ Hz) {
  constexpr bool kPml = kFlav == kCpml;
  if constexpr (kCells > 0) {
#pragma unroll
    for (int s = 0; s < kCells; ++s) {
      if (s > 0) asm volatile("" ::: "memory");
      const int c = r.first + s * threads(kCells) + threadIdx.x;
      if (c >= r.end) continue;
      int i, j, k;
      unpack(word<kCells>(a, kWordIJK, s), i, j, k);
      h_cell<true, kPml>(a, vo + c, i, j, k, Ex, Ey, Ez, Hx, Hy, Hz);
    }
  } else {
    const int cells = a.nx * a.ny * a.nz;
    const int total = kBatch ? cells * bt.n : cells;
    for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < total;
         g += gridDim.x * blockDim.x) {
      int c, v0;
      if (!batch_cell<kBatch>(bt, cells, g, c, v0)) continue;
      int i, j, k;
      decode(a, c, i, j, k);
      h_cell<false, kPml>(a, v0 + c, i, j, k, Ex, Ey, Ez, Hx, Hy, Hz);
    }
  }
}

// The E update of one cell with its MUR walls: the cell's own update,
// then the fix of each component it needs; `lane_z` leaves Ex and Ey of a
// z wall cell to the caller (the neighbour lane's value, below). v gets
// the values to store, eo the cell's old E; c = vo + the cell's index in
// the grid. (Loading the fixes' operands before the own update, to share
// one round of loads, spilled registers and was slower on the card.)
template <bool kOnChip, int kFlav>
__device__ __forceinline__ void e_cell(
    const Ops& a, const int c, const int i, const int j, const int k,
    const bool lane_z, const float (&ca)[3], const float (&cb)[3],
    const float (&sr)[3], const float s, const float* Hx, const float* Hy,
    const float* Hz, const float* Ex, const float* Ey, const float* Ez,
    float (&v)[3], float (&eo)[3], const int vo) {
  const float* Eo[3] = {Ex, Ey, Ez};
  if constexpr (kFlav == kMur) {
    e_own<kOnChip, false>(a, c, i, j, k, ca, cb, sr, s, Hx, Hy, Hz, Ex, Ey,
                          Ez, v, eo);
    if (on_wall(a, i, j, k)) {
#pragma unroll
      for (int m = 0; m < 3; ++m)
        if (!(lane_z && m < 2))
          v[m] = mur_fix<kOnChip>(a, m, i, j, k, c, v[m], s, Hx, Hy, Hz,
                                  Eo[m], vo);
    }
  } else {
    e_own<kOnChip, kFlav == kCpml>(a, c, i, j, k, ca, cb, sr, s, Hx, Hy, Hz,
                                   Ex, Ey, Ez, v, eo);
  }
}

// In the resident form the inner neighbour of a z wall cell, (i, j, 1) or
// (i, j, qz-2), is the next or the previous cell of the same slot, so
// usually the next or previous lane's: its final Ex and Ey (it lies on no z
// wall) are what the z fix reads as E'[nb], and its old Ex and Ey are
// E[nb]; both come over by warp shuffle. A z wall cell whose neighbour lies
// in another warp or past the block's end recomputes it (mur_fix) instead;
// either way the values are the same.
template <int kCells, int kFlav, bool kBatch>
__device__ __forceinline__ void e_cells(
    const Ops& a, const Range r, const int vo, const Batch bt,
    const float sample, const float* __restrict__ Hx,
    const float* __restrict__ Hy,
    const float* __restrict__ Hz, const float* __restrict__ Ex,
    const float* __restrict__ Ey, const float* __restrict__ Ez,
    float* __restrict__ Nx, float* __restrict__ Ny, float* __restrict__ Nz) {
  if constexpr (kCells > 0) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 0; s < kCells; ++s) {
      if (s > 0) asm volatile("" ::: "memory");
      const int c = r.first + s * threads(kCells) + threadIdx.x;
      const bool live = c < r.end;
      float v[3] = {0.f, 0.f, 0.f}, eo[3] = {0.f, 0.f, 0.f};
      int zside = -1;
      bool lane_z = false;
      if (live) {
        int i, j, k;
        unpack(word<kCells>(a, kWordIJK, s), i, j, k);
        if (kFlav == kMur) {
          zside = wall_side(a, 2, k);
          lane_z = zside == 0 ? lane < 31 && c + 1 < r.end
                              : zside == 1 && lane > 0;
        }
        float ca[3], cb[3], sr[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          ca[m] = word<kCells>(a, m, s);
          cb[m] = word<kCells>(a, 3 + m, s);
          sr[m] = word<kCells>(a, 6 + m, s);
        }
        e_cell<true, kFlav>(a, vo + c, i, j, k, lane_z, ca, cb, sr, sample, Hx,
                            Hy, Hz, Ex, Ey, Ez, v, eo, vo);
      }
      if constexpr (kFlav == kMur) {  // every lane takes part
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
      }
      if (live) {
        Nx[vo + c] = v[0];
        Ny[vo + c] = v[1];
        Nz[vo + c] = v[2];
      }
    }
  } else {
    const int cells = a.nx * a.ny * a.nz;
    const int total = kBatch ? cells * bt.n : cells;
    for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < total;
         g += gridDim.x * blockDim.x) {
      int c, v0;
      if (!batch_cell<kBatch>(bt, cells, g, c, v0)) continue;
      int i, j, k;
      decode(a, c, i, j, k);
      float ca[3], cb[3], sr[3], v[3], eo[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        ca[m] = __ldg(a.ca[m] + v0 + c);
        cb[m] = __ldg(a.cb[m] + v0 + c);
        sr[m] = a.src[m] != nullptr ? __ldg(a.src[m] + c) : 0.f;
      }
      e_cell<false, kFlav>(a, v0 + c, i, j, k, false, ca, cb, sr, sample, Hx,
                           Hy, Hz, Ex, Ey, Ez, v, eo, v0);
      Nx[v0 + c] = v[0];
      Ny[v0 + c] = v[1];
      Nz[v0 + c] = v[2];
    }
  }
}

// H pass: every cell of the block, from e[p]. Batched (kBatch): the
// resident form's cells of the variant at vo, the streamed form's of every
// active variant of bt.
template <int kCells, int kFlav, bool kBatch = false>
__device__ __forceinline__ void h_pass(const Ops& a, const int p,
                                       const Range r, const int vo = 0,
                                       const Batch bt = Batch{nullptr, 1}) {
  h_cells<kCells, kFlav, kBatch>(a, r, vo, bt, a.e[p][0], a.e[p][1],
                                 a.e[p][2], a.h[0], a.h[1], a.h[2]);
}

// E pass: every cell of the block, from e[p] into e[1-p], walls fused in.
template <int kCells, int kFlav, bool kBatch = false>
__device__ __forceinline__ void e_pass(const Ops& a, const int p,
                                       const Range r, const float sample,
                                       const int vo = 0,
                                       const Batch bt = Batch{nullptr, 1}) {
  e_cells<kCells, kFlav, kBatch>(a, r, vo, bt, sample, a.h[0], a.h[1],
                                 a.h[2], a.e[p][0], a.e[p][1], a.e[p][2],
                                 a.e[1 - p][0], a.e[1 - p][1], a.e[1 - p][2]);
}

// ---------------------------------------------------------------------------
// host: which form, how many blocks, and the launch
// ---------------------------------------------------------------------------

// kernels[0] is the streamed form, kernels[c] the resident form with c
// cells a thread, all built for one boundary (null: not built). The plan:
// the resident form with the fewest cells a thread that holds every cell,
// at as many blocks as the occupancy query gives for it (never more than
// one per threads(c) cells), else the streamed form. A batch of `batch`
// variants splits the blocks the card holds evenly over them: the resident
// form fits when each variant's share holds its cells; the streamed form
// walks all variants' cells. request: -1 either, 0 streamed, 1 resident
// (refused when it does not fit). out: {cells a thread (0 streamed),
// blocks, shared bytes, threads a block}.
inline cudaError_t plan(const Ops& a, const void* const* kernels,
                        const int request, int out[4], const int batch = 1) {
  const int64_t cells64 = (int64_t)a.nx * a.ny * a.nz;
  if (cells64 < 1 || batch < 1 || cells64 * batch >= ((int64_t)1 << 31) ||
      request < -1 || request > 1)
    return cudaErrorInvalidValue;
  for (int c = 0; c <= kMaxCells; ++c)
    if (kernels[c] == nullptr) return cudaErrorInvalidValue;
  const int cells = (int)cells64;
  int dev = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const bool packs = a.nx <= kPackI && a.ny <= kPackJ && a.nz <= kPackK;
  for (int c = 1; request != 0 && packs && c <= kMaxCells; ++c) {
    const size_t bytes = smem_bytes(a, c);
    if (bytes > (size_t)optin) break;
    err = cudaFuncSetAttribute(kernels[c],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernels[c],
                                                          threads(c), bytes);
    if (err != cudaSuccess) return err;
    const int share = per_sm * sms / batch;  // blocks a variant may take
    if (share < 1) continue;
    const int wanted = (cells + threads(c) - 1) / threads(c);
    const int blocks = share < wanted ? share : wanted;
    if ((cells + blocks - 1) / blocks <= c * threads(c)) {
      out[0] = c;
      out[1] = blocks * batch;
      out[2] = (int)bytes;
      out[3] = threads(c);
      return cudaSuccess;
    }
  }
  if (request == 1) return cudaErrorInvalidValue;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernels[0],
                                                      threads(0), 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int wanted = (int)((cells64 * batch + threads(0) - 1) / threads(0));
  out[0] = 0;
  out[1] = per_sm * sms < wanted ? per_sm * sms : wanted;
  out[2] = 0;
  out[3] = threads(0);
  return cudaSuccess;
}

// One cooperative launch of the form with `cells` cells a thread on
// `blocks` blocks (of a batch of `batch` variants: the resident form gives
// each variant blocks / batch of them); params are the kernel's arguments.
inline cudaError_t launch(const Ops& a, const void* const* kernels,
                          const int cells, const int blocks, void** params,
                          void* stream, const int batch = 1) {
  const int64_t n = (int64_t)a.nx * a.ny * a.nz;
  if (cells < 0 || cells > kMaxCells || blocks < 1 || n < 1 || batch < 1 ||
      n * batch >= ((int64_t)1 << 31) || kernels[cells] == nullptr)
    return cudaErrorInvalidValue;
  const int64_t share = blocks / batch;  // the resident form's blocks a variant
  if (cells > 0 &&
      (blocks % batch != 0 ||
       (n + share - 1) / share > (int64_t)cells * threads(cells) ||
       a.nx > kPackI || a.ny > kPackJ || a.nz > kPackK))
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(a, cells);
  cudaError_t err = cudaSuccess;
  if (bytes > 0)
    err = cudaFuncSetAttribute(kernels[cells],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(kernels[cells], dim3(blocks),
                                      dim3(threads(cells)), params, bytes,
                                      (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

}  // namespace persist
