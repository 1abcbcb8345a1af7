// The Yee grid's build on the card (sm_90a): the material raster and the
// float32 update coefficients Ca/Cb, from a small table of the scene's
// primitives, bound to Python with ctypes.
//
// Replaces no TPU kernel. The JAX package builds the grid on the host
// (ops/voxelize.py on native/voxelize.cpp, then ops/fdtd.py's float64
// Ca/Cb arithmetic) and uploads it; the port did the same, and the card
// sat idle for that whole prepare, about 1.5 s of each job of the mixed
// patch+horn scene (4.2M cells). Every output element here depends only
// on its own point and the scene's few primitives, so the card builds
// the grid in about a millisecond, and nothing but a table of a few KB
// crosses the bus.
//
// Two kernels (ops/grid_build.py packs the table and launches them):
//  paint_cells_kernel  one thread a cell: the cell centre from the axis
//      vectors, the material primitives walked in ascending (priority,
//      insertion) order, the last that holds the centre wins; writes the
//      cell-centred eps_r and sigma in float64.
//  edge_coeffs_kernel  one thread an E edge of the padded grid, blockIdx.y
//      the component: the PEC test (with the carve rule: a material of
//      higher priority removes metal), the conductive sheets' sigma_s /
//      dn, the node average of eps and sigma from the four cells around
//      the edge, the lumped ports' added conductivities, then beta, Ca and
//      Cb in float64, the invalid trailing slot, the outer planes
//      tangential to the component (MUR: Ca 1, Cb 0; else 0, 0), PEC last;
//      one float32 write each of Ca and Cb (zero in the pad cells).
//
// THE RULE: the outputs equal the host build's bit for bit. Every
// operation is the host's, in the host's order, in float64, and the
// library is built with -fmad=false so no multiply and add fuse:
//  - the rigid transform as native/voxelize.cpp computes it,
//    ((q0*R0j + q1*R1j) + q2*R2j) + oj (models/scene.py sums it in the
//    same order);
//  - a polyhedron's half-space test (n0*x + n1*y) + n2*z <= d + tol, the
//    order of models/scene.py::ConvexPolyhedron.contains;
//  - each primitive's index window (ops/voxelize.py::_poly_window), packed
//    by the host for each point set, so an edge the host never tests is
//    not tested here;
//  - the node average in cell_edge_avg_impl's order,
//    0.5*(0.5*(A + B) + 0.5*(C + D)), the inner pairs along the lower
//    transverse axis;
//  - beta = (sigma*dt) / (2*eps), Ca = (1 - beta)/(1 + beta),
//    Cb = (dt/eps)/(1 + beta), rounded to float32 once, to nearest.
// Double division on the card is IEEE round to nearest, as on the host.
//
// What bounds it on the card: bytes. Each cell's eps and sigma written
// once (16 B a cell), each edge's four neighbours read once (from the L2
// after the first of the three components) and Ca, Cb written once (8 B
// an edge of the padded grid): for the mixed scene about 68 MB + 101 MB,
// some 50 us at 3.35 TB/s. The float64 arithmetic (a few hundred
// operations an edge, most of them the PEC tests of a dozen primitives)
// is some 3 GFLOP against 34 TFLOP/s. The design is the plainest that
// keeps the rule: one thread an output element, no shared memory, the
// table read through the L1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

// The launch arguments (a mirror in ops/grid_build.py). Outside the
// unnamed namespace: the C interface's functions take it, and a type of
// internal linkage in their signature would keep them out of the
// library's exported symbols.
struct GridBuildArgs {
  const double* tab;  // primitive records, plane rows, fold sigmas, axes
  const int* itab;    // primitive records, fold records
  double* eps;        // (qx-1, qy-1, qz-1) cell-centred eps_r
  double* sigma;      // the same cells' sigma
  float* ca[3];       // (px, py, pz) each
  float* cb[3];
  int q[3];           // grid lines a axis
  int p[3];           // padded shape
  int n_mat, n_pec, n_sheet, n_fold;
  int planes_off;     // first double of the plane rows, 4 a row
  int fold_off;       // first double of the fold sigmas
  int fold_ioff;      // first int of the fold records
  int lines_off[3];   // each axis's lines, q[a] doubles
  int cpad_off[3];    // each axis's cell centres, the last repeated: q[a]
  int dual_off[3];    // each axis's dual spacings (m): q[a]
  int carve, mur;
  double background_eps, dt, eps0;
};

namespace {

// The table's records (ops/grid_build.py writes them; keep in step).
constexpr int kRecD = 24;  // doubles a primitive: lo[3] hi[3] rot[9]
                           // org[3] trn[3] val0 val1 (unused)
constexpr int kRecI = 32;  // ints a primitive: kind has_rot plane_row
                           // n_planes prio n_axis (2 unused) win[4][6]
constexpr int kWin = 8;    // the first window's int
constexpr int kFoldI = 8;  // ints a port fold: comp lo0 hi0 lo1 hi1 lo2 hi2
constexpr int kThreads = 256;

__device__ __forceinline__ bool in_window(const int* w, int i, int j, int k) {
  return i >= w[0] && i < w[1] && j >= w[2] && j < w[3] && k >= w[4] &&
         k < w[5];
}

// Whether primitive m holds the world point (x, y, z).
__device__ bool contains(const GridBuildArgs& a, int m, double x, double y,
                         double z) {
  const double* r = a.tab + (int64_t)m * kRecD;
  const int* ri = a.itab + (int64_t)m * kRecI;
  double p0 = x - r[18];
  double p1 = y - r[19];
  double p2 = z - r[20];
  if (ri[1]) {
    const double q0 = p0 - r[15];
    const double q1 = p1 - r[16];
    const double q2 = p2 - r[17];
    p0 = q0 * r[6] + q1 * r[9] + q2 * r[12] + r[15];
    p1 = q0 * r[7] + q1 * r[10] + q2 * r[13] + r[16];
    p2 = q0 * r[8] + q1 * r[11] + q2 * r[14] + r[17];
  }
  if (ri[0] == 0)
    return p0 >= r[0] && p0 <= r[3] && p1 >= r[1] && p1 <= r[4] &&
           p2 >= r[2] && p2 <= r[5];
  const double* pl = a.tab + a.planes_off + 4 * (int64_t)ri[2];
  for (int n = 0; n < ri[3]; ++n, pl += 4)
    if (!(p0 * pl[0] + p1 * pl[1] + p2 * pl[2] <= pl[3])) return false;
  return true;
}

__global__ void __launch_bounds__(kThreads)
    paint_cells_kernel(const GridBuildArgs a) {
  const int nx = a.q[0] - 1, ny = a.q[1] - 1, nz = a.q[2] - 1;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)nx * ny * nz) return;
  const int k = (int)(t % nz);
  const int64_t r = t / nz;
  const int j = (int)(r % ny);
  const int i = (int)(r / ny);
  const double x = a.tab[a.cpad_off[0] + i];
  const double y = a.tab[a.cpad_off[1] + j];
  const double z = a.tab[a.cpad_off[2] + k];
  double e = a.background_eps, s = 0.0;
  for (int m = 0; m < a.n_mat; ++m) {
    if (in_window(a.itab + (int64_t)m * kRecI + kWin, i, j, k) &&
        contains(a, m, x, y, z)) {
      e = a.tab[(int64_t)m * kRecD + 21];
      s = a.tab[(int64_t)m * kRecD + 22];
    }
  }
  a.eps[t] = e;
  a.sigma[t] = s;
}

__global__ void __launch_bounds__(kThreads)
    edge_coeffs_kernel(const GridBuildArgs a) {
  const int c = blockIdx.y;  // 0 ex, 1 ey, 2 ez
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)a.p[0] * a.p[1] * a.p[2]) return;
  const int k = (int)(t % a.p[2]);
  const int64_t r = t / a.p[2];
  const int j = (int)(r % a.p[1]);
  const int i = (int)(r / a.p[1]);
  float* ca_out = a.ca[c];
  float* cb_out = a.cb[c];
  if (i >= a.q[0] || j >= a.q[1] || k >= a.q[2]) {  // a pad cell
    ca_out[t] = 0.f;
    cb_out[t] = 0.f;
    return;
  }
  const int idx[3] = {i, j, k};
  // the edge's midpoint: its own axis at the cell centres, the others on
  // the lines (ops/voxelize.py::_edge_axes)
  double pt[3];
  for (int ax = 0; ax < 3; ++ax)
    pt[ax] = a.tab[(ax == c ? a.cpad_off[ax] : a.lines_off[ax]) + idx[ax]];
  const int* win_of = a.itab + kWin + 6 * (1 + c);  // + m * kRecI

  // PEC: the highest priority of the metal holding the edge; under the
  // carve rule it must not be below the highest material's
  int pec_prio = INT_MIN;
  for (int m = a.n_mat; m < a.n_mat + a.n_pec; ++m) {
    const int prio = a.itab[(int64_t)m * kRecI + 4];
    if (prio > pec_prio && in_window(win_of + (int64_t)m * kRecI, i, j, k) &&
        contains(a, m, pt[0], pt[1], pt[2]))
      pec_prio = prio;
  }
  bool pec = pec_prio > INT_MIN;
  if (pec && a.carve) {
    int mat_prio = INT_MIN;
    for (int m = 0; m < a.n_mat; ++m) {
      const int prio = a.itab[(int64_t)m * kRecI + 4];
      if (prio > mat_prio &&
          in_window(win_of + (int64_t)m * kRecI, i, j, k) &&
          contains(a, m, pt[0], pt[1], pt[2]))
        mat_prio = prio;
    }
    pec = pec_prio >= mat_prio;
  }
  if (pec) {
    ca_out[t] = 0.f;
    cb_out[t] = 0.f;
    return;
  }

  // the node average of the cells around the edge (cell_edge_avg_impl):
  // the component's own axis at its clamped cell, the two transverse axes
  // u < v between their two neighbours, the inner pairs along u
  const int n[3] = {a.q[0] - 1, a.q[1] - 1, a.q[2] - 1};
  int lo[3], hi[3];
  for (int ax = 0; ax < 3; ++ax) {
    hi[ax] = idx[ax] < n[ax] ? idx[ax] : n[ax] - 1;
    lo[ax] = ax == c ? hi[ax] : (idx[ax] > 0 ? idx[ax] - 1 : 0);
  }
  const int u = c == 0 ? 1 : 0;
  const int v = c == 2 ? 1 : 2;
  int64_t off[4];  // (u lo, v lo), (u hi, v lo), (u lo, v hi), (u hi, v hi)
  for (int q = 0; q < 4; ++q) {
    int at[3] = {lo[0], lo[1], lo[2]};
    at[u] = (q & 1) ? hi[u] : lo[u];
    at[v] = (q & 2) ? hi[v] : lo[v];
    off[q] = ((int64_t)at[0] * n[1] + at[1]) * n[2] + at[2];
  }
  const double H = 0.5;
  const double eps_avg = H * (H * (a.eps[off[0]] + a.eps[off[1]]) +
                              H * (a.eps[off[2]] + a.eps[off[3]]));
  double sig = H * (H * (a.sigma[off[0]] + a.sigma[off[1]]) +
                    H * (a.sigma[off[2]] + a.sigma[off[3]]));

  // a conductive sheet: the first (highest priority) holding the edge,
  // whose normal is not the component's axis, adds sigma_s / dn
  const int s0 = a.n_mat + a.n_pec;
  for (int m = s0; m < s0 + a.n_sheet; ++m) {
    const int na = a.itab[(int64_t)m * kRecI + 5];
    if (na != c && in_window(win_of + (int64_t)m * kRecI, i, j, k) &&
        contains(a, m, pt[0], pt[1], pt[2])) {
      const int ni = idx[na] < a.q[na] - 1 ? idx[na] : a.q[na] - 1;
      sig = sig + a.tab[(int64_t)m * kRecD + 21] / a.tab[a.dual_off[na] + ni];
      break;
    }
  }
  // the lumped ports' resistances, in the host's order
  for (int f = 0; f < a.n_fold; ++f) {
    const int* fr = a.itab + a.fold_ioff + f * kFoldI;
    if (fr[0] == c && i >= fr[1] && i < fr[2] && j >= fr[3] && j < fr[4] &&
        k >= fr[5] && k < fr[6])
      sig = sig + a.tab[a.fold_off + f];
  }

  const double eps = eps_avg * a.eps0;
  const double beta = sig * a.dt / (2.0 * eps);
  double ca = (1.0 - beta) / (1.0 + beta);
  double cb = (a.dt / eps) / (1.0 + beta);
  if (idx[c] == a.q[c] - 1) {  // the invalid trailing slot
    ca = 0.0;
    cb = 0.0;
  }
  for (int b = 0; b < 3; ++b) {  // outer planes tangential to the edge
    if (b != c && (idx[b] == 0 || idx[b] == a.q[b] - 1)) {
      cb = 0.0;
      ca = a.mur ? 1.0 : 0.0;
    }
  }
  ca_out[t] = (float)ca;
  cb_out[t] = (float)cb;
}

bool valid(const GridBuildArgs* a) {
  if (a == nullptr || a->tab == nullptr) return false;
  if (a->itab == nullptr && a->n_mat + a->n_pec + a->n_sheet + a->n_fold > 0)
    return false;
  for (int ax = 0; ax < 3; ++ax)
    if (a->q[ax] < 2) return false;
  return a->n_mat >= 0 && a->n_pec >= 0 && a->n_sheet >= 0 && a->n_fold >= 0;
}

}  // namespace

extern "C" {

int grid_build_args_size() { return (int)sizeof(GridBuildArgs); }

const char* grid_build_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// eps and sigma of every cell of the grid, on `stream`.
int grid_paint_cells(const GridBuildArgs* a, void* stream) {
  if (!valid(a) || a->eps == nullptr || a->sigma == nullptr)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)(a->q[0] - 1) * (a->q[1] - 1) * (a->q[2] - 1);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  paint_cells_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// Ca and Cb of the three components over the padded grid, from the cells
// grid_paint_cells wrote, on `stream`.
int grid_edge_coeffs(const GridBuildArgs* a, void* stream) {
  if (!valid(a) || a->eps == nullptr || a->sigma == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < 3; ++c)
    if (a->ca[c] == nullptr || a->cb[c] == nullptr || a->p[c] < a->q[c])
      return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)a->p[0] * a->p[1] * a->p[2];
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  edge_coeffs_kernel<<<dim3((unsigned)blocks, 3), kThreads, 0,
                       (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
