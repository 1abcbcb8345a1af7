// The probe table and one row's weighted sum, shared by the kernels that
// sample probes: csrc/fdtd_chunk.cu (probe_gather, the gathers inside
// chunk_steps and chunk_steps_batch) and csrc/fdtd_chunk_march.cu (the
// gather inside the marched form of chunk_steps_batch). The table's layout
// is described in csrc/fdtd_chunk.cu ("The probe table").

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kProbeBlocks = 4;  // port V, port I, face E, face H

// Mirrored field for field by ops/fdtd_cuda.py::_ProbeTable (ctypes).
struct ProbeTable {
  const int* code;   // cell << 3 | component (0..5: Ex..Hz)
  const float* w;    // weights, laid out as code
  const int* meta;   // on the device: row0[kProbeBlocks + 1], k[kProbeBlocks],
                     // off[kProbeBlocks] (kMeta* below)
  int rows;          // all blocks' rows
};

// meta: block b's rows are [row0[b], row0[b + 1]), k[b] terms each, its
// first entry off[b]; term m of its row r at off[b] + m * rows_b + r
constexpr int kMetaRow0 = 0;
constexpr int kMetaK = kProbeBlocks + 1;
constexpr int kMetaOff = 2 * kProbeBlocks + 1;

// Probe row r (of all blocks) of the fields ex .. hz: its terms summed
// m = 0 .. k-1, one rounding each, kU terms' code and weight loaded, then
// their field values, then added in order. kL2: the field values are read
// through the L2 only (ld.global.cg), for fields that other blocks wrote
// earlier in the same launch behind a barrier that is not grid.sync().
template <int kU, bool kL2 = false>
__device__ __forceinline__ float probe_row(
    const int* __restrict__ code, const float* __restrict__ w,
    const int* __restrict__ meta, const int r, const float* ex,
    const float* ey, const float* ez, const float* hx, const float* hy,
    const float* hz) {
  int b = 0;
#pragma unroll
  for (int q = 1; q < kProbeBlocks; ++q) b += r >= __ldg(meta + kMetaRow0 + q);
  const int r0 = __ldg(meta + kMetaRow0 + b);
  const int rows = __ldg(meta + kMetaRow0 + b + 1) - r0;
  const int k = __ldg(meta + kMetaK + b);
  const int at = __ldg(meta + kMetaOff + b) + (r - r0);
  code += at;
  w += at;
  float acc = 0.f;
  for (int m0 = 0; m0 < k; m0 += kU) {
    int c[kU];
    float wt[kU], v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const bool on = m0 + u < k;
      c[u] = on ? __ldg(code + (m0 + u) * rows) : 0;
      wt[u] = on ? __ldg(w + (m0 + u) * rows) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int comp = c[u] & 7;
      const float* f = comp < 3 ? (comp == 0 ? ex : (comp == 1 ? ey : ez))
                                : (comp == 3 ? hx : (comp == 4 ? hy : hz));
      const float* at_f = f + (c[u] >> 3);
      v[u] = m0 + u < k ? (kL2 ? __ldcg(at_f) : *at_f) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (m0 + u < k) acc = acc + v[u] * wt[u];
  }
  return acc;
}
