// Whole-image 2-D lifting level, forward and inverse, for sm_90a.
//
// Replaces the TPU kernels kernels/fused2d.py::_fwd2d_pallas (body
// _fwd2d_kernel) and ::_inv2d_pallas (body _inv2d_kernel).  On the TPU
// one grid cell holds one whole image in VMEM; one Hopper block cannot
// (227 KB of shared memory is about 240x240 int32 samples), so a level is
// two passes over device memory:
//
//   forward:  row pass     x (B,H,W)  -> s_r (B,H,We), d_r (B,H,Wo)
//             column pass  s_r -> LL, LH;  d_r -> HL, HH
//   inverse:  column pass  LL, LH -> s_r;  HL, HH -> d_r
//             row pass     s_r, d_r -> x
//
// Both passes are the shared line passes of passes.cuh: each block stages
// whole lines (a group of rows, or a strip of adjacent columns over the
// full height) in shared memory, runs the band-policy cascade on them with
// one __syncthreads() per lifting step, and reads past the borders through
// reflect_entry — the reference's math (core/schemes.py _walk_policy), so
// every scheme and every shape down to 2x2 works, including cdf22 and haar
// on odd sizes.  A line too long for shared memory is staged in a global
// scratch buffer instead (same code, generic addressing), so there is no
// size cap.
//
// Bound: memory.  A level must read the input and write the four bands
// once (8 bytes per sample, int32 in and out, at 3.35 TB/s); this design
// also writes and reads the row-pass intermediates once (another 8 bytes
// per sample), so it is at best half the bound.  The whole-image path
// serves only the coarse levels (images up to the shared-memory size),
// which are small and L2-resident; the fine levels go to the tiled kernel
// (tiled2d.cu), which makes one pass.
#include "passes.cuh"

using namespace passes;

namespace {

// The two column planes of a 2-D level: the row bands s_r / d_r and their
// (B, He, w) / (B, Ho, w) column bands.
Planes col_planes(int32_t* s_r, int32_t* d_r, int32_t* ll, int32_t* lh, int32_t* hl,
                  int32_t* hh, int W) {
  Planes ps{};
  ps.np = 2;
  ps.p[0] = Plane{s_r, ll, lh, (W + 1) >> 1};
  ps.p[1] = Plane{d_r, hl, hh, W >> 1};
  return ps;
}

}  // namespace

// Forward level: x -> (ll, lh, hl, hh) through the row-pass
// intermediates s_r, d_r.  `scratch` is null unless a line is staged in
// global memory (row_global / col_global).  Returns a cudaError_t code.
extern "C" int repro_whole_fwd(int device, const int32_t* x, int32_t* s_r, int32_t* d_r,
                               int32_t* ll, int32_t* lh, int32_t* hl, int32_t* hh,
                               int32_t* scratch, int B, int H, int W, int rb,
                               int row_global, int cw, int col_global,
                               const int32_t* table, int table_len, void* stream) {
  Cascade c;
  cudaError_t e = lift2d::parse_cascade(table, table_len, &c);
  if (e != cudaSuccess) return e;
  if (B < 1 || H < 2) return cudaErrorInvalidValue;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((e = launch_rows(false, x, nullptr, s_r, d_r, (long long)B * H, W, rb, row_global, scratch,
                       c, st)) != cudaSuccess)
    return e;
  return launch_cols<false>(col_planes(s_r, d_r, ll, lh, hl, hh, W), B, H, col_global ? 0 : cw,
                            scratch, c, st);
}

// Inverse level: (ll, lh, hl, hh) -> x through s_r, d_r.
extern "C" int repro_whole_inv(int device, const int32_t* ll, const int32_t* lh,
                               const int32_t* hl, const int32_t* hh, int32_t* s_r,
                               int32_t* d_r, int32_t* x, int32_t* scratch, int B, int H,
                               int W, int rb, int row_global, int cw, int col_global,
                               const int32_t* table, int table_len, void* stream) {
  Cascade c;
  cudaError_t e = lift2d::parse_cascade(table, table_len, &c);
  if (e != cudaSuccess) return e;
  if (B < 1 || H < 2) return cudaErrorInvalidValue;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Planes ps = col_planes(s_r, d_r, const_cast<int32_t*>(ll), const_cast<int32_t*>(lh),
                               const_cast<int32_t*>(hl), const_cast<int32_t*>(hh), W);
  if ((e = launch_cols<true>(ps, B, H, col_global ? 0 : cw, scratch, c, st)) != cudaSuccess)
    return e;
  return launch_rows(true, s_r, d_r, x, nullptr, (long long)B * H, W, rb, row_global, scratch, c,
                     st);
}

// The row pass alone over a (rows, n) signal — the 1-D level for what the
// windowed kernels (lift1d.cu) do not take: lines of fewer than 8 pairs,
// and schemes that do not commute with whole-point reflection on this
// length (cdf22; haar on odd n).  Band-policy math, so every scheme and
// every n >= 2 works; a line too long for shared memory is staged in
// `scratch` (row_global), one block per line.  Returns a cudaError_t code.
extern "C" int repro_rows_fwd(int device, const int32_t* x, int32_t* s, int32_t* d,
                              int32_t* scratch, int rows, int n, int rb, int row_global,
                              const int32_t* table, int table_len, void* stream) {
  Cascade c;
  cudaError_t e = lift2d::parse_cascade(table, table_len, &c);
  if (e != cudaSuccess) return e;
  if (rows < 1 || n < 2 || rb < 1) return cudaErrorInvalidValue;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  return launch_rows(false, x, nullptr, s, d, rows, n, rb, row_global, scratch, c,
                     static_cast<cudaStream_t>(stream));
}

// Inverse row pass: s (rows, ceil(n/2)), d (rows, floor(n/2)) -> x (rows, n).
extern "C" int repro_rows_inv(int device, const int32_t* s, const int32_t* d, int32_t* x,
                              int32_t* scratch, int rows, int n, int rb, int row_global,
                              const int32_t* table, int table_len, void* stream) {
  Cascade c;
  cudaError_t e = lift2d::parse_cascade(table, table_len, &c);
  if (e != cudaSuccess) return e;
  if (rows < 1 || n < 2 || rb < 1) return cudaErrorInvalidValue;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  return launch_rows(true, s, d, x, nullptr, rows, n, rb, row_global, scratch, c,
                     static_cast<cudaStream_t>(stream));
}
