// Windowed 1-D lifting level, forward and inverse, for sm_90a.
//
// Replaces the TPU kernels kernels/dwt53.py::lift_fwd_windows (body
// _fwd_kernel) and ::lift_inv_windows (body _inv_kernel).  The signal is
// a (rows, n) int32 array; a level cuts each row into tiles of `bp` core
// pairs, and one block takes `rb` rows of one tile (the grid is the
// flattened (row group, tile) pair, so one row of 11.5 M samples and
// 10^6 rows of 16 samples are both legal grids):
//
//   forward:  the block reads its window of 2*bp + 2*halo samples per row
//             (halo = 2 * fwd_margin) straight from the signal, mapping
//             every out-of-range position through whole-point reflection
//             (reflect_index, the reference's reflect_indices) — the
//             (rows_pad, n_tiles, wlen) gather and the edge row padding
//             the reference materialises in device memory are never
//             built.  The window is lifted in place in shared memory as
//             interior-only math (cascade_ext, the reference's _walk_ext),
//             and the block writes its bp core (s, d) pairs, cropped at
//             n_e / n_o and at `rows`.
//   inverse:  the block reads bp + 2*m entries of each band per row
//             (m = inv_margin) through reflect_entry (the reference's
//             reflect_entries), interleaves them into a 2*(bp + 2m)
//             sample window, runs the inverse cascade in place and writes
//             its 2*bp core samples, cropped at n.
//
// The window dataflow reproduces the band-policy reference only for
// schemes that commute with whole-point reflection on this length
// (scheme.can_window) and for lines of at least 8 pairs; the dispatcher
// (kernels/ops.py) sends everything else to the row pass of whole2d.cu.
//
// Bound: memory.  A level reads every sample once and writes every band
// entry once: 8 bytes per sample at 3.35 TB/s.  The design makes one
// pass; its overheads are the halo re-reads (2*halo / (2*bp) of the
// input, under 1% at bp = 1024), one __syncthreads() per lifting step,
// and scalar (4-byte) loads and stores.  Tile sizes come from the card's
// shared memory (kernels/backend.py pick_blocks), not from the TPU's
// 8 x 256 blocks.
#include <climits>

#include "lift2d.cuh"

namespace lift2d {

__global__ void lift1d_fwd_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ s,
                                  int32_t* __restrict__ d, int rows, int n, int rb, int bp,
                                  int m, int tiles, Cascade c) {
  extern __shared__ int32_t win[];
  const int t = blockIdx.x % tiles;
  const int r0 = (blockIdx.x / tiles) * rb;
  const int nr = min(rb, rows - r0);
  const int halo = 2 * m;
  const int W = 2 * bp + 2 * halo;  // window samples per row
  const int start = 2 * t * bp - halo;
  const int32_t* src = x + (size_t)r0 * n;
  for (int idx = threadIdx.x; idx < nr * W; idx += blockDim.x) {
    const int l = idx / W, k = idx % W;
    win[idx] = src[(size_t)l * n + reflect_index(start + k, n)];
  }
  __syncthreads();
  cascade_ext<false>(win, 1, W, nr, W / 2, c);
  const int ne = (n + 1) >> 1, no = n >> 1;
  const int p0 = t * bp;
  for (int idx = threadIdx.x; idx < nr * bp; idx += blockDim.x) {
    const int l = idx / bp, p = idx % bp, gp = p0 + p;
    const int32_t* v = win + l * W + 2 * (m + p);
    if (gp < ne) s[(size_t)(r0 + l) * ne + gp] = v[0];
    if (gp < no) d[(size_t)(r0 + l) * no + gp] = v[1];
  }
}

__global__ void lift1d_inv_kernel(const int32_t* __restrict__ s, const int32_t* __restrict__ d,
                                  int32_t* __restrict__ x, int rows, int n, int rb, int bp,
                                  int m, int tiles, Cascade c) {
  extern __shared__ int32_t win[];
  const int t = blockIdx.x % tiles;
  const int r0 = (blockIdx.x / tiles) * rb;
  const int nr = min(rb, rows - r0);
  const int P = bp + 2 * m;  // window pairs per row
  const int W = 2 * P;
  const int q0 = t * bp - m;
  const int ne = (n + 1) >> 1, no = n >> 1;
  for (int idx = threadIdx.x; idx < nr * P; idx += blockDim.x) {
    const int l = idx / P, q = idx % P;
    const size_t row = (size_t)(r0 + l);
    win[l * W + 2 * q] = s[row * ne + reflect_entry(q0 + q, 0, n)];
    win[l * W + 2 * q + 1] = d[row * no + reflect_entry(q0 + q, 1, n)];
  }
  __syncthreads();
  cascade_ext<false>(win, 1, W, nr, P, c);
  const int x0 = 2 * t * bp, core = 2 * bp;
  for (int idx = threadIdx.x; idx < nr * core; idx += blockDim.x) {
    const int l = idx / core, k = idx % core;
    if (x0 + k < n) x[(size_t)(r0 + l) * n + x0 + k] = win[l * W + 2 * m + k];
  }
}

// Flattened grid of (row group, tile) blocks; fails on an empty or
// oversized grid rather than launching a wrong one.
inline cudaError_t grid_1d(int rows, int rb, int tiles, unsigned* blocks) {
  if (rows < 1 || rb < 1 || tiles < 1) return cudaErrorInvalidConfiguration;
  const long long total = (long long)((rows + rb - 1) / rb) * tiles;
  if (total > INT_MAX) return cudaErrorInvalidConfiguration;
  *blocks = static_cast<unsigned>(total);
  return cudaSuccess;
}

}  // namespace lift2d

using namespace lift2d;

// Forward level of a (rows, n) int32 signal into s (rows, ceil(n/2)) and
// d (rows, floor(n/2)), with rb rows and bp core pairs per block and
// forward margin m (halo 2m samples).  Returns a cudaError_t code.
extern "C" int repro_lift1d_fwd(int device, const int32_t* x, int32_t* s, int32_t* d, int rows,
                                int n, int rb, int bp, int m, const int32_t* table,
                                int table_len, void* stream) {
  Cascade c;
  cudaError_t e = parse_cascade(table, table_len, &c);
  if (e != cudaSuccess) return e;
  if (bp < 1 || m < 0 || n < 2) return cudaErrorInvalidValue;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  const int tiles = ((n + 1) / 2 + bp - 1) / bp;
  unsigned blocks;
  if ((e = grid_1d(rows, rb, tiles, &blocks)) != cudaSuccess) return e;
  const size_t bytes = (size_t)rb * (2 * bp + 4 * m) * sizeof(int32_t);
  if ((e = allow_smem(lift1d_fwd_kernel, bytes)) != cudaSuccess) return e;
  lift1d_fwd_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, s, d, rows, n, rb, bp, m, tiles, c);
  return cudaGetLastError();
}

// Inverse level from s (rows, ceil(n/2)) and d (rows, floor(n/2)) to x
// (rows, n), with inverse margin m.  Returns a cudaError_t code.
extern "C" int repro_lift1d_inv(int device, const int32_t* s, const int32_t* d, int32_t* x,
                                int rows, int n, int rb, int bp, int m, const int32_t* table,
                                int table_len, void* stream) {
  Cascade c;
  cudaError_t e = parse_cascade(table, table_len, &c);
  if (e != cudaSuccess) return e;
  if (bp < 1 || m < 0 || n < 2) return cudaErrorInvalidValue;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  const int tiles = ((n + 1) / 2 + bp - 1) / bp;
  unsigned blocks;
  if ((e = grid_1d(rows, rb, tiles, &blocks)) != cudaSuccess) return e;
  const size_t bytes = (size_t)rb * 2 * (bp + 2 * m) * sizeof(int32_t);
  if ((e = allow_smem(lift1d_inv_kernel, bytes)) != cudaSuccess) return e;
  lift1d_inv_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      s, d, x, rows, n, rb, bp, m, tiles, c);
  return cudaGetLastError();
}
