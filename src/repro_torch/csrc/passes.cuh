// Line passes shared by the whole-image and 3-D lifting kernels
// (whole2d.cu, whole3d.cu, slab3d.cu), sm_90a.
//
// A level lifts along each of its axes in turn (2-D: W, then H; 3-D: W,
// H, then D; inverses in reverse).  When the data is larger than one
// block's shared memory, each axis is one pass over device memory:
//
//   row pass     lines along W: `rb` whole rows of one (rows, W) array per
//                block, with band-policy reads at the ends;
//   column pass  lines along H or D: an (nb, n, wp) array is cut into
//                strips of `cw` adjacent columns over the full line
//                length n, so neighbouring threads read neighbouring
//                addresses; up to four such arrays ("planes") per launch;
//   slab pass    lines along D, but only a depth window of TD + 2*halo
//                samples per block, reflected by the kernel itself, with
//                interior-only math (slab3d.cu).
//
// Each pass stages its lines in shared memory, or in a global scratch
// buffer when one line is longer than a block's shared memory (`cw` or
// `row_global` say which), so no size is refused.  Grids are flattened to
// one dimension (blockIdx.x), so a batch of many deep volumes never meets
// the 65,535 limit of gridDim.y; every global offset is size_t.
#pragma once

#include <climits>

#include "lift2d.cuh"

namespace passes {

using lift2d::Cascade;
using lift2d::cascade_ext;
using lift2d::cascade_policy;
using lift2d::kThreads;
using lift2d::lift_value;
using lift2d::reflect_entry;
using lift2d::reflect_index;
using lift2d::Step;

constexpr int kMaxPlanes = 4;
constexpr int kGlobalStrip = 32;  // strip width of a column pass staged in global memory

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// One array of a column or slab pass: `wide` is (nb, n, wp) line-major,
// `even` / `odd` its (nb, ceil(n/2), wp) / (nb, floor(n/2), wp) halves
// along n.  A forward pass reads wide and writes even/odd; an inverse
// pass reads even/odd and writes wide.
struct Plane {
  int32_t* wide;
  int32_t* even;
  int32_t* odd;
  int wp;
};

struct Planes {
  Plane p[kMaxPlanes];
  int np;
};

// The eight bands of one 3-D level, in code order (bit 0: highpass along
// W, bit 1: along H, bit 2: along D).
struct Bands8 {
  int32_t* p[8];
};

// ---------------------------------------------------------------------------
// Row pass: `rb` rows of W samples per block.
// ---------------------------------------------------------------------------

__global__ void row_fwd_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ s,
                               int32_t* __restrict__ d, long long rows, int W, int rb,
                               int32_t* gscratch, Cascade c) {
  extern __shared__ int32_t smem[];
  const long long r0 = (long long)blockIdx.x * rb;
  const int nr = (int)min((long long)rb, rows - r0);
  int32_t* buf = gscratch ? gscratch + (size_t)blockIdx.x * rb * W : smem;
  for (int idx = threadIdx.x; idx < nr * W; idx += blockDim.x) buf[idx] = x[(size_t)r0 * W + idx];
  __syncthreads();
  cascade_policy<false>(buf, 1, W, nr, W, c);
  const int we = (W + 1) >> 1, wo = W >> 1;
  for (int idx = threadIdx.x; idx < nr * W; idx += blockDim.x) {
    const int l = idx / W, k = idx % W, p = k >> 1;
    if (k & 1)
      d[(size_t)(r0 + l) * wo + p] = buf[idx];
    else
      s[(size_t)(r0 + l) * we + p] = buf[idx];
  }
}

__global__ void row_inv_kernel(const int32_t* __restrict__ s, const int32_t* __restrict__ d,
                               int32_t* __restrict__ x, long long rows, int W, int rb,
                               int32_t* gscratch, Cascade c) {
  extern __shared__ int32_t smem[];
  const long long r0 = (long long)blockIdx.x * rb;
  const int nr = (int)min((long long)rb, rows - r0);
  int32_t* buf = gscratch ? gscratch + (size_t)blockIdx.x * rb * W : smem;
  const int we = (W + 1) >> 1, wo = W >> 1;
  for (int idx = threadIdx.x; idx < nr * W; idx += blockDim.x) {
    const int l = idx / W, k = idx % W, p = k >> 1;
    buf[idx] = (k & 1) ? d[(size_t)(r0 + l) * wo + p] : s[(size_t)(r0 + l) * we + p];
  }
  __syncthreads();
  cascade_policy<false>(buf, 1, W, nr, W, c);
  for (int idx = threadIdx.x; idx < nr * W; idx += blockDim.x) x[(size_t)r0 * W + idx] = buf[idx];
}

// ---------------------------------------------------------------------------
// Column pass: strips of cw columns over the full line length n; blocks
// are batch-major, then plane, then strip.
// ---------------------------------------------------------------------------

// The plane and strip (or slab and strip) of block `r` within one batch
// entry, given `per` blocks per strip of each plane.
__device__ __forceinline__ int find_plane(const Planes& ps, int cw, int per, int* r) {
  int i = 0;
  while (i + 1 < ps.np && *r >= per * cdiv(ps.p[i].wp, cw)) {
    *r -= per * cdiv(ps.p[i].wp, cw);
    ++i;
  }
  return i;
}

__host__ __device__ inline int strips_per_batch(const Planes& ps, int cw) {
  int total = 0;
  for (int i = 0; i < ps.np; ++i) total += cdiv(ps.p[i].wp, cw);
  return total;
}

template <bool INVERSE>
__global__ void col_kernel(Planes ps, int n, int cw, int32_t* gscratch, Cascade c) {
  extern __shared__ int32_t smem[];
  const int per_b = strips_per_batch(ps, cw);
  const int b = blockIdx.x / per_b;
  int r = blockIdx.x % per_b;
  const Plane p = ps.p[find_plane(ps, cw, 1, &r)];
  const int c0 = r * cw, ncol = min(cw, p.wp - c0);
  int32_t* buf = gscratch ? gscratch + (size_t)blockIdx.x * n * cw : smem;
  const int ne = (n + 1) >> 1, no = n >> 1;
  const size_t wide0 = (size_t)b * n * p.wp + c0;
  const size_t even0 = (size_t)b * ne * p.wp + c0;
  const size_t odd0 = (size_t)b * no * p.wp + c0;
  for (int idx = threadIdx.x; idx < n * ncol; idx += blockDim.x) {
    const int l = idx % ncol, k = idx / ncol, q = k >> 1;
    if (INVERSE)
      buf[k * cw + l] = (k & 1) ? p.odd[odd0 + (size_t)q * p.wp + l]
                                : p.even[even0 + (size_t)q * p.wp + l];
    else
      buf[k * cw + l] = p.wide[wide0 + (size_t)k * p.wp + l];
  }
  __syncthreads();
  cascade_policy<true>(buf, cw, 1, ncol, n, c);
  for (int idx = threadIdx.x; idx < n * ncol; idx += blockDim.x) {
    const int l = idx % ncol, k = idx / ncol, q = k >> 1;
    const int32_t v = buf[k * cw + l];
    if (INVERSE)
      p.wide[wide0 + (size_t)k * p.wp + l] = v;
    else if (k & 1)
      p.odd[odd0 + (size_t)q * p.wp + l] = v;
    else
      p.even[even0 + (size_t)q * p.wp + l] = v;
  }
}

// ---------------------------------------------------------------------------
// Launchers.  `rb` / `row_global` come from the wrapper's row geometry;
// a column pass's `cw` of 0 means "stage in global scratch" (strips of
// kGlobalStrip columns then).  Each returns a cudaError_t code.
// ---------------------------------------------------------------------------

inline cudaError_t flat_grid(long long blocks, unsigned* out) {
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  *out = static_cast<unsigned>(blocks);
  return cudaSuccess;
}

inline cudaError_t launch_rows(bool inverse, const int32_t* in0, const int32_t* in1,
                               int32_t* out0, int32_t* out1, long long rows, int W, int rb,
                               int row_global, int32_t* scratch, const Cascade& c,
                               cudaStream_t stream) {
  if (rb < 1 || W < 2) return cudaErrorInvalidValue;
  unsigned blocks;
  cudaError_t e = flat_grid((rows + rb - 1) / rb, &blocks);
  if (e != cudaSuccess) return e;
  const size_t bytes = row_global ? 0 : (size_t)rb * W * sizeof(int32_t);
  int32_t* gs = row_global ? scratch : nullptr;
  if (row_global && !scratch) return cudaErrorInvalidValue;
  if (inverse) {
    if ((e = lift2d::allow_smem(row_inv_kernel, bytes)) != cudaSuccess) return e;
    row_inv_kernel<<<blocks, kThreads, bytes, stream>>>(in0, in1, out0, rows, W, rb, gs, c);
  } else {
    if ((e = lift2d::allow_smem(row_fwd_kernel, bytes)) != cudaSuccess) return e;
    row_fwd_kernel<<<blocks, kThreads, bytes, stream>>>(in0, out0, out1, rows, W, rb, gs, c);
  }
  return cudaGetLastError();
}

template <bool INVERSE>
cudaError_t launch_cols(const Planes& ps, int nb, int n, int cw, int32_t* scratch,
                        const Cascade& c, cudaStream_t stream) {
  if (n < 2 || cw < 0) return cudaErrorInvalidValue;
  const bool global = cw == 0;
  if (global && !scratch) return cudaErrorInvalidValue;
  const int w = global ? kGlobalStrip : cw;
  unsigned blocks;
  cudaError_t e = flat_grid((long long)nb * strips_per_batch(ps, w), &blocks);
  if (e != cudaSuccess) return e;
  const size_t bytes = global ? 0 : (size_t)n * w * sizeof(int32_t);
  if ((e = lift2d::allow_smem(col_kernel<INVERSE>, bytes)) != cudaSuccess) return e;
  col_kernel<INVERSE><<<blocks, kThreads, bytes, stream>>>(ps, n, w, global ? scratch : nullptr,
                                                            c);
  return cudaGetLastError();
}

// The four (B*D, Hc, Wc) planes between the H and D passes, as planes of
// the H pass (two: the W-lowpass and W-highpass row bands) or of the D
// pass (four: one per W/H code, each (B, D, Hc*Wc)).
inline Planes h_planes(int32_t* sw, int32_t* dw, int32_t* const t[4], int W) {
  Planes ps{};
  ps.np = 2;
  ps.p[0] = Plane{sw, t[0], t[2], (W + 1) >> 1};
  ps.p[1] = Plane{dw, t[1], t[3], W >> 1};
  return ps;
}

inline Planes d_planes(int32_t* const t[4], const Bands8& b, int H, int W) {
  const int hd[2] = {(H + 1) >> 1, H >> 1}, wd[2] = {(W + 1) >> 1, W >> 1};
  Planes ps{};
  ps.np = 4;
  for (int code = 0; code < 4; ++code)
    ps.p[code] = Plane{t[code], b.p[code], b.p[code | 4], hd[(code >> 1) & 1] * wd[code & 1]};
  return ps;
}

// The parsed scheme and the stream of one 3-D launcher call.
struct Args {
  Cascade c;
  cudaStream_t stream;
};

inline cudaError_t prepare(int device, const int32_t* table, int table_len, void* stream,
                           int B, int D, int H, int W, Args* a) {
  cudaError_t e = lift2d::parse_cascade(table, table_len, &a->c);
  if (e != cudaSuccess) return e;
  if (B < 1 || D < 2 || H < 2 || W < 2) return cudaErrorInvalidValue;
  a->stream = static_cast<cudaStream_t>(stream);
  return cudaSetDevice(device);
}

}  // namespace passes
