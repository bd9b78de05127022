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
// Each block stages whole lines (a group of rows, or a strip of adjacent
// columns over the full height) in shared memory, runs the band-policy
// cascade on them with one __syncthreads() per lifting step, and reads
// past the borders through reflect_entry — the reference's math
// (core/schemes.py _walk_policy), so every scheme and every shape down to
// 2x2 works, including cdf22 and haar on odd sizes.  A line too long for
// shared memory is staged in a global scratch buffer instead (same code,
// generic addressing), so there is no size cap.
//
// Bound: memory.  A level must read the input and write the four bands
// once (8 bytes per sample, int32 in and out, at 3.35 TB/s); this design
// also writes and reads the row-pass intermediates once (another 8 bytes
// per sample), so it is at best half the bound.  The whole-image path
// serves only the coarse levels (images up to the shared-memory size),
// which are small and L2-resident; the fine levels go to the tiled kernel
// (tiled2d.cu), which makes one pass.
#include "lift2d.cuh"

namespace lift2d {

// rb rows of one image per block; line buffer rb x W.
__global__ void row_fwd_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ s,
                               int32_t* __restrict__ d, int H, int W, int rb,
                               int32_t* gscratch, Cascade c) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.y, r0 = blockIdx.x * rb;
  const int nr = min(rb, H - r0);
  int32_t* buf = gscratch
      ? gscratch + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * rb * W
      : smem;
  const size_t row0 = (size_t)b * H + r0;
  for (int idx = threadIdx.x; idx < nr * W; idx += blockDim.x) buf[idx] = x[row0 * W + idx];
  __syncthreads();
  cascade_policy<false>(buf, 1, W, nr, W, c);
  const int we = (W + 1) >> 1, wo = W >> 1;
  for (int idx = threadIdx.x; idx < nr * W; idx += blockDim.x) {
    const int l = idx / W, k = idx % W, p = k >> 1;
    if (k & 1)
      d[(row0 + l) * wo + p] = buf[idx];
    else
      s[(row0 + l) * we + p] = buf[idx];
  }
}

// Inverse row pass: s_r, d_r -> x.
__global__ void row_inv_kernel(const int32_t* __restrict__ s, const int32_t* __restrict__ d,
                               int32_t* __restrict__ x, int H, int W, int rb,
                               int32_t* gscratch, Cascade c) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.y, r0 = blockIdx.x * rb;
  const int nr = min(rb, H - r0);
  int32_t* buf = gscratch
      ? gscratch + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * rb * W
      : smem;
  const size_t row0 = (size_t)b * H + r0;
  const int we = (W + 1) >> 1, wo = W >> 1;
  for (int idx = threadIdx.x; idx < nr * W; idx += blockDim.x) {
    const int l = idx / W, k = idx % W, p = k >> 1;
    buf[idx] = (k & 1) ? d[(row0 + l) * wo + p] : s[(row0 + l) * we + p];
  }
  __syncthreads();
  cascade_policy<false>(buf, 1, W, nr, W, c);
  for (int idx = threadIdx.x; idx < nr * W; idx += blockDim.x) x[row0 * W + idx] = buf[idx];
}

// One plane of the column passes: `wide` is the (B, H, wp) row band,
// `even` / `odd` its (B, He, wp) / (B, Ho, wp) column bands.
struct Plane {
  int32_t* wide;
  int32_t* even;
  int32_t* odd;
  int wp;
};

// Strips of cw adjacent columns over the full height; blocks
// [0, nstrips0) take plane p0, the rest p1.  Forward when !INVERSE
// (wide -> even/odd), inverse otherwise (even/odd -> wide).
template <bool INVERSE>
__global__ void col_kernel(Plane p0, Plane p1, int nstrips0, int H, int cw,
                           int32_t* gscratch, Cascade c) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.y;
  const bool second = blockIdx.x >= nstrips0;
  const Plane p = second ? p1 : p0;
  const int c0 = (second ? blockIdx.x - nstrips0 : blockIdx.x) * cw;
  const int ncol = min(cw, p.wp - c0);
  int32_t* buf = gscratch
      ? gscratch + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * H * cw
      : smem;
  const int he = (H + 1) >> 1, ho = H >> 1;
  const size_t wide0 = (size_t)b * H * p.wp + c0;
  const size_t even0 = (size_t)b * he * p.wp + c0;
  const size_t odd0 = (size_t)b * ho * p.wp + c0;
  for (int idx = threadIdx.x; idx < H * ncol; idx += blockDim.x) {
    const int l = idx % ncol, k = idx / ncol, q = k >> 1;
    if (INVERSE)
      buf[k * cw + l] = (k & 1) ? p.odd[odd0 + (size_t)q * p.wp + l]
                                : p.even[even0 + (size_t)q * p.wp + l];
    else
      buf[k * cw + l] = p.wide[wide0 + (size_t)k * p.wp + l];
  }
  __syncthreads();
  cascade_policy<true>(buf, cw, 1, ncol, H, c);
  for (int idx = threadIdx.x; idx < H * ncol; idx += blockDim.x) {
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

struct Geometry {
  int rb, row_global, cw, col_global;
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

cudaError_t launch_rows(bool inverse, const int32_t* in0, const int32_t* in1, int32_t* out0,
                        int32_t* out1, int B, int H, int W, const Geometry& g,
                        int32_t* scratch, const Cascade& c, cudaStream_t stream) {
  const dim3 grid(cdiv(H, g.rb), B);
  const size_t bytes = g.row_global ? 0 : (size_t)g.rb * W * sizeof(int32_t);
  int32_t* gs = g.row_global ? scratch : nullptr;
  cudaError_t e;
  if (inverse) {
    if ((e = allow_smem(row_inv_kernel, bytes)) != cudaSuccess) return e;
    row_inv_kernel<<<grid, kThreads, bytes, stream>>>(in0, in1, out0, H, W, g.rb, gs, c);
  } else {
    if ((e = allow_smem(row_fwd_kernel, bytes)) != cudaSuccess) return e;
    row_fwd_kernel<<<grid, kThreads, bytes, stream>>>(in0, out0, out1, H, W, g.rb, gs, c);
  }
  return cudaGetLastError();
}

template <bool INVERSE>
cudaError_t launch_cols(const Plane& p0, const Plane& p1, int B, int H, const Geometry& g,
                        int32_t* scratch, const Cascade& c, cudaStream_t stream) {
  const int n0 = cdiv(p0.wp, g.cw), n1 = cdiv(p1.wp, g.cw);
  const dim3 grid(n0 + n1, B);
  const size_t bytes = g.col_global ? 0 : (size_t)H * g.cw * sizeof(int32_t);
  cudaError_t e;
  if ((e = allow_smem(col_kernel<INVERSE>, bytes)) != cudaSuccess) return e;
  col_kernel<INVERSE><<<grid, kThreads, bytes, stream>>>(
      p0, p1, n0, H, g.cw, g.col_global ? scratch : nullptr, c);
  return cudaGetLastError();
}

}  // namespace lift2d

using namespace lift2d;

// Forward level: x -> (ll, lh, hl, hh) through the row-pass
// intermediates s_r, d_r.  `scratch` is null unless a line is staged in
// global memory (row_global / col_global).  Returns a cudaError_t code.
extern "C" int repro_whole_fwd(int device, const int32_t* x, int32_t* s_r, int32_t* d_r,
                               int32_t* ll, int32_t* lh, int32_t* hl, int32_t* hh,
                               int32_t* scratch, int B, int H, int W, int rb,
                               int row_global, int cw, int col_global,
                               const int32_t* table, int table_len, void* stream) {
  Cascade c;
  cudaError_t e = parse_cascade(table, table_len, &c);
  if (e != cudaSuccess) return e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  const Geometry g{rb, row_global, cw, col_global};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((e = launch_rows(false, x, nullptr, s_r, d_r, B, H, W, g, scratch, c, st)) != cudaSuccess)
    return e;
  const int we = (W + 1) >> 1, wo = W >> 1;
  const Plane p0{s_r, ll, lh, we}, p1{d_r, hl, hh, wo};
  return launch_cols<false>(p0, p1, B, H, g, scratch, c, st);
}

// Inverse level: (ll, lh, hl, hh) -> x through s_r, d_r.
extern "C" int repro_whole_inv(int device, const int32_t* ll, const int32_t* lh,
                               const int32_t* hl, const int32_t* hh, int32_t* s_r,
                               int32_t* d_r, int32_t* x, int32_t* scratch, int B, int H,
                               int W, int rb, int row_global, int cw, int col_global,
                               const int32_t* table, int table_len, void* stream) {
  Cascade c;
  cudaError_t e = parse_cascade(table, table_len, &c);
  if (e != cudaSuccess) return e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  const Geometry g{rb, row_global, cw, col_global};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int we = (W + 1) >> 1, wo = W >> 1;
  const Plane p0{s_r, const_cast<int32_t*>(ll), const_cast<int32_t*>(lh), we};
  const Plane p1{d_r, const_cast<int32_t*>(hl), const_cast<int32_t*>(hh), wo};
  if ((e = launch_cols<true>(p0, p1, B, H, g, scratch, c, st)) != cudaSuccess) return e;
  return launch_rows(true, s_r, d_r, x, nullptr, B, H, W, g, scratch, c, st);
}
