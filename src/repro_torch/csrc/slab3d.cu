// Depth-slab 3-D lifting level, forward and inverse, for sm_90a.
//
// Replaces the TPU kernels kernels/fused3d.py::fwd3d_slab (body
// _fwd_slab_kernel) and ::inv3d_slab (body _inv_slab_kernel).  The
// reference blocks a volume along depth only: each grid cell holds a
// window of TD + 2*halo depth slices (halo = scheme.halo) with the whole
// (H, W) plane, runs the band-policy math along W then H on every slice,
// and interior-only window math (_walk_ext) along depth.  It gathers the
// overlapping, reflected depth windows into a copy in device memory
// first (_depth_windows) and pads the output depth to whole slabs.
//
// Here the plane axes and the depth axis are separate passes, which is
// the same arithmetic: a plane transform of each slice commutes with
// gathering slices into depth windows.
//
//   forward:  row pass along W and column pass along H over the whole
//             (B*D, H, W) stack of slices (passes.cuh), then the slab
//             pass: one block per (batch, code plane, slab, strip of
//             plane columns) reads its TD + 2*halo deep window straight
//             from the (B, D, H*W/4) plane, reflecting every depth
//             position itself (reflect_index around t*TD - halo), lifts
//             it in place with cascade_ext, and writes only its valid
//             core: TD/2 (s, d) depth pairs, cropped at ceil(D/2) and
//             floor(D/2).  No windowed copy and no padded output exist.
//   inverse:  the slab pass reads TD/2 + 2*m entries of the depth-even
//             and depth-odd bands (m = inv_margin) through reflect_entry
//             by parity, interleaves them into a 2*(TD/2 + 2m) window,
//             runs the inverse cascade in place and writes its TD depth
//             samples, cropped at D; then the column pass along H and the
//             row pass along W.
//
// The depth windows reproduce the band-policy reference only for
// schemes that commute with whole-point reflection on this depth
// (scheme.can_window(D)); the dispatcher (kernels/fused3d.py) sends every
// other volume to whole3d.cu.
//
// Bound: memory.  A level must read every sample once and write every
// band once (8 bytes per sample at 3.35 TB/s).  This design moves each
// sample three times (the row, column and slab passes: about 3x the
// bound's bytes), plus the depth halo re-read (2*halo / TD of the slab
// pass's input).  TD is sized from the card's shared memory
// (kernels/backend.py pick_slab), not from the TPU's default of 8.
#include "passes.cuh"

namespace passes {

// Blocks are batch-major, then code plane, then slab, then strip.
template <bool INVERSE>
__global__ void slab_kernel(Planes ps, int n, int td, int m, int nslabs, int cw, Cascade c) {
  extern __shared__ int32_t win[];
  const int per_b = nslabs * strips_per_batch(ps, cw);
  const int b = blockIdx.x / per_b;
  int r = blockIdx.x % per_b;
  const Plane p = ps.p[find_plane(ps, cw, nslabs, &r)];
  const int strips = cdiv(p.wp, cw);
  const int t = r / strips, c0 = (r % strips) * cw;
  const int ncol = min(cw, p.wp - c0);
  const int ne = (n + 1) >> 1, no = n >> 1, bd = td / 2;
  const size_t wide0 = (size_t)b * n * p.wp + c0;
  const size_t even0 = (size_t)b * ne * p.wp + c0;
  const size_t odd0 = (size_t)b * no * p.wp + c0;
  if (!INVERSE) {
    const int halo = 2 * m, depth = td + 2 * halo, start = t * td - halo;
    for (int idx = threadIdx.x; idx < depth * ncol; idx += blockDim.x) {
      const int l = idx % ncol, k = idx / ncol;
      win[k * cw + l] = p.wide[wide0 + (size_t)reflect_index(start + k, n) * p.wp + l];
    }
    __syncthreads();
    cascade_ext<true>(win, cw, 1, ncol, depth / 2, c);
    for (int idx = threadIdx.x; idx < bd * ncol; idx += blockDim.x) {
      const int l = idx % ncol, q = idx / ncol, gq = t * bd + q;
      const int32_t* v = win + 2 * (m + q) * cw + l;
      if (gq < ne) p.even[even0 + (size_t)gq * p.wp + l] = v[0];
      if (gq < no) p.odd[odd0 + (size_t)gq * p.wp + l] = v[cw];
    }
  } else {
    const int pairs = bd + 2 * m, q0 = t * bd - m;
    for (int idx = threadIdx.x; idx < pairs * ncol; idx += blockDim.x) {
      const int l = idx % ncol, q = idx / ncol;
      win[2 * q * cw + l] = p.even[even0 + (size_t)reflect_entry(q0 + q, 0, n) * p.wp + l];
      win[(2 * q + 1) * cw + l] = p.odd[odd0 + (size_t)reflect_entry(q0 + q, 1, n) * p.wp + l];
    }
    __syncthreads();
    cascade_ext<true>(win, cw, 1, ncol, pairs, c);
    for (int idx = threadIdx.x; idx < td * ncol; idx += blockDim.x) {
      const int l = idx % ncol, k = idx / ncol, gz = t * td + k;
      if (gz < n) p.wide[wide0 + (size_t)gz * p.wp + l] = win[(2 * m + k) * cw + l];
    }
  }
}

// The slab pass over the four (B, D, Hc*Wc) code planes: forward margin
// m and windows of td + 4m samples, or inverse margin m and windows of
// td + 4m samples (2 * (td/2 + 2m)); strips of cw columns.
template <bool INVERSE>
cudaError_t launch_slabs(const Planes& ps, int B, int D, int td, int m, int cw,
                         const Cascade& c, cudaStream_t stream) {
  if (td < 2 || td % 2 || m < 0 || cw < 1) return cudaErrorInvalidValue;
  const int nslabs = cdiv((D + 1) / 2, td / 2);
  unsigned blocks;
  cudaError_t e = flat_grid((long long)B * nslabs * strips_per_batch(ps, cw), &blocks);
  if (e != cudaSuccess) return e;
  const size_t bytes = (size_t)(td + 4 * m) * cw * sizeof(int32_t);
  if ((e = lift2d::allow_smem(slab_kernel<INVERSE>, bytes)) != cudaSuccess) return e;
  slab_kernel<INVERSE><<<blocks, kThreads, bytes, stream>>>(ps, D, td, m, nslabs, cw, c);
  return cudaGetLastError();
}

}  // namespace passes

using namespace passes;

// Forward level: x (B, D, H, W) -> bands b0..b7 (code order), through the
// row bands sw / dw (B*D*H, We/Wo) and the planes t0..t3 (B*D, Hc, Wc).
// Rows of `rb` (one row in global scratch when `row_global`), H-pass
// strips of cw_h columns (0: global scratch), slab depth td with forward
// margin m, slab strips of cw_s columns.  Returns a cudaError_t code.
extern "C" int repro_slab3d_fwd(int device, const int32_t* x, int32_t* sw, int32_t* dw,
                                int32_t* t0, int32_t* t1, int32_t* t2, int32_t* t3, int32_t* b0,
                                int32_t* b1, int32_t* b2, int32_t* b3, int32_t* b4, int32_t* b5,
                                int32_t* b6, int32_t* b7, int32_t* scratch, int B, int D, int H,
                                int W, int td, int m, int rb, int row_global, int cw_h, int cw_s,
                                const int32_t* table, int table_len, void* stream) {
  Args a;
  cudaError_t e = prepare(device, table, table_len, stream, B, D, H, W, &a);
  if (e != cudaSuccess) return e;
  int32_t* const t[4] = {t0, t1, t2, t3};
  const Bands8 b{{b0, b1, b2, b3, b4, b5, b6, b7}};
  if ((e = launch_rows(false, x, nullptr, sw, dw, (long long)B * D * H, W, rb, row_global,
                       scratch, a.c, a.stream)) != cudaSuccess)
    return e;
  if ((e = launch_cols<false>(h_planes(sw, dw, t, W), B * D, H, cw_h, scratch, a.c,
                              a.stream)) != cudaSuccess)
    return e;
  return launch_slabs<false>(d_planes(t, b, H, W), B, D, td, m, cw_s, a.c, a.stream);
}

// Inverse level: bands b0..b7 -> x (B, D, H, W), with inverse margin m
// (same geometry otherwise).
extern "C" int repro_slab3d_inv(int device, const int32_t* b0, const int32_t* b1,
                                const int32_t* b2, const int32_t* b3, const int32_t* b4,
                                const int32_t* b5, const int32_t* b6, const int32_t* b7,
                                int32_t* t0, int32_t* t1, int32_t* t2, int32_t* t3, int32_t* sw,
                                int32_t* dw, int32_t* x, int32_t* scratch, int B, int D, int H,
                                int W, int td, int m, int rb, int row_global, int cw_h, int cw_s,
                                const int32_t* table, int table_len, void* stream) {
  Args a;
  cudaError_t e = prepare(device, table, table_len, stream, B, D, H, W, &a);
  if (e != cudaSuccess) return e;
  int32_t* const t[4] = {t0, t1, t2, t3};
  const Bands8 b{{const_cast<int32_t*>(b0), const_cast<int32_t*>(b1), const_cast<int32_t*>(b2),
                  const_cast<int32_t*>(b3), const_cast<int32_t*>(b4), const_cast<int32_t*>(b5),
                  const_cast<int32_t*>(b6), const_cast<int32_t*>(b7)}};
  if ((e = launch_slabs<true>(d_planes(t, b, H, W), B, D, td, m, cw_s, a.c, a.stream)) !=
      cudaSuccess)
    return e;
  if ((e = launch_cols<true>(h_planes(sw, dw, t, W), B * D, H, cw_h, scratch, a.c,
                             a.stream)) != cudaSuccess)
    return e;
  return launch_rows(true, sw, dw, x, nullptr, (long long)B * D * H, W, rb, row_global, scratch,
                     a.c, a.stream);
}
