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
// gathering slices into depth windows.  A level is two passes over
// device memory wherever the scheme windows along H and a strip of whole
// rows fits a block (kernels/backend.py plane_rows):
//
//   forward:  the plane pass: one block per strip of R rows of one
//             (H, W) slice of the (B*D, H, W) stack loads rows
//             [r0 - halo, r0 + R + halo) at full width into shared
//             memory (16-byte cp.async copies; the rows inside the slice
//             are one contiguous run, and only the rows past its top or
//             bottom edge are reflected, once per row), runs the
//             band-policy cascade along W on every row and the interior
//             cascade along H over the window (as tiled2d.cu does), and
//             writes its R/2 core row pairs into the four (B*D, Hc, Wc)
//             code planes t0..t3.  Then the depth pass: one block per
//             (batch, code plane, slab, strip of cw plane columns) reads
//             its TD + 2*halo deep window straight from the (B, D, Hc*Wc)
//             plane (a warp along contiguous columns, looping down the
//             depth; only window entries past either end of D are
//             reflected), lifts it in place (cascade_cols_ext), and writes
//             its valid core: TD/2 (s, d) depth pairs, cropped at
//             ceil(D/2) and floor(D/2).  No windowed copy and no padded
//             output exist.
//   inverse:  the depth pass reads TD/2 + 2*m entries of the depth-even
//             and depth-odd bands (m = inv_margin) through reflect_entry
//             by parity, interleaves them into a 2*(TD/2 + 2m) window,
//             runs the inverse cascade in place and writes its TD depth
//             samples into t0..t3, cropped at D; then the inverse plane
//             pass reads the R/2 + 2m band rows of t0..t3 around its
//             strip (reflected by parity at the slice's edges),
//             interleaves them into an (R + 4m) x W window, runs the H
//             inverse interior cascade, then the W inverse band-policy
//             cascade on each core row, and writes R rows of x.
//
// Where the plane pass does not apply (a scheme that cannot window H,
// such as haar on odd H, or rows too wide for a block), the plane axes
// take the row pass along W and the column pass along H of passes.cuh,
// three passes per level in all.  The choice is the wrapper's, from the
// shape alone (a `plane_rows` of 0 selects the row and column passes).
//
// The depth windows reproduce the band-policy reference only for
// schemes that commute with whole-point reflection on this depth
// (scheme.can_window(D)); the dispatcher (kernels/fused3d.py) sends every
// other volume to whole3d.cu.
//
// Bound: memory.  A level must read every sample once and write every
// band once (8 bytes per sample at 3.35 TB/s).  This design moves each
// sample twice (the plane and depth passes: about 2x the bound's bytes),
// plus the H halo re-read (4m/R of the plane pass's input) and the depth
// halo re-read (4m/TD of the depth pass's input).  Where W is a multiple
// of 8 (plane pass) and every code plane's width a multiple of 4 (depth
// pass), copies and stores move 16 bytes a thread; other shapes take the
// same kernels with 4-byte accesses.  Measured on the H100, the depth
// pass runs near its bytes and the plane pass is bound by its lifting
// (PERF.md).  TD is sized from the card's shared memory
// (kernels/backend.py pick_slab), not from the TPU's default of 8.
#include "passes.cuh"
#include "terms.cuh"

namespace passes {

constexpr int kPlaneThreads = 512;

using lift2d::aligned16;
using lift2d::async_wait;
using lift2d::cascade_cols_ext;
using lift2d::copy_async;
using lift2d::copy_sync;
using lift2d::lift_terms;
using lift2d::pack_terms;
using lift2d::Terms;
using lift2d::TermStep;

// The cascades of the plane and depth passes.  Each thread keeps its
// line (a warp per row; a column per thread) and steps along it, so no
// sample pays a division or modulo to find its line and entry.

// Band-policy cascade along nl whole rows of n samples (row l at
// buf + l*n): one warp per row, lanes along its entries.
__device__ void cascade_rows(int32_t* buf, int nl, int n, const Terms& c) {
  const int len[2] = {(n + 1) >> 1, n >> 1};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int s = 0; s < c.nsteps; ++s) {
    const TermStep& st = c.steps[s];
    const int tpar = st.tgt_odd, spar = 1 - tpar;
    const int tlen = len[tpar], slen = len[spar];
    for (int l = warp; l < nl; l += nwarps) {
      int32_t* line = buf + (size_t)l * n;
      auto read = [&](int j) -> int32_t {
        if (j < 0 || j >= slen) j = reflect_entry(j, spar, n);
        return line[2 * j + spar];
      };
#pragma unroll 4
      for (int i = lane; i < tlen; i += 32) {
        int32_t* t = line + 2 * i + tpar;
        *t = lift_terms(st, *t, i, read);
      }
    }
    __syncthreads();
  }
}

// The four (nb, Hc, Wc) code planes between the plane and depth passes
// (bit 0: highpass along W, bit 1: along H).
struct Quad {
  int32_t* p[4];
};

// ---------------------------------------------------------------------------
// Plane pass: one block per strip of R rows of one (H, W) slice.
// ---------------------------------------------------------------------------

// Rows [first, first + rows) of one (H, W) slice into win (rows x W),
// reflected at the slice's edges.  The rows inside [0, H) are one
// contiguous run in both memories; a reflected row is mapped once and
// copied by one warp.
template <bool VEC>
__device__ void load_rows(int32_t* win, const int32_t* __restrict__ slice, int H, int W,
                          int first, int rows) {
  const int lo = max(first, 0), hi = min(first + rows, H);
  const int step = VEC ? 4 : 1;
  const int32_t* src = slice + (size_t)lo * W;
  int32_t* dst = win + (size_t)(lo - first) * W;
  const int n = (hi - lo) * W;
  for (int i = threadIdx.x * step; i < n; i += blockDim.x * step)
    copy_async<VEC>(dst + i, src + i);
  const int top = lo - first, nref = top + (first + rows - hi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int j = warp; j < nref; j += nwarps) {
    const int k = j < top ? j : hi - first + (j - top);
    const int32_t* s = slice + (size_t)reflect_index(first + k, H) * W;
    for (int e = lane * step; e < W; e += 32 * step)
      copy_async<VEC>(win + (size_t)k * W + e, s + e);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kPlaneThreads, 3)
    plane_fwd_kernel(const int32_t* __restrict__ x, Quad t, int H, int W, int R, int m,
                     int nstrips, Terms c) {
  extern __shared__ __align__(16) int32_t win[];
  const size_t z = blockIdx.x / nstrips;
  const int strip = blockIdx.x % nstrips;
  const int rows = R + 4 * m;
  load_rows<VEC>(win, x + z * H * W, H, W, strip * R - 2 * m, rows);
  async_wait();
  __syncthreads();
  // W: band policy on every whole row; H: interior math over the window
  cascade_rows(win, rows, W, c);
  cascade_cols_ext(win, W, W, rows / 2, c);
  const int he = (H + 1) >> 1, ho = H >> 1, we = (W + 1) >> 1, wo = W >> 1;
  const int q0 = strip * (R / 2);
  const int nq[2] = {min(R / 2, he - q0), min(R / 2, ho - q0)};
  const size_t zrow[2] = {z * he + q0, z * ho + q0};
  const int32_t* core = win + (size_t)2 * m * W;  // window row 2m + r is sample row r0 + r
  if (VEC) {  // W % 8 == 0: we == wo, rows of 16-byte groups
    const int per = we / 4;
    for (int idx = threadIdx.x; idx < R * per; idx += blockDim.x) {
      const int r = idx / per, p4 = idx - r * per, hp = r & 1;
      if ((r >> 1) >= nq[hp]) continue;
      const int4* v = reinterpret_cast<const int4*>(core + (size_t)r * W + 8 * p4);
      const int4 a = v[0], b = v[1];
      const size_t off = (zrow[hp] + (r >> 1)) * we + 4 * p4;
      *reinterpret_cast<int4*>(t.p[2 * hp] + off) = make_int4(a.x, a.z, b.x, b.z);
      *reinterpret_cast<int4*>(t.p[2 * hp + 1] + off) = make_int4(a.y, a.w, b.y, b.w);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * W; idx += blockDim.x) {
      const int r = idx / W, k = idx - r * W, hp = r & 1;
      if ((r >> 1) >= nq[hp]) continue;
      const int wd = (k & 1) ? wo : we;
      t.p[2 * hp + (k & 1)][(zrow[hp] + (r >> 1)) * wd + (k >> 1)] = core[idx];
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kPlaneThreads, 3)
    plane_inv_kernel(Quad t, int32_t* __restrict__ x, int H, int W, int R, int m, int nstrips,
                     Terms c) {
  extern __shared__ __align__(16) int32_t win[];
  const size_t z = blockIdx.x / nstrips;
  const int strip = blockIdx.x % nstrips;
  const int pr = R / 2 + 2 * m, rows = 2 * pr, qb = strip * (R / 2) - m;
  const int he = (H + 1) >> 1, ho = H >> 1, we = (W + 1) >> 1, wo = W >> 1;
  const int nb[2] = {he, ho};
  // window row r is band row qb + r/2 of the H-parity r&1 planes,
  // interleaved along W (s at even samples, d at odd)
  if (VEC) {
    const int per = we / 4;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < rows * per; idx += blockDim.x) {
      const int r = idx / per, p4 = idx - r * per, hp = r & 1;
      int g = qb + (r >> 1);
      if (g < 0 || g >= nb[hp]) g = reflect_entry(g, hp, H);
      const size_t off = ((size_t)z * nb[hp] + g) * we + 4 * p4;
      const int4 a = __ldg(reinterpret_cast<const int4*>(t.p[2 * hp] + off));
      const int4 b = __ldg(reinterpret_cast<const int4*>(t.p[2 * hp + 1] + off));
      int4* v = reinterpret_cast<int4*>(win + (size_t)r * W + 8 * p4);
      v[0] = make_int4(a.x, b.x, a.y, b.y);
      v[1] = make_int4(a.z, b.z, a.w, b.w);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * W; idx += blockDim.x) {
      const int r = idx / W, k = idx - r * W, hp = r & 1;
      int g = qb + (r >> 1);
      if (g < 0 || g >= nb[hp]) g = reflect_entry(g, hp, H);
      const int wd = (k & 1) ? wo : we;
      win[idx] = t.p[2 * hp + (k & 1)][((size_t)z * nb[hp] + g) * wd + (k >> 1)];
    }
  }
  __syncthreads();
  // H: interior inverse over the window; W: band policy on the core rows
  const int r0 = strip * R, nr = min(R, H - r0);
  int32_t* core = win + (size_t)2 * m * W;
  cascade_cols_ext(win, W, W, pr, c);
  cascade_rows(core, nr, W, c);
  int32_t* out = x + (z * H + r0) * W;
  const int step = VEC ? 4 : 1;
  for (int i = threadIdx.x * step; i < nr * W; i += blockDim.x * step)
    copy_sync<VEC>(out + i, core + i);
}

// The plane pass over `slices` (H, W) slices in strips of R rows, with
// margin m (forward: fwd_margin, window R + 2*halo; inverse: inv_margin,
// window R + 4m): x -> t0..t3, or t0..t3 -> x.
template <bool INVERSE>
cudaError_t launch_planes(const int32_t* x_in, int32_t* x_out, const Quad& t, long long slices,
                          int H, int W, int R, int m, const Cascade& c, cudaStream_t stream) {
  if (R < 2 || R % 2 || m < 0) return cudaErrorInvalidValue;
  const int nstrips = cdiv((H + 1) / 2, R / 2);
  unsigned blocks;
  cudaError_t e = flat_grid(slices * nstrips, &blocks);
  if (e != cudaSuccess) return e;
  const size_t bytes = (size_t)(R + 4 * m) * W * sizeof(int32_t);
  bool vec = W % 8 == 0 && aligned16(INVERSE ? x_out : x_in);
  for (int i = 0; i < 4; ++i) vec = vec && aligned16(t.p[i]);
  if (INVERSE) {
    auto k = vec ? plane_inv_kernel<true> : plane_inv_kernel<false>;
    if ((e = lift2d::allow_smem(k, bytes)) != cudaSuccess) return e;
    k<<<blocks, kPlaneThreads, bytes, stream>>>(t, x_out, H, W, R, m, nstrips, pack_terms(c));
  } else {
    auto k = vec ? plane_fwd_kernel<true> : plane_fwd_kernel<false>;
    if ((e = lift2d::allow_smem(k, bytes)) != cudaSuccess) return e;
    k<<<blocks, kPlaneThreads, bytes, stream>>>(x_in, t, H, W, R, m, nstrips, pack_terms(c));
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Depth pass: one block per (batch, code plane, slab, strip of cw
// columns); blocks are batch-major, then code plane, then slab, then
// strip.  A row of the window is cw / (VEC ? 4 : 1) copies wide; each
// thread keeps one column group and steps down the depth.
// ---------------------------------------------------------------------------

template <bool INVERSE, bool VEC>
__global__ void slab_kernel(Planes ps, int n, int td, int m, int nslabs, int cw, Terms c) {
  extern __shared__ __align__(16) int32_t win[];
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
  const int lanes = VEC ? cw / 4 : cw, kstep = blockDim.x / lanes;
  const int col = (threadIdx.x % lanes) * (VEC ? 4 : 1), k0 = threadIdx.x / lanes;
  const bool live = col < ncol && k0 < kstep;
  if (!INVERSE) {
    const int depth = td + 4 * m, start = t * td - 2 * m;
    if (live)
      for (int k = k0; k < depth; k += kstep) {
        int g = start + k;
        if (g < 0 || g >= n) g = reflect_index(g, n);
        copy_async<VEC>(win + k * cw + col, p.wide + wide0 + (size_t)g * p.wp + col);
      }
    async_wait();
    __syncthreads();
    cascade_cols_ext(win, cw, ncol, depth / 2, c);
    if (live)
      for (int q = k0; q < bd; q += kstep) {
        const int gq = t * bd + q;
        const int32_t* v = win + 2 * (m + q) * cw + col;
        if (gq < ne) copy_sync<VEC>(p.even + even0 + (size_t)gq * p.wp + col, v);
        if (gq < no) copy_sync<VEC>(p.odd + odd0 + (size_t)gq * p.wp + col, v + cw);
      }
  } else {
    const int pairs = bd + 2 * m, q0 = t * bd - m;
    if (live)
      for (int q = k0; q < pairs; q += kstep) {
        int ge = q0 + q, go = ge;
        if (ge < 0 || ge >= ne) ge = reflect_entry(ge, 0, n);
        if (go < 0 || go >= no) go = reflect_entry(go, 1, n);
        copy_async<VEC>(win + 2 * q * cw + col, p.even + even0 + (size_t)ge * p.wp + col);
        copy_async<VEC>(win + (2 * q + 1) * cw + col, p.odd + odd0 + (size_t)go * p.wp + col);
      }
    async_wait();
    __syncthreads();
    cascade_cols_ext(win, cw, ncol, pairs, c);
    if (live)
      for (int k = k0; k < td; k += kstep) {
        const int gz = t * td + k;
        if (gz < n)
          copy_sync<VEC>(p.wide + wide0 + (size_t)gz * p.wp + col, win + (2 * m + k) * cw + col);
      }
  }
}

// The depth pass over the four (B, D, Hc*Wc) code planes: forward margin
// m and windows of td + 4m samples, or inverse margin m and windows of
// td + 4m samples (2 * (td/2 + 2m)); strips of cw columns, a power of
// two up to kThreads.
template <bool INVERSE>
cudaError_t launch_slabs(const Planes& ps, int B, int D, int td, int m, int cw,
                         const Cascade& c, cudaStream_t stream) {
  if (td < 2 || td % 2 || m < 0 || cw < 1 || cw > kThreads || (cw & (cw - 1)))
    return cudaErrorInvalidValue;
  const int nslabs = cdiv((D + 1) / 2, td / 2);
  unsigned blocks;
  cudaError_t e = flat_grid((long long)B * nslabs * strips_per_batch(ps, cw), &blocks);
  if (e != cudaSuccess) return e;
  const size_t bytes = (size_t)(td + 4 * m) * cw * sizeof(int32_t);
  bool vec = cw % 4 == 0;
  for (int i = 0; i < ps.np; ++i)
    vec = vec && ps.p[i].wp % 4 == 0 && aligned16(ps.p[i].wide) && aligned16(ps.p[i].even) &&
          aligned16(ps.p[i].odd);
  auto k = vec ? slab_kernel<INVERSE, true> : slab_kernel<INVERSE, false>;
  if ((e = lift2d::allow_smem(k, bytes)) != cudaSuccess) return e;
  k<<<blocks, kThreads, bytes, stream>>>(ps, D, td, m, nslabs, cw, pack_terms(c));
  return cudaGetLastError();
}

}  // namespace passes

using namespace passes;

// Forward level: x (B, D, H, W) -> bands b0..b7 (code order), through the
// planes t0..t3 (B*D, Hc, Wc).  With `plane_rows` R > 0 the plane pass
// runs in strips of R rows (two passes in all); with 0 the row pass
// (through the row bands sw / dw (B*D*H, We/Wo), `rb` rows per block, one
// row in global scratch when `row_global`) and the column pass (strips
// of cw_h columns, 0: global scratch) run instead.  Slab depth td with
// forward margin m, slab strips of cw_s columns.  Returns a cudaError_t
// code.
extern "C" int repro_slab3d_fwd(int device, const int32_t* x, int32_t* sw, int32_t* dw,
                                int32_t* t0, int32_t* t1, int32_t* t2, int32_t* t3, int32_t* b0,
                                int32_t* b1, int32_t* b2, int32_t* b3, int32_t* b4, int32_t* b5,
                                int32_t* b6, int32_t* b7, int32_t* scratch, int B, int D, int H,
                                int W, int td, int m, int rb, int row_global, int cw_h, int cw_s,
                                int plane_rows, const int32_t* table, int table_len,
                                void* stream) {
  Args a;
  cudaError_t e = prepare(device, table, table_len, stream, B, D, H, W, &a);
  if (e != cudaSuccess) return e;
  int32_t* const t[4] = {t0, t1, t2, t3};
  const Bands8 b{{b0, b1, b2, b3, b4, b5, b6, b7}};
  if (plane_rows > 0) {
    e = launch_planes<false>(x, nullptr, Quad{{t0, t1, t2, t3}}, (long long)B * D, H, W,
                             plane_rows, m, a.c, a.stream);
  } else if ((e = launch_rows(false, x, nullptr, sw, dw, (long long)B * D * H, W, rb, row_global,
                              scratch, a.c, a.stream)) == cudaSuccess) {
    e = launch_cols<false>(h_planes(sw, dw, t, W), B * D, H, cw_h, scratch, a.c, a.stream);
  }
  if (e != cudaSuccess) return e;
  return launch_slabs<false>(d_planes(t, b, H, W), B, D, td, m, cw_s, a.c, a.stream);
}

// Inverse level: bands b0..b7 -> x (B, D, H, W), with inverse margin m:
// the depth pass into t0..t3, then the plane pass (plane_rows > 0) or the
// column and row passes (same geometry otherwise).
extern "C" int repro_slab3d_inv(int device, const int32_t* b0, const int32_t* b1,
                                const int32_t* b2, const int32_t* b3, const int32_t* b4,
                                const int32_t* b5, const int32_t* b6, const int32_t* b7,
                                int32_t* t0, int32_t* t1, int32_t* t2, int32_t* t3, int32_t* sw,
                                int32_t* dw, int32_t* x, int32_t* scratch, int B, int D, int H,
                                int W, int td, int m, int rb, int row_global, int cw_h, int cw_s,
                                int plane_rows, const int32_t* table, int table_len,
                                void* stream) {
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
  if (plane_rows > 0)
    return launch_planes<true>(nullptr, x, Quad{{t0, t1, t2, t3}}, (long long)B * D, H, W,
                               plane_rows, m, a.c, a.stream);
  if ((e = launch_cols<true>(h_planes(sw, dw, t, W), B * D, H, cw_h, scratch, a.c,
                             a.stream)) != cudaSuccess)
    return e;
  return launch_rows(true, sw, dw, x, nullptr, (long long)B * D * H, W, rb, row_global, scratch,
                     a.c, a.stream);
}
