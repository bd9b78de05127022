// Halo-tiled 2-D lifting level, forward and inverse, for sm_90a.
//
// Replaces the TPU kernels kernels/tiled2d.py::fwd2d_tiled (body
// _fwd_tile_kernel) and ::inv2d_tiled (body _inv_tile_kernel).  One block
// of 512 threads per (tile column, tile row, image):
//
//   forward:  the block reads its (TH + 2h) x (TW + 2h) window straight
//             from the image, h = scheme.halo, into shared memory, with
//             the window's first column aligned down to a multiple of 4
//             samples so that every in-range group of four columns is one
//             16-byte cp.async copy.  Positions past the image's edges
//             are mapped by whole-point reflection (the reference's
//             reflect_indices, the bytes its XLA gather materialises):
//             a row once per row, a group of columns past an edge sample
//             by sample, and a tile inside the image maps nothing.  Then
//             the row cascade on every window row and the column cascade
//             on the core columns, both interior-only (_walk_ext) on
//             packed shift-add terms (terms.cuh), and the four
//             (TH/2, TW/2) band tiles are de-interleaved from shared
//             memory into registers and written as 16-byte words, cropped
//             at the band edges.
//   inverse:  the block reads the four inv_margin-extended band windows
//             (m = inv_margin) into one (TH + 4m)-row window whose rows
//             are planar (the even-column band's entries, then the
//             odd-column band's), so that every in-range group of four
//             band entries is one 16-byte cp.async copy (entries past an
//             edge through reflect_entry, edge tiles only); runs the column
//             cascade on every window column, then the row cascade on the
//             core rows, and interleaves its (TH, TW) image tile from
//             shared memory in registers, written as 16-byte words,
//             cropped.
//
// Where the shape or a pointer's alignment forbids 16-byte words (W % 4
// for the forward's loads, W % 8 or TW % 8 for its stores, W % 8 for the
// inverse's loads, W % 4 or TW % 4 for its stores), the same kernel moves
// 4-byte words (template flags VLOAD / VSTORE, chosen by the launcher).
// No load, cascade or store loop divides: a thread's place in the tile
// is computed once per phase (Lanes), and reflection folds a position
// back across the edges (reflect_fold) instead of taking a modulo.
//
// The tile dataflow reproduces the band-policy reference only for
// schemes that commute with whole-point reflection (scheme.can_window);
// the dispatcher (kernels/fused2d.py) sends everything else to the
// whole-image kernel.
//
// Bound: memory.  One level reads the input and writes the outputs once:
// 8 bytes per sample at 3.35 TB/s.  The design makes one pass; its
// overheads are the halo re-reads ((TH+2h)(TW+2h)/(TH*TW) of the input:
// 1.06x at 128 x 128 tiles and h = 2 (cdf53), 1.13x at 124 x 128 and
// h = 4 (97m); 64 x 64 tiles would re-read 1.13x and 1.27x) and the
// tile's lifting steps separated by __syncthreads().  Tiles are sized so
// that three blocks share an SM's shared memory (kernels/backend.py
// pick_tile), not from the TPU's 252.  Measured on the H100, level 1
// copies its bytes at ~2.6 TB/s and the two cascades with their syncs
// add half as much again (PERF.md).
#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include "terms.cuh"

namespace lift2d {

constexpr int kTileThreads = 512;

// The four bands of one level in code order (bit 0: highpass along W,
// bit 1: along H): ll, hl, lh, hh.
struct Bands4 {
  int32_t* p[4];
};

// A block's threads over a grid of nx columns and any number of rows:
// this thread takes columns x0, x0 + xs, ... of rows y0, y0 + ys, ...
// Neighbouring threads take neighbouring columns; when the block has
// more threads than columns, the rest of them take further rows, and
// the threads past the last whole row idle (y0 beyond every row).
struct Lanes {
  int x0, xs, y0, ys;
  __device__ explicit Lanes(int nx) {
    const int n = blockDim.x;
    if (nx >= n) {
      x0 = threadIdx.x, xs = n, y0 = 0, ys = 1;
    } else {
      x0 = threadIdx.x % nx, xs = nx, y0 = threadIdx.x / nx, ys = n / nx;
      if (y0 >= ys) y0 = 1 << 30;
    }
  }
};

// Whole-point reflection of `pos` into [0, n) without a modulo: fold
// about 0 and about n - 1 until the position is in range (more than one
// fold only where the window is wider than the signal).  Equal to
// reflect_index.
__device__ __forceinline__ int reflect_fold(int pos, int n) {
  if (n == 1) return 0;
  while (pos < 0 || pos >= n) pos = pos < 0 ? -pos : 2 * (n - 1) - pos;
  return pos;
}

// Entry p of the parity-`parity` stream of a length-n signal, reflected
// into range (reflect_entry, by folding).
__device__ __forceinline__ int fold_entry(int p, int parity, int n) {
  return (reflect_fold(2 * p + parity, n) - parity) >> 1;
}

// Interior-only cascade (the reference's _walk_ext) along nl rows of
// pext pairs, row l at buf + l*ls: interleaved (entry j of parity q at
// 2j + q) or, PLANAR, the even entries at [0, pext) and the odd ones ps
// further.  Lanes take neighbouring entries of a row, the block's
// further threads further rows (Lanes over the step's target entries);
// each step's lift unrolled for its term count (with_terms).
template <bool PLANAR>
__device__ void cascade_rows_ext(int32_t* buf, int ls, int nl, int pext, int ps,
                                 const Terms& c) {
  int lo[2] = {0, 0}, hi[2] = {pext, pext};
  for (int s = 0; s < c.nsteps; ++s) {
    const TermStep& st = c.steps[s];
    const int tpar = st.tgt_odd, spar = 1 - tpar;
    const int nlo = max(lo[tpar], lo[spar] - st.min_off);
    const int nhi = min(hi[tpar], hi[spar] - st.max_off);
    if (nhi > nlo)
      with_terms(st, [&](auto n) {
        const Lanes t(nhi - nlo);
#pragma unroll 4
        for (int l = t.y0; l < nl; l += t.ys) {
          int32_t* line = buf + l * ls;
          auto at = [&](int j, int par) { return PLANAR ? par * ps + j : 2 * j + par; };
          auto read = [&](int j) -> int32_t { return line[at(j, spar)]; };
          for (int i = nlo + t.x0; i < nhi; i += t.xs) {
            int32_t* tg = line + at(i, tpar);
            *tg = lift_terms<decltype(n)::value>(st, *tg, i, read);
          }
        }
      });
    lo[tpar] = nlo;
    hi[tpar] = nhi;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Forward: window rows [r0, r0 + R), columns [ca, ca + cs) in shared
// memory, cs a multiple of 4; window column k (sample c0 + k) sits at
// shared column a + k, a = c0 - ca.
// ---------------------------------------------------------------------------

template <bool VLOAD, bool VSTORE>
__global__ void __launch_bounds__(kTileThreads, 3)
    tiled_fwd_kernel(const int32_t* __restrict__ x, Bands4 band, int H, int W, int th, int tw,
                     int m, int cs, Terms c) {
  extern __shared__ __align__(16) int32_t win[];
  const int halo = 2 * m, R = th + 2 * halo, C = tw + 2 * halo;
  const int tj = blockIdx.x, ti = blockIdx.y;
  const size_t b = blockIdx.z;
  const int r0 = ti * th - halo, c0 = tj * tw - halo;
  const int ca = c0 & ~3, a = c0 - ca;
  const int32_t* img = x + b * H * W;
  {
    // VLOAD: a group of four columns per lane, copied whole where it lies
    // inside the image; past an edge (edge tiles only) its columns are
    // folded once, before the rows, and copied sample by sample.
    // Otherwise one column per lane.
    const int nx = VLOAD ? cs / 4 : C, n = VLOAD ? 4 : 1;
    const Lanes t(nx);
    for (int gx = t.x0; gx < nx; gx += t.xs) {
      const int col = VLOAD ? ca + 4 * gx : c0 + gx;
      const bool inside = col >= 0 && col + n <= W;
      int cm[4] = {col, col, col, col};
      if (!inside)
        for (int e = 0; e < n; ++e) cm[e] = reflect_fold(col + e, W);
      int32_t* dst = win + (VLOAD ? 4 * gx : a + gx);
      for (int y = t.y0; y < R; y += t.ys) {
        int gr = r0 + y;
        if (gr < 0 || gr >= H) gr = reflect_fold(gr, H);
        const int32_t* src = img + (size_t)gr * W;
        if (inside)
          copy_async<VLOAD>(dst + y * cs, src + col);
        else
          for (int e = 0; e < n; ++e) dst[y * cs + e] = src[cm[e]];
      }
    }
  }
  async_wait();
  __syncthreads();
  // rows: R lines of C/2 pairs; then the core columns [h, h + tw) as
  // lines of R/2 pairs
  cascade_rows_ext<false>(win + a, cs, R, C / 2, 1, c);
  cascade_cols_ext<true>(win + a + halo, cs, tw, R / 2, c);
  const int bh = th / 2, bw = tw / 2;
  const int he = (H + 1) >> 1, ho = H >> 1, we = (W + 1) >> 1, wo = W >> 1;
  const int32_t* core = win + halo * cs + a + halo;  // core sample (0, 0)
  if (VSTORE) {  // W % 8 == 0 and tw % 8 == 0: we == wo, groups of 4 band entries
    const Lanes t(bw / 4);
    for (int gx = t.x0; gx < bw / 4; gx += t.xs) {
      const int gp = tj * bw + 4 * gx;
      if (gp >= we) break;
      for (int q = t.y0; q < bh; q += t.ys) {
        const int gq = ti * bh + q;
        if (gq >= he) break;
        const int4* v = reinterpret_cast<const int4*>(core + 2 * q * cs + 8 * gx);
        const int4 e0 = v[0], e1 = v[1];
        const size_t off = (b * he + gq) * we + gp;
        *reinterpret_cast<int4*>(band.p[0] + off) = make_int4(e0.x, e0.z, e1.x, e1.z);
        *reinterpret_cast<int4*>(band.p[1] + off) = make_int4(e0.y, e0.w, e1.y, e1.w);
        if (gq < ho) {
          const int4* u = reinterpret_cast<const int4*>(core + (2 * q + 1) * cs + 8 * gx);
          const int4 o0 = u[0], o1 = u[1];
          const size_t off2 = (b * ho + gq) * we + gp;
          *reinterpret_cast<int4*>(band.p[2] + off2) = make_int4(o0.x, o0.z, o1.x, o1.z);
          *reinterpret_cast<int4*>(band.p[3] + off2) = make_int4(o0.y, o0.w, o1.y, o1.w);
        }
      }
    }
  } else {
    const Lanes t(tw);
    for (int k = t.x0; k < tw; k += t.xs) {
      const int wp = k & 1, gp = tj * bw + (k >> 1), wd = wp ? wo : we;
      if (gp >= wd) continue;
      for (int r = t.y0; r < th; r += t.ys) {
        const int hp = r & 1, gq = ti * bh + (r >> 1), hd = hp ? ho : he;
        if (gq >= hd) continue;
        band.p[2 * hp + wp][(b * hd + gq) * wd + gp] = core[r * cs + k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Inverse: window pair rows [q0, q0 + pr) of the bands, 2*pr sample rows
// (even rows from ll / hl, odd rows from lh / hh), each row planar: band
// columns [pa, pa + half) of the even-column band (ll / lh) at [0, half),
// and of the odd-column band (hl / hh) at [half, cs), cs = 2 * half;
// pa = p0 aligned down to a multiple of 4, and window pair p (band
// column p0 + p) sits at a + p and half + a + p, a = p0 - pa.  Planar
// rows let every in-range group of four band entries arrive as one
// 16-byte cp.async copy, and the row cascade read adjacent entries.
// ---------------------------------------------------------------------------

template <bool VLOAD, bool VSTORE>
__global__ void __launch_bounds__(kTileThreads, 3)
    tiled_inv_kernel(Bands4 band, int32_t* __restrict__ x, int H, int W, int th, int tw, int m,
                     int cs, Terms c) {
  extern __shared__ __align__(16) int32_t win[];
  const int me = th / 2, mo = tw / 2;
  const int pr = me + 2 * m, pc = mo + 2 * m;  // window pairs along rows / columns
  const int rows = 2 * pr, half = cs / 2;
  const int tj = blockIdx.x, ti = blockIdx.y;
  const size_t b = blockIdx.z;
  const int q0 = ti * me - m, p0 = tj * mo - m;
  const int pa = p0 & ~3, a = p0 - pa;
  const int he = (H + 1) >> 1, ho = H >> 1, we = (W + 1) >> 1, wo = W >> 1;
  {
    // VLOAD (W % 8 == 0: we == wo): a group of four band entries of each
    // plane per lane, copied whole inside the bands and folded entry by
    // entry past an edge (edge tiles only); otherwise one entry of one
    // plane per lane, folded once
    const int nx = VLOAD ? half / 4 : cs;
    const Lanes t(nx);
    for (int gx = t.x0; gx < nx; gx += t.xs) {
      const int wp = VLOAD ? 0 : gx >= half;  // the plane of a scalar lane
      int col = pa + (VLOAD ? 4 * gx : gx - wp * half);
      const int wd = wp ? wo : we;
      const bool inside = VLOAD ? col >= 0 && col + 4 <= we : true;
      if (!VLOAD && (col < 0 || col >= wd)) col = fold_entry(col, wp, W);
      int32_t* dst = win + (VLOAD ? 4 * gx : gx);
      for (int y = t.y0; y < rows; y += t.ys) {
        const int hp = y & 1, hd = hp ? ho : he;
        int g = q0 + (y >> 1);
        if (g < 0 || g >= hd) g = fold_entry(g, hp, H);
        const int32_t* s = band.p[2 * hp + wp] + (b * hd + g) * wd;
        int32_t* d = dst + y * cs;
        if (!VLOAD) {
          copy_async<false>(d, s + col);
        } else if (inside) {
          copy_async<true>(d, s + col);
          copy_async<true>(d + half, band.p[2 * hp + 1] + (b * hd + g) * wd + col);
        } else {
          const int32_t* o = band.p[2 * hp + 1] + (b * hd + g) * wd;
          for (int e = 0; e < 4; ++e) {
            d[e] = s[fold_entry(col + e, 0, W)];
            d[half + e] = o[fold_entry(col + e, 1, W)];
          }
        }
      }
    }
  }
  async_wait();
  __syncthreads();
  // columns: the window's even-column entries [a, a + pc) through its
  // odd-column ones [half + a, half + a + pc), as lines of pr pairs; then
  // the core rows [2m, 2m + th) as planar lines of pc pairs
  cascade_cols_ext<true>(win + a, cs, half + pc, pr, c);
  cascade_rows_ext<true>(win + 2 * m * cs + a, cs, th, pc, half, c);
  const int32_t* core = win + 2 * m * cs + a + m;  // core pair 0 of the even plane
  int32_t* out = x + b * H * W;
  const int gr0 = ti * th, gc0 = tj * tw;
  if (VSTORE) {  // W % 4 == 0 and tw % 4 == 0: groups of 2 pairs, 4 samples
    const Lanes t(tw / 4);
    for (int gx = t.x0; gx < tw / 4; gx += t.xs) {
      const int gc = gc0 + 4 * gx;
      if (gc >= W) break;
      for (int r = t.y0; r < th && gr0 + r < H; r += t.ys) {
        const int2 e = *reinterpret_cast<const int2*>(core + r * cs + 2 * gx);
        const int2 o = *reinterpret_cast<const int2*>(core + r * cs + half + 2 * gx);
        int4* dst = reinterpret_cast<int4*>(out + (size_t)(gr0 + r) * W + gc);
        *dst = make_int4(e.x, o.x, e.y, o.y);
      }
    }
  } else {
    const Lanes t(tw);
    for (int k = t.x0; k < tw; k += t.xs) {
      const int gc = gc0 + k;
      if (gc >= W) break;
      const int32_t* src = core + (k & 1) * half + (k >> 1);
      for (int r = t.y0; r < th && gr0 + r < H; r += t.ys)
        out[(size_t)(gr0 + r) * W + gc] = src[r * cs];
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The largest offset a = (t * step - back) & 3 of a window's first entry
// past the aligned column before it, over the tile columns t.
inline int max_offset(int step, int back) {
  int amax = 0;
  for (int t = 0; t < 4; ++t) amax = std::max(amax, (t * step - back) & 3);
  return amax;
}

// The launch geometry: one block per (tile column, tile row, image).
inline cudaError_t tile_grid(int B, int H, int W, int th, int tw, dim3* grid) {
  if (B < 1 || H < 2 || W < 2 || th < 4 || tw < 4 || th % 2 || tw % 2)
    return cudaErrorInvalidValue;
  *grid = dim3(cdiv((W + 1) >> 1, tw / 2), cdiv((H + 1) >> 1, th / 2), B);
  return grid->y > 65535 || grid->z > 65535 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// A kernel's attributes are set when a launch first needs them on a
// device, not on every launch (each cudaFuncSetAttribute costs the host
// microseconds on every level): the largest shared-memory carveout, which
// three blocks per SM need, and the dynamic shared memory of the largest
// window launched so far.
template <class K>
cudaError_t prepare_kernel(K kernel, int device, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(reinterpret_cast<const void*>(kernel), device);
  const auto it = allowed.find(key);
  if (it != allowed.end() && it->second >= bytes) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) e = allow_smem(kernel, bytes);
  if (e == cudaSuccess) allowed[key] = bytes;
  return e;
}

}  // namespace lift2d

using namespace lift2d;

// Forward level over a (B, H, W) batch with (th, tw) core tiles and
// forward margin m (halo 2m).  Returns a cudaError_t code.
extern "C" int repro_tiled_fwd(int device, const int32_t* x, int32_t* ll, int32_t* lh,
                               int32_t* hl, int32_t* hh, int B, int H, int W, int th,
                               int tw, int m, const int32_t* table, int table_len,
                               void* stream) {
  Cascade c;
  cudaError_t e = parse_cascade(table, table_len, &c);
  if (e != cudaSuccess) return e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  const Bands4 band{{ll, hl, lh, hh}};
  const int cs = cdiv(max_offset(tw, 2 * m) + tw + 4 * m, 4) * 4;
  const size_t bytes = (size_t)(th + 4 * m) * cs * sizeof(int32_t);
  const bool vload = W % 4 == 0 && aligned16(x);
  bool vstore = W % 8 == 0 && tw % 8 == 0;
  for (int i = 0; i < 4; ++i) vstore = vstore && aligned16(band.p[i]);
  auto k = vload ? (vstore ? tiled_fwd_kernel<true, true> : tiled_fwd_kernel<true, false>)
                 : (vstore ? tiled_fwd_kernel<false, true> : tiled_fwd_kernel<false, false>);
  dim3 grid;
  if ((e = tile_grid(B, H, W, th, tw, &grid)) != cudaSuccess) return e;
  if ((e = prepare_kernel(k, device, bytes)) != cudaSuccess) return e;
  k<<<grid, kTileThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, band, H, W, th, tw, m, cs, pack_terms(c));
  return cudaGetLastError();
}

// Inverse level to a (B, H, W) batch with (th, tw) core tiles and
// inverse margin m.  Returns a cudaError_t code.
extern "C" int repro_tiled_inv(int device, const int32_t* ll, const int32_t* lh,
                               const int32_t* hl, const int32_t* hh, int32_t* x, int B,
                               int H, int W, int th, int tw, int m, const int32_t* table,
                               int table_len, void* stream) {
  Cascade c;
  cudaError_t e = parse_cascade(table, table_len, &c);
  if (e != cudaSuccess) return e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  const Bands4 band{{const_cast<int32_t*>(ll), const_cast<int32_t*>(hl),
                     const_cast<int32_t*>(lh), const_cast<int32_t*>(hh)}};
  const int cs = cdiv(2 * max_offset(tw / 2, m) + tw + 4 * m, 8) * 8;
  const size_t bytes = (size_t)(th + 4 * m) * cs * sizeof(int32_t);
  bool vload = W % 8 == 0;
  for (int i = 0; i < 4; ++i) vload = vload && aligned16(band.p[i]);
  const bool vstore = W % 4 == 0 && tw % 4 == 0 && aligned16(x);
  auto k = vload ? (vstore ? tiled_inv_kernel<true, true> : tiled_inv_kernel<true, false>)
                 : (vstore ? tiled_inv_kernel<false, true> : tiled_inv_kernel<false, false>);
  dim3 grid;
  if ((e = tile_grid(B, H, W, th, tw, &grid)) != cudaSuccess) return e;
  if ((e = prepare_kernel(k, device, bytes)) != cudaSuccess) return e;
  k<<<grid, kTileThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      band, x, H, W, th, tw, m, cs, pack_terms(c));
  return cudaGetLastError();
}
