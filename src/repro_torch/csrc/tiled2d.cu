// Halo-tiled 2-D lifting level, forward and inverse, for sm_90a.
//
// Replaces the TPU kernels kernels/tiled2d.py::fwd2d_tiled (body
// _fwd_tile_kernel) and ::inv2d_tiled (body _inv_tile_kernel).  One block
// per (tile column, tile row, image):
//
//   forward:  the block reads its (TH + 2h) x (TW + 2h) window straight
//             from the image, h = scheme.halo, mapping every out-of-range
//             position through whole-point reflection (reflect_index, the
//             reference's reflect_indices) — the bytes the reference's
//             XLA gather materialises, without materialising them.  The
//             window stays in shared memory; the row cascade and then
//             the column cascade run in place as interior-only math
//             (_walk_ext), and the block writes its four (TH/2, TW/2)
//             band tiles, cropped at the band edges.
//   inverse:  the block reads the four inv_margin-extended band windows
//             through reflect_entry (the reference's reflect_entries),
//             interleaves them into one (TH + 4m) x (TW + 4m) sample
//             window, runs the column then the row inverse cascade in
//             place, and writes its (TH, TW) image tile, cropped.
//
// The tile dataflow reproduces the band-policy reference only for
// schemes that commute with whole-point reflection (scheme.can_window);
// the dispatcher (kernels/fused2d.py) sends everything else to the
// whole-image kernel.
//
// Bound: memory.  One level reads the input and writes the outputs once:
// 8 bytes per sample at 3.35 TB/s.  The design makes one pass; its
// overheads are the halo re-reads ((TH+2h)(TW+2h)/(TH*TW) of the input,
// about 1.13x at 64x64 tiles and h = 4) and the tile's lifting steps
// separated by __syncthreads().  Tiles are sized from the H100's shared
// memory (kernels/backend.py pick_tile), not from the TPU's 252.
#include "lift2d.cuh"

namespace lift2d {

__global__ void tiled_fwd_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ ll,
                                 int32_t* __restrict__ lh, int32_t* __restrict__ hl,
                                 int32_t* __restrict__ hh, int H, int W, int th, int tw,
                                 int m, Cascade c) {
  extern __shared__ int32_t win[];
  const int halo = 2 * m;
  const int R = th + 2 * halo, C = tw + 2 * halo;
  const int tj = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  const int r0 = ti * th - halo, c0 = tj * tw - halo;
  const int32_t* img = x + (size_t)b * H * W;
  for (int idx = threadIdx.x; idx < R * C; idx += blockDim.x) {
    const int r = idx / C, k = idx % C;
    const int gr = reflect_index(r0 + r, H), gc = reflect_index(c0 + k, W);
    win[idx] = img[(size_t)gr * W + gc];
  }
  __syncthreads();
  // rows: R lines of C/2 pairs; then the core columns [2m, 2m + tw) as
  // lines of R/2 pairs
  cascade_ext<false>(win, 1, C, R, C / 2, c);
  cascade_ext<true>(win + halo, C, 1, tw, R / 2, c);
  const int bh = th / 2, bw = tw / 2;
  const int he = (H + 1) >> 1, ho = H >> 1, we = (W + 1) >> 1, wo = W >> 1;
  for (int idx = threadIdx.x; idx < bh * bw; idx += blockDim.x) {
    const int qq = idx / bw, pp = idx % bw;
    const int gq = ti * bh + qq, gp = tj * bw + pp;
    const int32_t* v = win + 2 * (m + qq) * C + 2 * (m + pp);
    if (gq < he && gp < we) ll[((size_t)b * he + gq) * we + gp] = v[0];
    if (gq < ho && gp < we) lh[((size_t)b * ho + gq) * we + gp] = v[C];
    if (gq < he && gp < wo) hl[((size_t)b * he + gq) * wo + gp] = v[1];
    if (gq < ho && gp < wo) hh[((size_t)b * ho + gq) * wo + gp] = v[C + 1];
  }
}

__global__ void tiled_inv_kernel(const int32_t* __restrict__ ll,
                                 const int32_t* __restrict__ lh,
                                 const int32_t* __restrict__ hl,
                                 const int32_t* __restrict__ hh, int32_t* __restrict__ x,
                                 int H, int W, int th, int tw, int m, Cascade c) {
  extern __shared__ int32_t win[];
  const int me = th / 2, mo = tw / 2;
  const int pr = me + 2 * m, pc = mo + 2 * m;  // window pairs along rows / columns
  const int C = 2 * pc;
  const int tj = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  const int q0 = ti * me - m, p0 = tj * mo - m;
  const int he = (H + 1) >> 1, ho = H >> 1, we = (W + 1) >> 1, wo = W >> 1;
  const int32_t* LL = ll + (size_t)b * he * we;
  const int32_t* LH = lh + (size_t)b * ho * we;
  const int32_t* HL = hl + (size_t)b * he * wo;
  const int32_t* HH = hh + (size_t)b * ho * wo;
  for (int idx = threadIdx.x; idx < pr * pc; idx += blockDim.x) {
    const int q = idx / pc, p = idx % pc;
    const int rs = reflect_entry(q0 + q, 0, H), rd = reflect_entry(q0 + q, 1, H);
    const int cs = reflect_entry(p0 + p, 0, W), cd = reflect_entry(p0 + p, 1, W);
    int32_t* v = win + 2 * q * C + 2 * p;
    v[0] = LL[(size_t)rs * we + cs];
    v[C] = LH[(size_t)rd * we + cs];
    v[1] = HL[(size_t)rs * wo + cd];
    v[C + 1] = HH[(size_t)rd * wo + cd];
  }
  __syncthreads();
  // columns: all C columns as lines of pr pairs; then the core rows
  // [2m, 2m + th) as lines of pc pairs
  cascade_ext<true>(win, C, 1, C, pr, c);
  cascade_ext<false>(win + 2 * m * C, 1, C, th, pc, c);
  const int32_t* core = win + 2 * m * C + 2 * m;
  for (int idx = threadIdx.x; idx < th * tw; idx += blockDim.x) {
    const int rr = idx / tw, cc = idx % tw;
    const int gr = ti * th + rr, gc = tj * tw + cc;
    if (gr < H && gc < W) x[((size_t)b * H + gr) * W + gc] = core[rr * C + cc];
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

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
  const int he = (H + 1) >> 1, we = (W + 1) >> 1;
  const dim3 grid(cdiv(we, tw / 2), cdiv(he, th / 2), B);
  const size_t bytes = (size_t)(th + 4 * m) * (tw + 4 * m) * sizeof(int32_t);
  if ((e = allow_smem(tiled_fwd_kernel, bytes)) != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  tiled_fwd_kernel<<<grid, kThreads, bytes, st>>>(
      x, ll, lh, hl, hh, H, W, th, tw, m, c);
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
  const int he = (H + 1) >> 1, we = (W + 1) >> 1;
  const dim3 grid(cdiv(we, tw / 2), cdiv(he, th / 2), B);
  const size_t bytes = (size_t)(th + 4 * m) * (tw + 4 * m) * sizeof(int32_t);
  if ((e = allow_smem(tiled_inv_kernel, bytes)) != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  tiled_inv_kernel<<<grid, kThreads, bytes, st>>>(
      ll, lh, hl, hh, x, H, W, th, tw, m, c);
  return cudaGetLastError();
}
