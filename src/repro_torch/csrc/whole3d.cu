// Whole-volume 3-D lifting level, forward and inverse, for sm_90a.
//
// Replaces the TPU kernels kernels/fused3d.py::_fwd3d_pallas (body
// _fwd3d_kernel) and ::_inv3d_pallas (body _inv3d_kernel): one level of
// a (B, D, H, W) int32 batch into its eight octant bands in code order
// (bit 0: highpass along W, bit 1: along H, bit 2: along D), and back,
// with band-policy math on all three axes — so every registered scheme
// and every shape down to 2x2x2 works, cdf22 and haar on odd sizes
// included.  The forward lifts W, then H, then D; the inverse D, H, W.
// Rounding makes the order part of the bits.
//
// On the TPU one grid cell holds one whole volume in VMEM.  One Hopper
// block holds about 58,000 int32 samples (227 KB), so:
//
//   * a volume within that budget runs in ONE block (volume_kernel): the
//     volume is read once into shared memory, lifted in place along W,
//     H and D (the in-place interleaved layout: a sample's parities on
//     the three axes are its band code), and written once as eight
//     bands — the TPU kernel's dataflow;
//   * a larger volume runs as three passes over device memory
//     (passes.cuh): rows (W), columns of the (B*D, H, w) planes (H),
//     and columns of the (B, D, H*W/4) planes (D) — the depth pass is the
//     column pass of that view, lines strided by the plane size and
//     threads along the contiguous plane columns, so loads coalesce.
//     Lines too long for shared memory are staged in global scratch.
//
// Bound: memory.  A level must read every sample once and write every
// band once (8 bytes per sample at 3.35 TB/s).  The one-block path moves
// exactly that; the three-pass path moves each sample three times (about
// 3x the bound's bytes) and is what a volume takes only where it cannot
// slab (cdf22 anywhere, haar on odd depth): the dispatcher
// (kernels/fused3d.py) sends slab-able large volumes to slab3d.cu.
#include "passes.cuh"

namespace passes {

// One block per (D, H, W) volume, all of it in shared memory.
template <bool INVERSE>
__global__ void __launch_bounds__(1024)
    volume_kernel(int32_t* x, Bands8 bands, int D, int H, int W, Cascade c) {
  extern __shared__ int32_t vol[];
  const int n = D * H * W;
  const int dd[2] = {(D + 1) >> 1, D >> 1}, hd[2] = {(H + 1) >> 1, H >> 1},
            wd[2] = {(W + 1) >> 1, W >> 1};
  int32_t* xv = x + (size_t)blockIdx.x * n;
  // sample (z, y, w) <-> entry (z/2, y/2, w/2) of band (w&1 | (y&1)<<1 | (z&1)<<2)
  auto band_at = [&](int idx) -> int32_t* {
    const int z = idx / (H * W), y = (idx / W) % H, w = idx % W;
    const int code = (w & 1) | ((y & 1) << 1) | ((z & 1) << 2);
    const int bd = dd[code >> 2], bh = hd[(code >> 1) & 1], bw = wd[code & 1];
    return bands.p[code] + (size_t)blockIdx.x * bd * bh * bw + ((z >> 1) * bh + (y >> 1)) * bw +
           (w >> 1);
  };
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
    vol[idx] = INVERSE ? *band_at(idx) : xv[idx];
  __syncthreads();
  if (INVERSE) {
    cascade_policy_mid(vol, 1, D, H * W, c);
    cascade_policy_mid(vol, D, H, W, c);
    cascade_policy<false>(vol, 1, W, D * H, W, c);
  } else {
    cascade_policy<false>(vol, 1, W, D * H, W, c);
    cascade_policy_mid(vol, D, H, W, c);
    cascade_policy_mid(vol, 1, D, H * W, c);
  }
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    if (INVERSE)
      xv[idx] = vol[idx];
    else
      *band_at(idx) = vol[idx];
  }
}

constexpr int kVolumeThreads = 1024;

template <bool INVERSE>
cudaError_t launch_volume(int32_t* x, const Bands8& b, int B, int D, int H, int W,
                          const Cascade& c, cudaStream_t stream) {
  const size_t bytes = (size_t)D * H * W * sizeof(int32_t);
  cudaError_t e = lift2d::allow_smem(volume_kernel<INVERSE>, bytes);
  if (e != cudaSuccess) return e;
  volume_kernel<INVERSE><<<B, kVolumeThreads, bytes, stream>>>(x, b, D, H, W, c);
  return cudaGetLastError();
}

}  // namespace passes

using namespace passes;

// Forward level: x (B, D, H, W) -> bands b0..b7 (code order).  When
// `fused` is set the volume fits one block and sw, dw, t0..t3 and scratch
// are unused (may be null); otherwise sw / dw are the (B*D*H, We/Wo) row
// bands, t0..t3 the (B*D, Hc, Wc) planes after the H pass, rows of `rb`
// (or one row in global scratch when `row_global`), and column strips of
// cw_h (H pass) and cw_d (D pass) columns, 0 meaning global scratch.
// Returns a cudaError_t code.
extern "C" int repro_whole3d_fwd(int device, const int32_t* x, int32_t* sw, int32_t* dw,
                                 int32_t* t0, int32_t* t1, int32_t* t2, int32_t* t3,
                                 int32_t* b0, int32_t* b1, int32_t* b2, int32_t* b3,
                                 int32_t* b4, int32_t* b5, int32_t* b6, int32_t* b7,
                                 int32_t* scratch, int B, int D, int H, int W, int fused, int rb,
                                 int row_global, int cw_h, int cw_d, const int32_t* table,
                                 int table_len, void* stream) {
  Args a;
  cudaError_t e = prepare(device, table, table_len, stream, B, D, H, W, &a);
  if (e != cudaSuccess) return e;
  const Bands8 b{{b0, b1, b2, b3, b4, b5, b6, b7}};
  if (fused) return launch_volume<false>(const_cast<int32_t*>(x), b, B, D, H, W, a.c, a.stream);
  int32_t* const t[4] = {t0, t1, t2, t3};
  const long long rows = (long long)B * D * H;
  if ((e = launch_rows(false, x, nullptr, sw, dw, rows, W, rb, row_global, scratch, a.c,
                       a.stream)) != cudaSuccess)
    return e;
  if ((e = launch_cols<false>(h_planes(sw, dw, t, W), B * D, H, cw_h, scratch, a.c,
                              a.stream)) != cudaSuccess)
    return e;
  return launch_cols<false>(d_planes(t, b, H, W), B, D, cw_d, scratch, a.c, a.stream);
}

// Inverse level: bands b0..b7 -> x (B, D, H, W), through t0..t3 and
// sw / dw unless `fused` (same geometry as the forward).
extern "C" int repro_whole3d_inv(int device, const int32_t* b0, const int32_t* b1,
                                 const int32_t* b2, const int32_t* b3, const int32_t* b4,
                                 const int32_t* b5, const int32_t* b6, const int32_t* b7,
                                 int32_t* t0, int32_t* t1, int32_t* t2, int32_t* t3,
                                 int32_t* sw, int32_t* dw, int32_t* x, int32_t* scratch, int B,
                                 int D, int H, int W, int fused, int rb, int row_global,
                                 int cw_h, int cw_d, const int32_t* table, int table_len,
                                 void* stream) {
  Args a;
  cudaError_t e = prepare(device, table, table_len, stream, B, D, H, W, &a);
  if (e != cudaSuccess) return e;
  const Bands8 b{{const_cast<int32_t*>(b0), const_cast<int32_t*>(b1), const_cast<int32_t*>(b2),
                  const_cast<int32_t*>(b3), const_cast<int32_t*>(b4), const_cast<int32_t*>(b5),
                  const_cast<int32_t*>(b6), const_cast<int32_t*>(b7)}};
  if (fused) return launch_volume<true>(x, b, B, D, H, W, a.c, a.stream);
  int32_t* const t[4] = {t0, t1, t2, t3};
  if ((e = launch_cols<true>(d_planes(t, b, H, W), B, D, cw_d, scratch, a.c, a.stream)) !=
      cudaSuccess)
    return e;
  if ((e = launch_cols<true>(h_planes(sw, dw, t, W), B * D, H, cw_h, scratch, a.c,
                             a.stream)) != cudaSuccess)
    return e;
  return launch_rows(true, sw, dw, x, nullptr, (long long)B * D * H, W, rb, row_global, scratch,
                     a.c, a.stream);
}
