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
//   * a volume whose rows, split over a thread-block cluster of c blocks
//     (c <= 16), fit one block's shared memory each runs as ONE cluster
//     per volume (cluster_kernel): block r of the cluster holds an
//     even-aligned run of rows of every slice (W and D whole), read once
//     from device memory; W and D lift in the block's own shared memory,
//     H lifts in place across the cluster, reading the rows that other
//     blocks own through distributed shared memory, one cluster barrier
//     per lifting step; the eight bands are written once.  c = 1 is one
//     block per volume, the same code;
//   * a larger volume runs as three passes over device memory
//     (passes.cuh): rows (W), columns of the (B*D, H, w) planes (H),
//     and columns of the (B, D, H*W/4) planes (D) — the depth pass is the
//     column pass of that view, lines strided by the plane size and
//     threads along the contiguous plane columns, so loads coalesce.
//     Lines too long for shared memory are staged in global scratch.
//
// Bound: memory.  A level must read every sample once and write every
// band once (8 bytes per sample at 3.35 TB/s).  The cluster path moves
// exactly that; at the coarse levels it serves (a few thousand to a few
// hundred thousand samples a volume) what it is far from is latency: a
// volume's cascades are serial steps with a barrier each, so the
// cluster spreads them over c SMs (c x B blocks for a batch of B, up to
// the card's 132 SMs), and the wrapper's host work (kernels/fused3d.py)
// is a cached plan and one allocation.  The three-pass path moves each
// sample three times (about 3x the bound's bytes) and is what a volume
// takes only where no cluster's shares fit a block and it cannot slab
// (cdf22 anywhere, haar on odd depth): the dispatcher sends slab-able
// large volumes to slab3d.cu.
#include <cooperative_groups.h>

#include "cluster.cuh"
#include "passes.cuh"
#include "terms.cuh"

namespace passes {

namespace cg = cooperative_groups;
using lift2d::lift_terms;
using lift2d::pack_terms;
using lift2d::Terms;
using lift2d::TermStep;
using lift2d::with_terms;

constexpr int kVolumeThreads = 1024;

// One block's share of a (D, H, W) volume: the row pairs
// [rank * P / c, (rank + 1) * P / c) of every slice, P = ceil(H / 2), so
// rows [y0, y0 + rows); sample (z, y, w) sits at z * stride + (y - y0) * W
// + w of the block's shared memory, and `stride` (rows of the largest
// share, times W) is the same in every block of the cluster.
struct Share {
  int D, H, W, c, pairs, y0, rows, stride;
};

__host__ __device__ inline int cluster_rows(int H, int c) { return 2 * cdiv((H + 1) >> 1, c); }

__device__ inline Share share_of(int D, int H, int W, int rank, int c) {
  Share v{D, H, W, c, (H + 1) >> 1, 0, 0, cluster_rows(H, c) * W};
  v.y0 = 2 * (rank * v.pairs / c);
  v.rows = min(2 * ((rank + 1) * v.pairs / c), H) - v.y0;
  return v;
}

// The rank of the block that owns row pair q, and that block's first row.
__device__ inline int owner_of(const Share& v, int q) { return ((q + 1) * v.c - 1) / v.pairs; }
__device__ inline int first_row(const Share& v, int rank) { return 2 * (rank * v.pairs / v.c); }

// Band-policy cascades, each step's lift unrolled for its term count
// (terms.cuh with_terms).  Along W: D * rows lines of W samples.
__device__ void lift_w(int32_t* vol, const Share& v, const Terms& c) {
  const int ne = (v.W + 1) >> 1, no = v.W >> 1;
  for (int s = 0; s < c.nsteps; ++s) {
    const TermStep& st = c.steps[s];
    const int tpar = st.tgt_odd, spar = 1 - tpar, slen = spar ? no : ne;
    with_terms(st, [&](auto n) {
      for (Walk it(v.rows, tpar ? no : ne); it.a < v.D; it.next()) {
        int32_t* line = vol + it.a * v.stride + it.b * v.W;
        auto read = [&](int j) -> int32_t {
          if (j < 0 || j >= slen) j = reflect_entry(j, spar, v.W);
          return line[2 * j + spar];
        };
        int32_t* t = line + 2 * it.k + tpar;
        *t = lift_terms<decltype(n)::value>(st, *t, it.k, read);
      }
    });
    __syncthreads();
  }
}

// Along D: rows * W lines of D samples, strided by the slice.
__device__ void lift_d(int32_t* vol, const Share& v, const Terms& c) {
  const int ne = (v.D + 1) >> 1, no = v.D >> 1;
  for (int s = 0; s < c.nsteps; ++s) {
    const TermStep& st = c.steps[s];
    const int tpar = st.tgt_odd, spar = 1 - tpar, slen = spar ? no : ne;
    with_terms(st, [&](auto n) {
      for (Walk it(1, v.rows * v.W); it.a < (tpar ? no : ne); it.next()) {
        int32_t* line = vol + it.k;
        auto read = [&](int j) -> int32_t {
          if (j < 0 || j >= slen) j = reflect_entry(j, spar, v.D);
          return line[(2 * j + spar) * v.stride];
        };
        int32_t* t = line + (2 * it.a + tpar) * v.stride;
        *t = lift_terms<decltype(n)::value>(st, *t, it.a, read);
      }
    });
    __syncthreads();
  }
}

// Along H, across the cluster: each block lifts the targets in its own
// rows; a source row another block owns (a neighbour's edge rows, or a
// reflection at an end of H) is read from that block's shared memory.
// Targets and sources of a step have opposite parity, so a step writes
// nothing that any block reads in it, and one cluster barrier per step
// orders it against the next; the barrier before the first step waits
// for every block's rows.  The barrier after the last step is also the
// exit barrier: no block reads another's shared memory after it, so a
// block may exit.
template <class Cluster>
__device__ void lift_h(int32_t* vol, const Share& v, const Terms& c, Cluster& cluster) {
  const int no = v.H >> 1, i0 = v.y0 >> 1;
  cluster.sync();
  for (int s = 0; s < c.nsteps; ++s) {
    const TermStep& st = c.steps[s];
    const int tpar = st.tgt_odd, spar = 1 - tpar, slen = spar ? no : v.pairs;
    const int targets = (v.rows + 1 - tpar) >> 1;  // 0 in a one-row share, odd step
    if (targets)
      with_terms(st, [&](auto n) {
        for (Walk it(targets, v.W); it.a < v.D; it.next()) {
          const int col = it.a * v.stride + it.k;
          auto read = [&](int j) -> int32_t {
            if (j < 0 || j >= slen) j = reflect_entry(j, spar, v.H);
            const int y = 2 * j + spar;
            if (static_cast<unsigned>(y - v.y0) < static_cast<unsigned>(v.rows))
              return vol[col + (y - v.y0) * v.W];
            const int o = owner_of(v, j);
            return cluster.map_shared_rank(vol, o)[col + (y - first_row(v, o)) * v.W];
          };
          int32_t* t = vol + col + (2 * it.b + tpar) * v.W;
          *t = lift_terms<decltype(n)::value>(st, *t, i0 + it.b, read);
        }
      });
    cluster.sync();
  }
}

// Entry (z/2, y/2, w/2) of band (w&1 | (y&1)<<1 | (z&1)<<2) of volume vi:
// a sample's parities on the three axes are its band code.
__device__ inline int32_t* band_entry(const Bands8& bands, int vi, int D, int H, int W, int z,
                                      int y, int w) {
  const int code = (w & 1) | ((y & 1) << 1) | ((z & 1) << 2);
  const int bd = (z & 1) ? D >> 1 : (D + 1) >> 1;
  const int bh = (y & 1) ? H >> 1 : (H + 1) >> 1;
  const int bw = (w & 1) ? W >> 1 : (W + 1) >> 1;
  return bands.p[code] + (size_t)vi * bd * bh * bw + ((size_t)(z >> 1) * bh + (y >> 1)) * bw +
         (w >> 1);
}

// One cluster of c blocks per (D, H, W) volume (blocks vi*c .. vi*c+c-1).
template <bool INVERSE>
__global__ void __launch_bounds__(kVolumeThreads)
    cluster_kernel(int32_t* x, Bands8 bands, int D, int H, int W, Terms c) {
  extern __shared__ int32_t vol[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int vi = blockIdx.x / nc;
  const Share v = share_of(D, H, W, static_cast<int>(cluster.block_rank()), nc);
  int32_t* xv = x + (size_t)vi * D * H * W;
  for (Walk it(v.rows, W); it.a < D; it.next()) {
    const int y = v.y0 + it.b;
    vol[it.a * v.stride + it.b * W + it.k] =
        INVERSE ? *band_entry(bands, vi, D, H, W, it.a, y, it.k)
                : xv[((size_t)it.a * H + y) * W + it.k];
  }
  __syncthreads();
  if (INVERSE) {
    lift_d(vol, v, c);
    lift_h(vol, v, c, cluster);
    lift_w(vol, v, c);
  } else {
    lift_w(vol, v, c);
    lift_h(vol, v, c, cluster);
    lift_d(vol, v, c);
  }
  for (Walk it(v.rows, W); it.a < D; it.next()) {
    const int y = v.y0 + it.b;
    const int32_t s = vol[it.a * v.stride + it.b * W + it.k];
    if (INVERSE)
      xv[((size_t)it.a * H + y) * W + it.k] = s;
    else
      *band_entry(bands, vi, D, H, W, it.a, y, it.k) = s;
  }
}

// A configuration the card cannot co-schedule is refused with its error
// code, never run another way.
template <bool INVERSE>
cudaError_t launch_cluster(int device, int32_t* x, const Bands8& b, int B, int D, int H, int W,
                           int nc, const Cascade& c, cudaStream_t stream) {
  if (nc < 1 || nc > kMaxCluster || nc > (H + 1) >> 1) return cudaErrorInvalidValue;
  unsigned blocks;
  const cudaError_t e = flat_grid((long long)B * nc, &blocks);
  if (e != cudaSuccess) return e;
  return launch_clusters(cluster_kernel<INVERSE>, device, blocks, nc, kVolumeThreads,
                         (size_t)D * cluster_rows(H, nc) * W * sizeof(int32_t), stream, x, b, D,
                         H, W, pack_terms(c));
}

}  // namespace passes

using namespace passes;

// How many clusters of `cluster` blocks, each block holding a share of
// `bytes`, the card co-schedules for both directions' kernels (the
// smaller), into *clusters; 0 where it cannot run one.  The geometry
// (kernels/fused3d.py) asks before it picks a cluster size.  Returns a
// cudaError_t code (a refusal leaves no error behind).
extern "C" int repro_whole3d_cluster_room(int device, int cluster, int bytes, int* clusters) {
  return cluster_room_pair(cluster_kernel<false>, cluster_kernel<true>, device, cluster,
                           kVolumeThreads, bytes, clusters);
}

// Forward level: x (B, D, H, W) -> bands b0..b7 (code order).  When
// `cluster` (c) is > 0, one cluster of c blocks holds each volume and
// sw, dw, t0..t3 and scratch are unused (may be null).  When it is 0,
// the three passes: sw / dw are the (B*D*H, We/Wo) row bands, t0..t3
// the (B*D, Hc, Wc) planes after the H pass, rows of `rb` (or one row in
// global scratch when `row_global`), and column strips of cw_h (H pass)
// and cw_d (D pass) columns, 0 meaning global scratch.  Returns a
// cudaError_t code.
extern "C" int repro_whole3d_fwd(int device, const int32_t* x, int32_t* sw, int32_t* dw,
                                 int32_t* t0, int32_t* t1, int32_t* t2, int32_t* t3,
                                 int32_t* b0, int32_t* b1, int32_t* b2, int32_t* b3,
                                 int32_t* b4, int32_t* b5, int32_t* b6, int32_t* b7,
                                 int32_t* scratch, int B, int D, int H, int W, int cluster, int rb,
                                 int row_global, int cw_h, int cw_d, const int32_t* table,
                                 int table_len, void* stream) {
  Args a;
  cudaError_t e = prepare(device, table, table_len, stream, B, D, H, W, &a);
  if (e != cudaSuccess) return e;
  const Bands8 b{{b0, b1, b2, b3, b4, b5, b6, b7}};
  if (cluster)
    return launch_cluster<false>(device, const_cast<int32_t*>(x), b, B, D, H, W, cluster, a.c,
                                 a.stream);
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

// Inverse level: bands b0..b7 -> x (B, D, H, W), one cluster of c =
// `cluster` blocks per volume, or through t0..t3 and sw / dw when it is
// 0 (same geometry as the forward).
extern "C" int repro_whole3d_inv(int device, const int32_t* b0, const int32_t* b1,
                                 const int32_t* b2, const int32_t* b3, const int32_t* b4,
                                 const int32_t* b5, const int32_t* b6, const int32_t* b7,
                                 int32_t* t0, int32_t* t1, int32_t* t2, int32_t* t3,
                                 int32_t* sw, int32_t* dw, int32_t* x, int32_t* scratch, int B,
                                 int D, int H, int W, int cluster, int rb, int row_global,
                                 int cw_h, int cw_d, const int32_t* table, int table_len,
                                 void* stream) {
  Args a;
  cudaError_t e = prepare(device, table, table_len, stream, B, D, H, W, &a);
  if (e != cudaSuccess) return e;
  const Bands8 b{{const_cast<int32_t*>(b0), const_cast<int32_t*>(b1), const_cast<int32_t*>(b2),
                  const_cast<int32_t*>(b3), const_cast<int32_t*>(b4), const_cast<int32_t*>(b5),
                  const_cast<int32_t*>(b6), const_cast<int32_t*>(b7)}};
  if (cluster) return launch_cluster<true>(device, x, b, B, D, H, W, cluster, a.c, a.stream);
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
