// Whole-image 2-D lifting levels, forward and inverse, for sm_90a.
//
// Replaces the TPU kernels kernels/fused2d.py::_fwd2d_pallas (body
// _fwd2d_kernel) and ::_inv2d_pallas (body _inv2d_kernel): one level of a
// (B, H, W) int32 batch into its four bands (ll, lh, hl, hh) and back,
// with band-policy math on both axes — so every registered scheme and
// every shape down to 2x2 works, cdf22 and haar on odd sizes included.
// The forward lifts W (rows), then H (columns); the inverse H, then W.
//
// On the TPU one grid cell holds one whole image in VMEM.  One Hopper
// block holds about 58,000 int32 samples (227 KB), so:
//
//   * an image whose rows, split over a thread-block cluster of c blocks
//     (c <= 16), fit one block's shared memory each runs as ONE cluster
//     per image (chain_kernel), and a run of L consecutive levels of a
//     pyramid runs in ONE launch: block r of the cluster holds a run of
//     whole rows, read once from device memory; W lifts in the block's
//     own shared memory, H lifts in place across the cluster, reading the
//     rows other blocks own through distributed shared memory, one
//     cluster barrier per lifting step.  The forward keeps each level's
//     LL in shared memory as the next level's image and writes each
//     level's lh / hl / hh and the last LL once; the inverse reads the
//     coarsest LL and every level's details once, rebuilds coarsest
//     first, and writes the image once.  Row ownership is cut in groups
//     of 2^(L-k) rows at level k (2^L rows of the first level), so a
//     block's rows at every level of the chain start on an even row and
//     each LL row stays with the block that lifted it;
//   * a larger image runs as two passes over device memory (passes.cuh):
//     a row pass x -> s_r, d_r, then a column pass into the bands (the
//     inverse in reverse), lines too long for shared memory staged in
//     global scratch.  Only schemes that cannot be tiled (cdf22, haar on
//     odd sizes) reach it, at large sizes: the dispatcher tiles others.
//
// Bound: memory.  A level must read every sample once and write every
// band once (8 bytes per sample at 3.35 TB/s); a run of levels, its first
// level's samples once and every band once (the bands partition them).
// The cluster path moves exactly that for the run of levels; at the
// coarse levels it serves (images of a few thousand to a few hundred
// thousand samples) what it is far from is latency: a level's cascades
// are serial steps with a barrier each, so the cluster spreads them over
// c SMs (c x B blocks for a batch of B, times the chain's levels within
// the card's 132 SMs: kernels/fused2d.py _pick_cluster), chaining the
// levels saves a launch and a round trip through device memory per
// level, and the wrapper's host work (kernels/fused2d.py) is a cached
// plan, one allocation and one launch.  The two-pass path also writes and reads
// the row-pass intermediates (about 2x the bound's bytes).
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

constexpr int kImageThreads = 512;
constexpr int kMaxChain = 16;  // levels of one launch

// The bands of a run of levels, four a level in code order (bit 0:
// highpass along W, bit 1: along H — ll, hl, lh, hh), finest level
// first; the ll of every level but the last is neither read nor written.
struct Chain {
  int32_t* p[4 * kMaxChain];
};

// Row groups of a chain of L levels of an H-row image: ceil(H / 2^L),
// the same count at every level, a group being 2^(L-k) rows at level k.
__host__ __device__ inline int chain_groups(int H, int L) { return (H + (1 << L) - 1) >> L; }

// Int32 entries of shared memory one block of a cluster of c holds: the
// largest level-0 share and, past one level, the largest level-1 share
// beside it (the chain's even levels use the first region, its odd
// levels the second).
__host__ __device__ inline long long chain_entries(int H, int W, int L, int c) {
  const long long per = cdiv(chain_groups(H, L), c);
  long long n = (per << L) * W;
  if (L > 1) n += (per << (L - 1)) * ((W + 1) >> 1);
  return n;
}

// One block's share of level k of a chain: the level's image is H x W;
// the block owns groups [rank * G / c, (rank + 1) * G / c) of the G
// groups of 2^shift rows, rows [y0, y0 + rows); sample (y, w) sits at
// base + (y - y0) * W + w of its shared memory, base being the level's
// region, the same in every block of the cluster.
struct Level {
  int H, W, shift, groups, c, y0, rows, base;
};

__device__ inline Level level_of(int H0, int W0, int L, int k, int rank, int c) {
  Level v;
  v.H = (H0 + (1 << k) - 1) >> k;
  v.W = (W0 + (1 << k) - 1) >> k;
  v.shift = L - k;
  v.groups = chain_groups(H0, L);
  v.c = c;
  v.y0 = (rank * v.groups / c) << v.shift;
  v.rows = min(((rank + 1) * v.groups / c) << v.shift, v.H) - v.y0;
  v.base = (k & 1) ? static_cast<int>((static_cast<long long>(cdiv(v.groups, c)) << L) * W0) : 0;
  return v;
}

// The rank of the block that owns row y of a level, and that block's
// first row.
__device__ inline int owner_of(const Level& v, int y) {
  return (((y >> v.shift) + 1) * v.c - 1) / v.groups;
}
__device__ inline int first_row(const Level& v, int rank) {
  return (rank * v.groups / v.c) << v.shift;
}

// Band-policy cascade along W: the block's rows of the level, each
// step's lift unrolled for its term count (terms.cuh with_terms).
__device__ void lift_w(int32_t* buf, const Level& v, const Terms& c) {
  int32_t* img = buf + v.base;
  const int ne = (v.W + 1) >> 1, no = v.W >> 1;
  for (int s = 0; s < c.nsteps; ++s) {
    const TermStep& st = c.steps[s];
    const int tpar = st.tgt_odd, spar = 1 - tpar, slen = spar ? no : ne;
    with_terms(st, [&](auto n) {
      for (Walk it(v.rows, tpar ? no : ne); it.a < 1; it.next()) {
        int32_t* line = img + it.b * v.W;
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

// Along H, across the cluster: each block lifts the targets in its own
// rows; a source row another block owns (a neighbour's edge rows, or a
// reflection at an end of H) is read from that block's shared memory.
// Targets and sources of a step have opposite parity, so a step writes
// nothing that any block reads in it, and one cluster barrier per step
// orders it against the next; the barrier before the first step waits
// for every block's rows.  After the last step's barrier no block reads
// another's rows of this level.
template <class Cluster>
__device__ void lift_h(int32_t* buf, const Level& v, const Terms& c, Cluster& cluster) {
  const int ne = (v.H + 1) >> 1, no = v.H >> 1, i0 = v.y0 >> 1;
  cluster.sync();
  for (int s = 0; s < c.nsteps; ++s) {
    const TermStep& st = c.steps[s];
    const int tpar = st.tgt_odd, spar = 1 - tpar, slen = spar ? no : ne;
    const int targets = (v.rows + 1 - tpar) >> 1;  // 0 in a one-row share, odd step
    if (targets)
      with_terms(st, [&](auto n) {
        for (Walk it(targets, v.W); it.a < 1; it.next()) {
          auto read = [&](int j) -> int32_t {
            if (j < 0 || j >= slen) j = reflect_entry(j, spar, v.H);
            const int y = 2 * j + spar;
            if (static_cast<unsigned>(y - v.y0) < static_cast<unsigned>(v.rows))
              return buf[v.base + (y - v.y0) * v.W + it.k];
            const int o = owner_of(v, y);
            return cluster.map_shared_rank(buf, o)[v.base + (y - first_row(v, o)) * v.W + it.k];
          };
          int32_t* t = buf + v.base + (2 * it.b + tpar) * v.W + it.k;
          *t = lift_terms<decltype(n)::value>(st, *t, i0 + it.b, read);
        }
      });
    cluster.sync();
  }
}

// Entry (y/2, w/2) of band (w&1 | (y&1)<<1) of level k of image vi: a
// sample's parities on the two axes are its band code.
__device__ inline int32_t* band_entry(const Chain& ch, int k, int vi, int H, int W, int y,
                                      int w) {
  const int bh = (y & 1) ? H >> 1 : (H + 1) >> 1;
  const int bw = (w & 1) ? W >> 1 : (W + 1) >> 1;
  return ch.p[4 * k + ((w & 1) | ((y & 1) << 1))] + (size_t)vi * bh * bw +
         (size_t)(y >> 1) * bw + (w >> 1);
}

// A contiguous run of n int32 between device memory and the block's
// shared memory, 16 bytes a thread on the device side from its first
// 16-byte boundary on (the shared side takes four 4-byte accesses: the
// two sides' alignments differ in general).
template <bool TO_SHARED>
__device__ void copy_run(int32_t* smem, int32_t* gmem, int n) {
  const int head =
      min(n, static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(gmem) >> 2) & 3)) & 3));
  const int nv = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x) {
    if (TO_SHARED)
      smem[i] = gmem[i];
    else
      gmem[i] = smem[i];
  }
  int4* g4 = reinterpret_cast<int4*>(gmem + head);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    int32_t* s = smem + head + 4 * i;
    if (TO_SHARED) {
      const int4 v = g4[i];
      s[0] = v.x;
      s[1] = v.y;
      s[2] = v.z;
      s[3] = v.w;
    } else {
      g4[i] = make_int4(s[0], s[1], s[2], s[3]);
    }
  }
  for (int i = head + 4 * nv + threadIdx.x; i < n; i += blockDim.x) {
    if (TO_SHARED)
      smem[i] = gmem[i];
    else
      gmem[i] = smem[i];
  }
}

// One cluster of c blocks per (H0, W0) image (blocks vi*c .. vi*c+c-1),
// L levels.  Forward: the block's rows of x in, then per level W, H,
// and the level's samples out — lh / hl / hh to their bands, LL into the
// next level's region (the last level's LL to its band).  Inverse: per
// level, coarsest first, the LL from the coarser level's region (the
// last level's from its band) and the details in, then H, W; the image
// out.  An LL row stays with the block that holds it: the block's rows
// at level k + 1 are the halves of its even rows at level k.
template <bool INVERSE>
__global__ void __launch_bounds__(kImageThreads)
    chain_kernel(int32_t* x, Chain ch, int H0, int W0, int L, Terms c) {
  extern __shared__ int32_t buf[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int vi = blockIdx.x / nc;
  const Level top = level_of(H0, W0, L, 0, rank, nc);
  int32_t* xv = x + ((size_t)vi * H0 + top.y0) * W0;
  if (!INVERSE) {
    copy_run<true>(buf, xv, top.rows * W0);
    __syncthreads();
  }
  for (int i = 0; i < L; ++i) {
    const int k = INVERSE ? L - 1 - i : i;
    const Level v = level_of(H0, W0, L, k, rank, nc);
    const bool chained = k < L - 1;  // LL lives in the region of level k + 1
    const Level n = chained ? level_of(H0, W0, L, k + 1, rank, nc) : v;
    if (INVERSE) {
      for (Walk it(v.rows, v.W); it.a < 1; it.next()) {
        const int y = v.y0 + it.b, w = it.k;
        buf[v.base + it.b * v.W + w] =
            chained && !((y | w) & 1) ? buf[n.base + ((y >> 1) - n.y0) * n.W + (w >> 1)]
                                      : *band_entry(ch, k, vi, v.H, v.W, y, w);
      }
      // the first barrier of the H cascade orders the stores above
      lift_h(buf, v, c, cluster);
      lift_w(buf, v, c);
    } else {
      lift_w(buf, v, c);
      lift_h(buf, v, c, cluster);
      for (Walk it(v.rows, v.W); it.a < 1; it.next()) {
        const int y = v.y0 + it.b, w = it.k;
        const int32_t s = buf[v.base + it.b * v.W + w];
        if (chained && !((y | w) & 1))
          buf[n.base + ((y >> 1) - n.y0) * n.W + (w >> 1)] = s;
        else
          *band_entry(ch, k, vi, v.H, v.W, y, w) = s;
      }
      __syncthreads();
    }
  }
  if (INVERSE) copy_run<false>(buf, xv, top.rows * W0);
}

// A configuration the card cannot co-schedule, or a chain the shape
// cannot take, is refused with its error code, never run another way.
template <bool INVERSE>
cudaError_t launch_chain(int device, int32_t* x, const long long* ptrs, int B, int H, int W,
                         int L, int nc, const int32_t* table, int table_len, void* stream) {
  Cascade c;
  cudaError_t e = lift2d::parse_cascade(table, table_len, &c);
  if (e != cudaSuccess) return e;
  if (B < 1 || L < 1 || L > kMaxChain || nc < 1 || nc > kMaxCluster ||
      nc > chain_groups(H, L))
    return cudaErrorInvalidValue;
  const int last = L - 1;  // the chain's last level is at least 2 x 2
  if (((H + (1 << last) - 1) >> last) < 2 || ((W + (1 << last) - 1) >> last) < 2)
    return cudaErrorInvalidValue;
  const long long entries = chain_entries(H, W, L, nc);
  if (entries > INT_MAX / 4) return cudaErrorInvalidValue;
  Chain ch{};
  for (int i = 0; i < 4 * L; ++i) ch.p[i] = reinterpret_cast<int32_t*>(ptrs[i]);
  unsigned blocks;
  if ((e = flat_grid((long long)B * nc, &blocks)) != cudaSuccess) return e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  return launch_clusters(chain_kernel<INVERSE>, device, blocks, nc, kImageThreads,
                         static_cast<size_t>(entries) * sizeof(int32_t),
                         static_cast<cudaStream_t>(stream), x, ch, H, W, L, pack_terms(c));
}

}  // namespace passes

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

// How many clusters of `cluster` blocks, each block holding `bytes` of
// shared memory, the card co-schedules for both directions' chain
// kernels (the smaller), into *clusters; 0 where it cannot run one.  The
// plan (kernels/fused2d.py) asks before it picks a cluster size.  Returns
// a cudaError_t code (a refusal leaves no error behind).
extern "C" int repro_whole2d_cluster_room(int device, int cluster, int bytes, int* clusters) {
  return cluster_room_pair(chain_kernel<false>, chain_kernel<true>, device, cluster,
                           kImageThreads, bytes, clusters);
}

// Forward run of `levels` levels from x (B, H, W): one cluster of
// `cluster` blocks per image.  `ptrs` (host memory) holds 4 * levels
// device addresses, each level's bands in code order (ll, hl, lh, hh),
// finest level first; only the last level's ll is written.  Returns a
// cudaError_t code.
extern "C" int repro_whole2d_cluster_fwd(int device, const int32_t* x, const long long* ptrs,
                                         int B, int H, int W, int levels, int cluster,
                                         const int32_t* table, int table_len, void* stream) {
  return launch_chain<false>(device, const_cast<int32_t*>(x), ptrs, B, H, W, levels, cluster,
                             table, table_len, stream);
}

// Inverse run: the bands at `ptrs` (as the forward's; only the last
// level's ll is read) -> x (B, H, W).
extern "C" int repro_whole2d_cluster_inv(int device, const long long* ptrs, int32_t* x, int B,
                                         int H, int W, int levels, int cluster,
                                         const int32_t* table, int table_len, void* stream) {
  return launch_chain<true>(device, x, ptrs, B, H, W, levels, cluster, table, table_len, stream);
}
