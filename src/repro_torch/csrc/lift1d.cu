// Windowed 1-D lifting, forward and inverse, one launch per run of levels
// (sm_90a).
//
// Replaces the TPU kernels kernels/dwt53.py::lift_fwd_windows (body
// _fwd_kernel) and ::lift_inv_windows (body _inv_kernel), which run one
// level per call: here one launch runs L consecutive levels of a (rows,
// n) int32 signal (windowed, or band-policy: see below; the reference
// computes the latter in-graph), keeping every intermediate approximation in
// shared memory.  A work item is `rb` rows of one tile; each row has its
// own lanes (a power-of-two group of the block's 128 threads, fixed per
// thread, so no sample pays a divide to find its row).  Blocks are
// persistent (as many as the card keeps resident) and walk the items in
// grid strides, issuing the next item's loads (cp.async, one commit group
// an item) before they lift the current one, so every block keeps a
// tile's bytes in flight while it computes.
//
//   forward:  a tile owns T level-0 samples (T a multiple of 2^L), so T_k
//             = T >> k samples of level k.  Its level-k window reaches
//             E_k = h * (2^(L-k) - 1) samples past the core on each side
//             (h = the scheme's halo).  The level-0 window is read once
//             (coalesced 4-byte copies, reflected at the line's ends) into
//             one of two load buffers, split as it lands into an even and
//             an odd plane; then at each level the window is lifted in
//             place as interior-only math on the packed terms of
//             terms.cuh, its d core written to that level's band and its
//             s entries split into the next level's planes.  The last
//             level writes its s core too.
//   inverse:  the mirror image.  A tile owns T level-0 output samples; its
//             level-k window holds T_k / 2 + 2 P_k pairs, P_0 = m and
//             P_k = ceil(P_{k-1} / 2) + m (m = the inverse margin).  The
//             coarsest s window and every level's d window are read at
//             once into a load region (reflected at the ends), where each
//             d window is its level's odd plane; levels merge coarse to
//             fine in shared memory, and the x core is written once.
//
// Line ends: the reference reflects at every level's own length n_k
// (whole-point; reflect_index / reflect_entry).  A level-0 reflection
// carried down is wrong where n_k is even (the s band then ends
// half-point symmetric), so a tile whose level-k window crosses an end
// rewrites each out-of-range entry with the in-range entry that level's
// reflection names, from the entries it already holds; an entry whose
// source lies outside the window keeps its own value and never reaches a
// written core (held by the numpy mirror in tests/test_torch_lift1d_run.py
// against the per-level plain versions).  Interior tiles reflect nothing.
//
// That reflection once a level reproduces the band-policy reference only
// for schemes that commute with whole-point reflection (scheme.can_window)
// on every level's length.  The reference (schemes.py _walk_policy)
// reflects the current streams at every lifting STEP, so the POLICY
// instantiation of both kernels (cdf22; haar on odd lengths; any run with
// a level the scheme cannot window) follows each step, in a work item
// whose window crosses a line end, with a barrier and a rewrite of the
// step's target: each out-of-range entry in the step's valid range takes
// the value of the in-range entry of the same stream that reflect_entry
// names, where that entry is valid too.  The condition is the item's tile,
// uniform over the block, so interior items pay nothing.  The planner
// gives policy runs one more pair of margin than the scheme needs: a last
// tile may hold a single in-range entry at some level, and the source of
// its rewrite then lies one pair before its core (held by the numpy mirror
// in tests/test_torch_policy_run.py against the band policy).
//
// Bound: memory.  A run reads the level-0 signal once and writes every
// band once: 8 bytes per level-0 sample at 3.35 TB/s.  Overheads: the
// overlap re-read (2 E_0 / T of the input, 1.5% for cdf53 at L = 4 and
// T = 4096) and one __syncthreads() per lifting step and level; the planes
// keep every shared-memory access of the cascade unit-stride, one read a
// tap.  Tile and rows per block come from the card's shared memory
// (kernels/backend.py run_tile).
#include <algorithm>
#include <climits>

#include "terms.cuh"

#ifndef __CUDACC__
#define __grid_constant__
#endif

namespace lift1d {

using namespace lift2d;

constexpr int kMaxRun = 16;
constexpr int kRunThreads = 128;
constexpr int kMaxRows = kRunThreads / 32;

// Device addresses of a run's bands: d_0 .. d_{L-1}, then s_{L-1}.
struct Bands {
  int32_t* p[kMaxRun + 1];
};

struct Geom {
  int rows, n, levels, tile, rb, lg, m, tiles, items;
  int pitch_a, pitch_b, pitch_r, pitch;  // per row: load buffers, window buffers
  int ext[kMaxRun];         // forward: E_k samples; inverse: P_k pairs
  int region[kMaxRun + 1];  // inverse: offsets of d_0 .. d_{L-1}, s in the load region
};

__device__ __forceinline__ void async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most one commit group (the next item's loads) is pending.
__device__ __forceinline__ void async_wait_prior() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

// One lifting step over targets [lo, hi) of a window held as two planes
// (tgt: the target stream, src: the other), on lanes lane, lane + tpr,
// ...: the step's N packed terms (terms.cuh) unpacked into registers
// once, and one shared-memory read per tap (a tap's digits are adjacent
// terms with one offset), so the loop reads each neighbour once.
template <int N>
__device__ __forceinline__ void lift_span(int32_t* tgt, const int32_t* src, const TermStep& st,
                                          int lo, int hi, int lane, int tpr) {
  int off[N], shl[N], neg[N], fresh[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int p = st.term[k];
    off[k] = p >> 6;
    shl[k] = (p >> 1) & 31;
    neg[k] = p & 1;
    fresh[k] = k == 0 || off[k] != off[k - 1];
  }
  const uint32_t round = st.round_add;
  const int shift = st.shift;
  const bool plus = st.sign > 0;
#pragma unroll 4
  for (int i = lo + lane; i < hi; i += tpr) {
    uint32_t acc = 0u, v = 0u;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (fresh[k]) v = static_cast<uint32_t>(src[i + off[k]]);
      const uint32_t w = v << shl[k];
      acc = neg[k] ? acc - w : acc + w;
    }
    acc += round;
    const uint32_t r = static_cast<uint32_t>(static_cast<int32_t>(acc) >> shift);
    tgt[i] = static_cast<int32_t>(plus ? static_cast<uint32_t>(tgt[i]) + r
                                       : static_cast<uint32_t>(tgt[i]) - r);
  }
}

// Rewrites the out-of-range entries of a stream's window plane t in [lo,
// hi) (entry i is stream entry base + i; the stream holds len entries of
// a length-n level) from the in-range entries reflect_entry names, where
// those lie in [lo, hi) too.  Sources are in range, targets out of range:
// no entry is both.
__device__ __forceinline__ void reflect_plane(int32_t* t, int parity, int base, int n, int lo,
                                              int hi, int lane, int tpr) {
  const int len = parity ? n >> 1 : (n + 1) >> 1;
  auto fix = [&](int i) {
    const int r = reflect_entry(base + i, parity, n) - base;
    if (r >= lo && r < hi) t[i] = t[r];
  };
  for (int i = lo + lane; i < min(hi, -base); i += tpr) fix(i);
  for (int i = max(lo, len - base) + lane; i < hi; i += tpr) fix(i);
}

// Interior-only cascade (the reference's _walk_ext) over a window of pext
// pairs held as planes (ev[i]: entry i of the even stream, od[i]: of the
// odd), on lanes lane, lane + tpr, ... of the window's row group.  Every
// thread of the block calls it: one barrier a step.  POLICY, in an item
// whose window crosses an end of the length-n level (`end`; entry i of a
// plane is stream entry base + i): after each step, a rewrite of the
// target's out-of-range entries and one more barrier.
template <bool POLICY>
__device__ void lift_row(int32_t* ev, int32_t* od, int pext, const Terms& c, int lane, int tpr,
                         bool on, int base, int n, bool end) {
  int lo[2] = {0, 0}, hi[2] = {pext, pext};
  for (int s = 0; s < c.nsteps; ++s) {
    const TermStep& st = c.steps[s];
    const int tpar = st.tgt_odd, spar = 1 - tpar;
    const int nlo = max(lo[tpar], lo[spar] - st.min_off);
    const int nhi = min(hi[tpar], hi[spar] - st.max_off);
    if (on) {
      int32_t* tgt = tpar ? od : ev;
      const int32_t* src = tpar ? ev : od;
      switch (st.nterm) {
        case 1: lift_span<1>(tgt, src, st, nlo, nhi, lane, tpr); break;
        case 2: lift_span<2>(tgt, src, st, nlo, nhi, lane, tpr); break;
        case 4: lift_span<4>(tgt, src, st, nlo, nhi, lane, tpr); break;
        default: {
          auto read = [&](int j) -> int32_t { return src[j]; };
          for (int i = nlo + lane; i < nhi; i += tpr) tgt[i] = lift_terms(st, tgt[i], i, read);
        }
      }
    }
    lo[tpar] = nlo;
    hi[tpar] = nhi;
    __syncthreads();
    if (POLICY && end) {
      if (on) reflect_plane(tpar ? od : ev, tpar, base, n, nlo, nhi, lane, tpr);
      __syncthreads();
    }
  }
}

// The rows of work item `item` this thread's group takes: its row index,
// or -1 past the item's rows; its tile in *t.
__device__ __forceinline__ int item_row(const Geom& g, int item, int grp, int* t) {
  *t = item % g.tiles;
  const int r = (item / g.tiles) * g.rb + grp;
  return grp < g.rb && r < g.rows ? r : -1;
}

// Issues the level-0 window loads of `item` for this thread's row into
// the planes ev / od (sample j of the window to ev[j / 2] or od[j / 2]):
// 4-byte copies, coalesced, reflected at the line's ends.
__device__ __forceinline__ void fwd_load(const int32_t* __restrict__ x, const Geom& g, int item,
                                         int grp, int lane, int tpr, int32_t* ev, int32_t* od) {
  int t;
  const int r = item_row(g, item, grp, &t);
  if (r < 0) return;
  const int n = g.n, E = g.ext[0], W = g.tile + 2 * E, start = t * g.tile - E;
  const int32_t* src = x + static_cast<size_t>(r) * n;
  if (start >= 0 && start + W <= n) {
    for (int j = lane; j < W; j += tpr)
      copy_async<false>(j & 1 ? od + (j >> 1) : ev + (j >> 1), src + start + j);
  } else {
    for (int j = lane; j < W; j += tpr)
      copy_async<false>(j & 1 ? od + (j >> 1) : ev + (j >> 1), src + reflect_index(start + j, n));
  }
}

template <bool POLICY>
__global__ void __launch_bounds__(kRunThreads)
    run_fwd_kernel(const int32_t* __restrict__ x, const __grid_constant__ Bands b,
                   const __grid_constant__ Geom g, const __grid_constant__ Terms c) {
  extern __shared__ int4 smem4[];
  const int tpr = 1 << g.lg, lane = threadIdx.x & (tpr - 1), grp = threadIdx.x >> g.lg;
  // per row: two load buffers (planes of pitch_a / 2 each), buffer B
  int32_t* const base = reinterpret_cast<int32_t*>(smem4) + grp * g.pitch;
  const int ha = g.pitch_a / 2, hb = g.pitch_b / 2;
  int32_t* const B = base + 2 * g.pitch_a;
  int item = blockIdx.x, buf = 0;
  fwd_load(x, g, item, grp, lane, tpr, base, base + ha);
  async_commit();
  for (; item < g.items; item += gridDim.x, buf ^= 1) {
    int32_t* const A = base + buf * g.pitch_a;
    const int next = item + gridDim.x;
    if (next < g.items) {
      int32_t* const nA = base + (buf ^ 1) * g.pitch_a;
      fwd_load(x, g, next, grp, lane, tpr, nA, nA + ha);
    }
    async_commit();
    async_wait_prior();
    __syncthreads();
    int t;
    const int r = item_row(g, item, grp, &t);
    const bool on = r >= 0;
    const size_t row = on ? r : 0;
    int n = g.n, Tk = g.tile, E = g.ext[0];
    int start = t * Tk - E, W = Tk + 2 * E;
    int32_t *ev = A, *od = A + ha;
    for (int k = 0; k < g.levels; ++k) {
      const bool crosses = start < 0 || start + W > n;
      lift_row<POLICY>(ev, od, W >> 1, c, lane, tpr, on, start >> 1, n, crosses);
      const int ne = (n + 1) >> 1, no = n >> 1, half = Tk >> 1, p0 = t * half;
      const bool last = k + 1 == g.levels;
      const int E1 = last ? 0 : g.ext[k + 1];
      const int start1 = start / 2 + g.m, W1 = half + 2 * E1;
      // the next level's planes: B after even levels, A after odd ones
      int32_t* const nev = k & 1 ? A : B;
      int32_t* const nod = nev + (k & 1 ? ha : hb);
      if (on) {
        const int c0 = E >> 1;  // the window pair of the tile's first core pair
        int32_t* d = b.p[k] + row * no;
        for (int p = lane; p < half && p0 + p < no; p += tpr) d[p0 + p] = od[c0 + p];
        if (last) {
          int32_t* s = b.p[k + 1] + row * ne;
          for (int p = lane; p < half && p0 + p < ne; p += tpr) s[p0 + p] = ev[c0 + p];
        } else {
          // the next window: the s entries of pairs [m, m + W1), its
          // out-of-range positions rewritten by level k+1's reflection
          const int32_t* sv = ev + g.m;
          const bool end = start1 < 0 || start1 + W1 > ne;
          for (int j = lane; j < W1; j += tpr) {
            int sj = j;
            if (end) {
              const int q = start1 + j;
              if (q < 0 || q >= ne) {
                const int rq = reflect_index(q, ne) - start1;
                if (rq >= 0 && rq < W1) sj = rq;
              }
            }
            if (j & 1)
              nod[j >> 1] = sv[sj];
            else
              nev[j >> 1] = sv[sj];
          }
        }
      }
      __syncthreads();
      n = ne;
      Tk = half;
      E = E1;
      start = start1;
      W = W1;
      ev = nev;
      od = nod;
    }
  }
}

// Issues the loads of `item`'s band windows for this thread's row into
// the load region R: level k's d window at R + g.region[k], the coarsest
// s window at R + g.region[levels].
__device__ __forceinline__ void inv_load(const Bands& b, const Geom& g, int item, int grp,
                                         int lane, int tpr, int32_t* R) {
  int t;
  const int r = item_row(g, item, grp, &t);
  if (r < 0) return;
  const int L = g.levels;
  for (int k = 0; k <= L; ++k) {
    const int lv = k < L ? k : L - 1, parity = k < L ? 1 : 0;
    const int n = (g.n + (1 << lv) - 1) >> lv;
    const int half = (g.tile >> lv) >> 1, P = g.ext[lv];
    const int Wp = half + 2 * P, a = t * half - P;
    const int len = parity ? n >> 1 : (n + 1) >> 1;
    const int32_t* src = b.p[k] + static_cast<size_t>(r) * len;
    int32_t* dst = R + g.region[k];
    if (a >= 0 && a + Wp <= len) {
      for (int i = lane; i < Wp; i += tpr) copy_async<false>(dst + i, src + a + i);
    } else {
      for (int i = lane; i < Wp; i += tpr)
        copy_async<false>(dst + i, src + reflect_entry(a + i, parity, n));
    }
  }
}

template <bool POLICY>
__global__ void __launch_bounds__(kRunThreads)
    run_inv_kernel(const __grid_constant__ Bands b, int32_t* __restrict__ x,
                   const __grid_constant__ Geom g, const __grid_constant__ Terms c) {
  extern __shared__ int4 smem4[];
  const int tpr = 1 << g.lg, lane = threadIdx.x & (tpr - 1), grp = threadIdx.x >> g.lg;
  const int L = g.levels, m = g.m;
  // per row: two load regions, then the even levels' and the odd levels'
  // s planes (A, B); each level's d plane stays in the load region
  int32_t* const base = reinterpret_cast<int32_t*>(smem4) + grp * g.pitch;
  int32_t* const A = base + 2 * g.pitch_r;
  int32_t* const B = A + g.pitch_a;
  int item = blockIdx.x, buf = 0;
  inv_load(b, g, item, grp, lane, tpr, base);
  async_commit();
  for (; item < g.items; item += gridDim.x, buf ^= 1) {
    const int next = item + gridDim.x;
    if (next < g.items) inv_load(b, g, next, grp, lane, tpr, base + (buf ^ 1) * g.pitch_r);
    async_commit();
    async_wait_prior();
    __syncthreads();
    int t;
    const int r = item_row(g, item, grp, &t);
    const bool on = r >= 0;
    int32_t* const R = base + buf * g.pitch_r;
    // coarsest level L-1: both planes in the load region
    int k = L - 1;
    int n = (g.n + (1 << k) - 1) >> k;
    int half = (g.tile >> k) >> 1, Wp = half + 2 * g.ext[k], a = t * half - g.ext[k];
    int32_t* ev = R + g.region[L];
    int32_t* od = R + g.region[k];
    for (;; --k) {
      const bool crosses = a < 0 || 2 * (a + Wp) > n;
      lift_row<POLICY>(ev, od, Wp, c, lane, tpr, on, a, n, crosses);
      if (k == 0) break;
      // level k-1's s plane: level k's samples (sample 2i in ev[i], 2i + 1
      // in od[i], valid from 2m to 2Wp - 2m), out-of-range entries
      // rewritten by level k-1's reflection; its d plane is in the region
      const int n1 = (g.n + (1 << (k - 1)) - 1) >> (k - 1);
      const int half1 = (g.tile >> (k - 1)) >> 1, P1 = g.ext[k - 1];
      const int Wp1 = half1 + 2 * P1, a1 = t * half1 - P1;
      int32_t* const nev = (k - 1) & 1 ? B : A;
      if (on) {
        const int at = 2 * a;  // level k's sample at window index 0
        const bool end = a1 < 0 || a1 + Wp1 > n;
        for (int i = lane; i < Wp1; i += tpr) {
          const int e = a1 + i;
          int idx = e - at;
          if (end && (e < 0 || e >= n)) {
            const int rr = reflect_entry(e, 0, n1) - at;
            if (rr >= 2 * m && rr < 2 * Wp - 2 * m) idx = rr;
          }
          nev[i] = idx & 1 ? od[idx >> 1] : ev[idx >> 1];
        }
      }
      __syncthreads();
      ev = nev;
      od = R + g.region[k - 1];
      n = n1;
      Wp = Wp1;
      a = a1;
    }
    if (on) {
      // level 0: core sample j of the tile is window sample 2m + j
      const int x0 = t * g.tile;
      const int32_t* ce = ev + m;
      const int32_t* co = od + m;
      int32_t* dst = x + static_cast<size_t>(r) * g.n + x0;
      const int cnt = min(g.tile, g.n - x0);
      for (int j = lane; j < cnt; j += tpr) dst[j] = j & 1 ? co[j >> 1] : ce[j >> 1];
    }
    __syncthreads();
  }
}

inline int r4(int v) { return (v + 3) & ~3; }

// Validates a run's arguments and fills its geometry and bands; returns a
// cudaError_t code.  Shared memory per row, in int32 entries, each window
// held as an even and an odd plane (kernels/backend.py run_row_bytes
// mirrors it): forward, two load buffers of the level-0 window's planes
// (the even levels' windows reuse the current one) and buffer B for the
// odd levels'; inverse, two load regions (every level's d plane and the
// coarsest s plane) and the even and the odd levels' s planes (A, B).
inline cudaError_t plan(bool inverse, const long long* ptrs, int rows, int n, int levels,
                        int tile, int rb, int m, Geom* g, Bands* b, size_t* bytes) {
  if (rows < 1 || levels < 1 || levels > kMaxRun || rb < 1 || rb > kMaxRows || m < 0 ||
      m > 64 || !ptrs)
    return cudaErrorInvalidValue;
  if (tile < 2 || tile % (1 << levels) != 0 || ((n + (1 << (levels - 1)) - 1) >> (levels - 1)) < 2)
    return cudaErrorInvalidValue;
  for (int k = 0; k <= levels; ++k) {
    if (!ptrs[k]) return cudaErrorInvalidValue;
    b->p[k] = reinterpret_cast<int32_t*>(ptrs[k]);
  }
  g->rows = rows;
  g->n = n;
  g->levels = levels;
  g->tile = tile;
  g->rb = rb;
  g->m = m;
  for (int k = 0; k < levels; ++k)
    g->ext[k] = inverse ? (k == 0 ? m : (g->ext[k - 1] + 1) / 2 + m)
                        : 2 * m * ((1 << (levels - k)) - 1);
  if ((long long)tile + 2LL * g->ext[0] > (1 << 24)) return cudaErrorInvalidValue;
  int groups = 1;
  while (groups < rb) groups *= 2;
  int lg = 0;
  while ((1 << lg) * groups < kRunThreads) ++lg;
  g->lg = lg;
  g->tiles = (n + tile - 1) / tile;
  const long long items = (long long)((rows + rb - 1) / rb) * g->tiles;
  if (items > INT_MAX) return cudaErrorInvalidConfiguration;
  g->items = static_cast<int>(items);
  const bool two = levels > 1;
  if (inverse) {
    int off = 0;
    for (int k = 0; k <= levels; ++k) {
      const int lv = k < levels ? k : levels - 1;
      g->region[k] = off;
      off += r4((tile >> lv) / 2 + 2 * g->ext[lv]);
    }
    g->pitch_r = off;
    g->pitch_a = r4(tile / 2 + 2 * g->ext[0]);
    g->pitch_b = two ? r4(tile / 4 + 2 * g->ext[1]) : 0;
    g->pitch = 2 * g->pitch_r + g->pitch_a + g->pitch_b;
  } else {
    g->pitch_r = 0;
    g->pitch_a = 2 * r4(tile / 2 + g->ext[0]);
    g->pitch_b = two ? 2 * r4(tile / 4 + g->ext[1]) : 0;
    g->pitch = 2 * g->pitch_a + g->pitch_b;
  }
  *bytes = (size_t)groups * g->pitch * sizeof(int32_t);
  return cudaSuccess;
}

// Launches `kernel` with as many persistent blocks as the card keeps
// resident at `bytes` of shared memory each, at most one an item.
template <class K, class... Args>
inline cudaError_t launch_persistent(K kernel, int device, int items, size_t bytes,
                                     cudaStream_t stream, Args... args) {
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRunThreads, bytes)) !=
      cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const unsigned blocks = static_cast<unsigned>(std::min<long long>(items, (long long)per_sm * sms));
  kernel<<<blocks, kRunThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace lift1d

using namespace lift1d;

// Forward run of `levels` levels of a (rows, n) int32 signal x: `ptrs`
// (host memory) holds levels + 1 device addresses, d_0 (rows, floor(n/2))
// .. d_{L-1}, then s_{L-1} (rows, ceil(n_{L-1}/2)); `tile` level-0
// samples (a multiple of 2^levels) and `rb` rows (at most 8) a work item,
// forward margin m; `policy` nonzero: band-policy rewrites after every
// step (the run has a level its scheme cannot window).  Returns a
// cudaError_t code.
extern "C" int repro_lift1d_run_fwd(int device, const int32_t* x, const long long* ptrs, int rows,
                                    int n, int levels, int tile, int rb, int m, int policy,
                                    const int32_t* table, int table_len, void* stream) {
  Cascade cas;
  cudaError_t e = parse_cascade(table, table_len, &cas);
  if (e != cudaSuccess) return e;
  if (!x) return cudaErrorInvalidValue;
  Geom g;
  Bands b;
  size_t bytes;
  if ((e = plan(false, ptrs, rows, n, levels, tile, rb, m, &g, &b, &bytes)) != cudaSuccess)
    return e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  const Terms c = pack_terms(cas);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (policy)
    return launch_persistent(run_fwd_kernel<true>, device, g.items, bytes, st, x, b, g, c);
  return launch_persistent(run_fwd_kernel<false>, device, g.items, bytes, st, x, b, g, c);
}

// Inverse run: the bands at `ptrs` (as the forward's) -> x (rows, n), with
// inverse margin m and `policy` as the forward's.  Returns a cudaError_t
// code.
extern "C" int repro_lift1d_run_inv(int device, const long long* ptrs, int32_t* x, int rows,
                                    int n, int levels, int tile, int rb, int m, int policy,
                                    const int32_t* table, int table_len, void* stream) {
  Cascade cas;
  cudaError_t e = parse_cascade(table, table_len, &cas);
  if (e != cudaSuccess) return e;
  if (!x) return cudaErrorInvalidValue;
  Geom g;
  Bands b;
  size_t bytes;
  if ((e = plan(true, ptrs, rows, n, levels, tile, rb, m, &g, &b, &bytes)) != cudaSuccess)
    return e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  const Terms c = pack_terms(cas);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (policy)
    return launch_persistent(run_inv_kernel<true>, device, g.items, bytes, st, b, x, g, c);
  return launch_persistent(run_inv_kernel<false>, device, g.items, bytes, st, b, x, g, c);
}
