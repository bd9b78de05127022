// Device machinery shared by the plane pass of the depth-slab level
// (slab3d.cu) and the halo-tiled 2-D level (tiled2d.cu), sm_90a: packed
// shift-add lifting terms, 16-byte global -> shared copies, and the
// interior-only cascade along columns.
//
// Outside __CUDA_ARCH__ the copies are plain memcpy / loads, so the
// kernels that use this header also compile as host C++.
#pragma once

#include <cstring>
#include <type_traits>

#include "lift2d.cuh"

namespace lift2d {

// A global -> shared copy of one (VEC: four) int32, asynchronous on the
// card (cp.async; .cg bypasses L1 for the 16-byte form), completed by
// async_wait() and then __syncthreads().
template <bool VEC>
__device__ __forceinline__ void copy_async(int32_t* dst, const int32_t* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (VEC)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
#else
  std::memcpy(dst, src, VEC ? 16 : 4);
#endif
}

__device__ __forceinline__ void async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

template <bool VEC>
__device__ __forceinline__ void copy_sync(int32_t* dst, const int32_t* src) {
  if (VEC)
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
  else
    *dst = *src;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The scheme's steps with every weighted tap read flattened into one
// list of shift-add terms per step, packed as (offset << 6) | (shift << 1)
// | negate: a lift then walks one short uniform loop (one constant load
// per term) instead of the nested tap and digit loops of lift_value.  The
// sum is the same modulo 2^32, term for term.
struct TermStep {
  int tgt_odd, sign, shift, min_off, max_off, nterm;
  uint32_t round_add;
  int term[kMaxTaps * kMaxTerms];
};

struct Terms {
  int nsteps;
  TermStep steps[kMaxSteps];
};

inline Terms pack_terms(const Cascade& c) {
  Terms t{};
  t.nsteps = c.nsteps;
  for (int s = 0; s < c.nsteps; ++s) {
    const Step& st = c.steps[s];
    TermStep& o = t.steps[s];
    o.tgt_odd = st.tgt_odd;
    o.sign = st.sign;
    o.shift = st.shift;
    o.min_off = st.min_off;
    o.max_off = st.max_off;
    o.round_add = st.round_add;
    for (int j = 0; j < st.ntaps; ++j)
      for (int k = 0; k < st.taps[j].nterms; ++k)
        o.term[o.nterm++] =
            (st.taps[j].off * 64) | (st.taps[j].shift[k] << 1) | st.taps[j].neg[k];
  }
  return t;
}

// target +- ((sum of the step's terms + round) >> shift), in uint32_t.
// N > 0: the step has exactly N terms, and the loop unrolls (the terms
// then stay in registers across a cascade's samples); N == 0: any count.
template <int N = 0, class Read>
__device__ __forceinline__ int32_t lift_terms(const TermStep& st, int32_t tgt, int i, Read read) {
  uint32_t acc = 0u;
  auto add = [&](int p) {
    const uint32_t v = static_cast<uint32_t>(read(i + (p >> 6))) << ((p >> 1) & 31);
    acc = (p & 1) ? acc - v : acc + v;
  };
  if (N > 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) add(st.term[k]);
  } else {
    for (int k = 0; k < st.nterm; ++k) add(st.term[k]);
  }
  acc += st.round_add;
  const uint32_t r = static_cast<uint32_t>(static_cast<int32_t>(acc) >> st.shift);
  return static_cast<int32_t>(st.sign > 0 ? static_cast<uint32_t>(tgt) + r
                                          : static_cast<uint32_t>(tgt) - r);
}

// Calls f(std::integral_constant<int, N>) with N = the step's term count
// where it is one that the registered schemes use (1, 2 or 4), else N = 0.
template <class F>
__device__ __forceinline__ void with_terms(const TermStep& st, F f) {
  switch (st.nterm) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    default: f(std::integral_constant<int, 0>{});
  }
}

// Interior-only cascade (the reference's _walk_ext) along nl columns of
// pext pairs (column l at buf + l, samples ks apart): neighbouring
// threads take neighbouring columns; when the block has more threads
// than columns, kstep of them share a column, entries kstep apart.  Each
// thread keeps its column and steps along it, so no sample pays a
// division or modulo to find its line and entry.  BY_COUNT: each step
// runs the lift unrolled for its term count (with_terms).
template <bool BY_COUNT = false>
__device__ void cascade_cols_ext(int32_t* buf, int ks, int nl, int pext, const Terms& c) {
  const int lanes = min(nl, (int)blockDim.x), kstep = blockDim.x / lanes;
  const int l0 = threadIdx.x % lanes, i0 = threadIdx.x / lanes;
  int lo[2] = {0, 0}, hi[2] = {pext, pext};
  for (int s = 0; s < c.nsteps; ++s) {
    const TermStep& st = c.steps[s];
    const int tpar = st.tgt_odd, spar = 1 - tpar;
    const int nlo = max(lo[tpar], lo[spar] - st.min_off);
    const int nhi = min(hi[tpar], hi[spar] - st.max_off);
    auto step = [&](auto n) {
      if (i0 < kstep)
        for (int l = l0; l < nl; l += lanes) {
          int32_t* line = buf + l;
          auto read = [&](int j) -> int32_t { return line[(2 * j + spar) * ks]; };
#pragma unroll 4
          for (int i = nlo + i0; i < nhi; i += kstep) {
            int32_t* t = line + (2 * i + tpar) * ks;
            *t = lift_terms<decltype(n)::value>(st, *t, i, read);
          }
        }
    };
    if (BY_COUNT)
      with_terms(st, step);
    else
      step(std::integral_constant<int, 0>{});
    lo[tpar] = nlo;
    hi[tpar] = nhi;
    __syncthreads();
  }
}

}  // namespace lift2d
