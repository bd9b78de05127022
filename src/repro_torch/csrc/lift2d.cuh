// Shared device code of the 2-D integer lifting kernels (sm_90a).
//
// A lifting scheme reaches the kernels as data, not as a template: the
// Python wrapper encodes the resolved steps (kernels/_build.py,
// cascade_table) in execution order, with the inverse's reversed order
// and flipped signs already applied, and the host half of each launcher
// parses that table into a `Cascade` passed by value as a kernel
// parameter.  One compiled kernel serves every registered scheme.
//
// Tap weights arrive as their non-adjacent-form digits (+-2^k terms,
// the reference's `wmul`), so a weighted read is a sum of left shifts:
// the kernels stay multiplierless like the paper's modules.
//
// Integer semantics follow the reference (core/schemes.py
// `_apply_taps`): int32 with two's-complement wraparound and an
// arithmetic right shift of negative sums.  Signed overflow is undefined
// in C++, so every add, subtract and left shift runs in uint32_t, and the
// sum is converted back to int32_t only for the arithmetic shift.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lift2d {

constexpr int kMaxSteps = 8;
constexpr int kMaxTaps = 4;
constexpr int kMaxTerms = 6;
constexpr int kThreads = 256;

struct Tap {
  int off;                 // read offset into the source stream
  int nterms;              // NAF digits of |w| (0: weight 0)
  int shift[kMaxTerms];    // left shift of each digit
  int neg[kMaxTerms];      // 1: the digit is subtracted
};

struct Step {
  int tgt_odd;             // 1: predict (odd stream is the target)
  int sign;                // +1 / -1, direction already applied
  int shift;               // arithmetic right shift of the sum
  uint32_t round_add;      // rounding constant added before the shift
  int ntaps;
  int min_off, max_off;    // extreme tap offsets (valid-range tracking)
  Tap taps[kMaxTaps];
};

struct Cascade {
  int nsteps;
  Step steps[kMaxSteps];
};

// Table layout (int32): nsteps, then per step
//   tgt_odd, sign, shift, round_add, ntaps, then per tap
//     off, nterms, then per term: shift, neg
// Returns cudaSuccess or cudaErrorInvalidValue on a malformed table.
inline cudaError_t parse_cascade(const int32_t* t, int len, Cascade* c) {
  int k = 0;
  auto next = [&](int32_t* v) {
    if (k >= len) return false;
    *v = t[k++];
    return true;
  };
  int32_t v;
  if (!next(&v) || v < 1 || v > kMaxSteps) return cudaErrorInvalidValue;
  c->nsteps = v;
  for (int s = 0; s < c->nsteps; ++s) {
    Step& st = c->steps[s];
    int32_t f[5];
    for (int i = 0; i < 5; ++i)
      if (!next(&f[i])) return cudaErrorInvalidValue;
    st.tgt_odd = f[0] ? 1 : 0;
    st.sign = f[1] > 0 ? 1 : -1;
    st.shift = f[2];
    st.round_add = static_cast<uint32_t>(f[3]);
    st.ntaps = f[4];
    if (st.shift < 0 || st.shift > 31 || st.ntaps < 1 || st.ntaps > kMaxTaps)
      return cudaErrorInvalidValue;
    for (int j = 0; j < st.ntaps; ++j) {
      Tap& tp = st.taps[j];
      int32_t off, nterms;
      if (!next(&off) || !next(&nterms) || nterms < 0 || nterms > kMaxTerms)
        return cudaErrorInvalidValue;
      tp.off = off;
      tp.nterms = nterms;
      for (int i = 0; i < nterms; ++i) {
        int32_t sh, ng;
        if (!next(&sh) || !next(&ng) || sh < 0 || sh > 31) return cudaErrorInvalidValue;
        tp.shift[i] = sh;
        tp.neg[i] = ng ? 1 : 0;
      }
      st.min_off = j == 0 ? off : (off < st.min_off ? off : st.min_off);
      st.max_off = j == 0 ? off : (off > st.max_off ? off : st.max_off);
    }
  }
  return k == len ? cudaSuccess : cudaErrorInvalidValue;
}

// Whole-point reflection of sample position `pos` into [0, n) (the
// reference's reflect_indices, one entry).
__device__ __forceinline__ int reflect_index(int pos, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  pos %= period;
  if (pos < 0) pos += period;
  return pos > n - 1 ? period - pos : pos;
}

// Entry `p` of the parity-`parity` stream of a length-n signal, reflected
// into range (the reference's reflect_entry; identity in range).
__device__ __forceinline__ int reflect_entry(int p, int parity, int n) {
  return (reflect_index(2 * p + parity, n) - parity) >> 1;
}

// target +- ((sum of weighted reads + round) >> shift), in uint32_t.
template <class Read>
__device__ __forceinline__ int32_t lift_value(const Step& st, int32_t tgt, int i,
                                              Read read) {
  uint32_t acc = 0u;
  for (int j = 0; j < st.ntaps; ++j) {
    const Tap& tp = st.taps[j];
    const uint32_t v = static_cast<uint32_t>(read(i + tp.off));
    for (int t = 0; t < tp.nterms; ++t) {
      const uint32_t term = v << tp.shift[t];
      acc = tp.neg[t] ? acc - term : acc + term;
    }
  }
  acc += st.round_add;
  const uint32_t r = static_cast<uint32_t>(static_cast<int32_t>(acc) >> st.shift);
  const uint32_t out = st.sign > 0 ? static_cast<uint32_t>(tgt) + r
                                   : static_cast<uint32_t>(tgt) - r;
  return static_cast<int32_t>(out);
}

// The buffer holds `nl` lines of interleaved samples: sample k of line l
// sits at buf[k * ks + l * ls]; even entry p is sample 2p, odd entry p is
// sample 2p + 1.  LINE_FASTEST maps neighbouring threads to neighbouring
// lines (strips of columns, ls == 1), otherwise to neighbouring entries
// of one line (rows, ks == 1), so shared-memory reads stay conflict-light
// either way.  `buf` may point to shared or to global memory:
// __syncthreads() orders both within the block.
template <bool LINE_FASTEST>
__device__ __forceinline__ void split_index(int idx, int nl, int cnt, int* l, int* i) {
  if (LINE_FASTEST) {
    *l = idx % nl;
    *i = idx / nl;
  } else {
    *i = idx % cnt;
    *l = idx / cnt;
  }
}

// Band-policy cascade over full lines of n >= 2 samples (the reference's
// _walk_policy): out-of-range reads reflect through reflect_entry.
template <bool LINE_FASTEST>
__device__ void cascade_policy(int32_t* buf, int ks, int ls, int nl, int n,
                               const Cascade& c) {
  const int len[2] = {(n + 1) >> 1, n >> 1};
  for (int s = 0; s < c.nsteps; ++s) {
    const Step& st = c.steps[s];
    const int tpar = st.tgt_odd, spar = 1 - tpar;
    const int tlen = len[tpar], slen = len[spar];
    const int total = tlen * nl;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      int l, i;
      split_index<LINE_FASTEST>(idx, nl, tlen, &l, &i);
      int32_t* line = buf + l * ls;
      auto read = [&](int j) -> int32_t {
        if (j < 0 || j >= slen) j = reflect_entry(j, spar, n);
        return line[(2 * j + spar) * ks];
      };
      int32_t* t = line + (2 * i + tpar) * ks;
      *t = lift_value(st, *t, i, read);
    }
    __syncthreads();
  }
}

// Interior-only cascade over margin-extended lines of `pext` pairs (the
// reference's _walk_ext): each step's target is computed only where all
// of its reads are valid, so no read leaves the window.  The caller reads
// the core entries [margin, pext - margin) afterwards.
template <bool LINE_FASTEST>
__device__ void cascade_ext(int32_t* buf, int ks, int ls, int nl, int pext,
                            const Cascade& c) {
  int lo[2] = {0, 0}, hi[2] = {pext, pext};
  for (int s = 0; s < c.nsteps; ++s) {
    const Step& st = c.steps[s];
    const int tpar = st.tgt_odd, spar = 1 - tpar;
    const int nlo = max(lo[tpar], lo[spar] - st.min_off);
    const int nhi = min(hi[tpar], hi[spar] - st.max_off);
    const int cnt = nhi - nlo;
    for (int idx = threadIdx.x; idx < cnt * nl; idx += blockDim.x) {
      int l, i;
      split_index<LINE_FASTEST>(idx, nl, cnt, &l, &i);
      i += nlo;
      int32_t* line = buf + l * ls;
      auto read = [&](int j) -> int32_t { return line[(2 * j + spar) * ks]; };
      int32_t* t = line + (2 * i + tpar) * ks;
      *t = lift_value(st, *t, i, read);
    }
    lo[tpar] = nlo;
    hi[tpar] = nhi;
    __syncthreads();
  }
}

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lift2d

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
