// The float (5,3) analysis filter bank, direct form, one launch (sm_90a).
//
// Replaces no Pallas kernel.  The reference's `core/lifting.py`
// `filterbank53_fwd_float` is the paper's comparison baseline (Table 3:
// a standard float filter bank against the integer lifting modules),
// written in jnp and jitted, so XLA runs it as one fusion.  Its plain
// PyTorch transcription (`repro_torch.core.lifting.filterbank53_fwd_float`)
// launches about 20 kernels (a cast, two reflected slices, a concatenation,
// 8 multiplies, 6 adds, 2 strided slices), so timing the one-launch
// lifting kernel against that chain would favour lifting for the wrong
// reason.  This kernel is the card's counterpart of the jitted baseline:
// one launch, so Table 3 compares one launch with one launch.
//
// Work split: one thread per output pair k of one row; a 2-D grid, x over
// the row's ceil(n/2) pairs, y over rows (strided past 65,535).  Thread k
// reads x[2k-2 .. 2k+2], each index reflected whole-point at both ends as
// the reference's extension by 2 does (x[-i] = x[i], x[n-1+i] =
// x[n-1-i]; n >= 3), and writes s[k] (the 5-tap low-pass centred at 2k)
// and, for k < n/2, d[k] (the 3-tap high-pass centred at 2k+1).
//
// Rounding: each product and each sum is rounded once, in the plain
// version's order (acc = c0 * t0, then acc = acc + c_i * t_i), through
// __int2float_rn, __fmul_rn and __fadd_rn, which nvcc never contracts
// into an FMA; the result is bit-equal to the plain version on any input.
//
// Bound: bytes.  Each sample is read once as int32 and written once as a
// float32 coefficient, 8 bytes a sample at 3.35 TB/s; the 7 flops a
// sample (8 multiplies and 6 adds a pair) take about half as long at the
// card's FP32 rate.  Neighbouring threads read neighbouring pairs, so a
// warp's five overlapping loads fall in the same few sectors (L1 serves
// the overlap) and its two stores are contiguous.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) return -i;
  if (i > n - 1) return 2 * (n - 1) - i;
  return i;
}

__device__ __forceinline__ float sample(const int32_t* __restrict__ row, int i, int n) {
  return __int2float_rn(__ldg(row + reflect(i, n)));
}

__global__ void __launch_bounds__(kThreads)
    filterbank53_kernel(const int32_t* __restrict__ x, float* __restrict__ s,
                        float* __restrict__ d, int rows, int n) {
  const int ns = n - n / 2;
  const int nd = n / 2;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= ns) return;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int32_t* row = x + static_cast<int64_t>(r) * n;
    const float c0 = sample(row, 2 * k - 2, n);
    const float c1 = sample(row, 2 * k - 1, n);
    const float c2 = sample(row, 2 * k, n);
    const float c3 = sample(row, 2 * k + 1, n);
    const float c4 = sample(row, 2 * k + 2, n);
    // H_LO = (-1/8, 2/8, 6/8, 2/8, -1/8)
    float lo = __fmul_rn(c0, -0.125f);
    lo = __fadd_rn(lo, __fmul_rn(c1, 0.25f));
    lo = __fadd_rn(lo, __fmul_rn(c2, 0.75f));
    lo = __fadd_rn(lo, __fmul_rn(c3, 0.25f));
    lo = __fadd_rn(lo, __fmul_rn(c4, -0.125f));
    s[static_cast<int64_t>(r) * ns + k] = lo;
    if (k < nd) {
      // H_HI = (-1/2, 1, -1/2)
      float hi = __fmul_rn(c2, -0.5f);
      hi = __fadd_rn(hi, __fmul_rn(c3, 1.0f));
      hi = __fadd_rn(hi, __fmul_rn(c4, -0.5f));
      d[static_cast<int64_t>(r) * nd + k] = hi;
    }
  }
}

}  // namespace

// x (rows, n) int32 -> s (rows, ceil(n/2)) and d (rows, n/2) float32,
// all contiguous, on `device`'s `stream`.  Returns a cudaError_t code.
extern "C" int repro_filterbank53_fwd_float(int device, const int32_t* x, float* s, float* d,
                                            int rows, int n, void* stream) {
  if (!x || !s || !d || rows < 0 || n < 3) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int ns = n - n / 2;
  const dim3 grid((ns + kThreads - 1) / kThreads, rows < 65535 ? rows : 65535);
  filterbank53_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, s, d, rows,
                                                                                n);
  return cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
