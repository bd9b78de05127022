// Adaptive Golomb-Rice block encode and decode for sm_90a.
//
// rice_encode replaces the TPU kernel codec/rice.py::_pack_words_pallas
// (body _pack_kernel), fused with the stages the reference keeps in jnp
// around it (_encode_chunk): zigzag, the exact cost of every k in
// 0..K_MAX, the first minimum (jnp.argmin's rule), code lengths, their
// exclusive prefix sum, the bit placement and the word pack.  On the TPU
// the chunk's codes are scattered onto a (nb, 256, 40) bit grid in device
// memory and the kernel ORs 32 bit planes into words; here one thread
// block per Rice block keeps everything in shared memory: its 256 codes
// are OR-ed (atomicOr, the codes are disjoint) into a 320-word buffer, and
// the words go out byte-swapped, so row byte i holds stream bits
// 8i..8i+7 MSB first — the reference's word->byte order.  Each block
// writes its whole padded BYTES_CAP-byte row; rice_compact then copies
// each row's ceil(nbits/8) bytes to its offset in the payload.
//
// rice_decode has no TPU kernel: the reference decodes with a 256-step
// lax.scan of gathers (_decode_chunk).  Here one thread walks one Rice
// block's codes through a 64-bit bit buffer refilled byte by byte from
// the block's own byte range only (bytes past it read as zero, as the
// reference's zero-padded rows do), so even a malformed stream never
// reads outside the payload.  A warp decodes 32 blocks into shared
// memory, then writes them out coalesced.
//
// Bound: memory.  Encode must read 4 bytes per coefficient and write the
// coded bytes; this design also writes each block's padded 1280-byte row
// and reads it back in the compaction (a later PR can size the rows first
// and write at the offsets).  Decode must read the coded bytes and write
// 4 bytes per coefficient; one thread per block reads its bytes one at a
// time, so decode is latency-bound at first.
//
// Every function is written for any blockDim (loops strided by
// blockDim.x, barriers between phases), which is what lets it be checked
// off the card as host code with one thread per block.
#include <cstdint>
#include <cuda_runtime.h>

namespace rice {

constexpr int kBlock = 256;                  // BLOCK_VALUES
constexpr int kQMax = 8;                     // Q_MAX
constexpr int kKMax = 24;                    // K_MAX
constexpr int kLMax = kQMax + 32;            // LMAX: an escape's length
constexpr int kWords = kBlock * kLMax / 32;  // 320 words of block workspace
constexpr int kRowBytes = kWords * 4;        // BYTES_CAP
constexpr int kThreads = 256;
constexpr int kSegs = 8;                     // partial sums per k in the cost scan
constexpr int kDecodeBlocks = 32;            // Rice blocks per decode block

__device__ __forceinline__ uint32_t zigzag(int32_t x) {
  return (static_cast<uint32_t>(x) << 1) ^ static_cast<uint32_t>(x >> 31);
}

__device__ __forceinline__ int code_len(uint32_t u, int k) {
  const uint32_t q = u >> k;
  return q >= static_cast<uint32_t>(kQMax) ? kLMax : static_cast<int>(q) + 1 + k;
}

// The low 32 bits of v shifted left by d, or right by -d when d < 0.
__device__ __forceinline__ uint32_t shifted(uint64_t v, int d) {
  if (d >= 64 || d <= -64) return 0u;
  return static_cast<uint32_t>(d >= 0 ? v << d : v >> -d);
}

// One thread block per Rice block of 256 values.
__global__ void __launch_bounds__(kThreads)
    encode_kernel(const int32_t* __restrict__ x, uint8_t* __restrict__ rows,
                  uint8_t* __restrict__ ks, int32_t* __restrict__ nbits, int64_t count) {
  __shared__ uint32_t u[kBlock];
  __shared__ int lens[kBlock];
  __shared__ int scan[2][kBlock];
  __shared__ int part[kKMax + 1][kSegs];
  __shared__ uint32_t words[kWords];
  __shared__ int kbest;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlock;

  // zigzag; the values past the band's end are the last block's zero pad
  for (int i = threadIdx.x; i < kBlock; i += blockDim.x)
    u[i] = base + i < count ? zigzag(x[base + i]) : 0u;
  for (int w = threadIdx.x; w < kWords; w += blockDim.x) words[w] = 0u;
  __syncthreads();

  // exact cost of every k: (K_MAX + 1) x kSegs partial sums, then the
  // first minimum in k order
  for (int t = threadIdx.x; t < (kKMax + 1) * kSegs; t += blockDim.x) {
    const int k = t / kSegs, seg = t % kSegs;
    int c = 0;
    for (int i = seg * (kBlock / kSegs); i < (seg + 1) * (kBlock / kSegs); ++i)
      c += code_len(u[i], k);
    part[k][seg] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int best = 0, best_cost = 0;
    for (int k = 0; k <= kKMax; ++k) {
      int c = 0;
      for (int s = 0; s < kSegs; ++s) c += part[k][s];
      if (k == 0 || c < best_cost) {  // strictly smaller: ties keep the first k
        best = k;
        best_cost = c;
      }
    }
    kbest = best;
  }
  __syncthreads();
  const int k = kbest;

  // code lengths and their inclusive prefix sum (Hillis-Steele)
  for (int i = threadIdx.x; i < kBlock; i += blockDim.x) {
    lens[i] = code_len(u[i], k);
    scan[0][i] = lens[i];
  }
  __syncthreads();
  int src = 0;
  for (int d = 1; d < kBlock; d <<= 1) {
    for (int i = threadIdx.x; i < kBlock; i += blockDim.x)
      scan[src ^ 1][i] = scan[src][i] + (i >= d ? scan[src][i - d] : 0);
    __syncthreads();
    src ^= 1;
  }

  // each code, right-aligned in 64 bits, OR-ed into the (up to three)
  // words its bit range [off, off + len) covers, MSB first
  for (int i = threadIdx.x; i < kBlock; i += blockDim.x) {
    const int len = lens[i];
    const int off = scan[src][i] - len;
    const uint32_t ui = u[i];
    uint64_t code;
    if (len == kLMax) {  // escape: Q_MAX ones, then the raw 32 bits
      code = (static_cast<uint64_t>((1u << kQMax) - 1u) << 32) | ui;
    } else {  // q ones, a zero, then the k remainder bits
      const uint32_t q = ui >> k;
      code = ((((uint64_t{1} << q) - 1u) << (1 + k)) | (ui & ((1u << k) - 1u)));
    }
    const int w0 = off >> 5, s = off & 31;
    for (int j = 0; j < 3 && w0 + j < kWords; ++j) {
      const uint32_t bits = shifted(code, 32 * (j + 1) - s - len);
      if (bits) atomicOr(&words[w0 + j], bits);
    }
  }
  __syncthreads();

  // the whole row, word w as bytes 4w..4w+3 from its most significant
  uint32_t* row = reinterpret_cast<uint32_t*>(rows + static_cast<int64_t>(blockIdx.x) * kRowBytes);
  for (int w = threadIdx.x; w < kWords; w += blockDim.x) row[w] = __byte_perm(words[w], 0u, 0x0123);
  if (threadIdx.x == 0) {
    ks[blockIdx.x] = static_cast<uint8_t>(k);
    nbits[blockIdx.x] = scan[src][kBlock - 1];
  }
}

// Block b's ceil(nbits[b] / 8) row bytes to payload[offs[b]:].
__global__ void compact_kernel(const uint8_t* __restrict__ rows, const int32_t* __restrict__ nbits,
                               const int64_t* __restrict__ offs, uint8_t* __restrict__ payload) {
  const int64_t b = blockIdx.x;
  const int n = (nbits[b] + 7) >> 3;
  const uint8_t* src = rows + b * kRowBytes;
  uint8_t* dst = payload + offs[b];
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// kDecodeBlocks Rice blocks per thread block, one thread each.
__global__ void decode_kernel(const uint8_t* __restrict__ payload, const int64_t* __restrict__ offs,
                              const int32_t* __restrict__ lens, const uint8_t* __restrict__ ks,
                              int32_t* __restrict__ out, int64_t nb) {
  __shared__ int32_t tile[kDecodeBlocks][kBlock + 1];
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kDecodeBlocks;
  for (int r = threadIdx.x; r < kDecodeBlocks; r += blockDim.x) {
    const int64_t b = b0 + r;
    if (b >= nb) continue;
    const uint8_t* p = payload + offs[b];
    const int n = lens[b];
    const int k = ks[b];  // 0..K_MAX, checked on the host
    uint64_t buf = 0;     // the next stream bits, MSB first
    int have = 0, pos = 0;
    for (int i = 0; i < kBlock; ++i) {
      while (have <= 56) {  // keep >= 57 bits: a code is at most 40
        const uint64_t byte = pos < n ? p[pos] : 0u;
        ++pos;
        buf |= byte << (56 - have);
        have += 8;
      }
      const int ones = __clzll(~buf);  // the unary run (64 when all ones)
      uint32_t v;
      if (ones >= kQMax) {  // escape: the 32 bits after Q_MAX ones
        v = static_cast<uint32_t>(buf >> (64 - kLMax));
        buf <<= kLMax;
        have -= kLMax;
      } else {
        buf <<= ones + 1;
        const uint32_t rem = k ? static_cast<uint32_t>(buf >> (64 - k)) : 0u;
        if (k) buf <<= k;
        have -= ones + 1 + k;
        v = (static_cast<uint32_t>(ones) << k) | rem;
      }
      tile[r][i] = static_cast<int32_t>((v >> 1) ^ (0u - (v & 1u)));
    }
  }
  __syncthreads();
  for (int r = 0; r < kDecodeBlocks && b0 + r < nb; ++r)
    for (int i = threadIdx.x; i < kBlock; i += blockDim.x) out[(b0 + r) * kBlock + i] = tile[r][i];
}

}  // namespace rice

using namespace rice;

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: `count` int32 values (nb = ceil(count / 256) blocks); rows: nb x
// BYTES_CAP bytes; ks: nb uint8; nbits: nb int32.  Returns a cudaError_t.
extern "C" int repro_rice_encode(int device, const int32_t* x, uint8_t* rows, uint8_t* ks,
                                 int32_t* nbits, int64_t count, int64_t nb, void* stream) {
  cudaError_t e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  if (nb < 1 || nb > 0x7fffffff || (nb - 1) * kBlock >= count || nb * kBlock < count)
    return cudaErrorInvalidValue;
  encode_kernel<<<static_cast<unsigned>(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, rows, ks, nbits, count);
  return cudaGetLastError();
}

// Compacts the nb rows of repro_rice_encode to `payload` at `offs`.
extern "C" int repro_rice_compact(int device, const uint8_t* rows, const int32_t* nbits,
                                  const int64_t* offs, uint8_t* payload, int64_t nb,
                                  void* stream) {
  cudaError_t e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  if (nb < 1 || nb > 0x7fffffff) return cudaErrorInvalidValue;
  compact_kernel<<<static_cast<unsigned>(nb), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, nbits, offs, payload);
  return cudaGetLastError();
}

// Decodes nb blocks to out (nb x 256 int32).
extern "C" int repro_rice_decode(int device, const uint8_t* payload, const int64_t* offs,
                                 const int32_t* lens, const uint8_t* ks, int32_t* out,
                                 int64_t nb, void* stream) {
  cudaError_t e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  const int64_t grid = (nb + kDecodeBlocks - 1) / kDecodeBlocks;
  if (nb < 1 || grid > 0x7fffffff) return cudaErrorInvalidValue;
  decode_kernel<<<static_cast<unsigned>(grid), kDecodeBlocks, 0,
                  static_cast<cudaStream_t>(stream)>>>(payload, offs, lens, ks, out, nb);
  return cudaGetLastError();
}
