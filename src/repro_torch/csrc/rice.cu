// Adaptive Golomb-Rice block encode and decode for sm_90a.
//
// rice_encode replaces the TPU kernel codec/rice.py::_pack_words_pallas
// (body _pack_kernel), fused with the stages the reference keeps in jnp
// around it (_encode_chunk): zigzag, the exact cost of every k in
// 0..K_MAX, the first minimum (jnp.argmin's rule), code lengths, their
// exclusive prefix sum, the bit placement, the word pack, and the cut of
// each block's row to its ceil(nbits / 8) bytes at its offset in the
// payload.  One launch codes every band of a pyramid in a single pass:
//
//  * one warp per Rice block, kWarps blocks per thread block (a tile);
//    a lane holds 8 consecutive values from two 16-byte loads;
//  * the cost of every k comes from the block's values binned by bit
//    length, not from 25 passes over them: a value of bit length b is an
//    escape (40 bits) for k < b - 3, costs 1 + k for k >= b, and adds a
//    quotient u >> k in 1..7 only at k = b - 1, b - 2, b - 3, which the
//    two bits below its top bit give.  So a bin holds a count and the sums
//    of those bits, each lane keeps its own column of bins in shared
//    memory (no atomics, no bank conflicts), and lane k sums the columns
//    (16-byte reads) and prices k exactly; __reduce_min_sync on
//    (cost << 5 | k) is the first least cost and the block's bit count;
//  * byte offsets by decoupled look-back: a tile takes its id from a
//    global ticket (so it only ever waits on tiles that started before
//    it), publishes its byte count as one 64-bit status word (flag in the
//    top two bits) with release semantics as soon as its blocks are
//    priced, and, once packed, sums its predecessors' words, 32 at a
//    time, read with acquire semantics (a look-back per Rice block
//    instead, with no block barrier, measured 0.09 ms slower, and a
//    ninth warp looking back while the others pack no faster: PERF.md);
//  * a lane's 8 codes go into a 64-bit accumulator that hands out whole
//    32-bit words, OR-ed into the warp's staged words (only a lane's
//    first and last word can be shared with its neighbours);
//  * each warp writes exactly its block's bytes: bytes up to a 4-byte
//    boundary, then words, then a tail, so no word is read back or
//    shared with a neighbouring block; the same kernel writes each
//    band's first byte offset (and the total) as int64, each block's
//    byte length as uint16 and its k as uint8, into one table buffer.
//
// Bound: memory.  The encode must read 4 bytes per coefficient and write
// the coded bytes and 3 table bytes per block once; this kernel moves
// exactly those (plus a status word per tile).  The least integer work in
// the bit-length form is about 10 operations per coefficient (zigzag,
// bit length, its bin entry and the code's two parts, each a few
// operations: RICE_OPS in chip_smoke.py), under half the byte bound at
// the card's INT32 rate.  This kernel issues several times that: its
// bins, its packing and its look-back each add about as much time as its
// loads take (tools/rice_anatomy.py), so it runs at a quarter of the
// byte bound.
//
// rice_decode has no TPU kernel: the reference decodes with a 256-step
// lax.scan of gathers (_decode_chunk).  Here one launch decodes every
// band of a container, one warp per Rice block, kDecodePerWarp blocks a
// warp one after another, kWarps warps a tile:
//
//  * a tile finds its bytes by the same look-back as the encode (every
//    block's byte length is known up front, so a tile publishes its byte
//    count at once; on the H100 a host np.cumsum of the offsets instead
//    saves ~6% of the device time and costs more host time than the
//    whole kernel);
//  * the warp copies a block's bytes, at most 1280 (256 codes of at most
//    LMAX bits never reach further, whatever a malformed 16-bit length
//    says), into shared memory with 16-byte loads coalesced across lanes,
//    as big-endian words, bytes past the length zero (as the reference's
//    zero-padded rows read); the next block's loads are issued before the
//    current block is decoded;
//  * code boundaries, exact, by synchronising rounds (Weissenberger and
//    Schmidt, Massively Parallel Huffman Decoding on GPUs, ICPP 2018): the
//    block's 8 x len bits are cut into 32 lane segments; each lane walks
//    the codes from its start (at first its segment's own start, a guess)
//    to the first code start at or past its segment's end, which becomes
//    the next lane's start; until no start moves.  Lane 0 starts exact, so
//    a round fixes at least one more lane (32 rounds at most).  A Rice
//    code read from the middle of another resynchronises slowly (its
//    remainder bits look like any code), so blocks take 3-5 rounds;
//  * a warp scan of the lanes' code counts gives each lane its first
//    value; each lane walks its codes once more into the block's 256-value
//    row in shared memory, skewed so the lanes' stores hit 32 banks (codes
//    from past the bytes read only zeros: they stay 0, as every value past
//    the 256th is dropped), and the warp stores the row whole with 16-byte
//    stores into the band's rows, padded to whole blocks.
//
// Bound: memory.  The decode must read the coded bytes and write 4 bytes
// per value once; this kernel reads the bytes once more than that only
// where a block's first or last 16-byte chunk is shared with its
// neighbour, and writes a band's padding.  On the H100 it runs at a
// quarter of the byte bound: staging, look-back and stores alone take about half its
// time, the rounds and the value walk a quarter each
// (tools/rice_decode_anatomy.py).  One thread a block (the anatomy's
// other form) is slower: 256 dependent steps a thread.

// The per-lane arithmetic (zigzag, bins, costs, code parts, the bit run,
// the byte windows) is __host__ __device__, so it can be checked off the
// card as host code.
#include <cstdint>
#include <cuda_runtime.h>

namespace rice {

constexpr int kBlock = 256;                  // BLOCK_VALUES
constexpr int kQMax = 8;                     // Q_MAX
constexpr int kKMax = 24;                    // K_MAX
constexpr int kLMax = kQMax + 32;            // LMAX: an escape's length
constexpr int kWords = kBlock * kLMax / 32;  // 320 words: a block's longest stream
constexpr int kLanes = 32;
constexpr int kPerLane = kBlock / kLanes;    // 8 values per lane
constexpr int kBins = kKMax + 5;             // bit lengths 0..27, and one bin for >= 28
constexpr int kWarps = 8;                    // warps a tile (encode: one Rice block each)
constexpr int kBytesCap = kWords * 4;        // 1280: the bytes 256 codes can reach
constexpr int kStageChunks = kBytesCap / 16 + 2;  // 82: those bytes from a 16-byte
                                                  // boundary, then a zero chunk
constexpr int kTableHead = 3;  // the decode table's offsets of lengths, k and payload
constexpr int kDecodePerWarp = 4;  // Rice blocks a decode warp walks, one after another

// a tile's status word: flag in the top two bits, a byte count below
constexpr uint64_t kAggregate = uint64_t{1} << 62;  // the tile's own bytes
constexpr uint64_t kInclusive = uint64_t{2} << 62;  // the bytes of it and all before it
constexpr uint64_t kCountMask = kAggregate - 1u;

static_assert(kBins * kLanes >= kWords + 1, "a warp's bins also hold its staged words");

__host__ __device__ __forceinline__ uint32_t zigzag(int32_t x) {
  return (static_cast<uint32_t>(x) << 1) ^ static_cast<uint32_t>(x >> 31);
}

// Bit length of u: 0 for 0, 32 from 2^31 up.
__host__ __device__ __forceinline__ int bit_length(uint32_t u) {
#ifdef __CUDA_ARCH__
  return 32 - __clz(u);
#else
  return u ? 32 - __builtin_clz(u) : 0;
#endif
}

__host__ __device__ __forceinline__ int bin_of(int b) { return b < kBins - 1 ? b : kBins - 1; }

// One value's entry in its bin: a count of 1 (bits 0-8), t1 (bits 9-17)
// and 2 t1 + t2 (bits 18-27), t1 and t2 the two bits below the value's
// top bit.  With b its bit length, u >> k is 1 at k = b - 1, 2 + t1 at
// k = b - 2 and 4 + 2 t1 + t2 at k = b - 3.  Summed over a block's 256
// values no field overflows into the next (256, 256, 768).
__host__ __device__ __forceinline__ uint32_t bin_entry(uint32_t u, int b) {
  const uint32_t t1 = b >= 2 ? (u >> (b - 2)) & 1u : 0u;
  const uint32_t t12 = b >= 3 ? (u >> (b - 3)) & 3u : 0u;
  return 1u | (t1 << 9) | (t12 << 18);
}

// The exact cost in bits of a block at parameter k: ge4 values of bit
// length >= k + 4 escape (40 bits each), the others cost 1 + k plus
// their quotient, which only the bins of bit length k + 1, k + 2 and
// k + 3 (p1, p2, p3) make nonzero.
__host__ __device__ __forceinline__ uint32_t block_cost(int k, uint32_t ge4, uint32_t p1,
                                                        uint32_t p2, uint32_t p3) {
  const uint32_t quot = (p1 & 511u) + 2u * (p2 & 511u) + ((p2 >> 9) & 511u) +
                        4u * (p3 & 511u) + (p3 >> 18);
  return kLMax * ge4 + (1u + k) * (kBlock - ge4) + quot;
}

// A value's code at parameter k, MSB first, as at most two parts of at
// most 32 bits each: q ones, a zero and the k remainder bits (q + 1 + k
// <= 32 bits; lo_len 0); or, when q >= Q_MAX, Q_MAX ones, then the raw
// 32 bits.
struct CodeParts {
  uint32_t hi, lo;
  int hi_len, lo_len;
};

__host__ __device__ __forceinline__ CodeParts code_parts(uint32_t u, int k) {
  const uint32_t q = u >> k;
  if (q >= static_cast<uint32_t>(kQMax)) return {(1u << kQMax) - 1u, u, kQMax, 32};
  return {(((1u << q) - 1u) << (k + 1)) | (u & ((1u << k) - 1u)), 0u, static_cast<int>(q) + 1 + k,
          0};
}

// Codes appended MSB first from bit `start` of a block's stream; each
// 32-bit word of the stream is handed to flush(word index, bits) once it
// is full, and the last, partial one by finish().  The first word holds
// the bits before `start` as zeros.
struct BitRun {
  uint64_t acc;  // the pending `fill` bits, right-aligned (bits above them are spent)
  int fill, word;

  __host__ __device__ explicit BitRun(int start) : acc(0), fill(start & 31), word(start >> 5) {}

  template <class Flush>
  __host__ __device__ __forceinline__ void put(uint32_t v, int len, Flush& flush) {
    acc = (acc << len) | v;  // fill <= 31 and len <= 32: the pending bits fit in 63
    fill += len;
    if (fill >= 32) {
      fill -= 32;
      flush(word++, static_cast<uint32_t>(acc >> fill));
    }
  }

  template <class Flush>
  __host__ __device__ __forceinline__ void finish(Flush& flush) {
    if (fill) flush(word, static_cast<uint32_t>(acc << (32 - fill)));
  }
};

// Stream byte i of MSB-first words s.
__host__ __device__ __forceinline__ uint32_t stream_byte(const uint32_t* s, int i) {
  return (s[i >> 2] >> (24 - 8 * (i & 3))) & 0xFFu;
}

// Stream bytes i..i+3 of MSB-first words s as they lie in memory from
// an aligned address (byte i lowest).
__host__ __device__ __forceinline__ uint32_t stream_word(const uint32_t* s, int i) {
  const uint64_t pair = (static_cast<uint64_t>(s[i >> 2]) << 32) | s[(i >> 2) + 1];
  const uint32_t be = static_cast<uint32_t>(pair >> (32 - 8 * (i & 3)));
#ifdef __CUDA_ARCH__
  return __byte_perm(be, 0u, 0x0123);
#else
  return __builtin_bswap32(be);
#endif
}

// A tile's status word, stored with release and loaded with acquire
// semantics at device scope.
__host__ __device__ __forceinline__ void publish(unsigned long long* p, uint64_t v) {
#ifdef __CUDA_ARCH__
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
#else
  __atomic_store_n(p, v, __ATOMIC_RELEASE);
#endif
}

__host__ __device__ __forceinline__ uint64_t peek(const unsigned long long* p) {
#ifdef __CUDA_ARCH__
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
#endif
}

// The bytes of every tile before `tile`, by decoupled look-back: lane i
// reads the status word of tile at - i, 32 tiles a step, summing byte
// counts back to the first inclusive one (waiting on a tile that has not
// published yet); then the tile publishes its own inclusive count.  Tile 0
// published its inclusive count before.  Called by one whole warp.
__device__ __forceinline__ uint64_t look_back(unsigned long long* status, int64_t tile,
                                              uint32_t agg, int lane) {
  uint64_t prefix = 0;
  if (tile == 0) return prefix;
  int64_t at = tile - 1;
  for (;;) {
    const int64_t idx = at - lane;
    const uint64_t s = idx >= 0 ? peek(status + idx) : kInclusive;
    const uint32_t incl_lanes = __ballot_sync(~0u, (s >> 62) == 2u);
    // the lanes that count: up to and including the first inclusive one
    const uint32_t need = incl_lanes ? incl_lanes ^ (incl_lanes - 1u) : ~0u;
    if (__ballot_sync(~0u, (s >> 62) == 0u) & need) {  // a tile still to publish
      __nanosleep(32);
      continue;
    }
    uint64_t v = ((need >> lane) & 1u) ? (s & kCountMask) : uint64_t{0};
#pragma unroll
    for (int d = kLanes / 2; d; d >>= 1) v += __shfl_down_sync(~0u, v, d);
    prefix += __shfl_sync(~0u, v, 0);
    if (incl_lanes) break;
    at -= kLanes;
  }
  if (lane == 0) publish(status + tile, kInclusive | (prefix + agg));
  return prefix;
}

// The bands' table: first block of each band and the total (nbands + 1),
// then each band's data address, then its value count.  Tables out:
// int64 first byte offset of each band and the total (nbands + 1), then
// uint16 byte length of each block, then uint8 k of each block.
// status: one word per tile, zeroed; ticket: zeroed.
__global__ void __launch_bounds__(kWarps * kLanes)
    encode_kernel(const int64_t* __restrict__ bands, int nbands, int64_t nblocks,
                  uint8_t* __restrict__ payload, uint8_t* __restrict__ tables,
                  unsigned long long* __restrict__ status, unsigned int* __restrict__ ticket) {
  __shared__ __align__(16) uint32_t bins[kWarps][kBins * kLanes];  // per warp: bins, then staged words
  __shared__ uint32_t block_len[kWarps];
  __shared__ int64_t tile, tile_base;
  const int lane = threadIdx.x & (kLanes - 1), warp = threadIdx.x / kLanes;
  if (threadIdx.x == 0) tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t g = tile * kWarps + warp;  // this warp's Rice block
  const bool live = g < nblocks;           // warp-uniform
  uint32_t* sw = bins[warp];
  uint4* sw4 = reinterpret_cast<uint4*>(sw);
  const int64_t* firsts = bands;
  const int64_t* addrs = bands + nbands + 1;
  const int64_t* counts = addrs + nbands;

  int band = 0, k = 0;
  uint32_t nbytes = 0, u[kPerLane];
  if (live) {
    int lo = 0, hi = nbands - 1;  // the last band whose first block is <= g
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (firsts[mid] <= g) lo = mid; else hi = mid - 1;
    }
    band = lo;
    const int64_t at = (g - firsts[band]) * kBlock + lane * kPerLane;
    const int32_t* src = reinterpret_cast<const int32_t*>(addrs[band]) + at;
    const int64_t left = counts[band] - at;  // this lane's values still in the band
    if (left >= kPerLane && (addrs[band] & 15) == 0) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(src));
      const int4 b = __ldg(reinterpret_cast<const int4*>(src) + 1);
      u[0] = zigzag(a.x); u[1] = zigzag(a.y); u[2] = zigzag(a.z); u[3] = zigzag(a.w);
      u[4] = zigzag(b.x); u[5] = zigzag(b.y); u[6] = zigzag(b.z); u[7] = zigzag(b.w);
    } else {  // the band's last block codes its zero pad as values
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) u[j] = j < left ? zigzag(__ldg(src + j)) : 0u;
    }

    // each lane's column of bins; then lane t < kBins sums bin t across
    // the columns, 16 bytes at a time (rotated: a quarter warp's 8 lanes
    // hit 32 banks)
    for (int i = lane; i < kBins * kLanes / 4; i += kLanes) sw4[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int b = bit_length(u[j]);
      sw[bin_of(b) * kLanes + lane] += bin_entry(u[j], b);
    }
    __syncwarp();
    uint32_t bin = 0;
    if (lane < kBins) {
#pragma unroll
      for (int i = 0; i < kLanes / 4; ++i) {
        const uint4 v = sw4[lane * (kLanes / 4) + ((i + lane) & (kLanes / 4 - 1))];
        bin += v.x + v.y + v.z + v.w;
      }
    }

    // values of bit length >= lane (a suffix sum of the counts), then
    // lane k prices k; the least (cost << 5 | k) is the first least cost
    uint32_t ge = bin & 511u;
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      const uint32_t v = __shfl_down_sync(~0u, ge, d);
      if (lane + d < kLanes) ge += v;
    }
    const uint32_t ge4 = __shfl_down_sync(~0u, ge, 4);
    const uint32_t p1 = __shfl_down_sync(~0u, bin, 1);
    const uint32_t p2 = __shfl_down_sync(~0u, bin, 2);
    const uint32_t p3 = __shfl_down_sync(~0u, bin, 3);
    const uint32_t key = lane <= kKMax ? (block_cost(lane, ge4, p1, p2, p3) << 5) | lane : ~0u;
    const uint32_t best = __reduce_min_sync(~0u, key);
    k = static_cast<int>(best & 31u);
    nbytes = ((best >> 5) + 7u) >> 3;
  }

  // the tile's byte count, published before packing for the tiles after
  // it to sum; each block's offset in the tile
  if (lane == 0) block_len[warp] = nbytes;
  __syncthreads();
  uint32_t off = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t n = block_len[w];
    off += w < warp ? n : 0u;
    agg += n;
  }
  if (threadIdx.x == 0) publish(status + tile, (tile == 0 ? kInclusive : kAggregate) | agg);

  if (live) {
    // this lane's code lengths and its bit offset in the block's stream
    int len = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const uint32_t q = u[j] >> k;
      len += q >= static_cast<uint32_t>(kQMax) ? kLMax : static_cast<int>(q) + 1 + k;
    }
    int incl = len;
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      const int v = __shfl_up_sync(~0u, incl, d);
      if (lane >= d) incl += v;
    }
    __syncwarp();  // every lane has read the bins: their space stages the words
    for (int i = lane; i < (kWords + 4) / 4; i += kLanes) sw4[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
    auto flush = [sw](int w, uint32_t bits) {
      if (bits) atomicOr(&sw[w], bits);
    };
    BitRun run(incl - len);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const CodeParts c = code_parts(u[j], k);
      run.put(c.hi, c.hi_len, flush);
      if (c.lo_len) run.put(c.lo, c.lo_len, flush);
    }
    run.finish(flush);
  }

  // the tile's offset in the payload: the byte counts of every tile
  // before it
  if (warp == 0) {
    const uint64_t prefix = look_back(status, tile, agg, lane);
    if (lane == 0) tile_base = static_cast<int64_t>(prefix);
  }
  __syncthreads();
  if (!live) return;

  const int64_t dst = tile_base + off;
  if (lane == 0) {
    int64_t* band_off = reinterpret_cast<int64_t*>(tables);
    uint16_t* lens = reinterpret_cast<uint16_t*>(tables + 8 * (nbands + 1));
    uint8_t* ks = tables + 8 * (nbands + 1) + 2 * nblocks;
    lens[g] = static_cast<uint16_t>(nbytes);
    ks[g] = static_cast<uint8_t>(k);
    if (g == firsts[band]) band_off[band] = dst;
    if (g == nblocks - 1) band_off[nbands] = dst + nbytes;
  }
  uint8_t* out = payload + dst;
  const int n = static_cast<int>(nbytes);
  const int head = min(static_cast<int>((4 - (dst & 3)) & 3), n);
  if (lane < head) out[lane] = static_cast<uint8_t>(stream_byte(sw, lane));
  const int words = (n - head) >> 2;
  uint32_t* outw = reinterpret_cast<uint32_t*>(out + head);
  for (int m = lane; m < words; m += kLanes) outw[m] = stream_word(sw, head + 4 * m);
  const int tail = head + 4 * words;
  if (lane < n - tail) out[tail + lane] = static_cast<uint8_t>(stream_byte(sw, tail + lane));
}

// Stream bytes as big-endian words: word j of a 16-byte chunk loaded at
// stage byte 16 c, its bytes at or past `end` zeroed.
__host__ __device__ __forceinline__ uint32_t be_word(uint32_t w, int at, int end) {
  const int keep = end - at;  // bytes of w before the end
  if (keep <= 0) return 0u;
  if (keep < 4) w &= (1u << (8 * keep)) - 1u;
#ifdef __CUDA_ARCH__
  return __byte_perm(w, 0u, 0x0123);
#else
  return __builtin_bswap32(w);
#endif
}

// The 32 stream bits from bit P of big-endian words s: the top half of
// (s[P / 32] : s[P / 32 + 1]) << P % 32.
__host__ __device__ __forceinline__ uint32_t bits32(const uint32_t* s, int P) {
  const uint32_t w0 = s[P >> 5], w1 = s[(P >> 5) + 1];
#ifdef __CUDA_ARCH__
  return __funnelshift_l(w1, w0, P & 31);
#else
  return (P & 31) ? (w0 << (P & 31)) | (w1 >> (32 - (P & 31))) : w0;
#endif
}

__host__ __device__ __forceinline__ int leading_ones(uint32_t hi) {
#ifdef __CUDA_ARCH__
  return __clz(~hi);
#else
  return ~hi ? __builtin_clz(~hi) : 32;
#endif
}

// The length of the code at bit P: Q_MAX or more leading ones escape.
__host__ __device__ __forceinline__ int code_len(const uint32_t* s, int P, int k) {
  const int ones = leading_ones(bits32(s, P));
  return ones >= kQMax ? kLMax : ones + 1 + k;
}

// The code at bit P: its zigzag value and its length.  A code that does
// not escape fits the 32 bits from P (its q + 1 + k <= 32).
__host__ __device__ __forceinline__ uint32_t code_value(const uint32_t* s, int P, int k, int& len) {
  const uint32_t hi = bits32(s, P);
  const int ones = leading_ones(hi);
  if (ones >= kQMax) {  // escape: the 32 bits after Q_MAX ones
    len = kLMax;
    return (hi << kQMax) | (bits32(s, P + 32) >> (32 - kQMax));
  }
  len = ones + 1 + k;
  return (static_cast<uint32_t>(ones) << k) | (k ? (hi << (ones + 1)) >> (32 - k) : 0u);
}

// A block's bytes as the warp stages them: its first min(len, 1280)
// bytes from the 16-byte boundary at or before them (`s` bytes before),
// as kStageChunks 16-byte chunks, three a lane; those at or past `end`
// (chunk `nload` and on) read as zero.
static_assert(3 * kLanes >= kStageChunks, "a lane stages at most three chunks");

struct Staged {
  const uint4* from;
  int s, end, nload;
  uint4 v[3];

  __device__ __forceinline__ Staged(const uint8_t* src, uint32_t n, int lane) {
    s = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15u);
    end = s + min(static_cast<int>(n), kBytesCap);
    nload = (end + 15) >> 4;
    from = reinterpret_cast<const uint4*>(src - s);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int c = lane + i * kLanes;
      v[i] = c < nload ? __ldg(from + c) : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // into shared memory as big-endian words, the bytes past the block zero
  __device__ __forceinline__ void store(uint32_t* sw, int lane) const {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int c = lane + i * kLanes;
      if (c <= nload)
        reinterpret_cast<uint4*>(sw)[c] =
            make_uint4(be_word(v[i].x, 16 * c, end), be_word(v[i].y, 16 * c + 4, end),
                       be_word(v[i].z, 16 * c + 8, end), be_word(v[i].w, 16 * c + 12, end));
    }
  }
};

// A block's value i sits at row[skew(i)]: a lane's values start near 8 x
// its lane, and the skew puts the 32 lanes' stores in 32 banks.
__host__ __device__ __forceinline__ int skew(int i) { return i + (i >> 5); }
constexpr int kRow = kBlock + kBlock / 32;  // 264

// The decode's table: the byte offsets in `coded` of every block's uint16
// byte length, of its uint8 k and of the bands' payloads, back to back in
// block order (kTableHead); then each band's first block and the total
// (nbands + 1); then each band's value count.  Band b's values go to out
// from 256 x its first block (a band's last row is written whole: the
// values past its count are never read).  status: one word per tile,
// zeroed; ticket: zeroed.  `coded` holds 16 bytes past the last payload
// byte (the last 16-byte load may reach them; they are never decoded).
__global__ void __launch_bounds__(kWarps * kLanes)
    decode_kernel(const uint8_t* __restrict__ coded, const int64_t* __restrict__ table,
                  int64_t nblocks, int32_t* __restrict__ out,
                  unsigned long long* __restrict__ status, unsigned int* __restrict__ ticket) {
  __shared__ __align__(16) uint32_t stage[kWarps][kStageChunks * 4];
  __shared__ int32_t row[kWarps][kRow];
  __shared__ uint32_t warp_len[kWarps];
  __shared__ int64_t tile, tile_base;
  const int lane = threadIdx.x & (kLanes - 1), warp = threadIdx.x / kLanes;
  if (threadIdx.x == 0) tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t g0 = (tile * kWarps + warp) * kDecodePerWarp;  // this warp's first block
  const int64_t left = nblocks - g0;  // blocks from g0 on
  const int blocks = left <= 0 ? 0 : left < kDecodePerWarp ? static_cast<int>(left) : kDecodePerWarp;

  // lane j < blocks: block g0 + j's byte length, k and offset in the warp
  uint32_t n = 0;
  int k = 0;
  if (lane < blocks) {
    n = reinterpret_cast<const uint16_t*>(coded + table[0])[g0 + lane];
    k = coded[table[1] + g0 + lane];  // 0..K_MAX, checked on the host
  }
  uint32_t at = n;
#pragma unroll
  for (int d = 1; d < kDecodePerWarp; d <<= 1) {
    const uint32_t v = __shfl_up_sync(~0u, at, d);
    if (lane >= d) at += v;
  }
  if (lane == kDecodePerWarp - 1) warp_len[warp] = at;
  at -= n;

  // the tile's byte count, published at once; the warp's offset in the
  // tile; the tile's offset in the payloads
  __syncthreads();
  uint32_t off = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t m = warp_len[w];
    off += w < warp ? m : 0u;
    agg += m;
  }
  if (threadIdx.x == 0) publish(status + tile, (tile == 0 ? kInclusive : kAggregate) | agg);
  if (warp == 0) {
    const uint64_t prefix = look_back(status, tile, agg, lane);
    if (lane == 0) tile_base = static_cast<int64_t>(prefix);
  }
  __syncthreads();
  if (blocks == 0) return;

  const uint8_t* payload = coded + table[2] + tile_base + off;
  uint32_t* sw = stage[warp];
  int32_t* r = row[warp];
  Staged next(payload + __shfl_sync(~0u, at, 0), __shfl_sync(~0u, n, 0), lane);
  for (int j = 0; j < blocks; ++j) {
    // stage block j, then start the loads of block j + 1
    const Staged cur = next;
    const int kj = __shfl_sync(~0u, k, j);
    __syncwarp();  // block j - 1's walks have read the stage
    cur.store(sw, lane);
    if (j + 1 < blocks)
      next = Staged(payload + __shfl_sync(~0u, at, j + 1), __shfl_sync(~0u, n, j + 1), lane);
    __syncwarp();

    // the rounds: each lane's exact first code and its code count
    const int base = 8 * cur.s, nbits = 8 * (cur.end - cur.s);
    const int seg = (nbits + kLanes - 1) / kLanes;
    const int seg0 = min(lane * seg, nbits), seg1 = min(seg0 + seg, nbits);
    int start = seg0, count;
    for (;;) {
      int p = start;
      count = 0;
      while (p < seg1) {
        p += code_len(sw, base + p, kj);
        ++count;
      }
      int nxt = __shfl_up_sync(~0u, p, 1);
      if (lane == 0) nxt = 0;
      const bool moved = nxt != start && seg0 < nbits;  // lanes past the bits decode nothing
      start = nxt;
      if (!__any_sync(~0u, moved)) break;
    }
    int first = count;  // the index of this lane's first code in the block
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      const int v = __shfl_up_sync(~0u, first, d);
      if (lane >= d) first += v;
    }
    first -= count;

    // the values into the block's row, then the row out
    for (int i = lane; i < kRow; i += kLanes) r[i] = 0;
    __syncwarp();
    for (int p = start, i = first; p < seg1 && i < kBlock; ++i) {
      int len;
      const uint32_t u = code_value(sw, base + p, kj, len);
      r[skew(i)] = static_cast<int32_t>((u >> 1) ^ (0u - (u & 1u)));
      p += len;
    }
    __syncwarp();
    const int32_t* v = r + skew(lane * kPerLane);
    int4* dst = reinterpret_cast<int4*>(out + (g0 + j) * kBlock + lane * kPerLane);
    dst[0] = make_int4(v[0], v[1], v[2], v[3]);
    dst[1] = make_int4(v[4], v[5], v[6], v[7]);
  }
}

}  // namespace rice

using namespace rice;

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Codes `nblocks` Rice blocks of the bands that `table` (host memory,
// table_len int64: see encode_kernel) describes, in one launch.
// payload: nblocks x BYTES_CAP bytes (the worst case); tables: 8 x
// (nbands + 1) + 3 x nblocks bytes; work: nblocks + 1 + table_len int64
// (the tiles' status words, nblocks of room; the ticket; the table on
// the card).
// Returns a cudaError_t.
extern "C" int repro_rice_encode(int device, uint8_t* payload, uint8_t* tables, int64_t* work,
                                 int64_t nblocks, const int64_t* table, int table_len,
                                 void* stream) {
  cudaError_t e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  const int nbands = (table_len - 1) / 3;
  const int64_t tiles = (nblocks + kWarps - 1) / kWarps;
  if (nblocks < 1 || nbands < 1 || table_len != 3 * nbands + 1 || tiles > 0x7fffffff)
    return cudaErrorInvalidValue;
  // every band holds >= 1 value and exactly its blocks, in order
  if (table[0] != 0 || table[nbands] != nblocks) return cudaErrorInvalidValue;
  for (int i = 0; i < nbands; ++i) {
    const int64_t count = table[2 * nbands + 1 + i];
    if (count < 1 || table[i + 1] - table[i] != (count + kBlock - 1) / kBlock)
      return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(work, 0, (nblocks + 1) * sizeof(int64_t), s)) != cudaSuccess) return e;
  if ((e = cudaMemcpyAsync(work + nblocks + 1, table, table_len * sizeof(int64_t),
                           cudaMemcpyHostToDevice, s)) != cudaSuccess)
    return e;
  encode_kernel<<<static_cast<unsigned>(tiles), kWarps * kLanes, 0, s>>>(
      work + nblocks + 1, nbands, nblocks, payload, tables,
      reinterpret_cast<unsigned long long*>(work), reinterpret_cast<unsigned int*>(work + nblocks));
  return cudaGetLastError();
}

// Decodes the `nblocks` Rice blocks of the bands that `table` (host
// memory, table_len int64: see decode_kernel) describes, from `coded`
// (device memory), in one launch.  out: nblocks x 256 int32; work:
// nblocks + 1 + table_len int64 (the tiles' status words, nblocks of
// room; the ticket; the table on the card).
// Returns a cudaError_t.
extern "C" int repro_rice_decode(int device, const uint8_t* coded, int32_t* out, int64_t* work,
                                 int64_t nblocks, const int64_t* table, int table_len,
                                 void* stream) {
  cudaError_t e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return e;
  const int nbands = (table_len - kTableHead - 1) / 2;
  const int64_t tiles = (nblocks + kWarps * kDecodePerWarp - 1) / (kWarps * kDecodePerWarp);
  if (nblocks < 1 || nbands < 1 || table_len != kTableHead + 2 * nbands + 1 ||
      tiles > 0x7fffffff)
    return cudaErrorInvalidValue;
  // lengths 2-byte aligned, offsets not negative; every band holds >= 1
  // value and exactly its blocks, in order
  if (table[0] < 0 || (table[0] & 1) || table[1] < 0 || table[2] < 0) return cudaErrorInvalidValue;
  const int64_t* firsts = table + kTableHead;
  if (firsts[0] != 0 || firsts[nbands] != nblocks) return cudaErrorInvalidValue;
  for (int i = 0; i < nbands; ++i) {
    const int64_t count = firsts[nbands + 1 + i];
    if (count < 1 || firsts[i + 1] - firsts[i] != (count + kBlock - 1) / kBlock)
      return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((e = cudaMemsetAsync(work, 0, (tiles + 1) * sizeof(int64_t), s)) != cudaSuccess) return e;
  if ((e = cudaMemcpyAsync(work + nblocks + 1, table, table_len * sizeof(int64_t),
                           cudaMemcpyHostToDevice, s)) != cudaSuccess)
    return e;
  decode_kernel<<<static_cast<unsigned>(tiles), kWarps * kLanes, 0, s>>>(
      coded, work + nblocks + 1, nblocks, out, reinterpret_cast<unsigned long long*>(work),
      reinterpret_cast<unsigned int*>(work + tiles));
  return cudaGetLastError();
}
