// SHA-512 (FIPS 180-4) of one ragged message a lane, as __device__
// functions: the padding, the compression and the digest in the layout of
// hashgraph_tpu_torch/crypto_device/sha512.py.
//
// Every function here computes what the plain PyTorch version in
// crypto_device/sha512.py computes, word for word:
//
//   sha512_pad_byte, sha512_block_words   the host packing of
//                                         sha512_batch_dispatch: the
//                                         message, 0x80, zeros and the
//                                         128-bit big-endian bit length in
//                                         the last 16 bytes of the lane's
//                                         OWN final block
//   sha512_compress                       one block of _sha512_blocks
//   sha512_digest_halves                  its output row: int64[16], the
//                                         eight state words as (hi, lo)
//                                         32-bit halves
//
// The plain version carries each 64-bit word as two int64 halves masked to
// 32 bits; here a word is one uint64_t, which the card runs as 32-bit
// integer instructions (adds with carry, funnel shifts), so the state and
// the 16-word schedule window live in registers.
//
// A host C++ compiler builds this file too: __device__, __forceinline__
// and __constant__ are defined away when nvcc is not the compiler, which is
// how the CPU tests hold it against hashlib and the plain version
// (tests/test_torch_sha512_kernel.py).

#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#ifndef __device__
#define __device__
#endif
#ifndef __forceinline__
#define __forceinline__ inline
#endif
#ifndef __constant__
#define __constant__
#endif
#endif

constexpr int kShaBlock = 128;  // bytes a block
constexpr int kShaLength = 16;  // bytes of the bit-length field

// The round constants: the first 64 bits of the fractional parts of the
// cube roots of the first 80 primes (sha512.py derives the same _K64).
static __constant__ uint64_t kSha512K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, 0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, 0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, 0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, 0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, 0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, 0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

// blocks_needed: the payload, the 0x80 byte and the 16-byte length field,
// rounded up to whole blocks.
__device__ __forceinline__ int64_t sha512_blocks_needed(int64_t len) {
  return (len + 1 + kShaLength + kShaBlock - 1) / kShaBlock;
}

// Byte p of the padded message of `len` bytes whose padded length is
// `total` (blocks_needed * 128).
__device__ __forceinline__ uint32_t sha512_pad_byte(const uint8_t* msg, int64_t len,
                                                    int64_t total, int64_t p) {
  if (p < len) return msg[p];
  if (p == len) return 0x80u;
  const int64_t q = p - (total - kShaLength);  // byte of the length field
  if (q < 0) return 0u;
  // The bit length, len * 8, as 128 bits: high word len >> 61, low len << 3.
  const uint64_t half = q < 8 ? static_cast<uint64_t>(len) >> 61
                              : static_cast<uint64_t>(len) << 3;
  return static_cast<uint32_t>(half >> (8 * (7 - (q & 7)))) & 0xFFu;
}

// The 16 big-endian message words of block `block` of the padded message.
// A word wholly inside the payload is read directly; the one word that
// straddles its end and the words past it go byte by byte.
__device__ __forceinline__ void sha512_block_words(const uint8_t* msg, int64_t len,
                                                   int64_t block, uint64_t w[16]) {
  const int64_t total = sha512_blocks_needed(len) * kShaBlock;
  const int64_t base = block * kShaBlock;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int64_t p = base + 8 * t;
    uint64_t v = 0;
    if (p + 8 <= len) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v = (v << 8) | msg[p + j];
    } else {
#pragma unroll 1
      for (int j = 0; j < 8; ++j) v = (v << 8) | sha512_pad_byte(msg, len, total, p + j);
    }
    w[t] = v;
  }
}

__device__ __forceinline__ uint64_t sha512_rotr(uint64_t x, int r) {
  return (x >> r) | (x << (64 - r));
}

__device__ __forceinline__ void sha512_init(uint64_t s[8]) {
  // The first 64 bits of the fractional parts of the square roots of the
  // first 8 primes (sha512.py's _H64).
  s[0] = 0x6a09e667f3bcc908ULL;
  s[1] = 0xbb67ae8584caa73bULL;
  s[2] = 0x3c6ef372fe94f82bULL;
  s[3] = 0xa54ff53a5f1d36f1ULL;
  s[4] = 0x510e527fade682d1ULL;
  s[5] = 0x9b05688c2b3e6c1fULL;
  s[6] = 0x1f83d9abfb41bd6bULL;
  s[7] = 0x5be0cd19137e2179ULL;
}

// One block: 80 rounds over the schedule window w (rolled in place, word t
// in w[t % 16]), then the state's feed-forward.
__device__ __forceinline__ void sha512_compress(uint64_t s[8], uint64_t w[16]) {
  uint64_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint64_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    if (t >= 16) {
      const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint64_t sg0 = sha512_rotr(w15, 1) ^ sha512_rotr(w15, 8) ^ (w15 >> 7);
      const uint64_t sg1 = sha512_rotr(w2, 19) ^ sha512_rotr(w2, 61) ^ (w2 >> 6);
      w[t & 15] += sg0 + w[(t - 7) & 15] + sg1;
    }
    const uint64_t s1 = sha512_rotr(e, 14) ^ sha512_rotr(e, 18) ^ sha512_rotr(e, 41);
    const uint64_t ch = (e & f) ^ (~e & g);
    const uint64_t t1 = h + s1 + ch + kSha512K[t] + w[t & 15];
    const uint64_t s0 = sha512_rotr(a, 28) ^ sha512_rotr(a, 34) ^ sha512_rotr(a, 39);
    const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + s0 + maj;
  }
  s[0] += a;
  s[1] += b;
  s[2] += c;
  s[3] += d;
  s[4] += e;
  s[5] += f;
  s[6] += g;
  s[7] += h;
}

// The digest row: state word i as out[2i] (high half) and out[2i + 1] (low).
__device__ __forceinline__ void sha512_digest_halves(const uint64_t s[8], int64_t* out) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[2 * i] = static_cast<int64_t>(s[i] >> 32);
    out[2 * i + 1] = static_cast<int64_t>(s[i] & 0xFFFFFFFFull);
  }
}

// One lane of a ragged batch: message `lane` is data[offsets[lane] ..
// offsets[lane + 1]); its digest row goes to out[16 * lane ..]. The lane
// walks its own block count only.
__device__ __forceinline__ void sha512_ragged_lane(const int64_t* offsets, const uint8_t* data,
                                                   int64_t* out, int lane) {
  const int64_t start = offsets[lane];
  const int64_t len = offsets[lane + 1] - start;
  const uint8_t* msg = data + start;
  uint64_t s[8];
  sha512_init(s);
  const int64_t blocks = sha512_blocks_needed(len);
  for (int64_t b = 0; b < blocks; ++b) {
    uint64_t w[16];
    sha512_block_words(msg, len, b, w);
    sha512_compress(s, w);
  }
  sha512_digest_halves(s, out + 16 * static_cast<int64_t>(lane));
}
