// JAX's default PRNG, threefry2x32 (20 rounds), on Hopper: the draws the
// port makes from the JAX package's keys (utils/jax_random.py) after
// initialisation -- the step's key chain, dropout masks, time jitter,
// VQ-dropout, Gumbel noise, the AR samplers' uniforms and the reseed
// candidates.
//
// Not a port of a TPU kernel: the JAX package draws through XLA's threefry
// (jax.random under jax_threefry_partitionable, JAX 0.9.0), with no Pallas
// call. The plain version is kernels/threefry.py's torch-op code; every
// entry point here gives its bits exactly.
//
// What bounds it: integer operations. A counter costs ~75 32-bit integer
// operations (20 rounds of add, rotate, xor and 5 key injections), against
// at most 4 bytes written, so the card's int32 rate (64 lanes an SM) is the
// limit by ~40x over its memory rate. The design keeps to that: the iota
// entry points generate their counters in registers from a 64-bit offset
// (no counter array is read), each thread hashes counters in a grid-stride
// loop and writes its word, float or byte directly, and the rotations are
// single funnel shifts. One key per grid row (blockIdx.y), so no thread
// divides to find its key.
//
// Entry points (plain C, ctypes; each returns cudaGetLastError()):
//   (a) wae_threefry_hash     y = threefry(k, x) over n given counter pairs
//   (b) wae_threefry_bits     bits[k][j] = y0 ^ y1 of counter offset + j
//   (c) wae_threefry_uniform  max(lo, fmaf(mantissa(bits) - 1, span, lo))
//   (d) wae_threefry_keep     uniform(0, 1) < keep, one byte a value
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 4096;
constexpr int kMaxBlocksY = 65535;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

#define WAE_ROUND(r) \
  x0 += x1;          \
  x1 = rotl(x1, r) ^ x0;

// threefry2x32 with 20 rounds, as jax._src.prng.threefry2x32_p
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  WAE_ROUND(13) WAE_ROUND(15) WAE_ROUND(26) WAE_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  WAE_ROUND(17) WAE_ROUND(29) WAE_ROUND(16) WAE_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  WAE_ROUND(13) WAE_ROUND(15) WAE_ROUND(26) WAE_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  WAE_ROUND(17) WAE_ROUND(29) WAE_ROUND(16) WAE_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  WAE_ROUND(13) WAE_ROUND(15) WAE_ROUND(26) WAE_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef WAE_ROUND

__global__ void hash_kernel(const uint32_t* __restrict__ k0, const uint32_t* __restrict__ k1,
                            const uint32_t* __restrict__ x0, const uint32_t* __restrict__ x1,
                            uint32_t* __restrict__ y0, uint32_t* __restrict__ y1, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t a = x0[i], b = x1[i];
    threefry(k0[i], k1[i], a, b);
    y0[i] = a;
    y1[i] = b;
  }
}

enum Mode { kBits = 0, kUniform = 1, kKeep = 2 };

// the 32 random bits of counter c (its (hi, lo) words) under key (k0, k1):
// the xor of threefry's two outputs, as JAX's partitionable random_bits
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1, uint64_t c) {
  uint32_t a = (uint32_t)(c >> 32), b = (uint32_t)c;
  threefry(k0, k1, a, b);
  return a ^ b;
}

// jax.random.uniform's map: the top 23 bits as the mantissa of [1, 2),
// minus 1, times the span plus lo rounded once (XLA fuses the multiply-add),
// then max(lo, .)
__device__ __forceinline__ float uniform_of(uint32_t bits, float lo, float span) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(lo, fmaf(u, span, lo));
}

template <int MODE>
__global__ void iota_kernel(const uint32_t* __restrict__ keys, int64_t nk, int64_t n, uint64_t offset, float lo,
                            float span, float keep, void* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = blockIdx.y; k < nk; k += gridDim.y) {
    const uint32_t k0 = keys[2 * k], k1 = keys[2 * k + 1];
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += stride) {
      const uint32_t bits = bits_at(k0, k1, offset + (uint64_t)j);
      const int64_t at = k * n + j;
      if (MODE == kBits) {
        static_cast<uint32_t*>(out)[at] = bits;
      } else if (MODE == kUniform) {
        static_cast<float*>(out)[at] = uniform_of(bits, lo, span);
      } else {
        static_cast<uint8_t*>(out)[at] = uniform_of(bits, 0.0f, 1.0f) < keep ? 1 : 0;
      }
    }
  }
}

dim3 iota_grid(int64_t nk, int64_t n) {
  int64_t bx = (n + kThreads - 1) / kThreads;
  bx = bx < 1 ? 1 : (bx > kMaxBlocksX ? kMaxBlocksX : bx);
  const int64_t by = nk > kMaxBlocksY ? kMaxBlocksY : nk;
  return dim3((unsigned)bx, (unsigned)by);
}

template <int MODE>
int launch_iota(const uint32_t* keys, int64_t nk, int64_t n, uint64_t offset, float lo, float span, float keep,
                void* out, cudaStream_t stream) {
  if (nk <= 0 || n <= 0) return (int)cudaSuccess;
  iota_kernel<MODE><<<iota_grid(nk, n), kThreads, 0, stream>>>(keys, nk, n, offset, lo, span, keep, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wae_threefry_hash(const uint32_t* k0, const uint32_t* k1, const uint32_t* x0, const uint32_t* x1,
                                 uint32_t* y0, uint32_t* y1, int64_t n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks > kMaxBlocksX ? kMaxBlocksX : blocks;
  hash_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(k0, k1, x0, x1, y0, y1, n);
  return (int)cudaGetLastError();
}

extern "C" int wae_threefry_bits(const uint32_t* keys, int64_t nk, int64_t n, uint64_t offset, uint32_t* out,
                                 cudaStream_t stream) {
  return launch_iota<kBits>(keys, nk, n, offset, 0.0f, 0.0f, 0.0f, out, stream);
}

extern "C" int wae_threefry_uniform(const uint32_t* keys, int64_t nk, int64_t n, uint64_t offset, float lo,
                                    float span, float* out, cudaStream_t stream) {
  return launch_iota<kUniform>(keys, nk, n, offset, lo, span, 0.0f, out, stream);
}

extern "C" int wae_threefry_keep(const uint32_t* keys, int64_t nk, int64_t n, uint64_t offset, float keep,
                                 uint8_t* out, cudaStream_t stream) {
  return launch_iota<kKeep>(keys, nk, n, offset, 0.0f, 1.0f, keep, out, stream);
}

extern "C" const char* wae_threefry_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
