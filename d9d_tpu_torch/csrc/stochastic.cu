// stochastic: fp32 -> bf16 stochastic rounding, hand-written for sm_90a.
//
// Replaces `_sr_kernel` of d9d_tpu/ops/stochastic.py (through
// `stochastic_round_to_bf16_pallas`): add 16 random bits below the bf16
// mantissa cut and truncate, so that E[result] = x; non-finite values pass
// through (NaN as the quiet NaN 0x7FC0).
//
// Bound on this card: bytes. Each element reads 4 bytes and writes 2, and
// does a few dozen integer operations: 6 B per element at 3.35 TB/s, far
// below any compute limit (the embedding leaf of Qwen3-8B, 622 M elements,
// moves 3.7 GB: 1.1 ms).
//
// Design. The TPU kernel seeds its on-chip PRNG per (256, 128) block by
// (seed, program_id), so its bits depend on its tiling. Here the random
// bits are a counter-based hash of (seed, flat element index): two rounds of
// murmur3's fmix32 over the index, keyed by the two 32-bit halves of the
// 64-bit seed. They are computed in registers, need no state, and do not
// depend on the grid, so the plain PyTorch version (ops/stochastic.py
// `random_bits`) computes the same bits and the kernel is held to it bit for
// bit. The kernel is a grid-stride loop over the flat tensor: four elements
// per thread and step, read as one 16-byte load of fp32 and written as one
// 8-byte store of bf16; the tail shorter than four (and any tensor whose
// pointers are not aligned for the vector accesses) takes one element at a
// time. Only integer arithmetic touches the values, so denormals and signed
// zeros are rounded by the rule like any other value. The output may be a
// bf16 parameter written in place; it never overlaps the fp32 input.
//
// Shards. A tensor may be one rank's piece of a larger one (a parameter
// that FSDP sharded). The bits must be those the element draws in the whole
// tensor, so the hash takes the element's index there: local element i of
// a piece of `cols`-element rows lies at index_offset + (i / cols) *
// row_stride + i % cols of the whole tensor (a row-range piece, cut on dim
// 0, is one run: cols == row_stride, and the index is index_offset + i; a
// column piece, cut on a later dim, is one run per row). The division runs
// only in the second case, once per four elements where cols % 4 == 0 (the
// four then lie in one row), else once per element.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t random_bits(uint64_t i, uint32_t k0,
                                                uint32_t k1) {
  uint32_t h = fmix32(static_cast<uint32_t>(i) ^ k0);
  return fmix32(h ^ static_cast<uint32_t>(i >> 32) ^ k1);
}

__device__ __forceinline__ uint32_t round_one(float x, uint64_t i,
                                              uint32_t k0, uint32_t k1) {
  const uint32_t b = __float_as_uint(x);
  if ((b & 0x7f800000u) == 0x7f800000u) {  // inf passes, NaN is quieted
    return (b & 0x007fffffu) ? 0x7fc0u : (b >> 16);
  }
  // finite: b <= 0xff7fffff, so the sum does not wrap
  return (b + (random_bits(i, k0, k1) & 0xffffu)) >> 16;
}

struct Index {  // local flat index -> index in the whole tensor
  int64_t offset, cols, row_stride;
  template <bool kStrided>
  __device__ __forceinline__ uint64_t at(int64_t i) const {
    if (!kStrided) return static_cast<uint64_t>(offset + i);
    return static_cast<uint64_t>(offset + (i / cols) * row_stride + i % cols);
  }
};

template <bool kVec, bool kStrided>
__global__ void __launch_bounds__(256)
    sr_kernel(const float* __restrict__ x, uint16_t* __restrict__ out,
              int64_t n, uint32_t k0, uint32_t k1, Index ix) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (kVec) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    uint2* o4 = reinterpret_cast<uint2*>(out);
    for (int64_t g = t; g < n4; g += stride) {
      const float4 v = x4[g];
      const uint64_t i = ix.at<kStrided>(g * 4);
      uint2 w;
      w.x = round_one(v.x, i, k0, k1) | (round_one(v.y, i + 1, k0, k1) << 16);
      w.y = round_one(v.z, i + 2, k0, k1) |
            (round_one(v.w, i + 3, k0, k1) << 16);
      o4[g] = w;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + t; i < n; i += stride) {
    out[i] = static_cast<uint16_t>(
        round_one(x[i], ix.at<kStrided>(i), k0, k1));
  }
}

}  // namespace

// x: fp32 [n], out: bf16 [n] (as uint16), both contiguous; seed: the 64-bit
// key; index_offset, cols, row_stride: where the elements lie in the whole
// tensor (see "Shards"; 0, n, n for a whole tensor). Launches on `stream`,
// allocates nothing, never synchronizes.
extern "C" int d9d_stochastic_round(const void* x, void* out, long long n,
                                    unsigned long long seed,
                                    long long index_offset, long long cols,
                                    long long row_stride, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (index_offset < 0 || cols < 1 || row_stride < cols || n % cols != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const bool strided = cols != row_stride;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 8 == 0 &&
                   (!strided || cols % 4 == 0);
  const Index ix{index_offset, cols, row_stride};
  const int threads = 256;
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + threads - 1) / threads;
  const long long resident = static_cast<long long>(sms) * 8;  // 2048 threads/SM
  if (blocks > resident) blocks = resident;
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  uint16_t* o = static_cast<uint16_t*>(out);
  if (vec && strided) {
    sr_kernel<true, true><<<(unsigned)blocks, threads, 0, s>>>(xf, o, n, k0,
                                                               k1, ix);
  } else if (vec) {
    sr_kernel<true, false><<<(unsigned)blocks, threads, 0, s>>>(xf, o, n, k0,
                                                                k1, ix);
  } else if (strided) {
    sr_kernel<false, true><<<(unsigned)blocks, threads, 0, s>>>(xf, o, n, k0,
                                                                k1, ix);
  } else {
    sr_kernel<false, false><<<(unsigned)blocks, threads, 0, s>>>(xf, o, n, k0,
                                                                 k1, ix);
  }
  return (int)cudaGetLastError();
}
