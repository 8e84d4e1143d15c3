// moe_ffn: the fused expert FFN of a MoE layer over the group-aligned tile
// layout, hand-written for sm_90a. Three kernels, one per TPU kernel of
// d9d_tpu/ops/moe_pallas.py:
//
//   kernel 0 (B5) replaces `_ffn_kernel` (through `_fused_ffn_call`): rows
//       come from the aligned activation buffer. fp32: ffn_aligned_f32;
//       bf16: ffn_sm90_gate_up_aligned + ffn_sm90_down_aligned;
//   kernel 1 (B6) replaces `_ffn_gather_kernel` (`_fused_gather_call`):
//       each tile gathers its rows from x [N, h] by pair_src, so the
//       aligned buffer never exists. fp32: ffn_gather_f32; bf16:
//       ffn_sm90_gate_up_gather + ffn_sm90_down_gather;
//   kernel 2 (B7) replaces `_ffn_gather_combine_kernel`
//       (`_fused_gather_combine_call`): the gather, plus the combine — each
//       row's prob-weighted output is added straight into its token's row
//       of out [N, h]. fp32: ffn_gather_combine_f32; bf16:
//       ffn_sm90_gate_up_gather + ffn_sm90_down_combine.
//
// Every tile of block_m rows belongs to ONE expert (the groups are padded
// to block_m multiples), and computes
//     y = (silu(A Wg) * (A Wu)).astype(dtype) Wd * probs
// with fp32 accumulation, the hidden rounded to the compute dtype before the
// down product, and y * probs rounded once to the output dtype.
//
// Bound on this card: bytes, at Qwen3-30B-A3B widths. A training
// microbatch of 4096 tokens routes 32768 (token, expert) pairs through 128
// experts of h = 2048, i = 768: 6*M*h*i = 309 GFLOP (0.31 ms at the bf16
// tensor-core rate) against 1.2 GB of bf16 expert weights that must be read
// at least once plus the rows in and out (0.4-0.5 ms at 3.35 TB/s).
//
// Every bfloat16 kernel runs on the Hopper core of moe_ffn_sm90.cuh: wgmma
// fed by TMA, 128-row tiles, two launches a call with the hidden in device
// memory; bf16 takes block_m = 128. The body below runs every float32
// kernel: the exactness path of the parity chain.
//
// Design of the float32 body. The TPU kernel keeps a [block_m, h] row tile and
// one expert's three weight blocks resident in VMEM (3*h*i values, ~19 MB
// double-buffered at these widths); a Hopper block has 227 KB of shared
// memory. So a block owns one tile and runs two phases:
//   1. for each 64-wide chunk of i, stream A and the Wg/Wu chunk in k-slices
//      of h (cp.async, two stages), accumulate g and u, and write
//      silu(g) * u into a [block_m, i] hidden tile that stays in shared
//      memory (32 x 768 fp32 = 96 KB);
//   2. for each 64-wide chunk of h, stream the Wd chunk in k-slices of i,
//      multiply the hidden tile by it, scale by the row's prob and write
//      (or, for the combine kernel, atomicAdd into a zeroed fp32 [N, h]).
// No product is computed twice and the hidden never goes to device memory.
// It multiplies in exact fp32 FMAs on the CUDA cores with block_m = 32, so
// that its fp32 hidden tile fits.
//
// A tile whose first row is padding is all padding (real rows come first in
// every group): it writes zeros (aligned/gather) or nothing (combine) and
// exits without reading a weight. The layout bounds m_pad statically, so
// ~10 % of the tiles of a random routing are such tiles; the kernel reads
// that from pair_src on the device, with no readback.
//
// The combine kernel's K-sum runs in the order its atomics land, in fp32,
// followed by one rounding (the TPU kernel sums in expert order in the
// output dtype).
//
// Domain: h and i multiples of 64; in float32, the hidden tile plus two
// stages of operand slices within 227 KB (i <= 1600). The sm_90 core takes
// every bf16 shape with h and i multiples of 64 (its hidden goes through
// device memory). d9d_moe_ffn_tiling reports block_m and refuses shapes
// outside the domain; the launcher refuses them too.
#include "attn_mma.cuh"
#include "moe_ffn_sm90.cuh"

using namespace d9d;

namespace {

constexpr int NT = 256;              // 8 warps
constexpr int NC = 64;               // output columns per chunk (both phases)
constexpr int SMEM_LIMIT = 232448;   // opt-in shared memory of one sm_90 block

// the kernel numbers of d9d_moe_ffn, as the sm_90 core names them
using sm90::ALIGNED;
using sm90::COMBINE;
using sm90::GATHER;

struct FfnParams {
  const void* a;         // aligned: rows [m_pad, h]; gather/combine: x [N, h]
  const float* probs;    // aligned: [m_pad]; gather/combine: flat [N * K]
  const int* gid;        // [n_tiles] expert of each tile
  const int* pair_src;   // [m_pad] pair of each aligned row, -1 = padding
  const void* wg;        // [E, h, i]
  const void* wu;        // [E, h, i]
  const void* wd;        // [E, i, h]
  void* out;             // aligned/gather: [m_pad, h]; combine: fp32 [N, h]
  int h, inter, top_k;
};

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// row setup: source offset of each row of the tile in
// `a` (-1 = a zero row), its prob, and (combine) its token
template <int MODE, int BM>
__device__ __forceinline__ void setup_rows(const FfnParams& p, int tile,
                                           long long* row_off, float* row_prob,
                                           int* row_tok) {
  const int tid = threadIdx.x;
  if (tid < BM) {
    const long long row = (long long)tile * BM + tid;
    const int src = p.pair_src[row];
    long long off = -1;
    float pr = 0.f;
    int tok = -1;
    if (MODE == ALIGNED) {
      // the aligned buffer's pad rows are zero and their probs 0: read as is
      off = row * p.h;
      pr = p.probs[row];
    } else if (src >= 0) {
      tok = src / p.top_k;
      off = (long long)tok * p.h;
      pr = p.probs[src];
    }
    row_off[tid] = off;
    row_prob[tid] = pr;
    row_tok[tid] = tok;
  }
}

// all-padding tile: zero rows out (aligned/gather), nothing (combine)
template <typename T, int MODE, int BM>
__device__ __forceinline__ bool skip_pad_tile(const FfnParams& p, int tile) {
  if (p.pair_src[(long long)tile * BM] >= 0) return false;
  if (MODE != COMBINE) {
    constexpr int VEC = 16 / sizeof(T);
    uint4* o = reinterpret_cast<uint4*>(static_cast<T*>(p.out) +
                                        (long long)tile * BM * p.h);
    const int n = BM * p.h / VEC;
    for (int idx = threadIdx.x; idx < n; idx += NT)
      o[idx] = make_uint4(0u, 0u, 0u, 0u);
  }
  return true;
}

// ---------------------------------------------------------------------------
// float32 core: exact fp32 FMAs, block_m = 32
//
// thread t owns row t >> 3 and columns (t & 7) + 8 j, j < 8, of each 64-wide
// chunk: the 8 threads of a row read 8 consecutive weights, the 4 rows of a
// warp read one A value each (broadcast).

constexpr int F_BM = 32;
constexpr int F_KC = 16;
constexpr int F_AP = F_KC + 4;

inline size_t f32_smem_bytes(int inter) {
  return sizeof(float) * ((size_t)F_BM * (inter + 4) + 2 * F_BM * F_AP +
                          4 * F_KC * NC) +
         (size_t)F_BM * (sizeof(long long) + sizeof(float) + sizeof(int));
}

template <int MODE>
__device__ void ffn_f32_body(const FfnParams& p) {
  constexpr int BM = F_BM, KC = F_KC, AP = F_AP;
  const int tile = blockIdx.x;
  if (skip_pad_tile<float, MODE, BM>(p, tile)) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HP = p.inter + 4;
  float* hid_s = reinterpret_cast<float*>(smem_raw);  // [BM][HP]
  float* a_s = hid_s + BM * HP;                       // 2 x [BM][AP]
  float* w_s = a_s + 2 * BM * AP;                     // 2 x 2 x [KC][NC]
  long long* row_off = reinterpret_cast<long long*>(w_s + 4 * KC * NC);
  float* row_prob = reinterpret_cast<float*>(row_off + BM);
  int* row_tok = reinterpret_cast<int*>(row_prob + BM);

  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int cg = tid & 7;
  const int e = p.gid[tile];
  const float* xa = static_cast<const float*>(p.a);
  const long long w_off = (long long)e * p.h * p.inter;
  const float* wg = static_cast<const float*>(p.wg) + w_off;
  const float* wu = static_cast<const float*>(p.wu) + w_off;
  const float* wd = static_cast<const float*>(p.wd) + w_off;
  setup_rows<MODE, BM>(p, tile, row_off, row_prob, row_tok);
  __syncthreads();

  const int nk1 = p.h / KC;
  for (int c = 0; c < p.inter / NC; ++c) {
    float g[8], u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) g[j] = u[j] = 0.f;

    auto load = [&](int kk, int st) {
      if (tid < BM * 4) {  // A slice: 32 rows x 4 pieces
        const int rr = tid >> 2;
        const int pc = (tid & 3) * 4;
        const long long off = row_off[rr];
        const bool ok = off >= 0;
        cp_async_16(a_s + st * BM * AP + rr * AP + pc,
                    xa + (ok ? off + kk * KC + pc : 0), ok);
      }
      {  // Wg and Wu slices: 16 rows x 16 pieces each
        const int rr = tid >> 4;
        const int pc = (tid & 15) * 4;
        const long long off = (long long)(kk * KC + rr) * p.inter + c * NC + pc;
        float* dst = w_s + st * 2 * KC * NC + rr * NC + pc;
        cp_async_16(dst, wg + off, true);
        cp_async_16(dst + KC * NC, wu + off, true);
      }
      cp_async_commit();
    };

    load(0, 0);
    for (int kk = 0; kk < nk1; ++kk) {
      const int st = kk & 1;
      if (kk + 1 < nk1) {
        load(kk + 1, st ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* as = a_s + st * BM * AP + r * AP;
      const float* gs = w_s + st * 2 * KC * NC + cg;
      const float* us = gs + KC * NC;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float a = as[k];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          g[j] = fmaf(a, gs[k * NC + 8 * j], g[j]);
          u[j] = fmaf(a, us[k * NC + 8 * j], u[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      hid_s[r * HP + c * NC + cg + 8 * j] = silu(g[j]) * u[j];
  }
  __syncthreads();

  const int nk2 = p.inter / KC;
  const float pr = row_prob[r];
  for (int c2 = 0; c2 < p.h / NC; ++c2) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;

    auto load = [&](int kk, int st) {
      const int rr = tid >> 4;
      const int pc = (tid & 15) * 4;
      cp_async_16(w_s + st * 2 * KC * NC + rr * NC + pc,
                  wd + (long long)(kk * KC + rr) * p.h + c2 * NC + pc, true);
      cp_async_commit();
    };

    load(0, 0);
    for (int kk = 0; kk < nk2; ++kk) {
      const int st = kk & 1;
      if (kk + 1 < nk2) {
        load(kk + 1, st ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* hs = hid_s + r * HP + kk * KC;
      const float* ds = w_s + st * 2 * KC * NC + cg;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float hv = hs[k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(hv, ds[k * NC + 8 * j], acc[j]);
      }
      __syncthreads();
    }
    const int col = c2 * NC + cg;
    if (MODE == COMBINE) {
      const int tok = row_tok[r];
      if (tok >= 0) {
        float* o = static_cast<float*>(p.out) + (long long)tok * p.h + col;
#pragma unroll
        for (int j = 0; j < 8; ++j) atomicAdd(o + 8 * j, acc[j] * pr);
      }
    } else {
      float* o = static_cast<float*>(p.out) + ((long long)tile * BM + r) * p.h + col;
#pragma unroll
      for (int j = 0; j < 8; ++j) o[8 * j] = acc[j] * pr;
    }
  }
}

// ---------------------------------------------------------------------------
// the three float32 kernels (every bfloat16 kernel is the sm_90 core's)

__global__ void __launch_bounds__(NT) ffn_aligned_f32(const FfnParams p) {
  ffn_f32_body<ALIGNED>(p);
}
__global__ void __launch_bounds__(NT) ffn_gather_f32(const FfnParams p) {
  ffn_f32_body<GATHER>(p);
}
__global__ void __launch_bounds__(NT) ffn_gather_combine_f32(const FfnParams p) {
  ffn_f32_body<COMBINE>(p);
}

bool in_domain(int dtype, int h, int inter) {
  if (dtype != 0 && dtype != 1) return false;
  if (h <= 0 || inter <= 0 || h % NC != 0 || inter % NC != 0) return false;
  return dtype == 1 || f32_smem_bytes(inter) <= (size_t)SMEM_LIMIT;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Rows per tile (block_m) of the layout
// the kernels take in this dtype (bf16: the sm_90 core's 128);
// cudaErrorInvalidValue for (h, inter) outside
// the domain.
extern "C" int d9d_moe_ffn_tiling(int dtype, int h, int inter, int* block_m) {
  if (!in_domain(dtype, h, inter)) return (int)cudaErrorInvalidValue;
  *block_m = dtype == 1 ? sm90::BM : F_BM;
  return 0;
}

// kernel: 0 = aligned (B5), 1 = gather (B6), 2 = gather + combine (B7).
// All tensors contiguous. a: aligned rows [n_tiles * block_m, h] (kernel 0)
// or x [N, h]; probs: fp32 [n_tiles * block_m] (kernel 0) or [N * K];
// gid: int32 [n_tiles]; pair_src: int32 [n_tiles * block_m]; wg, wu:
// [E, h, inter]; wd: [E, inter, h]; out: [n_tiles * block_m, h] in the
// inputs' dtype (kernels 0, 1) or a ZEROED fp32 [N, h] (kernel 2); hidden:
// bf16 [n_tiles * block_m, inter] scratch of every bf16 kernel (its two
// launches pass the hidden through it), null in fp32. Launches on `stream`
// (bf16: two launches, each checked), allocates nothing, never
// synchronizes.
extern "C" int d9d_moe_ffn(const void* a, const void* probs, const void* gid,
                           const void* pair_src, const void* wg, const void* wu,
                           const void* wd, void* out, void* hidden, int kernel,
                           int n_tiles, int num_experts, int h, int inter,
                           int top_k, int dtype, void* stream) {
  if (!in_domain(dtype, h, inter) || n_tiles < 0 || top_k <= 0 ||
      num_experts <= 0 || kernel < 0 || kernel > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (hidden == nullptr) return (int)cudaErrorInvalidValue;
    return (int)sm90::ffn(static_cast<sm90::Mode>(kernel), a, static_cast<const float*>(probs),
                          static_cast<const int*>(gid),
                          static_cast<const int*>(pair_src), wg, wu, wd,
                          hidden, out, n_tiles, num_experts, h, inter, top_k,
                          st);
  }
  FfnParams p{};
  p.a = a;
  p.probs = static_cast<const float*>(probs);
  p.gid = static_cast<const int*>(gid);
  p.pair_src = static_cast<const int*>(pair_src);
  p.wg = wg;
  p.wu = wu;
  p.wd = wd;
  p.out = out;
  p.h = h;
  p.inter = inter;
  p.top_k = top_k;
  static void (*const f32_kernels[3])(const FfnParams) = {
      ffn_aligned_f32, ffn_gather_f32, ffn_gather_combine_f32};
  auto fn = f32_kernels[kernel];
  const size_t smem = f32_smem_bytes(inter);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<n_tiles, NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}
