// moe_ffn: the fused expert FFN of a MoE layer over the group-aligned tile
// layout, hand-written for sm_90a. Three kernels, one per TPU kernel of
// d9d_tpu/ops/moe_pallas.py:
//
//   ffn_aligned_f32, bf16 ffn_sm90_*_aligned (B5) replace `_ffn_kernel`
//       (through `_fused_ffn_call`): rows come from the aligned activation
//       buffer;
//   ffn_gather_* (B6) replaces `_ffn_gather_kernel` (`_fused_gather_call`):
//       each tile gathers its rows from x [N, h] by pair_src, so the
//       aligned buffer never exists;
//   ffn_gather_combine_f32, bf16 ffn_sm90_gate_up_gather +
//       ffn_sm90_down_combine (B7) replace `_ffn_gather_combine_kernel`
//       (`_fused_gather_combine_call`): the gather, plus the combine — each
//       row's prob-weighted output is added straight into its token's row
//       of out [N, h].
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
// The bfloat16 aligned and gather + combine kernels (B5, B7) run on the
// Hopper core of moe_ffn_sm90.cuh: wgmma fed by TMA, 128-row tiles, two
// launches a call with the hidden in device memory; bf16 takes block_m =
// 128. The bodies below run the bfloat16 gather kernel (B6) and every
// float32 kernel.
//
// Design of these bodies. The TPU kernel keeps a [block_m, h] row tile and
// one expert's three weight blocks resident in VMEM (3*h*i values, ~19 MB
// double-buffered at these widths); a Hopper block has 227 KB of shared
// memory. So a block owns one tile and runs two phases:
//   1. for each 64-wide chunk of i, stream A and the Wg/Wu chunk in k-slices
//      of h (cp.async, two stages), accumulate g and u, and write
//      silu(g) * u, rounded to the compute dtype, into a [block_m, i]
//      hidden tile that stays in shared memory (64 x 768 bf16 = 96 KB);
//   2. for each 64-wide chunk of h, stream the Wd chunk in k-slices of i,
//      multiply the hidden tile by it, scale by the row's prob and write
//      (or, for the combine kernel, atomicAdd into a zeroed fp32 [N, h]).
// No product is computed twice and the hidden never goes to device memory.
// bfloat16 multiplies on the tensor cores (mma.sync.m16n8k16, fragments by
// ldmatrix, helpers of attn_mma.cuh) over 64 rows — B6 runs two blocks on
// each 128-row tile of the bf16 layout, one per half; float32 multiplies
// in exact fp32 FMAs on the CUDA cores (the exactness path of the parity
// chain) with block_m = 32, so that its fp32 hidden tile fits.
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
// Domain: h and i multiples of 64, and the hidden tile plus two stages of
// operand slices within 227 KB (i <= 1536 in bf16, for B6). The sm_90
// core takes every such shape. d9d_moe_ffn_tiling reports block_m and
// refuses shapes outside the domain; the launcher refuses them too.
#include "attn_mma.cuh"
#include "moe_ffn_sm90.cuh"

using namespace d9d;

namespace {

constexpr int NT = 256;              // 8 warps
constexpr int NC = 64;               // output columns per chunk (both phases)
constexpr int SMEM_LIMIT = 232448;   // opt-in shared memory of one sm_90 block

constexpr int MODE_ALIGNED = 0;
constexpr int MODE_GATHER = 1;
constexpr int MODE_COMBINE = 2;

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
  int tile_shift;        // log2(layout tile / body tile): a block's expert
                         // is gid[blockIdx.x >> tile_shift]
};

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// row setup shared by both cores: source offset of each row of the tile in
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
    if (MODE == MODE_ALIGNED) {
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
  if (MODE != MODE_COMBINE) {
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
// bfloat16 core: tensor cores, block_m = 64
//
// warp w owns rows (w & 3) * 16 .. +16 and columns (w >> 2) * 32 .. +32 of
// each 64-wide output chunk: four m16n8 accumulator tiles per product.

constexpr int BF_BM = 64;
constexpr int BF_KC = 32;            // k-slice (of h in phase 1, of i in 2)
constexpr int BF_AP = BF_KC + 8;     // padded row of an A slice, in elements
constexpr int BF_WP = NC + 8;        // padded row of a weight slice

inline size_t bf16_smem_bytes(int inter) {
  return sizeof(__nv_bfloat16) *
             ((size_t)BF_BM * (inter + 8) + 2 * BF_BM * BF_AP +
              4 * BF_KC * BF_WP) +
         (size_t)BF_BM * (sizeof(long long) + sizeof(float) + sizeof(int));
}

template <int MODE>
__device__ void ffn_bf16_body(const FfnParams& p) {
  static_assert(MODE == MODE_GATHER,
                "bf16 B5 and B7 run on the sm_90 core (moe_ffn_sm90.cuh)");
  using bf16 = __nv_bfloat16;
  constexpr int BM = BF_BM, KC = BF_KC, AP = BF_AP, WP = BF_WP;
  const int tile = blockIdx.x;
  if (skip_pad_tile<bf16, MODE, BM>(p, tile)) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HP = p.inter + 8;                       // padded hidden row
  bf16* hid_s = reinterpret_cast<bf16*>(smem_raw);  // [BM][HP]
  bf16* a_s = hid_s + BM * HP;                      // 2 stages x [BM][AP]
  bf16* w_s = a_s + 2 * BM * AP;                    // 2 stages x 2 x [KC][WP]
  long long* row_off = reinterpret_cast<long long*>(w_s + 4 * KC * WP);
  float* row_prob = reinterpret_cast<float*>(row_off + BM);
  int* row_tok = reinterpret_cast<int*>(row_prob + BM);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rw = warp & 3;
  const int cw = warp >> 2;
  const int grp = lane >> 2;
  const int tig = lane & 3;

  const int e = p.gid[tile >> p.tile_shift];
  const bf16* xa = static_cast<const bf16*>(p.a);
  const long long w_off = (long long)e * p.h * p.inter;
  const bf16* wg = static_cast<const bf16*>(p.wg) + w_off;
  const bf16* wu = static_cast<const bf16*>(p.wu) + w_off;
  const bf16* wd = static_cast<const bf16*>(p.wd) + w_off;
  setup_rows<MODE, BM>(p, tile, row_off, row_prob, row_tok);
  __syncthreads();

  // ldmatrix lane addresses (see attn_mma.cuh): A fragments from row-major
  // [row][k], B fragments of two n-tiles from row-major [k][n] (transposed)
  const int a_frag = (rw * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * AP +
                     (lane >> 4) * 8;
  const int w_frag = (((lane >> 3) & 1) * 8 + (lane & 7)) * WP + cw * 32 +
                     (lane >> 4) * 8;
  const int h_frag = (rw * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * HP +
                     (lane >> 4) * 8;

  // ---- phase 1: hidden = silu(A Wg) * (A Wu), one 64-wide chunk of i at a time
  const int nk1 = p.h / KC;
  for (int c = 0; c < p.inter / NC; ++c) {
    float g[4][4], u[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) g[nt][q] = u[nt][q] = 0.f;

    auto load = [&](int kk, int st) {
      {  // A slice: 64 rows x 4 pieces of 16 bytes, one per thread
        const int r = tid >> 2;
        const int pc = (tid & 3) * 8;
        const long long off = row_off[r];
        const bool ok = off >= 0;
        cp_async_16(a_s + st * BM * AP + r * AP + pc,
                    xa + (ok ? off + kk * KC + pc : 0), ok);
      }
      {  // Wg and Wu slices: 32 rows x 8 pieces each
        const int r = tid >> 3;
        const int pc = (tid & 7) * 8;
        const long long off = (long long)(kk * KC + r) * p.inter + c * NC + pc;
        bf16* dst = w_s + st * 2 * KC * WP + r * WP + pc;
        cp_async_16(dst, wg + off, true);
        cp_async_16(dst + KC * WP, wu + off, true);
      }
      cp_async_commit();
    };

    load(0, 0);
    for (int kk = 0; kk < nk1; ++kk) {
      const int st = kk & 1;
      // the other stage was last read before the previous closing barrier
      if (kk + 1 < nk1) {
        load(kk + 1, st ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* as = a_s + st * BM * AP;
      const bf16* gs = w_s + st * 2 * KC * WP;
      const bf16* us = gs + KC * WP;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t a0, a1, a2, a3;
        ldmatrix_x4(a0, a1, a2, a3, as + a_frag + ks * 16);
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(b0, b1, b2, b3, gs + ks * 16 * WP + w_frag + nt * 8);
          mma_bf16_16816(g[nt], a0, a1, a2, a3, b0, b1);
          mma_bf16_16816(g[nt + 1], a0, a1, a2, a3, b2, b3);
          ldmatrix_x4_trans(b0, b1, b2, b3, us + ks * 16 * WP + w_frag + nt * 8);
          mma_bf16_16816(u[nt], a0, a1, a2, a3, b0, b1);
          mma_bf16_16816(u[nt + 1], a0, a1, a2, a3, b2, b3);
        }
      }
      __syncthreads();  // every warp is done with this stage
    }
    // the chunk's hidden, rounded to bf16 (the TPU kernel's .astype(a.dtype))
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = rw * 16 + grp + 8 * hh;
        const int col = c * NC + cw * 32 + nt * 8 + tig * 2;
        *reinterpret_cast<__nv_bfloat162*>(hid_s + row * HP + col) =
            __floats2bfloat162_rn(silu(g[nt][2 * hh]) * u[nt][2 * hh],
                                  silu(g[nt][2 * hh + 1]) * u[nt][2 * hh + 1]);
      }
  }
  __syncthreads();  // the whole hidden tile is written

  // ---- phase 2: y = hidden Wd * probs, one 64-wide chunk of h at a time ------
  const int nk2 = p.inter / KC;
  for (int c2 = 0; c2 < p.h / NC; ++c2) {
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;

    auto load = [&](int kk, int st) {
      const int r = tid >> 3;
      const int pc = (tid & 7) * 8;
      cp_async_16(w_s + st * 2 * KC * WP + r * WP + pc,
                  wd + (long long)(kk * KC + r) * p.h + c2 * NC + pc, true);
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
      const bf16* ds = w_s + st * 2 * KC * WP;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t a0, a1, a2, a3;
        ldmatrix_x4(a0, a1, a2, a3, hid_s + h_frag + kk * KC + ks * 16);
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(b0, b1, b2, b3, ds + ks * 16 * WP + w_frag + nt * 8);
          mma_bf16_16816(acc[nt], a0, a1, a2, a3, b0, b1);
          mma_bf16_16816(acc[nt + 1], a0, a1, a2, a3, b2, b3);
        }
      }
      __syncthreads();
    }
    // epilogue: scale by the row's prob and store
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rw * 16 + grp + 8 * hh;
      const float pr = row_prob[row];
      const int col = c2 * NC + cw * 32 + tig * 2;
      bf16* o = static_cast<bf16*>(p.out) +
                ((long long)tile * BM + row) * p.h + col;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) =
            __floats2bfloat162_rn(acc[nt][2 * hh] * pr,
                                  acc[nt][2 * hh + 1] * pr);
    }
  }
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
  const int e = p.gid[tile >> p.tile_shift];
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
    if (MODE == MODE_COMBINE) {
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
// the kernels on these bodies: the three in float32, B6 in bfloat16 (B5
// and B7 in bfloat16 are the sm_90 core's)

__global__ void __launch_bounds__(NT) ffn_gather_bf16(const FfnParams p) {
  ffn_bf16_body<MODE_GATHER>(p);
}
__global__ void __launch_bounds__(NT) ffn_aligned_f32(const FfnParams p) {
  ffn_f32_body<MODE_ALIGNED>(p);
}
__global__ void __launch_bounds__(NT) ffn_gather_f32(const FfnParams p) {
  ffn_f32_body<MODE_GATHER>(p);
}
__global__ void __launch_bounds__(NT) ffn_gather_combine_f32(const FfnParams p) {
  ffn_f32_body<MODE_COMBINE>(p);
}

bool in_domain(int dtype, int h, int inter) {
  if (dtype != 0 && dtype != 1) return false;
  if (h <= 0 || inter <= 0 || h % NC != 0 || inter % NC != 0) return false;
  const size_t smem = dtype == 1 ? bf16_smem_bytes(inter) : f32_smem_bytes(inter);
  return smem <= (size_t)SMEM_LIMIT;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Rows per tile (block_m) of the layout
// the kernels take in this dtype (bf16: the sm_90 core's 128; B6 runs its
// 64-row body on each half); cudaErrorInvalidValue for (h, inter) outside
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
// bf16 [n_tiles * block_m, inter] scratch of bf16 kernels 0 and 2 (their
// two launches pass the hidden through it), null otherwise. Launches on
// `stream` (bf16 kernels 0 and 2: two launches, each checked), allocates
// nothing, never synchronizes.
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
  if (dtype == 1 && kernel != 1) {
    if (hidden == nullptr) return (int)cudaErrorInvalidValue;
    return (int)sm90::ffn(kernel == 2, a, static_cast<const float*>(probs),
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
  // bf16 here is B6 alone: its 64-row body on each half of a 128-row tile
  auto fn = dtype == 1 ? ffn_gather_bf16 : f32_kernels[kernel];
  const size_t smem = dtype == 1 ? bf16_smem_bytes(inter) : f32_smem_bytes(inter);
  p.tile_shift = dtype == 1 ? 1 : 0;
  static_assert(sm90::BM == 2 * BF_BM, "B6 runs two 64-row bodies a tile");
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<n_tiles << p.tile_shift, NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}
