// Online-softmax attention core shared by the flash-prefill and the
// flash-decode kernels (flash_fwd.cu, flash_decode.cu).
//
// One thread block attends a tile of RT query rows against a range of keys,
// BN keys at a time, and keeps the running maximum `m`, denominator `l` and
// output accumulator for its rows on chip from the first key tile to the
// last. That in-block loop replaces the sequential innermost grid dimension
// (and the VMEM scratch carried across it) of the Pallas kernels this code
// ports; blocks are independent, so they may run in any order.
//
// Query rows are addressed the way the decode kernel of the JAX package lays
// them out: for one (batch row, kv head) the g*T rows of the GQA group are
// r = ig*T + i (head-in-group ig, token i), so every query head of a group
// shares the key/value tiles a block has loaded. The prefill entry point
// uses the same addressing with start = 0.
//
// Masks (all optional but the bounds): key < kv_len, key <= q_pos (causal),
// key > q_pos - window, tag equality (segment ids for prefill, key validity
// for decode). q_pos is the row's token index plus a per-batch-row base
// (decode: the cache write index offsets[b]) plus `shift` (prefill at global
// offsets, the ring-attention block: q_offset - k_offset, of any sign; a
// block wholly in the causal future has an empty key range and visits no
// tile). Probabilities are gated by the mask itself, not only by the
// -1e30 sentinel, so a row that sees no key keeps l = 0 and comes out as
// exact zeros with lse = -1e30 + log(1e-30).
//
// Paged mode (template flag PAGED, the paged flash-decode kernel of
// flash_decode.cu): k/v are page POOLS [P, Hkv, page_size, D] and key j of
// batch row b is slot j % page_size of pool page page_table[b, j / page_size]
// — the page id is the only new indirection; masks, splits and the online
// softmax are unchanged. int8 pools (KV = int8_t) carry f32 per-slot scales
// [P, Hkv, page_size] and are dequantized as the tile is widened to fp32.
//
// Arithmetic is fp32 throughout (tiles are widened when they are loaded into
// shared memory); the products run on the CUDA cores. This core serves the
// float32 calls (exact fp32 products); bfloat16 decode continuation chunks
// take the tensor-core core in attn_mma.cuh, which shares AttnParams, the
// row addressing, the masks and the combine kernel below, and the other
// bfloat16 decode calls the cluster core in attn_decode_sm90.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace d9d {

constexpr float NEG_BIG = -1e30f;
constexpr float MASKED_BELOW = -5e29f;  // anything below is the sentinel
constexpr int ROW_INVALID = -2147483647;

struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;            // [B, Hq, T] fp32
  const int* offsets;    // [B] per-row write index (q_pos base); null = 0
  const int* q_tag;      // [B, T] row tags (segment ids); null = 1
  const int* k_tag;      // [B, S] key tags (segment ids / validity); null = off
  float* o_part;         // [B*Hkv, n_splits, rows, D] fp32, n_splits > 1
  float* lse_part;       // [B*Hkv, n_splits, rows] fp32, n_splits > 1
  int B, T, Hq, Hkv, S;  // S = number of addressable keys
  int g;                 // Hq / Hkv
  long long q_sb, q_st, q_sh;  // element strides: batch, token, head
  long long k_sb, k_sh, k_ss;  // element strides: batch, head, key
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_st, o_sh;
  float scale;
  int causal;
  int window;            // -1 = none
  int n_splits;          // key-range splits (grid z)
  int split_len;         // keys per split, multiple of BN
  // paged mode only: k_sb / v_sb are then the PAGE strides of the pools
  const int* page_table; // [B, row_pages] int32 pool page ids
  int page_size;         // slots per page
  int row_pages;         // page-table entries per batch row (S = row_pages * page_size)
  const float* k_scale;  // int8 pools: [P, Hkv, page_size] fp32 scales
  const float* v_scale;
  // flash prefill at global offsets (ring attention): query row t sits at
  // key position t + shift, shift = q_offset - k_offset; 0 everywhere else
  int shift;
};

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

// 16 bytes from global memory, widened to fp32
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// n (4 or 8) fp32 values to 16-byte aligned shared memory, 16 bytes a store
__device__ __forceinline__ void store_row(float* dst, const float* x, int n) {
#pragma unroll
  for (int i = 0; i < n; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}

// n (4 or 8) int8 values from global memory (4 or 8 bytes), widened to fp32
__device__ __forceinline__ void unpack_i8x4(unsigned w, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}
template <int N>
__device__ __forceinline__ void load_i8(const int8_t* p, float* out) {
  static_assert(N == 4 || N == 8, "int8 loads of 4 or 8 values");
  if constexpr (N == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    unpack_i8x4(x.x, out);
    unpack_i8x4(x.y, out + 4);
  } else {
    unpack_i8x4(*reinterpret_cast<const unsigned*>(p), out);
  }
}

// Paged mode: VEC features [c, c + VEC) of key `key` of batch row b, kv
// head hkv, gathered through the page table and widened to fp32 (int8
// pools: times their slot's scale, the reference kernel's dequant order).
template <typename KV, int VEC>
__device__ __forceinline__ void load_paged_kv(const AttnParams& p, int b,
                                              int hkv, int key, int c,
                                              float* kx, float* vx) {
  const int page = p.page_table[(long long)b * p.row_pages + key / p.page_size];
  const int slot = key % p.page_size;
  const KV* kp = static_cast<const KV*>(p.k) + (long long)page * p.k_sb +
                 (long long)hkv * p.k_sh + (long long)slot * p.k_ss + c;
  const KV* vp = static_cast<const KV*>(p.v) + (long long)page * p.v_sb +
                 (long long)hkv * p.v_sh + (long long)slot * p.v_ss + c;
  if constexpr (std::is_same<KV, int8_t>::value) {
    load_i8<VEC>(kp, kx);
    load_i8<VEC>(vp, vx);
    const long long si = ((long long)page * p.Hkv + hkv) * p.page_size + slot;
    const float ks = p.k_scale[si];
    const float vs = p.v_scale[si];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      kx[i] *= ks;
      vx[i] *= vs;
    }
  } else {
    load16(kp, kx);
    load16(vp, vx);
  }
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D, int RT, int BN>
constexpr size_t attn_smem_bytes() {
  // q[RT][D+4] k[BN][D+4] v[BN][D] s[RT][BN+4] m,l,alpha[RT] + int tags
  return sizeof(float) * (size_t)(RT * (D + 4) + BN * (D + 4) + BN * D +
                                  RT * (BN + 4) + 3 * RT) +
         sizeof(int) * (size_t)(2 * RT + BN);
}

// grid: x = row tile, y = b * Hkv + kv head, z = key split. T is the type
// of q and o; KV that of the paged pools (T, or int8_t) and is T unless
// PAGED.
template <typename T, int D, int RT, int BN, int NT, bool PAGED = false,
          typename KV = T>
__global__ void __launch_bounds__(NT) attn_tile_kernel(const AttnParams p) {
  constexpr int DP = D + 4;   // padded rows: float4 reads, no bank conflicts
  constexpr int SP = BN + 4;
  constexpr int VEC = Vec<T>::N;
  constexpr int NRG = NT / BN;       // row groups in the score phase
  constexpr int RPT = RT / NRG;      // rows per thread in the score phase
  constexpr int NCG = NT / D;        // row groups in the PV phase
  constexpr int RPO = RT / NCG;      // rows per thread in the PV phase
  constexpr int NW = NT / 32;
  static_assert(NT % BN == 0 && RT % NRG == 0, "score phase tiling");
  static_assert(NT % D == 0 && RT % NCG == 0, "PV phase tiling");
  static_assert(BN % 32 == 0 && D % VEC == 0 && BN % 4 == 0, "tile widths");
  static_assert(PAGED || std::is_same<KV, T>::value, "int8 k/v are paged only");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + RT * DP;
  float* v_s = k_s + BN * DP;
  float* s_s = v_s + BN * D;
  float* m_s = s_s + RT * SP;
  float* l_s = m_s + RT;
  float* a_s = l_s + RT;
  int* rpos_s = reinterpret_cast<int*>(a_s + RT);
  int* rtag_s = rpos_s + RT;
  int* ktag_s = rtag_s + RT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y / p.Hkv;
  const int hkv = blockIdx.y % p.Hkv;
  const int split = blockIdx.z;
  const int rows = p.g * p.T;
  const int r0 = blockIdx.x * RT;
  const int r_last = min(r0 + RT, rows) - 1;
  const int base = (p.offsets ? p.offsets[b] : 0) + p.shift;

  const T* qg = static_cast<const T*>(p.q);
  // contiguous mode: this (batch row, kv head)'s cache slice
  const T* kg = static_cast<const T*>(p.k) +
                (PAGED ? 0 : (long long)b * p.k_sb + (long long)hkv * p.k_sh);
  const T* vg = static_cast<const T*>(p.v) +
                (PAGED ? 0 : (long long)b * p.v_sb + (long long)hkv * p.v_sh);

  // ---- per-row state ----------------------------------------------------
  if (tid < RT) {
    const int r = r0 + tid;
    const bool ok = r < rows;
    const int t = ok ? r % p.T : 0;
    rpos_s[tid] = ok ? base + t : ROW_INVALID;
    rtag_s[tid] = (ok && p.q_tag) ? p.q_tag[(long long)b * p.T + t] : 1;
    m_s[tid] = NEG_BIG;
    l_s[tid] = 0.f;
    a_s[tid] = 1.f;
  }
  // ---- q tile -> shared (fp32) ------------------------------------------
  for (int idx = tid; idx < RT * (D / VEC); idx += NT) {
    const int rr = idx / (D / VEC);
    const int c = (idx % (D / VEC)) * VEC;
    const int r = r0 + rr;
    float x[VEC];
    if (r < rows) {
      const int t = r % p.T;
      const int hq = hkv * p.g + r / p.T;
      load16(qg + (long long)b * p.q_sb + (long long)t * p.q_st +
                 (long long)hq * p.q_sh + c, x);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[i] = 0.f;
    }
    store_row(&q_s[rr * DP + c], x, VEC);
  }

  // ---- key range of this block ------------------------------------------
  // rows of the tile cover tokens [t_lo, t_hi] (all tokens when the tile
  // spans more than one head of the group)
  int t_lo = 0, t_hi = p.T - 1;
  if (r0 / p.T == r_last / p.T) {
    t_lo = r0 % p.T;
    t_hi = r_last % p.T;
  }
  int k_begin = 0, k_end = p.S;
  if (p.causal) k_end = min(k_end, base + t_hi + 1);
  if (p.window >= 0) k_begin = max(k_begin, base + t_lo - p.window + 1);
  const int split_lo = split * p.split_len;
  const int split_hi = split_lo + p.split_len;
  k_begin = max(k_begin, split_lo);
  k_end = min(k_end, split_hi);
  const int j_first = (k_begin / BN) * BN;

  float o_acc[RPO];
#pragma unroll
  for (int i = 0; i < RPO; ++i) o_acc[i] = 0.f;

  const int od = tid % D;   // PV phase: this thread's output column
  const int ocg = tid / D;  // and its row group

  for (int j0 = j_first; j0 < k_end; j0 += BN) {
    __syncthreads();  // previous tile fully consumed (and q/row state ready)
    // ---- k, v tiles -> shared (fp32); rows past the end are zeros -------
    for (int idx = tid; idx < BN * (D / VEC); idx += NT) {
      const int jj = idx / (D / VEC);
      const int c = (idx % (D / VEC)) * VEC;
      const int key = j0 + jj;
      float kx[VEC], vx[VEC];
      if (key < p.S) {
        if constexpr (PAGED) {
          load_paged_kv<KV, VEC>(p, b, hkv, key, c, kx, vx);
        } else {
          load16(kg + (long long)key * p.k_ss + c, kx);
          load16(vg + (long long)key * p.v_ss + c, vx);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) { kx[i] = 0.f; vx[i] = 0.f; }
      }
      store_row(&k_s[jj * DP + c], kx, VEC);
      store_row(&v_s[jj * D + c], vx, VEC);
    }
    if (tid < BN) {
      const int key = j0 + tid;
      ktag_s[tid] = (p.k_tag && key < p.S)
                        ? p.k_tag[(long long)b * p.S + key] : 1;
    }
    __syncthreads();

    // ---- scores: s = (q . k) * scale, masked -----------------------------
    {
      const int jj = tid % BN;
      const int rg = tid / BN;
      float acc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[jj * DP + d]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float4 q4 = *reinterpret_cast<const float4*>(
              &q_s[(rg + i * NRG) * DP + d]);
          acc[i] = fmaf(q4.x, k4.x, acc[i]);
          acc[i] = fmaf(q4.y, k4.y, acc[i]);
          acc[i] = fmaf(q4.z, k4.z, acc[i]);
          acc[i] = fmaf(q4.w, k4.w, acc[i]);
        }
      }
      const int key = j0 + jj;
      const int ktag = ktag_s[jj];
      const bool key_ok = key >= k_begin && key < k_end;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int rr = rg + i * NRG;
        const int qp = rpos_s[rr];
        bool ok = key_ok && qp != ROW_INVALID;
        if (p.causal) ok = ok && key <= qp;
        if (p.window >= 0) ok = ok && key > qp - p.window;
        if (p.k_tag) ok = ok && rtag_s[rr] == ktag;
        s_s[rr * SP + jj] = ok ? acc[i] * p.scale : NEG_BIG;
      }
    }
    __syncthreads();

    // ---- online softmax: one warp per row --------------------------------
    for (int rr = warp; rr < RT; rr += NW) {
      float mx = NEG_BIG;
#pragma unroll
      for (int jj = lane; jj < BN; jj += 32) mx = fmaxf(mx, s_s[rr * SP + jj]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[rr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = lane; jj < BN; jj += 32) {
        const float s = s_s[rr * SP + jj];
        // gate by the mask, not only by the sentinel: a row that has seen
        // no key keeps m = NEG_BIG, where exp(s - m) would be 1
        const float pv = (s > MASKED_BELOW) ? expf(s - m_new) : 0.f;
        s_s[rr * SP + jj] = pv;
        sum += pv;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[rr] = m_new;
        l_s[rr] = alpha * l_s[rr] + sum;
        a_s[rr] = alpha;
      }
    }
    __syncthreads();

    // ---- o = o * alpha + p . v -------------------------------------------
#pragma unroll
    for (int i = 0; i < RPO; ++i) o_acc[i] *= a_s[ocg + i * NCG];
#pragma unroll 2
    for (int jj = 0; jj < BN; jj += 4) {
      const float v0 = v_s[(jj + 0) * D + od];
      const float v1 = v_s[(jj + 1) * D + od];
      const float v2 = v_s[(jj + 2) * D + od];
      const float v3 = v_s[(jj + 3) * D + od];
#pragma unroll
      for (int i = 0; i < RPO; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(
            &s_s[(ocg + i * NCG) * SP + jj]);
        o_acc[i] = fmaf(p4.x, v0, o_acc[i]);
        o_acc[i] = fmaf(p4.y, v1, o_acc[i]);
        o_acc[i] = fmaf(p4.z, v2, o_acc[i]);
        o_acc[i] = fmaf(p4.w, v3, o_acc[i]);
      }
    }
  }
  __syncthreads();  // row state visible even when the key loop ran 0 times

  // ---- epilogue -----------------------------------------------------------
  const long long bs = blockIdx.y;  // b * Hkv + hkv
#pragma unroll
  for (int i = 0; i < RPO; ++i) {
    const int rr = ocg + i * NCG;
    const int r = r0 + rr;
    if (r >= rows) continue;
    const float val = o_acc[i] / fmaxf(l_s[rr], 1e-30f);
    if (p.n_splits == 1) {
      const int t = r % p.T;
      const int hq = hkv * p.g + r / p.T;
      T* og = static_cast<T*>(p.o) + (long long)b * p.o_sb +
              (long long)t * p.o_st + (long long)hq * p.o_sh + od;
      store_out(og, val);
    } else {
      p.o_part[((bs * p.n_splits + split) * rows + r) * D + od] = val;
    }
  }
  if (tid < RT) {
    const int r = r0 + tid;
    if (r < rows) {
      const float lse = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
      if (p.n_splits == 1) {
        p.lse[bs * rows + r] = lse;  // [B, Hkv, g*T] == [B, Hq, T]
      } else {
        p.lse_part[(bs * p.n_splits + split) * rows + r] = lse;
      }
    }
  }
}

// Merge the per-split partial results (o_i normalized, lse_i) of one query
// row: o = sum_i w_i o_i / sum_i w_i with w_i = exp(lse_i - max lse), the
// logsumexp combine. Splits that saw no key (lse_i at the sentinel) are
// skipped; a row with no live split yields zeros.
// grid: x = row, y = b * Hkv + kv head; D threads
template <typename T, int D>
__global__ void __launch_bounds__(D) attn_combine_kernel(const AttnParams p) {
  const int rows = p.g * p.T;
  const int r = blockIdx.x;
  const long long bs = blockIdx.y;
  const int b = blockIdx.y / p.Hkv;
  const int hkv = blockIdx.y % p.Hkv;
  const int d = threadIdx.x;

  float mx = NEG_BIG;
  for (int i = 0; i < p.n_splits; ++i)
    mx = fmaxf(mx, p.lse_part[(bs * p.n_splits + i) * rows + r]);
  float acc = 0.f, wsum = 0.f;
  if (mx > MASKED_BELOW) {
    for (int i = 0; i < p.n_splits; ++i) {
      const float li = p.lse_part[(bs * p.n_splits + i) * rows + r];
      if (li > MASKED_BELOW) {
        const float w = expf(li - mx);
        acc = fmaf(w, p.o_part[((bs * p.n_splits + i) * rows + r) * D + d], acc);
        wsum += w;
      }
    }
  }
  const int t = r % p.T;
  const int hq = hkv * p.g + r / p.T;
  T* og = static_cast<T*>(p.o) + (long long)b * p.o_sb + (long long)t * p.o_st +
          (long long)hq * p.o_sh + d;
  store_out(og, wsum > 0.f ? acc / wsum : 0.f);
  if (d == 0) {
    // a dead row keeps the single-pass value: -1e30 + log(1e-30)
    p.lse[bs * rows + r] =
        wsum > 0.f ? mx + logf(wsum) : NEG_BIG + logf(1e-30f);
  }
}

template <typename T, int D, int RT, int BN, int NT, bool PAGED = false,
          typename KV = T>
inline cudaError_t launch_attn(const AttnParams& p, cudaStream_t stream) {
  constexpr size_t smem = attn_smem_bytes<D, RT, BN>();
  auto kernel = attn_tile_kernel<T, D, RT, BN, NT, PAGED, KV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = p.g * p.T;
  const dim3 grid((rows + RT - 1) / RT, p.B * p.Hkv, p.n_splits);
  kernel<<<grid, NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.n_splits > 1) {
    const dim3 cgrid(rows, p.B * p.Hkv, 1);
    attn_combine_kernel<T, D><<<cgrid, D, 0, stream>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace d9d
