// Tensor-core kernels 0 (dq) and 1 (dk/dv) of the flash backward for
// bfloat16 inputs, hand-written for sm_90a. Included by flash_bwd.cu after
// BwdParams, visible() and the tile constants, which they share with the
// CUDA-core kernels there.
//
// Replace, for bf16, d9d_tpu/ops/attention/pallas_flash.py
// `_bwd_dq_kernel` (the `pallas_call` at :583) and `_bwd_dkv_kernel` (:602),
// also in their `has_positions` mode (the by-value `shift`, B4). Same
// function, same visited tiles, same ungated p (ROADMAP C3) as the CUDA-core
// kernels of flash_bwd.cu; float32 inputs and the fused kernel stay there.
//
// Bound on this card: operations — the split kernels do 7 [rows x keys x D]
// products per visited tile over a few megabytes of inputs, so the least
// time is flops over the bf16 tensor-core rate. What the design does about it:
//
// - every product is `mma.sync.m16n8k16` (bf16 in, fp32 accumulate) on bf16
//   tiles in shared memory, rows padded by 16 bytes so that each `ldmatrix`
//   is free of bank conflicts (the layout of attn_mma.cuh);
// - 4 warps own the block's 64 rows of the M dimension, 16 each; a warp's
//   [16, 64] score tile, formed in two halves of 32 columns, stays in its
//   accumulator fragments: masking, p and ds are computed there, and p and
//   ds are repacked to bf16 as the A operand of the next product straight
//   from registers (FlashAttention-2's scheme); rounding p and ds to bf16 is
//   the one change of arithmetic against the CUDA-core kernels (chip_smoke.py
//   derives the bf16 rule from it);
// - a tile that every row of the block sees whole (no causal, window,
//   segment or length edge crosses it) skips the mask;
// - the streamed tiles are double-buffered: `cp.async` fills the other stage
//   while the warps work on this one;
// - tiles are ~17 KB each at D = 128 and a block needs ~104 KB, so two blocks
//   share an SM where the fp32-widened tiles allowed one.
//
// dq (kernel 0): query rows are M. Block = (batch row, kv head, 64 rows
// r = ig*T + i of the GQA group), q and do resident (and held as A
// fragments in registers), key tiles of 64 streamed: s = q.k^T and
// dp = do.v^T (k and v as non-transposed B fragments), ds in registers,
// dq += ds.k (k by `ldmatrix.trans`).
//
// dk/dv (kernel 1): keys are M. Block = (batch row, kv head, 64 keys), k and
// v resident, the query tiles of the group's g heads streamed with their
// lse, delta, position and tag rows: s^T = k.q^T, p^T = exp(s^T - lse),
// dp^T = v.do^T, ds^T = p^T (dp^T - delta) scale; dv += p^T.do and
// dk += ds^T.q (do and q by `ldmatrix.trans`); dk and dv stay in fp32
// registers until the one store.
//
// `wgmma`, TMA and warp specialisation are left to later work.
#pragma once

#include "attn_mma.cuh"

namespace d9d {
namespace {

constexpr int BWD_MMA_BM = 64;   // M rows per block (query rows or keys)
constexpr int BWD_MMA_BN = 64;   // streamed rows per tile (keys or query rows)
constexpr int BWD_MMA_NT = 128;  // 4 warps, 16 M rows each
static_assert(BWD_MMA_BM == BWD_RQ && BWD_MMA_BN == BWD_BK,
              "the tensor-core kernels visit the CUDA-core kernels' tiles");
constexpr float LOG2E = 1.4426950408889634f;
// The score fragments of a 64-wide tile are formed in two halves of 32
// columns: 32 fewer live accumulator registers leave room to prefetch the
// operand fragments (with whole tiles the dk/dv kernel ran out of registers
// and spilled at D = 128, and both kernels ran slower on the card).
constexpr int BWD_MMA_HN = BWD_MMA_BN / 2;

template <int D>
constexpr size_t bwd_mma_smem_bytes() {
  // two resident tiles, two stages of two streamed tiles (bf16, rows of
  // D + 8); per stage dq keeps one key tag per key, dk/dv four words (pos,
  // tag, lse, delta) per query row
  return sizeof(__nv_bfloat16) * (size_t)((2 * BWD_MMA_BM + 4 * BWD_MMA_BN) *
                                          (D + 8)) +
         sizeof(int) * (size_t)(2 * 4 * BWD_MMA_BN);
}

// ldmatrix x4 lane offsets (elements) into a tile with rows of DP elements.
// MK: the A fragments of a row-major [m][k] tile, and equally the transposed
// B fragments (ldmatrix.trans) of a row-major [k][n] tile: lanes 0-7 / 8-15
// address rows 0-7 / 8-15 of columns 0-7, lanes 16-31 the same rows of
// columns 8-15. NK: the B fragments of a row-major [n][k] tile, two n-tiles
// at once: rows 0-7 of columns 0-7 / 8-15, then rows 8-15 of the same.
__device__ __forceinline__ int frag_off_mk(int lane, int dp) {
  return (((lane >> 3) & 1) * 8 + (lane & 7)) * dp + (lane >> 4) * 8;
}
__device__ __forceinline__ int frag_off_nk(int lane, int dp) {
  return ((lane >> 4) * 8 + (lane & 7)) * dp + ((lane >> 3) & 1) * 8;
}

// 64 rows of a [B, T, H, D]-addressed bf16 tensor into shared memory by
// cp.async (not committed here), rows padded to D + 8. Row rr of the tile
// (r = r0 + rr) is token r % T_len of head h0 + r / T_len; rows at or past
// n_rows are zero-filled (never NaN times 0).
template <int D>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* dst,
                                        const __nv_bfloat16* base,
                                        long long st, long long sh, int h0,
                                        int T_len, int r0, int n_rows) {
  constexpr int DP = D + 8, CH = D / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += BWD_MMA_NT) {
    const int rr = idx / CH;
    const int c = (idx % CH) * 8;
    const int r = r0 + rr;
    const bool valid = r < n_rows;
    const int t = valid ? r % T_len : 0;
    const int h = valid ? h0 + r / T_len : h0;
    cp_async_16(&dst[rr * DP + c], base + (long long)t * st + (long long)h * sh + c,
                valid);
  }
}

// acc[NT][4] (+)= A . B over one 16-deep slice: A from a row-major [m][k]
// tile, B from a row-major [n][k] tile (n-tiles of 8 rows), both ldmatrix
template <int NT>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         const __nv_bfloat16* b_frag, int dp) {
#pragma unroll
  for (int nt = 0; nt < NT; nt += 2) {
    uint32_t b0, b1, b2, b3;
    ldmatrix_x4(b0, b1, b2, b3, b_frag + nt * 8 * dp);
    mma_bf16_16816(acc[nt], a0, a1, a2, a3, b0, b1);
    mma_bf16_16816(acc[nt + 1], a0, a1, a2, a3, b2, b3);
  }
}

// acc[ND][4] += X . B where X is a warp's [16, NX*8] fp32 fragment tile x
// (rounded to bf16 here, as the A operand) and B a row-major [NX*8][ND*8]
// tile read by ldmatrix.trans (bt_frag = tile + frag_off_mk)
template <int ND, int NX>
__device__ __forceinline__ void mma_regs_by_trans(float (&acc)[ND][4],
                                                  const float (&x)[NX][4],
                                                  const __nv_bfloat16* bt_frag,
                                                  int dp) {
#pragma unroll
  for (int kk = 0; kk < NX / 2; ++kk) {
    const uint32_t a0 = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    const uint32_t a1 = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    const uint32_t a2 = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const __nv_bfloat16* bp = bt_frag + kk * 16 * dp;
#pragma unroll
    for (int dt = 0; dt < ND; dt += 2) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3, bp + dt * 8);
      mma_bf16_16816(acc[dt], a0, a1, a2, a3, b0, b1);
      mma_bf16_16816(acc[dt + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// grid: x = tile of 64 query rows of the GQA group, y = b * Hkv + kv head
template <int D>
__global__ void __launch_bounds__(BWD_MMA_NT, 2)
    bwd_dq_mma_kernel(const BwdParams p) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = BWD_MMA_BM, BN = BWD_MMA_BN;
  constexpr int DP = D + 8;
  constexpr int HN = BWD_MMA_HN;  // keys per half tile
  constexpr int NKT = HN / 8;     // key n-tiles of a half tile's scores
  constexpr int NDT = D / 8;   // dq n-tiles

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + BM * DP;
  bf16* kv_s = do_s + BM * DP;  // stage st: k at 2*st*BN*DP, v one tile later
  int* ktag_all = reinterpret_cast<int*>(kv_s + 4 * BN * DP);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // row within the 8-row half of a fragment
  const int tig = lane & 3;   // column pair within a fragment
  const int b = blockIdx.y / p.Hkv;
  const int hkv = blockIdx.y % p.Hkv;
  const long long bs = blockIdx.y;
  const int rows = p.g * p.T;
  const int r0 = blockIdx.x * BM;
  const int r_last = min(r0 + BM, rows) - 1;

  const bf16* qb = static_cast<const bf16*>(p.q) + (long long)b * p.q_sb;
  const bf16* ob = static_cast<const bf16*>(p.dout) + (long long)b * p.o_sb;
  const bf16* kb = static_cast<const bf16*>(p.k) + (long long)b * p.k_sb;
  const bf16* vb = static_cast<const bf16*>(p.v) + (long long)b * p.v_sb;

  // the two rows this thread holds fragments of; a row past the end gets
  // lse 0: with s = -1e30 its p is exactly 0
  int qpos[2], qtag[2];
  float lse[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + gid + 8 * h;
    const bool ok = r < rows;
    const int t = ok ? r % p.T : 0;
    qpos[h] = ok ? t + p.shift : ROW_INVALID;
    qtag[h] = (ok && p.q_tag) ? p.q_tag[(long long)b * p.T + t] : 1;
    lse[h] = ok ? p.lse[bs * rows + r] : 0.f;
    dl[h] = ok ? p.delta[bs * rows + r] : 0.f;
  }

  // keys the tile's rows can see (all keys when it spans two heads), as in
  // bwd_dq_kernel; an empty range visits no tile and dq is written as zeros
  int t_lo = 0, t_hi = p.T - 1;
  if (r0 / p.T == r_last / p.T) {
    t_lo = r0 % p.T;
    t_hi = r_last % p.T;
  }
  int k_begin = 0, k_end = p.T;
  if (p.causal) k_end = min(k_end, t_hi + p.shift + 1);
  if (p.window >= 0) k_begin = max(k_begin, t_lo + p.shift - p.window + 1);
  const int j_first = k_begin < k_end ? (k_begin / BN) * BN : k_end;
  // a key tile every row of this tile sees whole needs no mask: one head,
  // no row or key past the end, no segments, inside the causal and window
  // bounds of every row
  const bool one_head = r0 / p.T == r_last / p.T && r0 + BM <= rows;
  auto interior = [&](int j0) {
    return one_head && j0 + BN <= p.T && !p.q_tag &&
           (!p.causal || t_lo + p.shift >= j0 + BN - 1) &&
           (p.window < 0 || t_hi + p.shift - p.window < j0);
  };

  auto load_kv = [&](int j0, int st) {
    bf16* k_dst = kv_s + 2 * st * BN * DP;
    cp_rows<D>(k_dst, kb, p.k_st, p.k_sh, hkv, p.T, j0, p.T);
    cp_rows<D>(k_dst + BN * DP, vb, p.v_st, p.v_sh, hkv, p.T, j0, p.T);
    if (tid < BN) {
      const int key = j0 + tid;
      ktag_all[st * BN + tid] =
          (p.k_tag && key < p.T) ? p.k_tag[(long long)b * p.T + key] : 1;
    }
    cp_async_commit();
  };

  if (j_first < k_end) {
    cp_rows<D>(q_s, qb, p.q_st, p.q_sh, hkv * p.g, p.T, r0, rows);
    cp_rows<D>(do_s, ob, p.o_st, p.o_sh, hkv * p.g, p.T, r0, rows);
    load_kv(j_first, 0);  // one group: q, do and the first key tile
  }

  float dq[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;

  const int a_off = frag_off_mk(lane, DP);
  const int b_off = frag_off_nk(lane, DP);
  const bf16* q_frag = q_s + warp * 16 * DP + a_off;
  const bf16* do_frag = do_s + warp * 16 * DP + a_off;

  // q and do stay in registers as A fragments from the first tile on
  uint32_t qa[D / 16][4], oa[D / 16][4];
  int stage = 0;
  for (int j0 = j_first; j0 < k_end; j0 += BN, stage ^= 1) {
    // the other stage was last read one iteration ago, before that
    // iteration's closing barrier: free to refill while this tile is used
    if (j0 + BN < k_end) {
      load_kv(j0 + BN, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* k_s = kv_s + 2 * stage * BN * DP;
    const bf16* v_s = k_s + BN * DP;
    const int* ktag_s = ktag_all + stage * BN;

    const bool whole = interior(j0);
    if (j0 == j_first) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldmatrix_x4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                    q_frag + kk * 16);
        ldmatrix_x4(oa[kk][0], oa[kk][1], oa[kk][2], oa[kk][3],
                    do_frag + kk * 16);
      }
    }

#pragma unroll 1
    for (int hn = 0; hn < BN; hn += HN) {
      // ---- s = q.k^T, dp = do.v^T on the tensor cores ----------------------
      float s[NKT][4], dp[NKT][4];
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) { s[nt][e] = 0.f; dp[nt][e] = 0.f; }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_rows(s, qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                 k_s + hn * DP + b_off + kk * 16, DP);
        mma_rows(dp, oa[kk][0], oa[kk][1], oa[kk][2], oa[kk][3],
                 v_s + hn * DP + b_off + kk * 16, DP);
      }

      // ---- ds = exp(s - lse) * (dp - delta) * scale, p ungated (C3) ---------
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int jj = hn + nt * 8 + tig * 2 + e2;
          const int key = j0 + jj;
          const int ktag = ktag_s[jj];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + e2;
            const bool ok =
                whole || visible(p, key, qpos[h], qtag[h], ktag);
            const float x = ok ? s[nt][e] * p.scale : NEG_BIG;
            const float pr = exp2f((x - lse[h]) * LOG2E);
            s[nt][e] = pr * (dp[nt][e] - dl[h]) * p.scale;
          }
        }
      }

      // ---- dq += ds . k, ds as bf16 A fragments from registers -------------
      mma_regs_by_trans(dq, s, k_s + hn * DP + a_off, DP);
    }
    __syncthreads();  // every warp is done with this stage
  }

  bf16* dqg = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + gid + 8 * h;
    if (r >= rows) continue;
    const int t = r % p.T;
    const int hq = hkv * p.g + r / p.T;
    bf16* out = dqg + (((long long)b * p.T + t) * p.Hq + hq) * D + tig * 2;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(out + dt * 8) =
          __floats2bfloat162_rn(dq[dt][2 * h], dq[dt][2 * h + 1]);
  }
}

// grid: x = tile of 64 keys, y = b * Hkv + kv head
template <int D>
__global__ void __launch_bounds__(BWD_MMA_NT, 2)
    bwd_dkv_mma_kernel(const BwdParams p) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = BWD_MMA_BM, BN = BWD_MMA_BN;
  constexpr int DP = D + 8;
  constexpr int HN = BWD_MMA_HN;  // query rows per half tile
  constexpr int NQT = HN / 8;     // query n-tiles of a half tile's scores
  constexpr int NDT = D / 8;   // dk, dv n-tiles

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + BM * DP;
  bf16* qdo_s = v_s + BM * DP;  // stage st: q at 2*st*BN*DP, do one tile later
  float* lse_all = reinterpret_cast<float*>(qdo_s + 4 * BN * DP);  // [2][BN]
  float* dl_all = lse_all + 2 * BN;
  int* rpos_all = reinterpret_cast<int*>(dl_all + 2 * BN);
  int* rtag_all = rpos_all + 2 * BN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int b = blockIdx.y / p.Hkv;
  const int hkv = blockIdx.y % p.Hkv;
  const long long bs = blockIdx.y;
  const int rows = p.g * p.T;
  const int j0 = blockIdx.x * BM;
  const int j_last = min(j0 + BM, p.T) - 1;

  const bf16* qb = static_cast<const bf16*>(p.q) + (long long)b * p.q_sb;
  const bf16* ob = static_cast<const bf16*>(p.dout) + (long long)b * p.o_sb;
  const bf16* kb = static_cast<const bf16*>(p.k) + (long long)b * p.k_sb;
  const bf16* vb = static_cast<const bf16*>(p.v) + (long long)b * p.v_sb;

  // the two keys this thread holds fragments of
  int key[2], ktag[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = j0 + warp * 16 + gid + 8 * h;
    ktag[h] = (p.k_tag && key[h] < p.T) ? p.k_tag[(long long)b * p.T + key[h]]
                                        : 1;
  }

  // query tokens that can see a key of this tile, as in bwd_dkv_kernel; an
  // empty range visits no query tile and dk, dv are written as zeros
  const int i_begin = p.causal ? min(max(j0 - p.shift, 0), p.T) : 0;
  const int i_end =
      p.window >= 0 ? min(max(j_last + p.window - p.shift, 0), p.T) : p.T;
  const int i_first = i_begin < i_end ? (i_begin / BN) * BN : i_end;
  const int n_qt = (i_end - i_first + BN - 1) / BN;  // per query head
  const int n_tiles = p.g * n_qt;                     // over the GQA group

  // stage query tile n (head ig = n / n_qt of the group): q and do rows by
  // cp.async, the rows' position, tag, lse and delta by plain loads
  auto load_q = [&](int n, int st) {
    const int ig = n / n_qt;
    const int i0 = i_first + (n % n_qt) * BN;
    const int hq = hkv * p.g + ig;
    bf16* q_dst = qdo_s + 2 * st * BN * DP;
    cp_rows<D>(q_dst, qb, p.q_st, p.q_sh, hq, p.T, i0, p.T);
    cp_rows<D>(q_dst + BN * DP, ob, p.o_st, p.o_sh, hq, p.T, i0, p.T);
    if (tid < BN) {
      const int i = i0 + tid;
      const bool ok = i < p.T;
      rpos_all[st * BN + tid] = ok ? i + p.shift : ROW_INVALID;
      rtag_all[st * BN + tid] =
          (ok && p.q_tag) ? p.q_tag[(long long)b * p.T + i] : 1;
      lse_all[st * BN + tid] = ok ? p.lse[bs * rows + ig * p.T + i] : 0.f;
      dl_all[st * BN + tid] = ok ? p.delta[bs * rows + ig * p.T + i] : 0.f;
    }
    cp_async_commit();
  };

  if (n_tiles > 0) {
    cp_rows<D>(k_s, kb, p.k_st, p.k_sh, hkv, p.T, j0, p.T);
    cp_rows<D>(v_s, vb, p.v_st, p.v_sh, hkv, p.T, j0, p.T);
    load_q(0, 0);  // one group: k, v and the first query tile
  }

  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) { dk[dt][e] = 0.f; dv[dt][e] = 0.f; }

  const int a_off = frag_off_mk(lane, DP);
  const int b_off = frag_off_nk(lane, DP);
  const bf16* k_frag = k_s + warp * 16 * DP + a_off;
  const bf16* v_frag = v_s + warp * 16 * DP + a_off;

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n & 1;
    if (n + 1 < n_tiles) {
      load_q(n + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* q_t = qdo_s + 2 * st * BN * DP;
    const bf16* do_t = q_t + BN * DP;
    const float* lse_s = lse_all + st * BN;
    const float* dl_s = dl_all + st * BN;
    const int* rpos_s = rpos_all + st * BN;
    const int* rtag_s = rtag_all + st * BN;
    // a query tile that sees the key tile whole needs no mask: no row or
    // key past the end, no segments, inside the causal and window bounds
    const int i0 = i_first + (n % n_qt) * BN;
    const bool whole =
        i0 + BN <= p.T && j0 + BM <= p.T && !p.q_tag &&
        (!p.causal || i0 + p.shift >= j0 + BM - 1) &&
        (p.window < 0 || i0 + BN - 1 + p.shift - p.window < j0);

#pragma unroll 1
    for (int hn = 0; hn < BN; hn += HN) {
      // ---- s^T = k.q^T, dp^T = v.do^T on the tensor cores ------------------
      float s[NQT][4], dp[NQT][4];
#pragma unroll
      for (int nt = 0; nt < NQT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) { s[nt][e] = 0.f; dp[nt][e] = 0.f; }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a0, a1, a2, a3;
        ldmatrix_x4(a0, a1, a2, a3, k_frag + kk * 16);
        mma_rows(s, a0, a1, a2, a3, q_t + hn * DP + b_off + kk * 16, DP);
        ldmatrix_x4(a0, a1, a2, a3, v_frag + kk * 16);
        mma_rows(dp, a0, a1, a2, a3, do_t + hn * DP + b_off + kk * 16, DP);
      }

      // ---- p^T = exp(s^T - lse) ungated (C3), ds^T = p^T (dp^T - delta) scale
#pragma unroll
      for (int nt = 0; nt < NQT; ++nt) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int col = hn + nt * 8 + tig * 2 + e2;
          const int qpos = rpos_s[col];
          const int qtag = rtag_s[col];
          const float l = lse_s[col];
          const float d = dl_s[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + e2;
            const bool ok = whole || visible(p, key[h], qpos, qtag, ktag[h]);
            const float x = ok ? s[nt][e] * p.scale : NEG_BIG;
            const float pr = exp2f((x - l) * LOG2E);
            s[nt][e] = pr;
            dp[nt][e] = pr * (dp[nt][e] - d) * p.scale;
          }
        }
      }

      // ---- dv += p^T . do, dk += ds^T . q; p^T, ds^T as bf16 A fragments ---
      mma_regs_by_trans(dv, s, do_t + hn * DP + a_off, DP);
      mma_regs_by_trans(dk, dp, q_t + hn * DP + a_off, DP);
    }
    __syncthreads();  // every warp is done with this stage
  }

  bf16* dkg = static_cast<bf16*>(p.dk);
  bf16* dvg = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= p.T) continue;
    const long long off =
        (((long long)b * p.T + key[h]) * p.Hkv + hkv) * D + tig * 2;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + off + dt * 8) =
          __floats2bfloat162_rn(dk[dt][2 * h], dk[dt][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvg + off + dt * 8) =
          __floats2bfloat162_rn(dv[dt][2 * h], dv[dt][2 * h + 1]);
    }
  }
}

template <int D>
cudaError_t launch_bwd_mma(const BwdParams& p, int kernel,
                           cudaStream_t stream) {
  constexpr size_t smem = bwd_mma_smem_bytes<D>();
  auto fn = kernel == 0 ? bwd_dq_mma_kernel<D> : bwd_dkv_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory: two blocks fit
  err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int rows = kernel == 0 ? p.g * p.T : p.T;
  const dim3 grid((rows + BWD_MMA_BM - 1) / BWD_MMA_BM, p.B * p.Hkv);
  fn<<<grid, BWD_MMA_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace d9d
