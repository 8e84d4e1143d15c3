// The bfloat16 flash-prefill forward, designed for the H100 (sm_90a).
// Included by flash_fwd.cu and used by its bf16 dispatch alone; attn_mma.cuh
// keeps serving flash-decode's continuation chunks (splits, per-row offsets,
// partial outputs), which prefill never uses.
//
// Replaces, for bf16, d9d_tpu/ops/attention/pallas_flash.py `_fwd_kernel`
// (the `pallas_call` at :437), also in its `has_positions` mode (B4, the
// ring-attention block: a by-value `shift` = q_offset - k_offset). Same
// function as attn_mma.cuh: GQA rows r = ig*T + i of one kv head, causal,
// window and segment masks, T not a multiple of the tile, D 64 and 128, a
// row that sees no key written as zeros with lse = -1e30 + log(1e-30)
// (ROADMAP C3), and p rounded to bf16 once before p.v.
//
// Bound on this card: operations (two [rows x keys x D] products per visited
// pair over a few megabytes of q, k, v). What the design does about it:
//
// - 64-key tiles, double-buffered by cp.async (tile n + 1 in flight while
//   tile n is used): one barrier pair and one wait per 64 keys;
// - 128-row blocks of 8 warps (16 rows each), so every key tile brought
//   into shared memory serves 128 rows; ~104 KB of shared memory and at
//   most 128 registers a thread let two blocks, 16 warps, share an SM (on
//   the card this beat three stages with q held in registers at one block
//   per SM: the second block hides more latency than the third stage and
//   the resident q fragments);
// - a tile that every row of the block sees whole (one head, no row or key
//   past the end, no segments, inside every row's causal and window
//   bounds) skips the mask and the gate of p;
// - logits are scaled by scale * log2(e) once, so the online softmax runs
//   on exp2f, and lse = m * ln(2) + log(l) at the end;
// - under causal masking the blocks' work grows with the rows' position:
//   when T is a multiple of the block's rows, block x takes the row tile of
//   head x % g at the (x / g)-th latest position, so the heaviest blocks
//   start first and the light ones fill the tail.
//
// mma.sync (m16n8k16, bf16 in, fp32 accumulate) rather than wgmma: a wgmma
// core (two warpgroups of 64 rows, tiles in the unswizzled core-matrix
// layout by cp.async) came out right on the card but slower than this one,
// padded or not, and also with the next tile's scores issued before the
// current softmax; wgmma pays off with TMA, warp specialisation and
// ping-pong between warpgroups, later work (ROADMAP "Measured gaps").
#pragma once

#include "attn_mma.cuh"

namespace d9d {

constexpr int FWD_BM = 128;    // query rows per block, 16 per warp
constexpr int FWD_BN = 64;     // keys per tile
constexpr int FWD_NT = 256;    // 8 warps
constexpr float FWD_LOG2E = 1.4426950408889634f;
constexpr float FWD_LN2 = 0.6931471805599453f;

template <int D>
constexpr size_t attn_fwd_sm90_smem_bytes() {
  // q tile, two stages of (k tile, v tile) in bf16 rows of D + 8, and one
  // key tag per key and stage
  return sizeof(__nv_bfloat16) * (size_t)((FWD_BM + 4 * FWD_BN) * (D + 8)) +
         sizeof(int) * (size_t)(2 * FWD_BN);
}

// grid: x = row tile (heavy first when T % FWD_BM == 0), y = b * Hkv + kv head
template <int D>
__global__ void __launch_bounds__(FWD_NT, 2)
    attn_fwd_sm90_kernel(const AttnParams p) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = FWD_BM, BN = FWD_BN, NT = FWD_NT;
  constexpr int DP = D + 8;     // padded smem row, in elements
  constexpr int NKT = BN / 8;   // logit n-tiles of a warp's 16 rows
  constexpr int NDT = D / 8;    // output n-tiles
  constexpr int CH = D / 8;     // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + BM * DP;  // stage st: k at 2*st*BN*DP, v one tile later
  int* ktag_all = reinterpret_cast<int*>(kv_s + 4 * BN * DP);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;   // row within the 8-row half of a fragment
  const int tig = lane & 3;    // column pair within a fragment
  const int b = blockIdx.y / p.Hkv;
  const int hkv = blockIdx.y % p.Hkv;
  const int rows = p.g * p.T;
  int tile = blockIdx.x;
  if (p.T % BM == 0) {
    const int n_it = p.T / BM;  // row tiles per query head
    tile = (blockIdx.x % p.g) * n_it + (n_it - 1 - blockIdx.x / p.g);
  }
  const int r0 = tile * BM;
  const int r_last = min(r0 + BM, rows) - 1;
  const int base = p.shift;

  const bf16* qg = static_cast<const bf16*>(p.q) + (long long)b * p.q_sb;
  const bf16* kg = static_cast<const bf16*>(p.k) + (long long)b * p.k_sb +
                   (long long)hkv * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + (long long)b * p.v_sb +
                   (long long)hkv * p.v_sh;

  // ---- the two rows this thread holds fragments of ------------------------
  int row[2], qpos[2], qtag[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + warp * 16 + gid + 8 * h;
    const bool ok = row[h] < rows;
    const int t = ok ? row[h] % p.T : 0;
    qpos[h] = ok ? base + t : ROW_INVALID;
    qtag[h] = (ok && p.q_tag) ? p.q_tag[(long long)b * p.T + t] : 1;
  }

  // ---- key range of this block --------------------------------------------
  // keys the tile's rows can see (all keys when it spans two heads); an
  // empty range (a block wholly in the causal future, or behind the window)
  // visits no tile and writes o = 0, lse = -1e30 + log(1e-30)
  int t_lo = 0, t_hi = p.T - 1;
  if (r0 / p.T == r_last / p.T) {
    t_lo = r0 % p.T;
    t_hi = r_last % p.T;
  }
  int k_begin = 0, k_end = p.S;
  if (p.causal) k_end = min(k_end, base + t_hi + 1);
  if (p.window >= 0) k_begin = max(k_begin, base + t_lo - p.window + 1);
  const int j_first = k_begin < k_end ? (k_begin / BN) * BN : k_end;
  const int n_kt = j_first < k_end ? (k_end - j_first + BN - 1) / BN : 0;
  // a key tile that every row of the block sees whole needs no mask
  const bool one_head = r0 / p.T == r_last / p.T && r0 + BM <= rows &&
                        !p.q_tag && !p.k_tag;
  auto interior = [&](int j0) {
    return one_head && j0 + BN <= p.S &&
           (!p.causal || t_lo + base >= j0 + BN - 1) &&
           (p.window < 0 || t_hi + base - p.window < j0);
  };

  // stage one key tile: k and v rows by cp.async (rows past the end are
  // zero-filled: never NaN times 0), the key tags by plain loads
  auto load_tile = [&](int j0, int st) {
    bf16* k_dst = kv_s + 2 * st * BN * DP;
    bf16* v_dst = k_dst + BN * DP;
    for (int idx = tid; idx < BN * CH; idx += NT) {
      const int jj = idx / CH;
      const int c = (idx % CH) * 8;
      const bool valid = j0 + jj < p.S;
      const long long key = valid ? j0 + jj : 0;
      cp_async_16(&k_dst[jj * DP + c], kg + key * p.k_ss + c, valid);
      cp_async_16(&v_dst[jj * DP + c], vg + key * p.v_ss + c, valid);
    }
    if (tid < BN) {
      const int key = j0 + tid;
      ktag_all[st * BN + tid] = (p.k_tag && key < p.S)
                                    ? p.k_tag[(long long)b * p.S + key] : 1;
    }
    cp_async_commit();
  };

  // prologue: the q tile and the first key tile in one group
  if (n_kt > 0) {
    for (int idx = tid; idx < BM * CH; idx += NT) {
      const int rr = idx / CH;
      const int c = (idx % CH) * 8;
      const int r = r0 + rr;
      const bool valid = r < rows;
      const int t = valid ? r % p.T : 0;
      const int hq = hkv * p.g + (valid ? r / p.T : 0);
      cp_async_16(&q_s[rr * DP + c],
                  qg + (long long)t * p.q_st + (long long)hq * p.q_sh + c,
                  valid);
    }
    load_tile(j_first, 0);
  }

  float m_run[2] = {NEG_BIG, NEG_BIG};  // running maxima, log2 units
  float l_run[2] = {0.f, 0.f};
  float o_acc[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[dt][e] = 0.f;

  // ldmatrix x4 lane offsets: q as A fragments ([m][k] rows), k as B
  // fragments ([n][k] rows, two n-tiles at once), v as transposed B
  // fragments of a [k][n] tile (the layout notes of attn_mma.cuh)
  const int a_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * DP + (lane >> 4) * 8;
  const int b_off = ((lane >> 4) * 8 + (lane & 7)) * DP + ((lane >> 3) & 1) * 8;
  const float scale_log2 = p.scale * FWD_LOG2E;

  const bf16* q_frag = q_s + warp * 16 * DP + a_off;
  for (int n = 0; n < n_kt; ++n) {
    const int j0 = j_first + n * BN;
    const int st = n & 1;
    // the other stage was last read one iteration ago, before that
    // iteration's closing barrier: free to refill while this tile is used
    if (n + 1 < n_kt) {
      load_tile(j0 + BN, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* k_s = kv_s + 2 * st * BN * DP;
    const bf16* v_s = k_s + BN * DP;
    const int* ktag_s = ktag_all + st * BN;

    // ---- s = q . k^T on the tensor cores ----------------------------------
    float s[NKT][4];
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldmatrix_x4(a0, a1, a2, a3, q_frag + kk * 16);
#pragma unroll
      for (int nt = 0; nt < NKT; nt += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3, k_s + nt * 8 * DP + b_off + kk * 16);
        mma_bf16_16816(s[nt], a0, a1, a2, a3, b0, b1);
        mma_bf16_16816(s[nt + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // ---- mask (edge tiles only), online softmax in log2 units --------------
    const bool whole = interior(j0);
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = s[nt][e] * scale_log2;
        if (!whole) {
          const int jj = nt * 8 + tig * 2 + (e & 1);
          const int key = j0 + jj;
          bool ok = key < p.S && qpos[h] != ROW_INVALID;
          if (p.causal) ok = ok && key <= qpos[h];
          if (p.window >= 0) ok = ok && key > qpos[h] - p.window;
          if (p.k_tag) ok = ok && qtag[h] == ktag_s[jj];
          x = ok ? x : NEG_BIG;
        }
        s[nt][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
      alpha[h] = exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        // on an edge tile p is gated by the mask, not only by the sentinel,
        // so a row that has seen no key yet keeps l = 0 (attn_tile.cuh)
        const float pv = (whole || s[nt][e] > MASKED_BELOW)
                             ? exp2f(s[nt][e] - m_run[h]) : 0.f;
        s[nt][e] = pv;
        sum[h] += pv;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l_run[h] = alpha[h] * l_run[h] + quad_sum(sum[h]);

    // ---- o = o * alpha + p . v, p rounded to bf16 as the A operand ---------
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      o_acc[dt][0] *= alpha[0];
      o_acc[dt][1] *= alpha[0];
      o_acc[dt][2] *= alpha[1];
      o_acc[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vp = v_s + kk * 16 * DP + a_off;
#pragma unroll
      for (int dt = 0; dt < NDT; dt += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, vp + dt * 8);
        mma_bf16_16816(o_acc[dt], a0, a1, a2, a3, b0, b1);
        mma_bf16_16816(o_acc[dt + 1], a0, a1, a2, a3, b2, b3);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // ---- epilogue -------------------------------------------------------------
  const long long bs = blockIdx.y;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row[h];
    if (r >= rows) continue;
    const float inv = 1.f / fmaxf(l_run[h], 1e-30f);
    const int t = r % p.T;
    const int hq = hkv * p.g + r / p.T;
    bf16* og = static_cast<bf16*>(p.o) + (long long)b * p.o_sb +
               (long long)t * p.o_st + (long long)hq * p.o_sh + tig * 2;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(og + dt * 8) = __floats2bfloat162_rn(
          o_acc[dt][2 * h] * inv, o_acc[dt][2 * h + 1] * inv);
    // a row that saw no key keeps m at the sentinel and l = 0: its lse is the
    // previous cores' -1e30 + log(1e-30), which the backward relies on (C3)
    if (tig == 0)
      p.lse[bs * rows + r] = l_run[h] > 0.f
                                 ? m_run[h] * FWD_LN2 + logf(l_run[h])
                                 : NEG_BIG + logf(1e-30f);
  }
}

template <int D>
inline cudaError_t launch_attn_fwd_sm90(const AttnParams& p,
                                        cudaStream_t stream) {
  constexpr size_t smem = attn_fwd_sm90_smem_bytes<D>();
  auto kernel = attn_fwd_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory: two blocks fit
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int rows = p.g * p.T;
  const dim3 grid((rows + FWD_BM - 1) / FWD_BM, p.B * p.Hkv);
  kernel<<<grid, FWD_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace d9d
