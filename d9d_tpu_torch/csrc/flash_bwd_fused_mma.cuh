// Tensor-core kernel 2 (fused: dq, dk and dv from one recompute) of the flash
// backward for bfloat16 inputs, hand-written for sm_90a. Included by
// flash_bwd.cu after flash_bwd_mma.cuh, whose pieces it is built from
// (mma.sync.m16n8k16 on bf16 tiles, ldmatrix and ldmatrix.trans, tiles
// streamed by cp.async, score tiles formed in halves, the mask skipped on
// tiles every row sees whole), and after BwdParams, visible() and the fused
// kernels' turnstile (fused_ticket, first_key_tile_of, wait_turn,
// pass_turn) in flash_bwd.cu.
//
// Replaces, for bf16, d9d_tpu/ops/attention/pallas_flash.py
// `_bwd_fused_kernel` (the `pallas_call` at :548), also in its
// `has_positions` mode (the by-value `shift`, B4). Same function, same
// visited 64 x 64 tiles and ranges, same ungated p (ROADMAP C3) as the
// CUDA-core fused kernel of flash_bwd.cu, which float32 inputs keep.
//
// Bound on this card: operations — s, dp, dv, dk and dq are five [rows x
// keys x D] products per visited tile over a few megabytes of inputs. What
// the design does about it:
//
// - a block of 4 warps owns 64 keys (k and v resident), 16 per warp, as in
//   the split dk/dv kernel: s^T = k.q^T and dp^T = v.do^T of a streamed
//   64-row query tile, formed in two halves of 32 columns, stay in the
//   warp's accumulator fragments, where p^T and ds^T are formed; dv +=
//   p^T.do and dk += ds^T.q take them from registers as A operands, and dk
//   and dv stay in fp32 registers until the one store;
// - p and ds enter the second products (dv = p^T.do, dk = ds^T.q,
//   dq = ds.k) as a pair of bf16 values, hi = bf16(x) and lo = bf16(x - hi),
//   two mma per product: the pair leaves about 2^-18 |x| of each term where
//   one rounding (the split kernels') leaves 2^-9, so the fused kernel keeps
//   its row term (2^-12 of the row, chip_smoke.py BWD_RULE["fused"]);
// - ds^T goes to shared memory as hi and lo tiles [key][query]; then warp w
//   forms the dq of query rows 16 w, ds.k over the block's 64 keys (ds by
//   ldmatrix.trans, k by ldmatrix.trans), one half of D at a time, and adds
//   it into the fp32 dq in device memory at its turn of the turnstile
//   (ascending key tile, the order of the TPU kernel's sequential kv axis;
//   flash_bwd.cu says why it cannot deadlock);
// - the add waits on memory (a turn, loads and stores through L2, a
//   fence): ~89 KB of shared memory and at most 255 registers a thread let
//   two blocks share an SM, so one block's add runs beside the other's
//   products, and the next query tile streams in (cp.async) while this
//   one's dq is formed and added; the query tiles come latest position
//   first, all heads of the group at one position before the next (the
//   order that keeps the blocks of one kv head in step at the turnstile).
//
// `wgmma`, TMA and warp specialisation are left to later work.
#pragma once

#include "flash_bwd_mma.cuh"

namespace d9d {
namespace {

constexpr int BWD_FUSED_SP = BWD_MMA_BN + 8;  // ds tile row: 64 queries + pad
static_assert(BWD_MMA_BM == BWD_BK && BWD_MMA_BN == BWD_RQ,
              "the fused tensor-core kernel visits the CUDA-core kernels' "
              "tiles and counts the turnstile by them");

template <int D>
constexpr size_t bwd_fused_mma_smem_bytes() {
  // k, v resident and one stage of q, do (bf16, rows of D + 8); four words
  // (pos, tag, lse, delta) per query row; ds hi and lo tiles [64 keys][64 +
  // 8 queries] bf16
  return sizeof(__nv_bfloat16) *
             (size_t)((2 * BWD_MMA_BM + 2 * BWD_MMA_BN) * (D + 8) +
                      2 * BWD_MMA_BM * BWD_FUSED_SP) +
         sizeof(int) * (size_t)(4 * BWD_MMA_BN);
}

// (hi, lo) bf16 pairs of two fp32 values: hi = bf16(x), lo = bf16(x - hi);
// x - hi is exact in fp32
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// acc[ND][4] += X . B where X is a warp's [16, NX*8] fp32 fragment tile x,
// taken as hi + lo bf16 A operands (two mma per product), and B a row-major
// [NX*8][ND*8] tile read by ldmatrix.trans (bt_frag = tile + frag_off_mk)
template <int ND, int NX>
__device__ __forceinline__ void mma_hilo_by_trans(float (&acc)[ND][4],
                                                  const float (&x)[NX][4],
                                                  const __nv_bfloat16* bt_frag,
                                                  int dp) {
#pragma unroll
  for (int kk = 0; kk < NX / 2; ++kk) {
    uint32_t h[4], l[4];
    split_bf16x2(x[2 * kk][0], x[2 * kk][1], h[0], l[0]);
    split_bf16x2(x[2 * kk][2], x[2 * kk][3], h[1], l[1]);
    split_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1], h[2], l[2]);
    split_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3], h[3], l[3]);
    const __nv_bfloat16* bp = bt_frag + kk * 16 * dp;
#pragma unroll
    for (int dt = 0; dt < ND; dt += 2) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3, bp + dt * 8);
      mma_bf16_16816(acc[dt], h[0], h[1], h[2], h[3], b0, b1);
      mma_bf16_16816(acc[dt + 1], h[0], h[1], h[2], h[3], b2, b3);
      mma_bf16_16816(acc[dt], l[0], l[1], l[2], l[3], b0, b1);
      mma_bf16_16816(acc[dt + 1], l[0], l[1], l[2], l[3], b2, b3);
    }
  }
}

// grid: x = tile of 64 keys, y = b * Hkv + kv head (the count of blocks; a
// block takes its tile from its ticket)
template <int D>
__global__ void __launch_bounds__(BWD_MMA_NT, 2)
    bwd_fused_mma_kernel(const BwdParams p) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = BWD_MMA_BM, BN = BWD_MMA_BN;
  constexpr int DP = D + 8, SP = BWD_FUSED_SP;
  constexpr int HN = BWD_MMA_HN;  // query columns per half tile
  constexpr int NQT = HN / 8;     // query n-tiles of a half tile's scores
  constexpr int NDT = D / 8;      // dk, dv n-tiles
  constexpr int NDQ = D / 16;     // dq n-tiles of one half of D

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + BM * DP;
  bf16* q_s = v_s + BM * DP;
  bf16* do_s = q_s + BN * DP;
  bf16* dsh_s = do_s + BN * DP;  // ds^T hi [key][query]
  bf16* dsl_s = dsh_s + BM * SP;  // ds^T lo
  float* lse_s = reinterpret_cast<float*>(dsl_s + BM * SP);
  float* dl_s = lse_s + BN;
  int* rpos_s = reinterpret_cast<int*>(dl_s + BN);
  int* rtag_s = rpos_s + BN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  const int2 tk = fused_ticket(p);
  const int jt = tk.x;
  const int b = tk.y / p.Hkv;
  const int hkv = tk.y % p.Hkv;
  const long long bs = tk.y;
  const int rows = p.g * p.T;
  const int j0 = jt * BM;
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

  // query tile n of this block: latest position first, then the group's
  // heads at that position
  auto tile_head = [&](int n) { return n % p.g; };
  auto tile_row0 = [&](int n) { return i_first + (n_qt - 1 - n / p.g) * BN; };

  // stage query tile n: q and do rows by cp.async, the rows' position, tag,
  // lse and delta by plain loads
  auto load_q = [&](int n) {
    const int ig = tile_head(n);
    const int i0 = tile_row0(n);
    const int hq = hkv * p.g + ig;
    cp_rows<D>(q_s, qb, p.q_st, p.q_sh, hq, p.T, i0, p.T);
    cp_rows<D>(do_s, ob, p.o_st, p.o_sh, hq, p.T, i0, p.T);
    if (tid < BN) {
      const int i = i0 + tid;
      const bool ok = i < p.T;
      rpos_s[tid] = ok ? i + p.shift : ROW_INVALID;
      rtag_s[tid] = (ok && p.q_tag) ? p.q_tag[(long long)b * p.T + i] : 1;
      lse_s[tid] = ok ? p.lse[bs * rows + ig * p.T + i] : 0.f;
      dl_s[tid] = ok ? p.delta[bs * rows + ig * p.T + i] : 0.f;
    }
    cp_async_commit();
  };

  if (n_tiles > 0) {
    cp_rows<D>(k_s, kb, p.k_st, p.k_sh, hkv, p.T, j0, p.T);
    cp_rows<D>(v_s, vb, p.v_st, p.v_sh, hkv, p.T, j0, p.T);
    load_q(0);  // one group: k, v and the first query tile
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
  const int qr = warp * 16;                  // dq phase: this warp's rows
  const int ds_off = frag_off_nk(lane, SP);  // ds as A by ldmatrix.trans

  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<0>();
    __syncthreads();  // query tile n (and k, v) visible to every warp
    const int ig = tile_head(n);
    const int i0 = tile_row0(n);
    const int hq = hkv * p.g + ig;
    // a query tile that sees the key tile whole needs no mask: no row or
    // key past the end, no segments, inside the causal and window bounds
    const bool whole =
        i0 + BN <= p.T && j0 + BM <= p.T && !p.q_tag &&
        (!p.causal || i0 + p.shift >= j0 + BM - 1) &&
        (p.window < 0 || i0 + BN - 1 + p.shift - p.window < j0);

#pragma unroll 1
    for (int hn = 0; hn < BN; hn += HN) {
      // ---- s^T = k.q^T, dp^T = v.do^T: 16 keys x 32 query columns ----------
      float s[NQT][4], dp[NQT][4];
#pragma unroll
      for (int nt = 0; nt < NQT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) { s[nt][e] = 0.f; dp[nt][e] = 0.f; }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a0, a1, a2, a3;
        ldmatrix_x4(a0, a1, a2, a3, k_frag + kk * 16);
        mma_rows(s, a0, a1, a2, a3, q_s + hn * DP + b_off + kk * 16, DP);
        ldmatrix_x4(a0, a1, a2, a3, v_frag + kk * 16);
        mma_rows(dp, a0, a1, a2, a3, do_s + hn * DP + b_off + kk * 16, DP);
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

      // ---- dv += p^T . do, dk += ds^T . q; p^T, ds^T as hi/lo A operands ---
      mma_hilo_by_trans(dv, s, do_s + hn * DP + a_off, DP);
      mma_hilo_by_trans(dk, dp, q_s + hn * DP + a_off, DP);

      // ---- ds^T as hi and lo bf16 tiles [key][query] in shared memory ------
#pragma unroll
      for (int nt = 0; nt < NQT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t hi, lo;
          split_bf16x2(dp[nt][2 * h], dp[nt][2 * h + 1], hi, lo);
          const int at = (warp * 16 + gid + 8 * h) * SP + hn + nt * 8 + tig * 2;
          *reinterpret_cast<uint32_t*>(dsh_s + at) = hi;
          *reinterpret_cast<uint32_t*>(dsl_s + at) = lo;
        }
      }
    }
    __syncthreads();  // q, do and the rows' state consumed; ds tiles whole
    // the next query tile streams in while this one's dq is formed and added
    if (n + 1 < n_tiles) load_q(n + 1);

    // ---- dq of this warp's 16 query rows = ds . k over the block's keys,
    // added into dq at this key tile's turn, one half of D at a time --------
    int* counter = fused_counter(p, b, hq, i0);
    const int turn = jt - first_key_tile_of(p, i0);
#pragma unroll 1
    for (int dh = 0; dh < D; dh += D / 2) {
      float dq[NDQ][4];
#pragma unroll
      for (int dt = 0; dt < NDQ; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
        ldmatrix_x4_trans(h0, h1, h2, h3, dsh_s + kk * 16 * SP + qr + ds_off);
        ldmatrix_x4_trans(l0, l1, l2, l3, dsl_s + kk * 16 * SP + qr + ds_off);
        const bf16* bp = k_s + kk * 16 * DP + a_off + dh;
#pragma unroll
        for (int dt = 0; dt < NDQ; dt += 2) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(b0, b1, b2, b3, bp + dt * 8);
          mma_bf16_16816(dq[dt], h0, h1, h2, h3, b0, b1);
          mma_bf16_16816(dq[dt + 1], h0, h1, h2, h3, b2, b3);
          mma_bf16_16816(dq[dt], l0, l1, l2, l3, b0, b1);
          mma_bf16_16816(dq[dt + 1], l0, l1, l2, l3, b2, b3);
        }
      }
      float2* dq_row[2];
      bool in_t[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + qr + gid + 8 * h;
        in_t[h] = i < p.T;
        dq_row[h] = reinterpret_cast<float2*>(
            p.dq_acc + (((long long)b * p.T + (in_t[h] ? i : 0)) * p.Hq + hq) * D +
            dh + tig * 2);
      }
      if (dh == 0) wait_turn(counter, turn);
      // every load before any store (flash_bwd.cu, above wait_turn)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int dt = 0; dt < NDQ; ++dt)
          if (in_t[h]) {
            const float2 old = __ldcg(dq_row[h] + dt * 4);
            dq[dt][2 * h] += old.x;
            dq[dt][2 * h + 1] += old.y;
          }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int dt = 0; dt < NDQ; ++dt)
          if (in_t[h])
            __stcg(dq_row[h] + dt * 4,
                   make_float2(dq[dt][2 * h], dq[dt][2 * h + 1]));
    }
    pass_turn(counter, turn);
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
cudaError_t launch_bwd_fused_mma(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = bwd_fused_mma_smem_bytes<D>();
  auto fn = bwd_fused_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory: two blocks fit
  err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + BWD_MMA_BM - 1) / BWD_MMA_BM, p.B * p.Hkv);
  fn<<<grid, BWD_MMA_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace d9d
