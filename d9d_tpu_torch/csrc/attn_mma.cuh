// Tensor-core variant of the online-softmax attention core (attn_tile.cuh)
// for bfloat16 inputs: the two products of the flash-prefill kernel and of a
// flash-decode continuation chunk run as `mma.sync.m16n8k16` (bf16 in, fp32
// accumulate) instead of fp32 FMAs on the CUDA cores.
//
// Same contract as attn_tile_kernel — same AttnParams, same row addressing
// (r = ig*T + i over the GQA group of one kv head), same masks, same
// zero-row rule, same split/partial outputs — so the combine kernel and the
// launch logic are shared. What differs is where things live:
//
// - a block of 4 warps owns 64 query rows, 16 per warp; q, k and v tiles sit
//   in shared memory as bf16 with rows padded by 16 bytes, so every
//   `ldmatrix` that builds an operand fragment is free of bank conflicts;
// - the [16, BN] logit tile of a warp never leaves its registers: masking and
//   the online softmax run on the mma accumulator fragments (row maxima and
//   sums by two quad shuffles), and the probabilities are repacked to bf16 as
//   the A operand of the second product, as FlashAttention-2 does;
// - the v tile is read with `ldmatrix.trans`, which yields the transposed
//   B fragments straight from its row-major rows.
//
// - key/value tiles are double-buffered: `cp.async` brings tile j+1 into the
//   other stage while the warps work on tile j, so the load latency hides
//   behind the products.
//
// TMA loads, warp specialisation and `wgmma` are left to later work.
#pragma once

#include "attn_tile.cuh"

namespace d9d {

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* smem_ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* smem_ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// 16 bytes global -> shared without passing through registers; with
// `valid` false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async_16(void* smem_ptr, const void* gptr,
                                            bool valid) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gptr), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr int MMA_BM = 64;   // query rows per block (16 per warp, 4 warps)
constexpr int MMA_BN = 32;   // keys per tile: small, so that two stages of four
                             // blocks fit one SM's shared memory
constexpr int MMA_NT = 128;

template <int D>
constexpr size_t attn_mma_smem_bytes() {
  // q tile + two stages of (k tile, v tile) + two stages of key tags
  return sizeof(__nv_bfloat16) * (size_t)((MMA_BM + 4 * MMA_BN) * (D + 8)) +
         sizeof(int) * (size_t)(2 * MMA_BN);
}

// grid: x = row tile, y = b * Hkv + kv head, z = key split
template <int D>
__global__ void __launch_bounds__(MMA_NT) attn_mma_kernel(const AttnParams p) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = MMA_BM, BN = MMA_BN, NT = MMA_NT;
  constexpr int DP = D + 8;          // padded smem row, in elements
  constexpr int NKT = BN / 8;        // logit n-tiles per warp row block
  constexpr int NDT = D / 8;         // output n-tiles
  constexpr int CH = D / 8;          // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + BM * DP;  // stage st: k at 2*st*BN*DP, v one tile later
  int* ktag_all = reinterpret_cast<int*>(kv_s + 4 * BN * DP);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;   // row within the 8-row half of the fragment
  const int tig = lane & 3;    // column pair within the fragment
  const int b = blockIdx.y / p.Hkv;
  const int hkv = blockIdx.y % p.Hkv;
  const int split = blockIdx.z;
  const int rows = p.g * p.T;
  const int r0 = blockIdx.x * BM;
  const int r_last = min(r0 + BM, rows) - 1;
  const int base = (p.offsets ? p.offsets[b] : 0) + p.shift;

  const bf16* qg = static_cast<const bf16*>(p.q);
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

  // ---- q tile -> shared ---------------------------------------------------
  for (int idx = tid; idx < BM * CH; idx += NT) {
    const int rr = idx / CH;
    const int c = (idx % CH) * 8;
    const int r = r0 + rr;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const int t = r % p.T;
      const int hq = hkv * p.g + r / p.T;
      x = *reinterpret_cast<const uint4*>(
          qg + (long long)b * p.q_sb + (long long)t * p.q_st +
          (long long)hq * p.q_sh + c);
    }
    *reinterpret_cast<uint4*>(&q_s[rr * DP + c]) = x;
  }

  // ---- key range of this block (as in attn_tile_kernel) --------------------
  int t_lo = 0, t_hi = p.T - 1;
  if (r0 / p.T == r_last / p.T) {
    t_lo = r0 % p.T;
    t_hi = r_last % p.T;
  }
  int k_begin = 0, k_end = p.S;
  if (p.causal) k_end = min(k_end, base + t_hi + 1);
  if (p.window >= 0) k_begin = max(k_begin, base + t_lo - p.window + 1);
  k_begin = max(k_begin, split * p.split_len);
  k_end = min(k_end, (split + 1) * p.split_len);
  const int j_first = (k_begin / BN) * BN;

  float m_run[2] = {NEG_BIG, NEG_BIG};
  float l_run[2] = {0.f, 0.f};
  float o_acc[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[dt][e] = 0.f;

  // ldmatrix x4 lane addresses. q (A operand): the four 8x8 blocks are rows
  // 0-7 / 8-15 of columns kk*16 + 0-7, then the same rows of columns +8..15.
  // k (B operand, [key][d] is already its column-major form): keys 0-7 of
  // columns kk*16 + 0-7 / +8..15 of one n-tile, then of the next n-tile.
  const bf16* q_frag = &q_s[(warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * DP +
                            (lane >> 4) * 8];
  const int k_frag_off = ((lane >> 4) * 8 + (lane & 7)) * DP +
                         ((lane >> 3) & 1) * 8;
  const int v_frag_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * DP +
                         (lane >> 4) * 8;

  // stage one key tile: k and v rows by cp.async (rows past the end are
  // zero-filled: never NaN times 0), the key tags by plain loads
  auto load_tile = [&](int j0, int st) {
    bf16* k_dst = kv_s + 2 * st * BN * DP;
    bf16* v_dst = k_dst + BN * DP;
    for (int idx = tid; idx < BN * CH; idx += NT) {
      const int jj = idx / CH;
      const int c = (idx % CH) * 8;
      const bool valid = j0 + jj < p.S;
      const long long key = valid ? j0 + jj : p.S - 1;
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

  if (j_first < k_end) load_tile(j_first, 0);
  int stage = 0;
  for (int j0 = j_first; j0 < k_end; j0 += BN, stage ^= 1) {
    // the other stage was last read one iteration ago, before that
    // iteration's closing barrier: free to refill while this tile is used
    if (j0 + BN < k_end) {
      load_tile(j0 + BN, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and the q tile) visible to every warp
    const bf16* k_s = kv_s + 2 * stage * BN * DP;
    const bf16* v_s = k_s + BN * DP;
    const int* ktag_s = ktag_all + stage * BN;
    const bf16* k_frag = k_s + k_frag_off;

    // ---- s = q . k^T on the tensor cores --------------------------------
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
        ldmatrix_x4(b0, b1, b2, b3, k_frag + nt * 8 * DP + kk * 16);
        mma_bf16_16816(s[nt], a0, a1, a2, a3, b0, b1);
        mma_bf16_16816(s[nt + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // ---- mask, online softmax on the accumulator fragments ---------------
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = nt * 8 + tig * 2 + e;
        const int key = j0 + jj;
        const int ktag = ktag_s[jj];
        const bool key_ok = key >= k_begin && key < k_end;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bool ok = key_ok && qpos[h] != ROW_INVALID;
          if (p.causal) ok = ok && key <= qpos[h];
          if (p.window >= 0) ok = ok && key > qpos[h] - p.window;
          if (p.k_tag) ok = ok && qtag[h] == ktag;
          const float x = ok ? s[nt][2 * h + e] * p.scale : NEG_BIG;
          s[nt][2 * h + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        // gate by the mask, not only by the sentinel (see attn_tile.cuh)
        const float pv =
            (s[nt][e] > MASKED_BELOW) ? expf(s[nt][e] - m_run[h]) : 0.f;
        s[nt][e] = pv;
        sum[h] += pv;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l_run[h] = alpha[h] * l_run[h] + quad_sum(sum[h]);

    // ---- o = o * alpha + p . v on the tensor cores -------------------------
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
      // ldmatrix x4: lanes 0-7 / 8-15 address keys kk*16 + 0-7 / 8-15 of
      // output columns dt*8.., lanes 16-31 the same keys of columns
      // (dt+1)*8..; transposed, that is (b0, b1) of two output n-tiles
      const bf16* vp = v_s + kk * 16 * DP + v_frag_off;
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
    if (p.n_splits == 1) {
      const int t = r % p.T;
      const int hq = hkv * p.g + r / p.T;
      bf16* og = static_cast<bf16*>(p.o) + (long long)b * p.o_sb +
                 (long long)t * p.o_st + (long long)hq * p.o_sh + tig * 2;
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(og + dt * 8) = __floats2bfloat162_rn(
            o_acc[dt][2 * h] * inv, o_acc[dt][2 * h + 1] * inv);
      }
      if (tig == 0)
        p.lse[bs * rows + r] = m_run[h] + logf(fmaxf(l_run[h], 1e-30f));
    } else {
      float* op = p.o_part + ((bs * p.n_splits + split) * rows + r) * D + tig * 2;
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        op[dt * 8] = o_acc[dt][2 * h] * inv;
        op[dt * 8 + 1] = o_acc[dt][2 * h + 1] * inv;
      }
      if (tig == 0)
        p.lse_part[(bs * p.n_splits + split) * rows + r] =
            m_run[h] + logf(fmaxf(l_run[h], 1e-30f));
    }
  }
}

template <int D>
inline cudaError_t launch_attn_mma(const AttnParams& p, cudaStream_t stream) {
  constexpr size_t smem = attn_mma_smem_bytes<D>();
  auto kernel = attn_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = p.g * p.T;
  const dim3 grid((rows + MMA_BM - 1) / MMA_BM, p.B * p.Hkv, p.n_splits);
  kernel<<<grid, MMA_NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.n_splits > 1) {
    const dim3 cgrid(rows, p.B * p.Hkv, 1);
    attn_combine_kernel<__nv_bfloat16, D><<<cgrid, D, 0, stream>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace d9d
