// flash_bwd: flash-attention backward, hand-written for sm_90a.
//
// Replaces the three TPU backward kernels of
// d9d_tpu/ops/attention/pallas_flash.py, all called from `_bwd_call`:
//
//   kernel 0  dq     <- `_bwd_dq_kernel`    dq = sum_k ds . k
//   kernel 1  dk/dv  <- `_bwd_dkv_kernel`   dv = sum_q p^T . do, dk = sum_q ds^T . q
//   kernel 2  fused  <- `_bwd_fused_kernel` dq, dk and dv from one recompute
//
// with, for every visited (query row, key) pair, the TPU kernels' arithmetic:
// s = (q . k) * scale, masked to -1e30 (length, causal, window, segment ids);
// p = exp(s - lse) with the saved, sink-corrected lse; dp = do . v;
// ds = p * (dp - delta) * scale, where delta = rowsum(do * o) comes from
// the caller, as in the JAX package. p is NOT gated by the mask, exactly as
// in the TPU kernels: on an ordinary row exp(-1e30 - lse) is 0, and on a row
// that sees no key at all (lse at the sentinel, -1e30) every masked key the
// kernel visits gets p = 1. Which keys are visited depends on the tiling when
// causal or window masking skips tiles, in this code as in the TPU code.
//
// Bound on this card: operations. The backward does five [rows x keys x D]
// products per visited tile (the split kernels seven: s and dp are
// recomputed by both) over a few megabytes of inputs, far above the ~295
// flop/byte ridge of the H100.
//
// Design. Two families of kernels share the parameters, the masks, the
// ranges and the tiles below. bfloat16 inputs run on the tensor cores:
// dq and dk/dv in flash_bwd_mma.cuh (mma.sync on bf16 tiles fed by
// cp.async, p and ds rounded to bf16 as the A operands of the second
// products), the fused kernel in flash_bwd_fused_mma.cuh (the same pieces,
// with p and ds carried into the second products as a hi/lo pair of bf16
// values). float32 inputs (all three kernels) run every product on the CUDA
// cores as fp32 FMAs over tiles widened to fp32 in shared memory: exact fp32
// products, the exactness link of the parity chain. The TPU grid's
// sequential dimension and its VMEM accumulators become a loop inside the
// block with fp32 accumulators in registers:
//
// - dq: one block per (batch row, kv head, tile of 64 query rows of the GQA
//   group, r = ig*T + i as in the forward kernel); it loops over the key
//   tiles the rows can see (tiles wholly in the causal future or behind the
//   window are skipped, as `_skip_block` skips them) and writes dq once.
// - dk/dv: one block per (batch row, kv head, tile of 64 keys); it loops
//   over the g query heads of the group and their 64-token tiles that can
//   see the keys, and writes dk, dv once.
// - fused: the dk/dv block, which also forms ds . k for its query rows and
//   adds it into an fp32 dq buffer in device memory. A resident [g*T, D]
//   fp32 dq, as the TPU kernel keeps in VMEM, would not fit the SM's 228 KB
//   of shared memory at real T (4 MB at g=4, T=2048, D=128). The adds land
//   in a fixed order, ascending key tile — the order in which the TPU
//   kernel's sequential kv axis sums dq — so the fused dq is the same on
//   every run: a zeroed int32 turnstile holds one counter per (batch row,
//   query head, query tile) of 64 rows, and the block of key tile j waits
//   until the counter of query tile i has counted every earlier key tile
//   that visits i, adds its partial with plain loads and stores,
//   __threadfence()s and advances the counter. Its size is B * Hq *
//   ceil(T / 64) + 1 ints, whatever T. Deadlock freedom: a block waits only
//   on blocks of lower key tiles of its own (batch row, kv head), and it
//   takes its (kv head, key tile) from a ticket drawn at its start
//   (atomicAdd on the turnstile's last int), in ascending order, (batch
//   row, kv head) fastest, so that every head's key tile 0, the heaviest
//   under causal masking, starts first. Tickets run in the order blocks
//   start, so every block a waiter waits on has started before it — is
//   resident or done — and never waits on a later one; blockIdx order,
//   which the hardware does not promise to start in, is not relied on. A block visits its query tiles at the
//   latest position first (all heads of the group at one position, then
//   the next): under causal masking every key tile then reaches a query
//   tile at the same step, so the blocks of one kv head move in lockstep
//   and a wait lasts about one add.
//
// Global offsets (B4, `flash_attention_block` at pallas_flash.py:709: the
// three TPU kernels with `has_positions`). A ring-attention step attends a
// local query chunk against a rotated key chunk; only q_offset - k_offset
// matters, passed by value as `shift`: query row t sits at key position
// t + shift in `visible()` and in every key or query range below. shift may
// be negative (a chunk in the causal future: every range is empty, nothing
// is visited and dq, dk, dv are written as zeros) or large (the full past).
// Tiles outside the ranges are never visited, and a loop over an empty
// range does not run at all, so at shift 0 the kernels visit exactly the
// tiles they visited before.
//
// The CUDA-core kernels are synchronous (a tile is loaded, then used) and
// hold one block per SM; the tensor-core kernels stream their tiles with
// cp.async and hold two (see flash_bwd_mma.cuh, flash_bwd_fused_mma.cuh).
// wgmma and TMA are left to later work.
#include "attn_tile.cuh"

namespace d9d {
namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;      // [B, Hq, T] fp32 contiguous (== [B, Hkv, g*T])
  const float* delta;    // same layout
  const int* q_tag;      // [B, T] segment ids or null
  const int* k_tag;      // [B, T] or null
  void* dq;              // kernel 0: [B, T, Hq, D] contiguous, q's dtype
  float* dq_acc;         // kernel 2: [B, T, Hq, D] contiguous fp32, zeroed
  int* turnstile;        // kernel 2: [n_counters + 1] int32, zeroed
  int n_counters;        // B * Hq * ceil(T / 64); the ticket follows them
  void* dk;              // kernels 1, 2: [B, T, Hkv, D] contiguous
  void* dv;
  int B, T, Hq, Hkv, g;
  long long q_sb, q_st, q_sh;    // element strides: batch, token, head
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;    // of dout
  float scale;
  int causal;
  int window;            // -1 = none
  int shift;             // q_offset - k_offset: row t at key position t + shift
};

constexpr int BWD_RQ = 64;   // query rows per tile
constexpr int BWD_BK = 64;   // keys per tile
constexpr int BWD_NT = 256;

// ROWS rows of a [B, T, H, D]-addressed tensor into shared memory as fp32,
// rows padded to D + 4 floats. Row r of the tile (r0 + rr) is token
// r % T_len of head h0 + r / T_len; rows at or past n_rows are zeros.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const T* base,
                                          long long st, long long sh, int h0,
                                          int T_len, int r0, int n_rows) {
  constexpr int VEC = Vec<T>::N;
  constexpr int DP = D + 4;
  for (int idx = threadIdx.x; idx < ROWS * (D / VEC); idx += NT) {
    const int rr = idx / (D / VEC);
    const int c = (idx % (D / VEC)) * VEC;
    const int r = r0 + rr;
    float x[VEC];
    if (r < n_rows) {
      const int t = r % T_len;
      const int h = h0 + r / T_len;
      load16(base + (long long)t * st + (long long)h * sh + c, x);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[i] = 0.f;
    }
    store_row(&dst[rr * DP + c], x, VEC);
  }
}

__device__ __forceinline__ bool visible(const BwdParams& p, int key, int qpos,
                                        int qtag, int ktag) {
  bool ok = key < p.T && qpos != ROW_INVALID;
  if (p.causal) ok = ok && key <= qpos;
  if (p.window >= 0) ok = ok && key > qpos - p.window;
  if (p.q_tag) ok = ok && qtag == ktag;
  return ok;
}

// ---- the fused kernels' fixed-order dq (see the design notes above) -------

// The block's ticket: its key tile and its b * Hkv + kv head (fastest), in
// the order blocks start. Every thread of the block calls it once.
__device__ __forceinline__ int2 fused_ticket(const BwdParams& p) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(&p.turnstile[p.n_counters], 1);
  __syncthreads();
  const int n_groups = p.B * p.Hkv;
  return make_int2(ticket / n_groups, ticket % n_groups);
}

// The first key tile that visits query tile i0 (a multiple of 64): key tile
// j visits i0 when i_first(j) <= i0 < i_end(j) (the ranges of
// bwd_dkv_kernel), both bounds ascend with j, so the visitors of i0 are the
// key tiles from this one up to the last whose i_first is <= i0. Without a
// window every i_end is T. With one, i_end(j) > i0 exactly when j's last key
// exceeds i0 - window + shift.
__device__ __forceinline__ int first_key_tile_of(const BwdParams& p, int i0) {
  if (p.window < 0) return 0;
  const long long x = (long long)i0 - p.window + p.shift;
  return x < BWD_BK - 1 ? 0 : (int)((x - (BWD_BK - 1)) / BWD_BK + 1);
}

__device__ __forceinline__ int* fused_counter(const BwdParams& p, int b,
                                              int hq, int i0) {
  const int n_qt = (p.T + BWD_RQ - 1) / BWD_RQ;
  return p.turnstile + ((long long)b * p.Hq + hq) * n_qt + i0 / BWD_RQ;
}

// Wait until `counter` reaches `turn` (thread 0 spins with acquire loads,
// then the block's barrier passes the order on), so that the adds of every
// earlier visitor are visible to the block's loads below.
__device__ __forceinline__ void wait_turn(const int* counter, int turn) {
  if (threadIdx.x == 0) {
    int seen;
    while (true) {
      asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n"
                   : "=r"(seen) : "l"(counter) : "memory");
      if (seen >= turn) break;
      __nanosleep(32);
    }
  }
  __syncthreads();
}

// After the block's adds: fence them, then let the next visitor in.
__device__ __forceinline__ void pass_turn(int* counter, int turn) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.global.release.gpu.b32 [%0], %1;\n"
                 :: "l"(counter), "r"(turn + 1) : "memory");
}

// Between wait_turn and pass_turn a block adds its partial through L2
// (ld.cg / st.cg: never a stale L1 line of another block's add), loading
// every value it adds to before it stores any: the compiler cannot move a
// load above a store it may alias, so load, add, store per element would
// pay one L2 round trip per element. (Reductions in L2 in the same order,
// red.global.add, were slower on the card.)

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, do [RQ][D+4]; k, v [BK][D+4]; ds [RQ][BK+4]; lse, delta [RQ];
  // row pos, row tag [RQ]; key tag [BK]
  return sizeof(float) * (size_t)(2 * BWD_RQ * (D + 4) + 2 * BWD_BK * (D + 4) +
                                  BWD_RQ * (BWD_BK + 4) + 2 * BWD_RQ) +
         sizeof(int) * (size_t)(2 * BWD_RQ + BWD_BK);
}

// grid: x = tile of query rows of the GQA group, y = b * Hkv + kv head
template <typename T, int D>
__global__ void __launch_bounds__(BWD_NT) bwd_dq_kernel(const BwdParams p) {
  constexpr int RQ = BWD_RQ, BK = BWD_BK, NT = BWD_NT;
  constexpr int DP = D + 4, SP = BK + 4;
  constexpr int NRG = NT / BK, RPT = RQ / NRG;  // score phase
  constexpr int NCG = NT / D, RPO = RQ / NCG;   // dq phase
  static_assert(NT % BK == 0 && RQ % NRG == 0, "score phase tiling");
  static_assert(NT % D == 0 && RQ % NCG == 0, "dq phase tiling");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* do_s = q_s + RQ * DP;
  float* k_s = do_s + RQ * DP;
  float* v_s = k_s + BK * DP;
  float* ds_s = v_s + BK * DP;
  float* lse_s = ds_s + RQ * SP;
  float* dl_s = lse_s + RQ;
  int* rpos_s = reinterpret_cast<int*>(dl_s + RQ);
  int* rtag_s = rpos_s + RQ;
  int* ktag_s = rtag_s + RQ;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / p.Hkv;
  const int hkv = blockIdx.y % p.Hkv;
  const long long bs = blockIdx.y;
  const int rows = p.g * p.T;
  const int r0 = blockIdx.x * RQ;
  const int r_last = min(r0 + RQ, rows) - 1;

  const T* qb = static_cast<const T*>(p.q) + (long long)b * p.q_sb;
  const T* ob = static_cast<const T*>(p.dout) + (long long)b * p.o_sb;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.k_sb;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.v_sb;

  if (tid < RQ) {
    const int r = r0 + tid;
    const bool ok = r < rows;
    const int t = ok ? r % p.T : 0;
    rpos_s[tid] = ok ? t + p.shift : ROW_INVALID;
    rtag_s[tid] = (ok && p.q_tag) ? p.q_tag[(long long)b * p.T + t] : 1;
    // a row past the end gets lse 0: with s = -1e30 its p is exactly 0
    lse_s[tid] = ok ? p.lse[bs * rows + r] : 0.f;
    dl_s[tid] = ok ? p.delta[bs * rows + r] : 0.f;
  }
  load_rows<T, D, RQ, NT>(q_s, qb, p.q_st, p.q_sh, hkv * p.g, p.T, r0, rows);
  load_rows<T, D, RQ, NT>(do_s, ob, p.o_st, p.o_sh, hkv * p.g, p.T, r0, rows);

  // keys the tile's rows can see (all keys when it spans two heads)
  int t_lo = 0, t_hi = p.T - 1;
  if (r0 / p.T == r_last / p.T) {
    t_lo = r0 % p.T;
    t_hi = r_last % p.T;
  }
  int k_begin = 0, k_end = p.T;
  if (p.causal) k_end = min(k_end, t_hi + p.shift + 1);
  if (p.window >= 0) k_begin = max(k_begin, t_lo + p.shift - p.window + 1);
  // an empty range (a chunk in the causal future, or wholly behind the
  // window) visits no tile: dq is written as zeros
  const int j_first = k_begin < k_end ? (k_begin / BK) * BK : k_end;

  float dq_acc[RPO];
#pragma unroll
  for (int i = 0; i < RPO; ++i) dq_acc[i] = 0.f;
  const int od = tid % D;
  const int ocg = tid / D;

  for (int j0 = j_first; j0 < k_end; j0 += BK) {
    __syncthreads();  // previous tile consumed; q/do/row state ready
    load_rows<T, D, BK, NT>(k_s, kb, p.k_st, p.k_sh, hkv, p.T, j0, p.T);
    load_rows<T, D, BK, NT>(v_s, vb, p.v_st, p.v_sh, hkv, p.T, j0, p.T);
    if (tid < BK) {
      const int key = j0 + tid;
      ktag_s[tid] = (p.k_tag && key < p.T) ? p.k_tag[(long long)b * p.T + key]
                                           : 1;
    }
    __syncthreads();

    // ---- s = q.k*scale, dp = do.v; ds = exp(s - lse) * (dp - delta) * scale
    {
      const int jj = tid % BK;
      const int rg = tid / BK;
      float acc_s[RPT], acc_p[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) { acc_s[i] = 0.f; acc_p[i] = 0.f; }
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[jj * DP + d]);
        const float4 v4 = *reinterpret_cast<const float4*>(&v_s[jj * DP + d]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int rr = rg + i * NRG;
          const float4 q4 = *reinterpret_cast<const float4*>(&q_s[rr * DP + d]);
          const float4 o4 = *reinterpret_cast<const float4*>(&do_s[rr * DP + d]);
          acc_s[i] = fmaf(q4.x, k4.x, acc_s[i]);
          acc_s[i] = fmaf(q4.y, k4.y, acc_s[i]);
          acc_s[i] = fmaf(q4.z, k4.z, acc_s[i]);
          acc_s[i] = fmaf(q4.w, k4.w, acc_s[i]);
          acc_p[i] = fmaf(o4.x, v4.x, acc_p[i]);
          acc_p[i] = fmaf(o4.y, v4.y, acc_p[i]);
          acc_p[i] = fmaf(o4.z, v4.z, acc_p[i]);
          acc_p[i] = fmaf(o4.w, v4.w, acc_p[i]);
        }
      }
      const int key = j0 + jj;
      const int ktag = ktag_s[jj];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int rr = rg + i * NRG;
        const bool ok = visible(p, key, rpos_s[rr], rtag_s[rr], ktag);
        const float s = ok ? acc_s[i] * p.scale : NEG_BIG;
        const float pr = expf(s - lse_s[rr]);
        ds_s[rr * SP + jj] = pr * (acc_p[i] - dl_s[rr]) * p.scale;
      }
    }
    __syncthreads();

    // ---- dq += ds . k -------------------------------------------------------
#pragma unroll 2
    for (int jj = 0; jj < BK; jj += 4) {
      const float k0 = k_s[(jj + 0) * DP + od];
      const float k1 = k_s[(jj + 1) * DP + od];
      const float k2 = k_s[(jj + 2) * DP + od];
      const float k3 = k_s[(jj + 3) * DP + od];
#pragma unroll
      for (int i = 0; i < RPO; ++i) {
        const float4 d4 = *reinterpret_cast<const float4*>(
            &ds_s[(ocg + i * NCG) * SP + jj]);
        dq_acc[i] = fmaf(d4.x, k0, dq_acc[i]);
        dq_acc[i] = fmaf(d4.y, k1, dq_acc[i]);
        dq_acc[i] = fmaf(d4.z, k2, dq_acc[i]);
        dq_acc[i] = fmaf(d4.w, k3, dq_acc[i]);
      }
    }
  }

  T* dqg = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < RPO; ++i) {
    const int r = r0 + ocg + i * NCG;
    if (r >= rows) continue;
    const int t = r % p.T;
    const int hq = hkv * p.g + r / p.T;
    store_out(&dqg[(((long long)b * p.T + t) * p.Hq + hq) * D + od], dq_acc[i]);
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v [BK][D+4]; q, do [RQ][D+4]; p^T, ds^T [BK][RQ+4]; lse, delta [RQ];
  // row pos, row tag [RQ]; key tag [BK]
  return sizeof(float) * (size_t)(2 * BWD_BK * (D + 4) + 2 * BWD_RQ * (D + 4) +
                                  2 * BWD_BK * (BWD_RQ + 4) + 2 * BWD_RQ) +
         sizeof(int) * (size_t)(2 * BWD_RQ + BWD_BK);
}

// grid: x = tile of keys, y = b * Hkv + kv head. FUSED adds ds . k of every
// visited query tile into p.dq_acc in ascending key-tile order, takes its
// (kv head, key tile) from a ticket, and visits the query tiles latest
// position first (the design notes above); the split kernel keeps blockIdx
// and the ascending order, head by head.
template <typename T, int D, bool FUSED>
__global__ void __launch_bounds__(BWD_NT) bwd_dkv_kernel(const BwdParams p) {
  constexpr int RQ = BWD_RQ, BK = BWD_BK, NT = BWD_NT;
  constexpr int DP = D + 4, PP = RQ + 4;
  constexpr int NRG = NT / BK, RPT = RQ / NRG;  // score phase
  constexpr int NCG = NT / D;
  constexpr int KPT = BK / NCG;                 // keys per thread (dk, dv)
  constexpr int QPT = RQ / NCG;                 // rows per thread (fused dq)
  static_assert(NT % BK == 0 && RQ % NRG == 0, "score phase tiling");
  static_assert(NT % D == 0 && BK % NCG == 0 && QPT % 4 == 0, "dkv tiling");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = k_s + BK * DP;
  float* q_s = v_s + BK * DP;
  float* do_s = q_s + RQ * DP;
  float* pt_s = do_s + RQ * DP;   // p^T  [BK][RQ+4]
  float* dst_s = pt_s + BK * PP;  // ds^T [BK][RQ+4]
  float* lse_s = dst_s + BK * PP;
  float* dl_s = lse_s + RQ;
  int* rpos_s = reinterpret_cast<int*>(dl_s + RQ);
  int* rtag_s = rpos_s + RQ;
  int* ktag_s = rtag_s + RQ;

  const int tid = threadIdx.x;
  int jt = blockIdx.x, grp = blockIdx.y;
  if constexpr (FUSED) {
    const int2 tk = fused_ticket(p);
    jt = tk.x;
    grp = tk.y;
  }
  const int b = grp / p.Hkv;
  const int hkv = grp % p.Hkv;
  const long long bs = grp;
  const int rows = p.g * p.T;
  const int j0 = jt * BK;
  const int j_last = min(j0 + BK, p.T) - 1;

  const T* qb = static_cast<const T*>(p.q) + (long long)b * p.q_sb;
  const T* ob = static_cast<const T*>(p.dout) + (long long)b * p.o_sb;
  const T* kb = static_cast<const T*>(p.k) + (long long)b * p.k_sb;
  const T* vb = static_cast<const T*>(p.v) + (long long)b * p.v_sb;

  load_rows<T, D, BK, NT>(k_s, kb, p.k_st, p.k_sh, hkv, p.T, j0, p.T);
  load_rows<T, D, BK, NT>(v_s, vb, p.v_st, p.v_sh, hkv, p.T, j0, p.T);
  if (tid < BK) {
    const int key = j0 + tid;
    ktag_s[tid] = (p.k_tag && key < p.T) ? p.k_tag[(long long)b * p.T + key] : 1;
  }

  // query tokens that can see a key of this tile: key j is visible to
  // token i when j <= i + shift (causal) and j > i + shift - window
  const int i_begin = p.causal ? min(max(j0 - p.shift, 0), p.T) : 0;
  const int i_end =
      p.window >= 0 ? min(max(j_last + p.window - p.shift, 0), p.T) : p.T;
  // an empty range visits no query tile: dk and dv are written as zeros
  const int i_first = i_begin < i_end ? (i_begin / RQ) * RQ : i_end;

  float dk_acc[KPT], dv_acc[KPT];
#pragma unroll
  for (int m = 0; m < KPT; ++m) { dk_acc[m] = 0.f; dv_acc[m] = 0.f; }
  const int od = tid % D;
  const int cg = tid / D;  // this thread's keys: cg*KPT ...; rows: cg*QPT ...

  const int n_qt = (i_end - i_first + RQ - 1) / RQ;  // per query head
  for (int n = 0; n < p.g * n_qt; ++n) {
    int ig, i0;
    if constexpr (FUSED) {
      ig = n % p.g;
      i0 = i_first + (n_qt - 1 - n / p.g) * RQ;
    } else {
      ig = n / n_qt;
      i0 = i_first + (n % n_qt) * RQ;
    }
    const int hq = hkv * p.g + ig;
    __syncthreads();  // previous q tile consumed (and k/v tiles ready)
    load_rows<T, D, RQ, NT>(q_s, qb, p.q_st, p.q_sh, hq, p.T, i0, p.T);
    load_rows<T, D, RQ, NT>(do_s, ob, p.o_st, p.o_sh, hq, p.T, i0, p.T);
    if (tid < RQ) {
      const int i = i0 + tid;
      const bool ok = i < p.T;
      rpos_s[tid] = ok ? i + p.shift : ROW_INVALID;
      rtag_s[tid] = (ok && p.q_tag) ? p.q_tag[(long long)b * p.T + i] : 1;
      lse_s[tid] = ok ? p.lse[bs * rows + ig * p.T + i] : 0.f;
      dl_s[tid] = ok ? p.delta[bs * rows + ig * p.T + i] : 0.f;
    }
    __syncthreads();

    // ---- p^T and ds^T of the [RQ, BK] tile ------------------------------
    {
      const int jj = tid % BK;
      const int rg = tid / BK;
      float acc_s[RPT], acc_p[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) { acc_s[i] = 0.f; acc_p[i] = 0.f; }
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[jj * DP + d]);
        const float4 v4 = *reinterpret_cast<const float4*>(&v_s[jj * DP + d]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int rr = rg + i * NRG;
          const float4 q4 =
              *reinterpret_cast<const float4*>(&q_s[rr * DP + d]);
          const float4 o4 =
              *reinterpret_cast<const float4*>(&do_s[rr * DP + d]);
          acc_s[i] = fmaf(q4.x, k4.x, acc_s[i]);
          acc_s[i] = fmaf(q4.y, k4.y, acc_s[i]);
          acc_s[i] = fmaf(q4.z, k4.z, acc_s[i]);
          acc_s[i] = fmaf(q4.w, k4.w, acc_s[i]);
          acc_p[i] = fmaf(o4.x, v4.x, acc_p[i]);
          acc_p[i] = fmaf(o4.y, v4.y, acc_p[i]);
          acc_p[i] = fmaf(o4.z, v4.z, acc_p[i]);
          acc_p[i] = fmaf(o4.w, v4.w, acc_p[i]);
        }
      }
      const int key = j0 + jj;
      const int ktag = ktag_s[jj];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int rr = rg + i * NRG;
        const bool ok = visible(p, key, rpos_s[rr], rtag_s[rr], ktag);
        const float s = ok ? acc_s[i] * p.scale : NEG_BIG;
        const float pr = expf(s - lse_s[rr]);
        pt_s[jj * PP + rr] = pr;
        dst_s[jj * PP + rr] = pr * (acc_p[i] - dl_s[rr]) * p.scale;
      }
    }
    __syncthreads();

    // ---- dv += p^T . do, dk += ds^T . q ---------------------------------
#pragma unroll 2
    for (int rr = 0; rr < RQ; rr += 4) {
      float o[4], q[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        o[c] = do_s[(rr + c) * DP + od];
        q[c] = q_s[(rr + c) * DP + od];
      }
#pragma unroll
      for (int m = 0; m < KPT; ++m) {
        const int jj = cg * KPT + m;
        const float4 p4 = *reinterpret_cast<const float4*>(&pt_s[jj * PP + rr]);
        const float4 d4 =
            *reinterpret_cast<const float4*>(&dst_s[jj * PP + rr]);
        dv_acc[m] = fmaf(p4.x, o[0], dv_acc[m]);
        dv_acc[m] = fmaf(p4.y, o[1], dv_acc[m]);
        dv_acc[m] = fmaf(p4.z, o[2], dv_acc[m]);
        dv_acc[m] = fmaf(p4.w, o[3], dv_acc[m]);
        dk_acc[m] = fmaf(d4.x, q[0], dk_acc[m]);
        dk_acc[m] = fmaf(d4.y, q[1], dk_acc[m]);
        dk_acc[m] = fmaf(d4.z, q[2], dk_acc[m]);
        dk_acc[m] = fmaf(d4.w, q[3], dk_acc[m]);
      }
    }

    if constexpr (FUSED) {
      // ---- dq (rows cg*QPT ...) += ds . k, added into device memory ----
      float acc[QPT];
#pragma unroll
      for (int m = 0; m < QPT; ++m) acc[m] = 0.f;
      const int rq0 = cg * QPT;
#pragma unroll 2
      for (int jj = 0; jj < BK; ++jj) {
        const float kv = k_s[jj * DP + od];
#pragma unroll
        for (int m = 0; m < QPT; m += 4) {
          const float4 d4 =
              *reinterpret_cast<const float4*>(&dst_s[jj * PP + rq0 + m]);
          acc[m + 0] = fmaf(d4.x, kv, acc[m + 0]);
          acc[m + 1] = fmaf(d4.y, kv, acc[m + 1]);
          acc[m + 2] = fmaf(d4.z, kv, acc[m + 2]);
          acc[m + 3] = fmaf(d4.w, kv, acc[m + 3]);
        }
      }
      int* counter = fused_counter(p, b, hq, i0);
      const int turn = jt - first_key_tile_of(p, i0);
      const long long row_stride = (long long)p.Hq * D;
      float* dq_col =
          p.dq_acc + ((long long)b * p.T + i0 + rq0) * row_stride + hq * D + od;
      wait_turn(counter, turn);
#pragma unroll
      for (int m = 0; m < QPT; ++m)
        if (i0 + rq0 + m < p.T) acc[m] += __ldcg(dq_col + m * row_stride);
#pragma unroll
      for (int m = 0; m < QPT; ++m)
        if (i0 + rq0 + m < p.T) __stcg(dq_col + m * row_stride, acc[m]);
      pass_turn(counter, turn);
    }
  }

  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
#pragma unroll
  for (int m = 0; m < KPT; ++m) {
    const int key = j0 + cg * KPT + m;
    if (key >= p.T) continue;
    const long long off = (((long long)b * p.T + key) * p.Hkv + hkv) * D + od;
    store_out(&dkg[off], dk_acc[m]);
    store_out(&dvg[off], dv_acc[m]);
  }
}

}  // namespace
}  // namespace d9d

// kernels 0, 1 and 2 for bfloat16 (tensor cores); they use BwdParams,
// visible(), the fused kernels' turnstile and the tile constants above
#include "flash_bwd_mma.cuh"
#include "flash_bwd_fused_mma.cuh"

namespace d9d {
namespace {

template <typename Kernel>
cudaError_t launch_cuda_cores(Kernel fn, size_t smem, int rows,
                              const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + BWD_RQ - 1) / BWD_RQ, p.B * p.Hkv);
  fn<<<grid, BWD_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// bf16 takes the tensor-core kernels, fp32 the CUDA-core ones; the dtype
// alone decides (no other path exists for them)
template <typename T, int D>
cudaError_t launch_bwd(const BwdParams& p, int kernel, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (kernel == 2) return launch_bwd_fused_mma<D>(p, stream);
    return launch_bwd_mma<D>(p, kernel, stream);
  } else {
    if (kernel == 2)
      return launch_cuda_cores(bwd_dkv_kernel<T, D, true>, dkv_smem_bytes<D>(),
                               p.T, p, stream);
    if (kernel == 0)
      return launch_cuda_cores(bwd_dq_kernel<T, D>, dq_smem_bytes<D>(),
                               p.g * p.T, p, stream);
    return launch_cuda_cores(bwd_dkv_kernel<T, D, false>, dkv_smem_bytes<D>(),
                             p.T, p, stream);
  }
}

template <typename T>
cudaError_t dispatch_bwd(const BwdParams& p, int D, int kernel,
                         cudaStream_t stream) {
  if (D == 128) return launch_bwd<T, 128>(p, kernel, stream);
  if (D == 64) return launch_bwd<T, 64>(p, kernel, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace d9d

using d9d::BwdParams;

// kernel: 0 = dq (writes dq in the inputs' dtype), 1 = dk/dv, 2 = fused
// (dk/dv, and dq added into the zeroed fp32 buffer `dq` in ascending key-tile
// order through `dq_turnstile`, a zeroed int32 buffer of B * Hq *
// ceil(T / 64) + 1 elements; null for kernels 0 and 1). dtype: 0 =
// float32, 1 = bfloat16. Input strides are in elements with a contiguous
// head_dim: q/do [B, T, Hq, D]-addressed, k/v [B, T, Hkv, D]-addressed.
// Outputs are contiguous: dq [B, T, Hq, D], dk/dv [B, T, Hkv, D]. lse and
// delta are contiguous [B, Hq, T] fp32, q_seg/kv_seg contiguous int32 [B, T]
// or both null; shift = q_offset - k_offset (0 for ordinary training).
// Launches on `stream`, allocates nothing, never synchronizes.
extern "C" int d9d_flash_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* q_seg, const void* kv_seg,
    void* dq, void* dk, void* dv, void* dq_turnstile,
    int B, int T, int Hq, int Hkv, int D, int dtype, int kernel,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    float scale, int causal, int window, int shift, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || kernel < 0 ||
      kernel > 2 || (kernel == 2 && dq_turnstile == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  BwdParams p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.q_tag = static_cast<const int*>(q_seg);
  p.k_tag = static_cast<const int*>(kv_seg);
  p.dq = kernel == 0 ? dq : nullptr;
  p.dq_acc = kernel == 2 ? static_cast<float*>(dq) : nullptr;
  p.turnstile = kernel == 2 ? static_cast<int*>(dq_turnstile) : nullptr;
  p.n_counters = B * Hq * ((T + d9d::BWD_RQ - 1) / d9d::BWD_RQ);
  p.dk = dk; p.dv = dv;
  p.B = B; p.T = T; p.Hq = Hq; p.Hkv = Hkv; p.g = Hq / Hkv;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.scale = scale; p.causal = causal; p.window = window; p.shift = shift;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? d9d::dispatch_bwd<float>(p, D, kernel, s)
                  : dtype == 1 ? d9d::dispatch_bwd<__nv_bfloat16>(p, D, kernel, s)
                               : cudaErrorInvalidValue;
  return (int)err;
}
