// The bfloat16 decode core designed for the H100 (sm_90a): one launch per
// call, key tiles kept in flight by cp.async, and each row's visible keys
// split across the blocks of a thread-block cluster, merged through
// distributed shared memory in a fixed order. Included by flash_decode.cu.
//
// Replaces, for bf16, d9d_tpu/ops/attention/pallas_decode.py
// `_decode_kernel` (the `pallas_call` at :290) where the GQA group has at
// most 16 query rows per kv head (g * T <= 16: every serving step), and
// `_paged_decode_kernel` (the `pallas_call` at :252) for any T, with bf16
// or int8 pools. It computes what they compute: slot-causal attention of
// the g*T rows r = ig*T + i of one kv head over the cache, the optional
// window, the optional key validity, int8 pools dequantised by per-slot
// fp32 scales, (o, lse) out, and a row that sees no key written as exact
// zeros with lse = -1e30 + log(1e-30).
//
// Bound on this card: bytes. A step reads each visible cache slot once for
// the whole group (4*g flops per element read, far below the ridge).
// What the design does about it:
//
// - one cluster of n blocks (n = 1, 2, 4 or 8, chosen by the wrapper from
//   the shapes and the clusters the card holds at once, so that a launch
//   runs in one wave) per (batch row, kv head, 16-row tile); each block
//   reads the row's write index itself and takes its share of the row's own
//   visible range [window floor, start + T) in whole 64-key tiles, so no
//   block is launched for keys past the write index;
// - the four warps of a block split every 64-key tile into quarters of 16
//   keys: warp w copies keys [16w, 16w + 16) of each tile with cp.async
//   (16 B a lane, in their stored type: bf16, or int8 for int8 pools) into
//   its own slots of an NST-stage ring and is their only reader, so a warp
//   waits on its own copy groups and never on another warp: there is no
//   block barrier in the key loop, and NST - 1 tiles stay in flight while
//   one is used;
// - each warp keeps its own online softmax (m, l, o) over its quarters; at
//   the end the block merges its four warps in the order 0..3 and the
//   cluster merges its blocks in the order 0..n-1 through distributed
//   shared memory (each block writes one slice of head_dim), so there is no
//   partial-output scratch, no second kernel, and two runs give the same
//   bits;
// - paged pools: the page ids of a quarter (one int a key) are copied into
//   the ring a stage ahead of the quarter's rows, so a row copy never waits
//   on a table read; with the pools' slot stride D, a page's keys are
//   contiguous rows, so a warp's 32 lanes copy 512 contiguous bytes per
//   instruction; the per-slot scales of int8 pools and the key validity
//   flags ride with the rows (4-byte copies);
// - products on the tensor cores, mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate), with the g*T rows as M padded to 16; p is rounded to bf16
//   once before p.v (the bf16 decode rule of chip_smoke.py allows it);
// - a quarter that every row of the tile sees whole, with every key valid,
//   skips the mask and the gate of p, and a warp whose rows kept their
//   maxima skips the rescale of o (o * 1 is o);
// - int8 pools: int8 values are exact in bf16, so q.k and p.v multiply them
//   as they are; the k scale multiplies the key's score and the v scale
//   multiplies p before p is rounded for p.v: one multiply per key, not one
//   per element. The int8 fragments are built from 4-byte shared-memory
//   reads: head_dim is permuted consistently between q and k (and between
//   the output columns and v), which changes no sum;
// - logits are scaled by scale * log2(e) so the softmax runs on exp2f, and
//   lse = m * ln(2) + log(l).
#pragma once

#include <cooperative_groups.h>

#include "attn_mma.cuh"

namespace d9d {

constexpr int DEC_BM = 16;           // query rows of a cluster (mma M)
constexpr int DEC_BN = 64;           // keys per tile
constexpr int DEC_NW = 4;            // warps; warp w takes keys [16w, 16w+16)
constexpr int DEC_NT = 32 * DEC_NW;
constexpr int DEC_WK = DEC_BN / DEC_NW;  // keys per warp and tile
constexpr int DEC_MAX_CLUSTER = 8;
constexpr float DEC_LOG2E = 1.4426950408889634f;
constexpr float DEC_LN2 = 0.6931471805599453f;

struct DecodeParams {
  const void* q;
  const void* k;         // cache [B, Hkv, S, D] or pool [P, Hkv, ps, D]
  const void* v;
  void* o;
  float* lse;            // [B, Hq, T] fp32
  const int* offsets;    // write index of batch row b at offsets[b * offsets_stride]
  long long offsets_stride;  // 0: one index shared by every row
  const void* kv_valid;  // [B, S] key validity (nonzero = valid), or null
  int kv_valid_bytes;    // 1 (bool) or 4 (int32)
  long long kv_valid_sb; // row stride of kv_valid, in elements
  const int* page_table; // paged: [B, row_pages] int32 pool page ids
  int page_size;
  int page_shift;        // log2(page_size) when a power of two, else -1
  int row_pages;
  const float* k_scale;  // int8 pools: [P, Hkv, page_size] fp32
  const float* v_scale;
  int B, T, Hq, Hkv, S, g;
  long long q_sb, q_st, q_sh;  // element strides: batch, token, head
  long long k_sb, k_sh, k_ss;  // batch (paged: page), head, slot
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_st, o_sh;
  float scale;
  int window;            // -1 = none
};

// ring stages: a warp has NST - 1 quarters in flight while it uses one
template <typename KV> struct DecodeStages { static constexpr int N = 3; };
template <> struct DecodeStages<int8_t> { static constexpr int N = 4; };

template <int D, typename KV>
struct DecodeLayout {
  static constexpr int NST = DecodeStages<KV>::N;
  static constexpr bool I8 = std::is_same<KV, int8_t>::value;
  static constexpr int ROWB = D * (int)sizeof(KV);  // bytes of a key row
  static constexpr int PITCH = ROWB + 16;           // padded shared row
  static constexpr int CH = ROWB / 16;              // 16-byte chunks a row
  static constexpr int QB = DEC_WK * PITCH;         // a warp's quarter of k
  // a warp's slot of one stage: its k and v quarters, then the quarter's
  // pool page ids, key validity flags and (int8 pools) k and v scales
  static constexpr int IDS = 2 * QB;
  static constexpr int FLAGS = IDS + 4 * DEC_WK;
  static constexpr int SCALES = FLAGS + 4 * DEC_WK;
  static constexpr int WSLOT = SCALES + (I8 ? 2 * DEC_WK * 4 : 0);
  static constexpr int RING = NST * DEC_NW * WSLOT;
  static constexpr int OP = D + 4;                  // merge row pitch, floats
  // merge area (over the ring): the warps' (o, m, l), the block's (o, m, l),
  // the cluster's weights per block and row
  static constexpr int MERGE =
      4 * (DEC_NW * DEC_BM * OP + 2 * DEC_NW * DEC_BM + DEC_BM * OP +
           2 * DEC_BM + DEC_MAX_CLUSTER * DEC_BM + 2 * DEC_BM);
  static constexpr int SMEM = RING > MERGE ? RING : MERGE;
  static_assert(CH % 2 == 0 && (DEC_WK * CH) % 32 == 0, "copy tiling");
  static_assert(D % 32 == 0, "head_dim a multiple of 32");
};

// Signed int8 to bf16 on the full-rate units, exactly (the integer
// conversion units run at a quarter of the rate): with wx = w ^ 0x80808080,
// byte e of wx is x + 128, so the fp32 with bits 0x4B0000xx is 2^23 + x + 128
// and one subtraction leaves x; an integer of at most 8 significant bits is
// a bf16 value, the upper half of its fp32 bits.
__device__ __forceinline__ uint32_t i8_f32_bits(uint32_t wx, int e) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7440u | e)) -
      8388736.f);
}
// (byte e_lo of wx_lo, byte e_hi of wx_hi) as a bf16 pair, low half first
__device__ __forceinline__ uint32_t i8pair_bf16(uint32_t wx_lo, int e_lo,
                                                uint32_t wx_hi, int e_hi) {
  return __byte_perm(i8_f32_bits(wx_lo, e_lo), i8_f32_bits(wx_hi, e_hi),
                     0x7632u);
}
constexpr uint32_t I8_BIAS = 0x80808080u;

__device__ __forceinline__ void cp_async_4(void* smem_ptr, const void* gptr,
                                           bool valid) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(gptr), "r"(src_bytes));
}

// 4 bytes global -> shared of which the first `bytes` (0..4) are read and
// the rest zero-filled
__device__ __forceinline__ void cp_async_4_partial(void* smem_ptr,
                                                   const void* gptr,
                                                   int bytes) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(gptr), "r"(bytes));
}

// grid: x = row tile * n + rank in the cluster, y = b * Hkv + kv head;
// cluster (n, 1, 1)
template <int D, typename KV, bool PAGED>
__global__ void __launch_bounds__(DEC_NT, 2)
    attn_decode_sm90_kernel(const DecodeParams p) {
  namespace cg = cooperative_groups;
  using bf16 = __nv_bfloat16;
  using L = DecodeLayout<D, KV>;
  constexpr int NST = L::NST, PITCH = L::PITCH, CH = L::CH;
  constexpr bool I8 = L::I8;
  constexpr int EPC = 16 / (int)sizeof(KV);  // elements per 16-byte chunk
  constexpr int NDT = D / 8;                 // output n-tiles
  constexpr int NCP = DEC_WK * CH / 32;      // chunks a lane copies per tensor
  static_assert(PAGED || !I8, "int8 k/v are paged only");

  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int b = blockIdx.y / p.Hkv;
  const int hkv = blockIdx.y % p.Hkv;
  const int rows = p.g * p.T;
  const int r0 = (blockIdx.x / n) * DEC_BM;
  const int r_last = min(r0 + DEC_BM, rows) - 1;

  // ---- q as A fragments, straight from global memory, issued before the
  // write index is read so that the two trips overlap. bf16 pools: logical
  // k-step column c is head_dim kk*16 + c; int8 pools: columns 2tig, 2tig+1,
  // 2tig+8, 2tig+9 are head_dim kk*16 + 4tig + 0..3, the order in which a
  // 4-byte read of an int8 key row yields them
  uint32_t qf[D / 16][4];
  {
    const bf16* qg = static_cast<const bf16*>(p.q) + (long long)b * p.q_sb;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + gid + 8 * h;
      const bool ok = r < rows;
      const bf16* qr = qg + (ok ? (long long)(r % p.T) * p.q_st +
                                      (long long)(hkv * p.g + r / p.T) * p.q_sh
                                : 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c0 = I8 ? kk * 16 + 4 * tig : kk * 16 + 2 * tig;
        const int c1 = I8 ? c0 + 2 : c0 + 8;
        qf[kk][h] = ok ? *reinterpret_cast<const uint32_t*>(qr + c0) : 0u;
        qf[kk][2 + h] = ok ? *reinterpret_cast<const uint32_t*>(qr + c1) : 0u;
      }
    }
  }
  const int base = p.offsets[(long long)b * p.offsets_stride];

  // ---- the two rows this thread holds fragments of ------------------------
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + gid + 8 * h;
    qpos[h] = r < rows ? base + r % p.T : ROW_INVALID;
  }

  // ---- this block's share of the rows' visible keys, in whole tiles --------
  int t_lo = 0, t_hi = p.T - 1;
  if (r0 / p.T == r_last / p.T) {
    t_lo = r0 % p.T;
    t_hi = r_last % p.T;
  }
  const int q_first = base + t_lo;  // the tile's rows sit at [q_first, q_last]
  const int q_last = base + t_hi;
  const int k_end = min(p.S, base + t_hi + 1);
  const int k_begin = p.window >= 0 ? max(0, base + t_lo - p.window + 1) : 0;
  int tile_lo = 0, n_tiles = 0;
  if (k_begin < k_end) {
    const int first = k_begin / DEC_BN;
    const int count = (k_end + DEC_BN - 1) / DEC_BN - first;
    tile_lo = first + (int)((long long)count * rank / n);
    n_tiles = first + (int)((long long)count * (rank + 1) / n) - tile_lo;
  }

  const KV* kg = static_cast<const KV*>(p.k) +
                 (PAGED ? (long long)hkv * p.k_sh
                        : (long long)b * p.k_sb + (long long)hkv * p.k_sh);
  const KV* vg = static_cast<const KV*>(p.v) +
                 (PAGED ? (long long)hkv * p.v_sh
                        : (long long)b * p.v_sb + (long long)hkv * p.v_sh);
  const int* table = PAGED ? p.page_table + (long long)b * p.row_pages : nullptr;
  const unsigned char* valid_row =
      p.kv_valid == nullptr
          ? nullptr
          : static_cast<const unsigned char*>(p.kv_valid) +
                (long long)b * p.kv_valid_sb * p.kv_valid_bytes;

  // a warp's slot of ring stage st: k rows, v rows, then its meta data
  auto slot_of = [&](int st) { return smem + (st * DEC_NW + warp) * L::WSLOT; };
  // first key of this warp's quarter of local tile i
  auto quarter = [&](int i) { return (tile_lo + i) * DEC_BN + warp * DEC_WK; };

  // paged: the pool page ids of the quarter of local tile i (one int per
  // key, lanes 0-15) into the meta of ring slot i % NST. They ride with the
  // copies of tile i - NST + 1, so they have landed when tile i is staged.
  auto copy_ids = [&](int i) {
    if constexpr (PAGED) {
      const int key = min(quarter(i) + lane, p.S - 1);
      if (lane < DEC_WK && i < n_tiles)
        cp_async_4(slot_of(i % NST) + L::IDS + 4 * lane,
                   table + (p.page_shift >= 0 ? key >> p.page_shift
                                              : key / p.page_size),
                   true);
    }
  };

  // stage the quarter of local tile i into ring slot i % NST: k and v rows
  // (16 B a lane, rows past the end zero-filled), the key validity and the
  // int8 scales, all in this warp's own copy group
  auto issue = [&](int i) {
    unsigned char* k_dst = slot_of(i % NST);
    unsigned char* v_dst = k_dst + L::QB;
    const int key0 = quarter(i);
    const int* ids = reinterpret_cast<const int*>(k_dst + L::IDS);
#pragma unroll
    for (int c = 0; c < NCP; ++c) {
      const int idx = lane + 32 * c;
      const int jj = idx / CH;
      const int ch = idx % CH;
      const int key = key0 + jj;
      const bool valid = key < p.S;
      long long ko, vo;
      if constexpr (PAGED) {
        const int pg = ids[jj];
        const int sl = p.page_shift >= 0 ? key & (p.page_size - 1)
                                         : key % p.page_size;
        ko = (long long)pg * p.k_sb + (long long)sl * p.k_ss;
        vo = (long long)pg * p.v_sb + (long long)sl * p.v_ss;
      } else {
        ko = (long long)(valid ? key : 0) * p.k_ss;
        vo = (long long)(valid ? key : 0) * p.v_ss;
      }
      cp_async_16(k_dst + jj * PITCH + ch * 16, kg + ko + ch * EPC, valid);
      cp_async_16(v_dst + jj * PITCH + ch * 16, vg + vo + ch * EPC, valid);
    }
    if constexpr (I8) {
      // lanes 0-15: k scales of keys 0-15, lanes 16-31: their v scales
      const int jj = lane & 15;
      const bool valid = key0 + jj < p.S;
      const int sl = p.page_shift >= 0 ? (key0 + jj) & (p.page_size - 1)
                                       : (key0 + jj) % p.page_size;
      const long long si = ((long long)ids[jj] * p.Hkv + hkv) * p.page_size + sl;
      cp_async_4(k_dst + L::SCALES + 4 * lane,
                 (lane < 16 ? p.k_scale : p.v_scale) + (valid ? si : 0),
                 valid);
    }
    if (valid_row != nullptr) {
      // 4-byte copies: 16 int32 flags (lanes 0-15) or 16 bool flags (lanes
      // 0-3); the part past the row's end is zero-filled
      const int per = 4 / p.kv_valid_bytes;  // flags per copy
      const int key = key0 + lane * per;
      if (lane < DEC_WK / per) {
        const int left = min(max(p.S - key, 0), per) * p.kv_valid_bytes;
        cp_async_4_partial(k_dst + L::FLAGS + 4 * lane,
                           valid_row + (long long)(left > 0 ? key : 0) *
                                           p.kv_valid_bytes,
                           left);
      }
    }
  };

  // ---- prologue: NST - 1 quarters in flight ----------------------------------
  {
#pragma unroll
    for (int s = 0; s < NST - 1; ++s) copy_ids(s);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int s = 0; s < NST - 1; ++s) {
      if (s < n_tiles) issue(s);
      copy_ids(s + NST - 1);
      cp_async_commit();  // one group per tile, empty or not
      __syncwarp();       // the ids just read are overwritten next
    }
  }

  const float scale_log2 = p.scale * DEC_LOG2E;
  float m_run[2] = {NEG_BIG, NEG_BIG};
  float l_run[2] = {0.f, 0.f};
  float o_acc[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[dt][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<NST - 2>();  // this warp's quarter of tile i has landed,
    __syncwarp();              // for every lane; the slot refilled below was
                               // read by every lane in the last iteration
    if (i + NST - 1 < n_tiles) issue(i + NST - 1);
    copy_ids(i + 2 * NST - 2);
    cp_async_commit();

    const unsigned char* k_s = slot_of(i % NST);
    const unsigned char* v_s = k_s + L::QB;
    const float* sc_s = reinterpret_cast<const float*>(k_s + L::SCALES);
    const unsigned char* fl_s = k_s + L::FLAGS;
    const int key0 = quarter(i);

    // ---- s = q . k^T: 16 rows x 16 keys --------------------------------------
    // A warp's fragments are all read before its products, and the value
    // fragments before the softmax: the asm statements keep their order, so
    // a read placed between products would wait behind them, with one or two
    // warps per scheduler to hide it. The k-steps sum in two chains (even
    // and odd), halving the products' dependent latency.
    float s[2][4], s_odd[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s_odd[nt][e] = 0.f;
    uint32_t vf_reg[I8 ? D / 32 : NDT / 2][4];
    if constexpr (I8) {
      uint32_t kw[D / 16][2];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          kw[kk][nt] = I8_BIAS ^ *reinterpret_cast<const uint32_t*>(
              k_s + (nt * 8 + gid) * PITCH + kk * 16 + 4 * tig);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float(&acc)[4] = (kk & 1) ? s_odd[nt] : s[nt];
          mma_bf16_16816(acc, qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                         i8pair_bf16(kw[kk][nt], 0, kw[kk][nt], 1),
                         i8pair_bf16(kw[kk][nt], 2, kw[kk][nt], 3));
        }
      }
      // value words: a 4-byte read of a value row at head_dim 32a + 4gid
      // serves four output n-tiles (see the products below)
#pragma unroll
      for (int a = 0; a < D / 32; ++a) {
        const unsigned char* vp = v_s + 2 * tig * PITCH + 32 * a + 4 * gid;
        vf_reg[a][0] = I8_BIAS ^ *reinterpret_cast<const uint32_t*>(vp);
        vf_reg[a][1] = I8_BIAS ^ *reinterpret_cast<const uint32_t*>(vp + PITCH);
        vf_reg[a][2] =
            I8_BIAS ^ *reinterpret_cast<const uint32_t*>(vp + 8 * PITCH);
        vf_reg[a][3] =
            I8_BIAS ^ *reinterpret_cast<const uint32_t*>(vp + 9 * PITCH);
      }
    } else {
      // ldmatrix x4: keys 0-7 at columns +0..7 / +8..15, then keys 8-15
      const unsigned char* kf =
          k_s + ((lane >> 4) * 8 + (lane & 7)) * PITCH + ((lane >> 3) & 1) * 16;
      uint32_t kb[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(kb[kk][0], kb[kk][1], kb[kk][2], kb[kk][3], kf + kk * 32);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        float(&acc0)[4] = (kk & 1) ? s_odd[0] : s[0];
        float(&acc1)[4] = (kk & 1) ? s_odd[1] : s[1];
        mma_bf16_16816(acc0, qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                       kb[kk][0], kb[kk][1]);
        mma_bf16_16816(acc1, qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                       kb[kk][2], kb[kk][3]);
      }
      // ldmatrix x4 trans: keys 0-7 / 8-15 of columns dt*8.., then of
      // (dt+1)*8..: (b0, b1) of two output n-tiles
      const unsigned char* vf =
          v_s + (((lane >> 3) & 1) * 8 + (lane & 7)) * PITCH + (lane >> 4) * 16;
#pragma unroll
      for (int dt2 = 0; dt2 < NDT / 2; ++dt2)
        ldmatrix_x4_trans(vf_reg[dt2][0], vf_reg[dt2][1], vf_reg[dt2][2],
                          vf_reg[dt2][3], vf + dt2 * 32);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += s_odd[nt][e];

    // ---- mask, online softmax in log2 units ------------------------------------
    // element (nt, e): row gid + 8 * (e >> 1), key column nt*8 + 2tig + (e & 1).
    // A quarter every row of the tile sees whole skips the mask and the gate
    // of p (padding rows then carry finite values that are never written).
    bool whole = key0 + DEC_WK <= p.S && key0 + DEC_WK - 1 <= q_first &&
                 (p.window < 0 || key0 > q_last - p.window);
    if (valid_row != nullptr) {
      // ... and every key of the quarter is valid
      bool all_valid = true;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (e >> 1) * 8 + 2 * tig + (e & 1);
        all_valid = all_valid &&
                    (p.kv_valid_bytes == 1
                         ? fl_s[col] != 0
                         : reinterpret_cast<const int*>(fl_s)[col] != 0);
      }
      whole = __all_sync(0xffffffffu, whole && all_valid);
    }
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = nt * 8 + 2 * tig + (e & 1);
        float x = s[nt][e] * scale_log2;
        if constexpr (I8) x *= sc_s[col];
        if (!whole) {
          const int key = key0 + col;
          bool ok = key < p.S && key <= qpos[h] && qpos[h] != ROW_INVALID;
          if (valid_row != nullptr)
            ok = ok && (p.kv_valid_bytes == 1
                            ? fl_s[col] != 0
                            : reinterpret_cast<const int*>(fl_s)[col] != 0);
          if (p.window >= 0) ok = ok && key > qpos[h] - p.window;
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
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        // gated by the mask, not only by the sentinel: a row that has seen
        // no key keeps l = 0 (attn_tile.cuh)
        const float pv = (whole || s[nt][e] > MASKED_BELOW)
                             ? exp2f(s[nt][e] - m_run[h]) : 0.f;
        s[nt][e] = pv;
        sum[h] += pv;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l_run[h] = alpha[h] * l_run[h] + quad_sum(sum[h]);
    // no row of the warp raised its maximum: o * 1 is o, skip it
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        o_acc[dt][0] *= alpha[0];
        o_acc[dt][1] *= alpha[0];
        o_acc[dt][2] *= alpha[1];
        o_acc[dt][3] *= alpha[1];
      }
    }

    // ---- o += p . v, p (int8: p * v_scale) rounded to bf16 --------------------
    if constexpr (I8) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float s0 = sc_s[DEC_WK + nt * 8 + 2 * tig];
        const float s1 = sc_s[DEC_WK + nt * 8 + 2 * tig + 1];
        s[nt][0] *= s0;
        s[nt][1] *= s1;
        s[nt][2] *= s0;
        s[nt][3] *= s1;
      }
    }
    const uint32_t a0 = pack_bf16(s[0][0], s[0][1]);
    const uint32_t a1 = pack_bf16(s[0][2], s[0][3]);
    const uint32_t a2 = pack_bf16(s[1][0], s[1][1]);
    const uint32_t a3 = pack_bf16(s[1][2], s[1][3]);
    if constexpr (I8) {
      // output n-tile dt = 4a + e, column c holds head_dim 32a + 4c + e
#pragma unroll
      for (int a = 0; a < D / 32; ++a) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mma_bf16_16816(o_acc[4 * a + e], a0, a1, a2, a3,
                         i8pair_bf16(vf_reg[a][0], e, vf_reg[a][1], e),
                         i8pair_bf16(vf_reg[a][2], e, vf_reg[a][3], e));
        }
      }
    } else {
#pragma unroll
      for (int dt2 = 0; dt2 < NDT / 2; ++dt2) {
        mma_bf16_16816(o_acc[2 * dt2], a0, a1, a2, a3, vf_reg[dt2][0],
                       vf_reg[dt2][1]);
        mma_bf16_16816(o_acc[2 * dt2 + 1], a0, a1, a2, a3, vf_reg[dt2][2],
                       vf_reg[dt2][3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the merge area overlays it

  // ---- merge the warps, in the order 0..3 ------------------------------------
  // rows of D + 4 floats: 16-byte aligned, float4 reads and writes
  float* w_o = reinterpret_cast<float*>(smem);        // [NW][16][OP]
  float* w_m = w_o + DEC_NW * DEC_BM * L::OP;         // [NW][16]
  float* w_l = w_m + DEC_NW * DEC_BM;                 // [NW][16], then weights
  float* b_o = w_l + DEC_NW * DEC_BM;                 // [16][OP]  (read by the cluster)
  float* b_m = b_o + DEC_BM * L::OP;                  // [16]
  float* b_l = b_m + DEC_BM;                          // [16]
  float* c_w = b_l + DEC_BM;                          // [MAX_CLUSTER][16]
  float* c_m = c_w + DEC_MAX_CLUSTER * DEC_BM;        // [16]
  float* c_l = c_m + DEC_BM;                          // [16]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = gid + 8 * h;
    float* orow = w_o + (warp * DEC_BM + rr) * L::OP;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // the head_dim of output column 2tig + c of n-tile dt
        const int col = 2 * tig + c;
        const int d = I8 ? 32 * (dt >> 2) + 4 * col + (dt & 3) : dt * 8 + col;
        orow[d] = o_acc[dt][2 * h + c];
      }
    }
    if (tig == 0) {
      w_m[warp * DEC_BM + rr] = m_run[h];
      w_l[warp * DEC_BM + rr] = l_run[h];
    }
  }
  __syncthreads();
  if (tid < DEC_BM) {
    float m = NEG_BIG;
#pragma unroll
    for (int w = 0; w < DEC_NW; ++w) m = fmaxf(m, w_m[w * DEC_BM + tid]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_NW; ++w) {
      const float wt = exp2f(w_m[w * DEC_BM + tid] - m);
      l += w_l[w * DEC_BM + tid] * wt;
      w_m[w * DEC_BM + tid] = wt;  // from here on: the warp's weight
    }
    b_m[tid] = m;
    b_l[tid] = l;
  }
  __syncthreads();
  for (int idx = tid; idx < DEC_BM * D / 4; idx += DEC_NT) {
    const int rr = idx / (D / 4);
    const int d = (idx % (D / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < DEC_NW; ++w) {
      const float4 x =
          *reinterpret_cast<const float4*>(&w_o[(w * DEC_BM + rr) * L::OP + d]);
      const float wt = w_m[w * DEC_BM + rr];
      acc.x += x.x * wt;
      acc.y += x.y * wt;
      acc.z += x.z * wt;
      acc.w += x.w * wt;
    }
    *reinterpret_cast<float4*>(&b_o[rr * L::OP + d]) = acc;
  }

  // ---- merge the cluster's blocks, in the order 0..n-1 ----------------------
  // the remote reads of a thread are issued together (unrolled over the
  // largest cluster, predicated on n), then combined in order
  cluster.sync();  // every block's (o, m, l) is visible to the cluster
  if (tid < DEC_BM) {
    float mc[DEC_MAX_CLUSTER], lc[DEC_MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < DEC_MAX_CLUSTER; ++c) {
      mc[c] = c < n ? cluster.map_shared_rank(b_m, c)[tid] : NEG_BIG;
      lc[c] = c < n ? cluster.map_shared_rank(b_l, c)[tid] : 0.f;
    }
    float m = NEG_BIG;
#pragma unroll
    for (int c = 0; c < DEC_MAX_CLUSTER; ++c) m = fmaxf(m, mc[c]);
    float l = 0.f;
#pragma unroll
    for (int c = 0; c < DEC_MAX_CLUSTER; ++c) {
      if (c < n) {
        const float wt = exp2f(mc[c] - m);
        c_w[c * DEC_BM + tid] = wt;
        l += lc[c] * wt;
      }
    }
    c_m[tid] = m;
    c_l[tid] = l;
  }
  __syncthreads();
  const int dq = D / (4 * n);  // float4s of head_dim this block writes
  for (int idx = tid; idx < DEC_BM * dq; idx += DEC_NT) {
    const int rr = idx / dq;
    const int d = (rank * dq + idx % dq) * 4;
    const int r = r0 + rr;
    if (r >= rows) continue;
    float4 x[DEC_MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < DEC_MAX_CLUSTER; ++c)
      if (c < n)
        x[c] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(b_o, c) + rr * L::OP + d);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < DEC_MAX_CLUSTER; ++c) {
      if (c < n) {
        const float wt = c_w[c * DEC_BM + rr];
        acc.x += x[c].x * wt;
        acc.y += x[c].y * wt;
        acc.z += x[c].z * wt;
        acc.w += x[c].w * wt;
      }
    }
    const float l = c_l[rr];
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int t = r % p.T;
    const int hq = hkv * p.g + r / p.T;
    bf16* og = static_cast<bf16*>(p.o) + (long long)b * p.o_sb +
               (long long)t * p.o_st + (long long)hq * p.o_sh + d;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(og) = packed;
    if (rank == 0 && idx % dq == 0) {
      // a row that saw no key: m at the sentinel, l = 0 (attn_fwd_sm90.cuh)
      p.lse[(long long)blockIdx.y * rows + r] =
          l > 0.f ? c_m[rr] * DEC_LN2 + logf(l) : NEG_BIG + logf(1e-30f);
    }
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

// the attributes every launch of the kernel needs, once per device (host
// code; 64 devices at most)
template <int D, typename KV, bool PAGED>
inline cudaError_t prepare_attn_decode_sm90() {
  using L = DecodeLayout<D, KV>;
  auto kernel = attn_decode_sm90_kernel<D, KV, PAGED>;
  static unsigned long long ready = 0ull;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(ready >> dev & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready |= 1ull << dev;
  }
  return cudaSuccess;
}

inline cudaLaunchConfig_t decode_launch_config(dim3 grid, int smem, int n,
                                               cudaStream_t stream,
                                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(DEC_NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// how many clusters of n blocks the card holds at once (host code): a
// launch with more clusters runs in waves, each paying the launch, the
// first tile's trip and the merge again
template <int D, typename KV, bool PAGED>
inline cudaError_t max_clusters_attn_decode_sm90(int n, int* out) {
  cudaError_t err = prepare_attn_decode_sm90<D, KV, PAGED>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = decode_launch_config(
      dim3(n, 1, 1), DecodeLayout<D, KV>::SMEM, n, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(out, attn_decode_sm90_kernel<D, KV, PAGED>,
                                        &cfg);
}

template <int D, typename KV, bool PAGED>
inline cudaError_t launch_attn_decode_sm90(const DecodeParams& p, int n,
                                           cudaStream_t stream) {
  if (n != 1 && n != 2 && n != 4 && n != 8) return cudaErrorInvalidValue;
  const int row_tiles = (p.g * p.T + DEC_BM - 1) / DEC_BM;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = decode_launch_config(
      dim3(row_tiles * n, p.B * p.Hkv, 1), DecodeLayout<D, KV>::SMEM, n,
      stream, attr);
  cudaError_t err = prepare_attn_decode_sm90<D, KV, PAGED>();
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, attn_decode_sm90_kernel<D, KV, PAGED>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace d9d
