// flash_decode: decode attention over a heads-major KV slot cache,
// hand-written for sm_90a.
//
// Replaces the TPU kernel `_decode_kernel` (called from `_decode_call`) of
// d9d_tpu/ops/attention/pallas_decode.py: the T new tokens of every batch
// row, sitting at cache positions start[b] + [0, T), attend the slot cache
// [B, Hkv, S, D] with a slot-causal mask, an optional sliding window and an
// optional per-key validity vector; a row that sees no key yields exact
// zeros. Returns (o, lse); the sink correction stays outside.
//
// Bound on this card: bytes. A decode step (T = 1) does 4*g flops per cache
// element it reads, far below the ridge, so the least time is the bytes of
// cache up to start + T over the memory rate. The design therefore reads
// each (batch row, kv head) cache slice once for the whole GQA group: the
// g*T query rows of a group share the key/value tiles a block loads.
//
// What differs from the TPU design:
// - the block reads its own start = offsets[b] (no scalar prefetch) and
//   loops only over key tiles at or before start + T - 1 and past the
//   window floor;
// - the g*T rows are tiled over blocks (8, 16 or 64 rows each), so a
//   continuation chunk of any size rides this kernel: the MAX_DECODE_ROWS
//   limit of the TPU kernel was a VMEM limit and has no counterpart here;
// - B*Hkv blocks do not fill 132 SMs at small batch, so the key range is
//   split: in the cluster core by the blocks of a cluster, merged on chip;
//   in the other two cores over grid.z (n_splits chosen by the wrapper from
//   the shapes only, with the tiling that d9d_flash_decode_tiling reports),
//   merged by a second small kernel by logsumexp.
//
// Routes, by dtype and by the g*T query rows per kv head:
// - bfloat16 with at most 16 rows (every single-token step, and every
//   paged call, in row tiles of 16): the decode core designed for the H100
//   (attn_decode_sm90.cuh): one launch per call, the key split done by the
//   blocks of a thread-block cluster over each row's own visible range and
//   merged on chip, so it takes no split scratch and no combine;
// - bfloat16 continuation chunks (more than 16 rows, contiguous cache):
//   the tensor-core core (attn_mma.cuh), bound by operations;
// - float32: the CUDA-core core (attn_tile.cuh), exact fp32 products.
// The last two split the key range over grid.z as described above.
//
// d9d_flash_paged_decode (below) replaces the TPU kernel
// `_paged_decode_kernel` (called from `_paged_decode_call`) of the same file:
// the same function, with the cache read from page pools [P, Hkv, page_size,
// D] through a page table [B, n_pages] — logical key block ki of row b is
// pool page page_table[b, ki] — and, for int8 pools, dequantized by f32
// per-slot scales [P, Hkv, page_size]. Where the TPU kernel gathered whole
// pages through its block index map, a key tile here gathers its rows page
// by page, so page_size is a runtime argument that need not match the tile.
// Bound: bytes, as above — the visible pages (int8: a quarter of fp32's,
// half of bf16's) plus their scales and the page table.
#include "attn_decode_sm90.cuh"
#include "attn_mma.cuh"
#include "attn_tile.cuh"

using namespace d9d;

namespace {
// The routing rule, in one place: the launchers below and the tiling query
// the wrapper sizes its launch with both read it.
constexpr int FEW_ROWS = 8;      // fp32 single-token step: g rows per kv head
constexpr int FMA_ROW_TILE = 16;
constexpr int FMA_KEY_TILE = 32;
constexpr int SPLIT_ALIGN = 64;  // split_len granularity
static_assert(SPLIT_ALIGN % FMA_KEY_TILE == 0 && SPLIT_ALIGN % MMA_BN == 0,
              "a split starts on a key tile of every core");

inline bool takes_sm90(int dtype, int rows, int paged) {
  return dtype == 1 && (paged || rows <= DEC_BM);
}
inline bool takes_mma(int dtype, int rows) {
  return dtype == 1 && rows > DEC_BM;
}
inline int decode_row_tile(int dtype, int rows, int paged) {
  if (takes_sm90(dtype, rows, paged)) return DEC_BM;
  if (takes_mma(dtype, rows)) return MMA_BM;
  return rows <= FEW_ROWS ? FEW_ROWS : FMA_ROW_TILE;
}

// float32: a single-token step has g rows per kv head, and a narrower row
// tile wastes less of the score and PV phases on rows that do not exist
template <typename T>
cudaError_t dispatch_decode_fma(const AttnParams& p, int D, cudaStream_t stream) {
  const bool few_rows = p.g * p.T <= FEW_ROWS;
  if (D == 128) {
    return few_rows
        ? launch_attn<T, 128, FEW_ROWS, FMA_KEY_TILE, 128>(p, stream)
        : launch_attn<T, 128, FMA_ROW_TILE, FMA_KEY_TILE, 128>(p, stream);
  }
  if (D == 64) {
    return few_rows
        ? launch_attn<T, 64, FEW_ROWS, FMA_KEY_TILE, 128>(p, stream)
        : launch_attn<T, 64, FMA_ROW_TILE, FMA_KEY_TILE, 128>(p, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename KV, bool PAGED>
cudaError_t dispatch_sm90(const DecodeParams& p, int D, int n,
                          cudaStream_t stream) {
  if (D == 128) return launch_attn_decode_sm90<128, KV, PAGED>(p, n, stream);
  if (D == 64) return launch_attn_decode_sm90<64, KV, PAGED>(p, n, stream);
  return cudaErrorInvalidValue;
}
}  // namespace

// The tiling a call with `rows` = g*T query rows per kv head will run with:
// query rows per block, and the granularity split_len must keep — 0 when the
// call takes the cluster core, whose n_splits is then the number of blocks
// in a cluster (1, 2, 4 or 8) and which takes no split scratch. Host code
// only; the wrapper sizes its launch from it.
extern "C" int d9d_flash_decode_tiling(int dtype, int rows, int paged,
                                       int* row_tile, int* split_align) {
  if ((dtype != 0 && dtype != 1) || rows <= 0 || (paged != 0 && paged != 1) ||
      row_tile == nullptr || split_align == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  *row_tile = decode_row_tile(dtype, rows, paged);
  *split_align = takes_sm90(dtype, rows, paged) ? 0 : SPLIT_ALIGN;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; head_dim is
// contiguous. q/o are [B, T, Hq, D]-addressed, the caches [B, Hkv, S, D]-
// addressed, lse contiguous [B, Hq, T] fp32; row b's write index is
// offsets[b * offsets_stride] (int32; stride 0: one shared index), kv_valid
// [B, S] is null or, read as it comes, kv_valid_bytes = 1 (bool) or
// 4 (int32) wide with row stride kv_valid_sb (elements) and contiguous keys.
// The cluster core (d9d_flash_decode_tiling reports split_align 0) takes
// n_splits = blocks per cluster (1, 2, 4, 8), ignores split_len and needs no
// scratch. The other cores take offsets_stride 1 and an int32 kv_valid with
// row stride S; with n_splits > 1, o_part [B*Hkv, n_splits, g*T, D] and
// lse_part [B*Hkv, n_splits, g*T] are fp32 scratch the caller allocated, and
// split_len is a multiple of SPLIT_ALIGN with n_splits * split_len >= S.
// Launches on `stream`, allocates nothing, never synchronizes.
// How many clusters of n blocks (1, 2, 4 or 8) of the cluster core the card
// holds at once, for a call of this dtype (1 = bfloat16), mode (paged,
// int8 pools) and head_dim. Host code only; the wrapper sizes its clusters
// so that a launch runs in one wave.
extern "C" int d9d_flash_decode_max_clusters(int paged, int kv_int8, int D,
                                             int n, int* out) {
  if (out == nullptr || (n != 1 && n != 2 && n != 4 && n != 8) ||
      (kv_int8 && !paged)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (D == 128) {
    err = kv_int8 ? max_clusters_attn_decode_sm90<128, int8_t, true>(n, out)
        : paged   ? max_clusters_attn_decode_sm90<128, __nv_bfloat16, true>(n, out)
                  : max_clusters_attn_decode_sm90<128, __nv_bfloat16, false>(n, out);
  } else if (D == 64) {
    err = kv_int8 ? max_clusters_attn_decode_sm90<64, int8_t, true>(n, out)
        : paged   ? max_clusters_attn_decode_sm90<64, __nv_bfloat16, true>(n, out)
                  : max_clusters_attn_decode_sm90<64, __nv_bfloat16, false>(n, out);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" int d9d_flash_decode(
    const void* q, const void* k_cache, const void* v_cache, void* o,
    void* lse, const void* offsets, const void* kv_valid,
    void* o_part, void* lse_part,
    int B, int T, int Hq, int Hkv, int S, int D, int dtype,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_st, long long o_sh,
    float scale, int window, int n_splits, int split_len,
    long long offsets_stride, int kv_valid_bytes, long long kv_valid_sb,
    void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      offsets == nullptr || n_splits < 1 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (takes_sm90(dtype, (Hq / Hkv) * T, 0)) {
    if ((offsets_stride != 0 && offsets_stride != 1) ||
        (kv_valid != nullptr && kv_valid_bytes != 1 && kv_valid_bytes != 4)) {
      return (int)cudaErrorInvalidValue;
    }
    DecodeParams p{};
    p.q = q; p.k = k_cache; p.v = v_cache; p.o = o;
    p.lse = static_cast<float*>(lse);
    p.offsets = static_cast<const int*>(offsets);
    p.offsets_stride = offsets_stride;
    p.kv_valid = kv_valid;
    p.kv_valid_bytes = kv_valid_bytes;
    p.kv_valid_sb = kv_valid_sb;
    p.B = B; p.T = T; p.Hq = Hq; p.Hkv = Hkv; p.S = S; p.g = Hq / Hkv;
    p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
    p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
    p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
    p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
    p.scale = scale; p.window = window;
    return (int)dispatch_sm90<__nv_bfloat16, false>(p, D, n_splits, s);
  }
  if (split_len % SPLIT_ALIGN != 0 || (long long)n_splits * split_len < S ||
      (n_splits > 1 && (o_part == nullptr || lse_part == nullptr)) ||
      offsets_stride != 1 ||
      (kv_valid != nullptr && (kv_valid_bytes != 4 || kv_valid_sb != S))) {
    return (int)cudaErrorInvalidValue;
  }
  AttnParams p{};
  p.q = q; p.k = k_cache; p.v = v_cache; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.offsets = static_cast<const int*>(offsets);
  p.q_tag = nullptr;
  p.k_tag = static_cast<const int*>(kv_valid);
  p.o_part = static_cast<float*>(o_part);
  p.lse_part = static_cast<float*>(lse_part);
  p.B = B; p.T = T; p.Hq = Hq; p.Hkv = Hkv; p.S = S; p.g = Hq / Hkv;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.scale = scale; p.causal = 1; p.window = window;
  p.n_splits = n_splits; p.split_len = split_len;
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_decode_fma<float>(p, D, s);
  } else if (D == 128) {
    err = launch_attn_mma<128>(p, s);
  } else if (D == 64) {
    err = launch_attn_mma<64>(p, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}


// ---------------------------------------------------------------------------
// paged flash decode

namespace {
template <typename KV>
cudaError_t dispatch_paged_fma(const AttnParams& p, int D, cudaStream_t stream) {
  const bool few_rows = p.g * p.T <= FEW_ROWS;
  if (D == 128) {
    return few_rows
        ? launch_attn<float, 128, FEW_ROWS, FMA_KEY_TILE, 128, true, KV>(p, stream)
        : launch_attn<float, 128, FMA_ROW_TILE, FMA_KEY_TILE, 128, true, KV>(p, stream);
  }
  if (D == 64) {
    return few_rows
        ? launch_attn<float, 64, FEW_ROWS, FMA_KEY_TILE, 128, true, KV>(p, stream)
        : launch_attn<float, 64, FMA_ROW_TILE, FMA_KEY_TILE, 128, true, KV>(p, stream);
  }
  return cudaErrorInvalidValue;
}
}  // namespace

// dtype (of q and o): 0 = float32, 1 = bfloat16; kv_int8: 0 = the pools hold
// q's dtype, 1 = int8 pools with k_scale / v_scale [P, Hkv, page_size] fp32
// contiguous (null otherwise). Pools are [P, Hkv, page_size, D]-addressed
// with element strides (page, head, slot), head_dim contiguous; page_table
// int32 [B, row_pages] contiguous, every entry a page of the pools. q/o,
// lse, offsets (with offsets_stride), the split scratch and
// n_splits/split_len as for d9d_flash_decode with S = row_pages * page_size:
// every bfloat16 call takes the cluster core (n_splits = blocks per
// cluster), every float32 call the CUDA-core core with the grid.z split.
// Launches on `stream`, allocates nothing, never synchronizes.
extern "C" int d9d_flash_paged_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, void* o, void* lse,
    const void* offsets, const void* page_table,
    void* o_part, void* lse_part,
    int B, int T, int Hq, int Hkv, int page_size, int row_pages, int D,
    int dtype, int kv_int8,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sp, long long k_sh, long long k_ss,
    long long v_sp, long long v_sh, long long v_ss,
    long long o_sb, long long o_st, long long o_sh,
    float scale, int window, int n_splits, int split_len,
    long long offsets_stride, void* stream) {
  const long long S = (long long)row_pages * page_size;
  if (B <= 0 || T <= 0 || page_size <= 0 || row_pages <= 0 || Hkv <= 0 ||
      Hq % Hkv != 0 || S > 0x7fffffffLL || page_table == nullptr ||
      offsets == nullptr || (kv_int8 != 0 && kv_int8 != 1) ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      n_splits < 1 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (takes_sm90(dtype, (Hq / Hkv) * T, 1)) {
    if (offsets_stride != 0 && offsets_stride != 1) {
      return (int)cudaErrorInvalidValue;
    }
    DecodeParams p{};
    p.q = q; p.k = k_pool; p.v = v_pool; p.o = o;
    p.lse = static_cast<float*>(lse);
    p.offsets = static_cast<const int*>(offsets);
    p.offsets_stride = offsets_stride;
    p.page_table = static_cast<const int*>(page_table);
    p.page_size = page_size;
    p.page_shift = (page_size & (page_size - 1)) == 0 ? __builtin_ctz(page_size)
                                                       : -1;
    p.row_pages = row_pages;
    p.k_scale = static_cast<const float*>(k_scale);
    p.v_scale = static_cast<const float*>(v_scale);
    p.B = B; p.T = T; p.Hq = Hq; p.Hkv = Hkv; p.S = (int)S; p.g = Hq / Hkv;
    p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
    p.k_sb = k_sp; p.k_sh = k_sh; p.k_ss = k_ss;
    p.v_sb = v_sp; p.v_sh = v_sh; p.v_ss = v_ss;
    p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
    p.scale = scale; p.window = window;
    return (int)(kv_int8 ? dispatch_sm90<int8_t, true>(p, D, n_splits, s)
                         : dispatch_sm90<__nv_bfloat16, true>(p, D, n_splits, s));
  }
  if (split_len % SPLIT_ALIGN != 0 || (long long)n_splits * split_len < S ||
      (n_splits > 1 && (o_part == nullptr || lse_part == nullptr)) ||
      offsets_stride != 1) {
    return (int)cudaErrorInvalidValue;
  }
  AttnParams p{};
  p.q = q; p.k = k_pool; p.v = v_pool; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.offsets = static_cast<const int*>(offsets);
  p.q_tag = nullptr;
  p.k_tag = nullptr;
  p.o_part = static_cast<float*>(o_part);
  p.lse_part = static_cast<float*>(lse_part);
  p.B = B; p.T = T; p.Hq = Hq; p.Hkv = Hkv; p.S = (int)S; p.g = Hq / Hkv;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sp; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sp; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.scale = scale; p.causal = 1; p.window = window;
  p.n_splits = n_splits; p.split_len = split_len;
  p.page_table = static_cast<const int*>(page_table);
  p.page_size = page_size;
  p.row_pages = row_pages;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  return (int)(kv_int8 ? dispatch_paged_fma<int8_t>(p, D, s)
                       : dispatch_paged_fma<float>(p, D, s));
}
