// flash_fwd: flash-attention forward for prefill, hand-written for sm_90a.
//
// Replaces the TPU kernel `_fwd_kernel` (called from `_fwd_call`) of
// d9d_tpu/ops/attention/pallas_flash.py: online-softmax attention forward
// that returns (o, lse) without ever writing the [T, T] logits to device
// memory. GQA (kv head = q head / g), causal and sliding-window masks,
// packed-sequence segment ids, and a sequence length that need not be a
// multiple of the tile. The sink correction stays outside, as an elementwise
// step on (o, lse), as in the JAX package.
//
// Bound on this card: operations. Prefill at T in the thousands does
// 4*B*Hq*T*T*D/2 flops (causal) over a few megabytes of q/k/v, far above
// the ~295 flop/byte ridge of the H100, so the least time is flops over the
// bf16 tensor-core rate.
//
// Also the forward of `flash_attention_block` (pallas_flash.py:709, the TPU
// kernel with `has_positions`, masks by `_mask_block` and skipping by
// `_skip_block`): q rows at global positions q_offset + [0, T) attend keys
// at k_offset + [0, T). Only the difference matters, so the launcher takes
// one by-value `shift` = q_offset - k_offset (no device tensor, no
// readback) and the cores place query row t at key position t + shift: the
// causal and window masks and the key range of each block follow from it. A
// block wholly in the causal future (shift <= -T) has an empty key range:
// it visits no tile and writes o = 0, lse = -1e30 + log(1e-30).
//
// Design: one block per (batch row, kv head, tile of query rows of the GQA
// group); the loop over key tiles inside the block replaces the Pallas grid's
// sequential kv dimension and its VMEM scratch. Key tiles wholly in the
// causal future or behind the window are never visited. bfloat16 inputs take
// the core designed for the H100 (attn_fwd_sm90.cuh: 128-row blocks of 8
// warps, two per SM, 64-key tiles double-buffered by cp.async, mma.sync bf16
// products, softmax in registers on exp2f, the mask only on edge tiles,
// causal row tiles heaviest first); float32 inputs keep exact fp32 products
// on the CUDA cores (attn_tile.cuh: 32-row tiles, synchronous tile loads).
#include "attn_fwd_sm90.cuh"
#include "attn_tile.cuh"

using namespace d9d;

namespace {
cudaError_t dispatch_fwd_f32(const AttnParams& p, int D, cudaStream_t stream) {
  if (D == 128) return launch_attn<float, 128, 32, 64, 128>(p, stream);
  if (D == 64) return launch_attn<float, 64, 32, 64, 128>(p, stream);
  return cudaErrorInvalidValue;
}
cudaError_t dispatch_fwd_bf16(const AttnParams& p, int D, cudaStream_t stream) {
  if (D == 128) return launch_attn_fwd_sm90<128>(p, stream);
  if (D == 64) return launch_attn_fwd_sm90<64>(p, stream);
  return cudaErrorInvalidValue;
}
}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; head_dim is
// contiguous. q/o are [B, T, Hq, D]-addressed, k/v [B, T, Hkv, D]-addressed,
// lse is contiguous [B, Hq, T] fp32, q_seg/kv_seg contiguous int32 [B, T] or
// both null; shift = q_offset - k_offset (0 for ordinary prefill). Launches
// on `stream`, allocates nothing, never synchronizes.
extern "C" int d9d_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_seg, const void* kv_seg,
    int B, int T, int Hq, int Hkv, int D, int dtype,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    float scale, int causal, int window, int shift, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  AttnParams p{};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.offsets = nullptr;
  p.q_tag = static_cast<const int*>(q_seg);
  p.k_tag = static_cast<const int*>(kv_seg);
  p.o_part = nullptr; p.lse_part = nullptr;
  p.B = B; p.T = T; p.Hq = Hq; p.Hkv = Hkv; p.S = T; p.g = Hq / Hkv;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_st;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.scale = scale; p.causal = causal; p.window = window; p.shift = shift;
  p.n_splits = 1;
  p.split_len = ((T + 63) / 64) * 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_fwd_f32(p, D, s)
                  : dtype == 1 ? dispatch_fwd_bf16(p, D, s)
                               : cudaErrorInvalidValue;
  return (int)err;
}
