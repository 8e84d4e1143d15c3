// moe_ffn_sm90: the Hopper core of the bfloat16 expert FFN, the three
// kernels of moe_ffn.cu, each replacing a TPU kernel of
// d9d_tpu/ops/moe_pallas.py:
//
//   B5 (kernel 0, `_ffn_kernel` through `_fused_ffn_call`): rows from the
//      aligned activation buffer [m_pad, h], output y [m_pad, h] in bf16;
//   B6 (kernel 1, `_ffn_gather_kernel` through `_fused_gather_call`): rows
//      gathered from x [N, h] by pair_src, output y [m_pad, h] in bf16 as
//      B5's (the aligned buffer never exists);
//   B7 (kernel 2, `_ffn_gather_combine_kernel` through
//      `_fused_gather_combine_call`): rows gathered as B6's, each row's
//      prob-weighted output added into its token's row of a zeroed fp32
//      [N, h].
//
// The row source (aligned by TMA, or gathered) and the epilogue (stored, or
// added) are two choices of one body, set by its Mode. All compute, per
// tile of BM = 128 rows of ONE expert,
//     y = (silu(A Wg) * (A Wu)).astype(bf16) Wd * probs
// with fp32 accumulation, the hidden rounded to bf16 before the down
// product and y * probs rounded once (B5, B6) or added in fp32 (B7). B6
// reads each row's prob as probs[pair_src[row]] (0 for a pad row), B5 the
// aligned probs[row]: on one routing the two give the same bits.
//
// Bound on this card: bytes, at Qwen3-30B-A3B widths (h 2048, i 768, 128
// experts, 32768 pairs a microbatch): 1.2 GB of expert weights read at
// least once against 309 GFLOP (0.31 ms at the bf16 tensor-core rate).
//
// Design: two launches a call, the hidden through device memory in bf16.
//   gate-up  block (tile, 128 columns of i): [G | U] = A [Wg | Wu] over
//            k-slices of h, then bf16(silu(G) * U) into hidden [m_pad, i];
//   down     block (tile, 256 columns of h): Y = hidden Wd over k-slices of
//            i, then the prob scale and the store (B5, B6) or the add
//            (B7).
// The hidden's round trip (2 * m_pad * i * 2 bytes, ~0.15 GB at the widths
// above) frees the shared memory a resident [BM, i] hidden tile would take,
// so a block holds four 48 KB stages and 128 rows. A block is three
// warpgroups: two consumers, each running wgmma.m64n256k16 on 64 rows of
// the tile (the gate-up block's Wg and Wu boxes lie side by side in a
// stage, so g and u come out of one product), so every weight slice in
// shared memory feeds 128 rows; and one producer that keeps STAGES
// k-slices in flight, each stage guarded by a "full" and an "empty"
// mbarrier. Operands are 64-deep k-slices in the 128-byte swizzle that
// wgmma reads:
//   - weights [E*rows, cols] by TMA, boxes of 64 x 64; their columns are
//     contiguous, so they are N-major B operands (the descriptor's
//     transpose bit), never transposed in memory;
//   - B5's rows and the hidden by TMA, boxes of 128 rows x 64;
//   - B6's and B7's rows are gathered: TMA cannot gather rows on sm_90, so
//     the whole producer warpgroup copies each row's 16-byte pieces with
//     cp.async into the same swizzled places (piece c of row r at
//     r*128 + (c ^ (r&7))*16), zero-filling pad rows; each thread waits for
//     its copies two stages late, fences them into the async proxy (wgmma
//     reads shared memory there) and then arrives on the stage's full
//     barrier.
// The consumers keep two wgmma groups in flight (wait_group 1) and free a
// stage when its group has retired. Blocks run tile-major, so the column
// blocks of one tile and the tiles of one expert run next to each other
// and re-read the expert's weights and the tile's rows from L2. Epilogues:
// the hidden in bf16 pairs; B5's and B6's output staged through the drained
// stages and stored 16 bytes a thread; B7's as 4-column fp32 atomic adds
// (two lanes swap halves first).
//
// Padding: a tile whose first row is padding is all padding (real rows
// come first in every group); its blocks read no weight: the gate-up block
// and B7's down block exit, B5's and B6's down blocks write their zero
// outputs (the wrappers allocate y uninitialised). A warpgroup whose 64
// rows are all padding skips its products. Rows of a partly padded tile are
// zero (the aligned buffer's pad rows, or zero-filled by the gather) with
// prob 0, so they add nothing. At decode sizes (8 tokens, 64 pairs, 128
// experts) most tiles are all padding, and these exits are the common
// case.
//
// Domain: h and i multiples of 64 (a block whose last boxes lie beyond the
// matrix loads the boxes inside it and stores their columns only).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace d9d {
namespace sm90 {

constexpr int BM = 128;            // rows per tile: two consumer warpgroups
constexpr int BN_GATE_UP = 128;    // columns of i per gate-up block (g and u)
constexpr int BN_DOWN = 256;       // columns of h per down block
constexpr int BK = 64;             // k-slice: one 128-byte swizzled row
constexpr int PANEL = 64;          // columns of one weight box (128 bytes)
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;      // warpgroups 0, 1 consume; 2 produces
constexpr int A_BYTES = BM * BK * 2;           // 16 KB
constexpr int PANEL_BYTES = BK * PANEL * 2;    // 8 KB
constexpr int GATHER_LAG = 2;      // stages a gathering thread waits behind
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;

// the kernel number of d9d_moe_ffn: where the rows come from, and where the
// output goes
enum Mode : int {
  ALIGNED = 0,  // B5: aligned rows by TMA; bf16 y stored
  GATHER = 1,   // B6: rows gathered from x; bf16 y stored
  COMBINE = 2,  // B7: rows gathered from x; fp32 y * prob added per token
};

struct Params {
  const __nv_bfloat16* x;  // B6, B7 gate-up: x [N, h]
  const float* probs;      // B5: [m_pad]; B6, B7: [N * K]
  const int* pair_src;     // [m_pad], -1 = padding
  const int* gid;          // [n_tiles]
  __nv_bfloat16* hidden;   // [m_pad, i]
  void* out;               // B5, B6: bf16 [m_pad, h]; B7: zeroed fp32 [N, h]
  int h, inter, top_k;
  int n_col_blocks;        // column blocks per tile
};

// NW = 2: the gate-up block (two weights), NW = 1: the down block
__host__ __device__ constexpr int block_n(int nw) {
  return nw == 2 ? BN_GATE_UP : BN_DOWN;
}
// a stage: the rows' k-slice, then each weight's k-slice in 64-column boxes
// (48 KB in both blocks)
__host__ __device__ constexpr int stage_bytes(int nw) {
  return A_BYTES + nw * (block_n(nw) / PANEL) * PANEL_BYTES;
}
// B5's and B6's down block stages its bf16 output tile in the (drained)
// stages, in rows of this pitch (elements), free of bank conflicts
constexpr int EPI_PITCH = BN_DOWN + 8;
static_assert(2 * 64 * EPI_PITCH * 2 <= STAGES * stage_bytes(1),
              "the staged output tile fits in the stages");

// dynamic shared memory of one block: 1 KB of slack to align the stages to
// the swizzle's 1024-byte period, the stages, the barriers
__host__ __device__ constexpr size_t smem_bytes(int nw) {
  return 1024 + (size_t)STAGES * stage_bytes(nw) + 2 * STAGES * 8;
}

// ---------------------------------------------------------------------------
// PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// one 2-D TMA box (c0: column, c1: row) into shared memory, reported to bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle. K-major a: sbo = 1024
// (8 rows of 128 bytes), lbo unused. N-major b: lbo = the stride between
// 64-column boxes, sbo = 1024 (8 k-rows of 128 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d = a * b + d for one k16 step of a 64 x 256 tile: a K-major from shared
// memory (rows of 128 swizzled bytes), b N-major (transpose bit set: the
// weights' columns are contiguous), both 128-byte swizzled; fp32 accumulate
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float silu_f(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ void bar_sync_named(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// the body: NW = 2 is the gate-up block (A Wg and A Wu into the hidden), NW
// = 1 the down block (hidden Wd into the output). MODE picks the gate-up
// block's row source (ALIGNED: by TMA; GATHER, COMBINE: gathered) and the
// down block's epilogue (ALIGNED, GATHER: bf16 y stored; COMBINE: fp32 y
// added into the token's row).

template <int NW, Mode MODE>
__device__ __forceinline__ void ffn_body(const CUtensorMap* tm_a,
                                         const CUtensorMap* tm_w0,
                                         const CUtensorMap* tm_w1,
                                         const Params& p) {
  constexpr bool GATHERS_ROWS = NW == 2 && MODE != ALIGNED;
  constexpr bool STAGE_OUT = NW == 1 && MODE != COMBINE;
  constexpr int BN = block_n(NW);
  constexpr int W_BYTES = (BN / PANEL) * PANEL_BYTES;  // one weight's slice
  constexpr int SB = stage_bytes(NW);
  const int n_total = NW == 2 ? p.inter : p.h;
  const int k_total = NW == 2 ? p.h : p.inter;
  const int tile = blockIdx.x / p.n_col_blocks;
  const int n0 = (blockIdx.x % p.n_col_blocks) * BN;
  const long long row0 = (long long)tile * BM;
  // 64-column boxes of this block inside the matrix
  const int panels = min(BN / PANEL, (n_total - n0) / PANEL);

  if (p.pair_src[row0] < 0) {  // all padding
    if (STAGE_OUT) {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out);
      const int chunks = panels * PANEL / 8;  // 16-byte pieces of a row
      for (int idx = threadIdx.x; idx < BM * chunks; idx += NTHREADS) {
        const long long row = row0 + idx / chunks;
        *reinterpret_cast<uint4*>(o + row * p.h + n0 + (idx % chunks) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  const uint32_t bars = base + STAGES * SB;  // full[S], then empty[S]
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (STAGES + s); };

  const int e = p.gid[tile];
  const int nk = k_total / BK;
  const uint32_t tx = (GATHERS_ROWS ? 0u : (uint32_t)A_BYTES) +
                      (uint32_t)(NW * panels * PANEL_BYTES);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // gathering: the expect_tx arrival plus one per producer thread
      mbar_init(full_bar(s), GATHERS_ROWS ? 1 + 128 : 1);
      mbar_init(empty_bar(s), 8);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------- producer ----------------
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = threadIdx.x - 256;
    const int w_row0 = e * k_total;  // first row of this expert's weight
    auto load_weights = [&](uint32_t st, int kb, uint32_t bar) {
      for (int q = 0; q < panels; ++q) {
        tma_load(st + A_BYTES + q * PANEL_BYTES, tm_w0, n0 + q * PANEL,
                 w_row0 + kb * BK, bar);
        if constexpr (NW == 2)
          tma_load(st + A_BYTES + W_BYTES + q * PANEL_BYTES, tm_w1,
                   n0 + q * PANEL, w_row0 + kb * BK, bar);
      }
    };
    if constexpr (GATHERS_ROWS) {
      // piece c of rows r0 + 16 j: 8 threads read one row's 128 bytes
      const int c = pt & 7;
      const int r0 = pt >> 3;
      const uint32_t swz = (uint32_t)(r0 * 128 + ((c ^ (r0 & 7)) * 16));
      int tok[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int src = p.pair_src[row0 + r0 + 16 * j];
        tok[j] = src >= 0 ? src / p.top_k : -1;
      }
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(empty_bar(s), ((kb / STAGES) & 1) ^ 1);
        const uint32_t st = base + s * SB;
        if (pt == 0) {
          mbar_expect_tx(full_bar(s), tx);
          load_weights(st, kb, full_bar(s));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool ok = tok[j] >= 0;
          const __nv_bfloat16* src =
              p.x + (ok ? (long long)tok[j] * p.h + kb * BK + c * 8 : 0);
          cp_async16(st + swz + j * 16 * 128, src, ok);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        if (kb >= GATHER_LAG) {
          asm volatile("cp.async.wait_group %0;\n" ::"n"(GATHER_LAG)
                       : "memory");
          fence_proxy_async();
          mbar_arrive(full_bar((kb - GATHER_LAG) % STAGES));
        }
      }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      fence_proxy_async();
      for (int kb = max(0, nk - GATHER_LAG); kb < nk; ++kb)
        mbar_arrive(full_bar(kb % STAGES));
    } else if (pt == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(empty_bar(s), ((kb / STAGES) & 1) ^ 1);
        const uint32_t st = base + s * SB;
        mbar_expect_tx(full_bar(s), tx);
        tma_load(st, tm_a, kb * BK, (int)row0, full_bar(s));
        load_weights(st, kb, full_bar(s));
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<CONSUMER_REGS>();
    const int t = threadIdx.x & 127;
    const int warp = t >> 5;
    const int lane = t & 31;
    // a warpgroup whose 64 rows are all padding multiplies nothing: its
    // zero accumulators give zero hidden rows and (prob 0) zero outputs
    const bool idle = p.pair_src[row0 + wg * 64] < 0;
    // gate-up: [g | u], one 64 x 256 product over the Wg and Wu boxes,
    // which lie next to each other in the stage; down: y
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % STAGES;
      mbar_wait(full_bar(s), (kb / STAGES) & 1);
      if (!idle) {
        const uint32_t st = base + s * SB;
        const uint32_t a_base = st + wg * (64 * 128);  // this warpgroup's rows
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n256k16(
              acc, sw128_desc(a_base + kk * 32, 16, 1024),
              sw128_desc(st + A_BYTES + kk * 2048, PANEL_BYTES, 1024));
        wgmma_commit();
        fence_regs(acc);
      }
      wgmma_wait<1>();  // the previous stage's products have retired
      if (kb > 0 && lane == 0) mbar_arrive(empty_bar((kb - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // accumulator j of this thread: row warp*16 + lane/4 + 8*((j>>1)&1),
    // column (j>>2)*8 + (lane&3)*2 + (j&1) of the warpgroup's 64 x BN tile
    const int r_lo = wg * 64 + warp * 16 + (lane >> 2);
    const int c_q = (lane & 3) * 2;
    const int n_valid = panels * PANEL;
    if constexpr (NW == 2) {
      // the hidden, rounded once to bf16 (the TPU kernel's .astype)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        __nv_bfloat16* hrow =
            p.hidden + (row0 + r_lo + 8 * hh) * p.inter + n0 + c_q;
#pragma unroll
        for (int b = 0; b < BN / 8; ++b) {
          if (b * 8 >= n_valid) break;
          const int j = 4 * b + 2 * hh;
          *reinterpret_cast<__nv_bfloat162*>(hrow + b * 8) =
              __floats2bfloat162_rn(silu_f(acc[j]) * acc[64 + j],
                                    silu_f(acc[j + 1]) * acc[64 + j + 1]);
        }
      }
    } else if constexpr (MODE == COMBINE) {
      // fp32 adds of the prob-weighted rows into their tokens' rows, four
      // columns an add: neighbouring lanes swap halves, so the even lane
      // holds 4 columns of row r_lo and the odd lane 4 of row r_lo + 8
      const bool odd = lane & 1;
      const int src = p.pair_src[row0 + r_lo + (odd ? 8 : 0)];
      const float pr = src >= 0 ? p.probs[src] : 0.f;
      float* orow = static_cast<float*>(p.out) +
                    (long long)(src >= 0 ? src / p.top_k : 0) * p.h + n0 +
                    (lane & 2) * 2;
#pragma unroll
      for (int b = 0; b < BN / 8; ++b) {
        if (b * 8 >= n_valid) break;
        // even lane: sends its row r_lo + 8 pair, keeps row r_lo's
        const float s0 = odd ? acc[4 * b] : acc[4 * b + 2];
        const float s1 = odd ? acc[4 * b + 1] : acc[4 * b + 3];
        const float g0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        float4 v = odd ? make_float4(g0, g1, acc[4 * b + 2], acc[4 * b + 3])
                       : make_float4(acc[4 * b], acc[4 * b + 1], g0, g1);
        if (src >= 0) {
          v.x *= pr;
          v.y *= pr;
          v.z *= pr;
          v.w *= pr;
          atomicAdd(reinterpret_cast<float4*>(orow + b * 8), v);
        }
      }
    } else {
      // y * prob rounded once, staged through the drained stages (both
      // warpgroups' products have retired, every load was consumed), then
      // stored in 16-byte pieces, a row's pieces by neighbouring threads.
      // B5 reads the aligned probs, B6 the pair's (0 for a pad row).
      bar_sync_named(1, 256);
      __nv_bfloat16* tile_s =
          reinterpret_cast<__nv_bfloat16*>(base_ptr) + wg * 64 * EPI_PITCH;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = warp * 16 + (lane >> 2) + 8 * hh;
        const long long row = row0 + wg * 64 + rl;
        float pr;
        if constexpr (MODE == ALIGNED) {
          pr = p.probs[row];
        } else {
          const int src = p.pair_src[row];
          pr = src >= 0 ? p.probs[src] : 0.f;
        }
#pragma unroll
        for (int b = 0; b < BN / 8; ++b) {
          const int j = 4 * b + 2 * hh;
          *reinterpret_cast<__nv_bfloat162*>(tile_s + rl * EPI_PITCH + b * 8 +
                                             c_q) =
              __floats2bfloat162_rn(acc[j] * pr, acc[j + 1] * pr);
        }
      }
      bar_sync_named(2 + wg, 128);
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out);
      constexpr int CPR = BN / 8;  // 16-byte pieces of a staged row
      const int chunks = n_valid / 8;
#pragma unroll
      for (int q = 0; q < 64 * CPR / 128; ++q) {
        const int idx = t + 128 * q;
        const int rl = idx / CPR;
        const int cc = idx % CPR;
        if (cc < chunks)
          *reinterpret_cast<uint4*>(o + (row0 + wg * 64 + rl) * p.h + n0 +
                                    cc * 8) =
              *reinterpret_cast<const uint4*>(tile_s + rl * EPI_PITCH +
                                              cc * 8);
      }
    }
  }
}

// the five kernels: the gate-up of B5, the gathering gate-up of B6 and B7
// (the same block), and the down of each
__global__ void __launch_bounds__(NTHREADS, 1)
    ffn_sm90_gate_up_aligned(const __grid_constant__ CUtensorMap tm_a,
                             const __grid_constant__ CUtensorMap tm_wg,
                             const __grid_constant__ CUtensorMap tm_wu,
                             const Params p) {
  ffn_body<2, ALIGNED>(&tm_a, &tm_wg, &tm_wu, p);
}
__global__ void __launch_bounds__(NTHREADS, 1)
    ffn_sm90_gate_up_gather(const __grid_constant__ CUtensorMap tm_a,
                            const __grid_constant__ CUtensorMap tm_wg,
                            const __grid_constant__ CUtensorMap tm_wu,
                            const Params p) {
  ffn_body<2, GATHER>(&tm_a, &tm_wg, &tm_wu, p);
}
__global__ void __launch_bounds__(NTHREADS, 1)
    ffn_sm90_down_aligned(const __grid_constant__ CUtensorMap tm_h,
                          const __grid_constant__ CUtensorMap tm_wd,
                          const __grid_constant__ CUtensorMap tm_unused,
                          const Params p) {
  ffn_body<1, ALIGNED>(&tm_h, &tm_wd, &tm_unused, p);
}
__global__ void __launch_bounds__(NTHREADS, 1)
    ffn_sm90_down_gather(const __grid_constant__ CUtensorMap tm_h,
                         const __grid_constant__ CUtensorMap tm_wd,
                         const __grid_constant__ CUtensorMap tm_unused,
                         const Params p) {
  ffn_body<1, GATHER>(&tm_h, &tm_wd, &tm_unused, p);
}
__global__ void __launch_bounds__(NTHREADS, 1)
    ffn_sm90_down_combine(const __grid_constant__ CUtensorMap tm_h,
                          const __grid_constant__ CUtensorMap tm_wd,
                          const __grid_constant__ CUtensorMap tm_unused,
                          const Params p) {
  ffn_body<1, COMBINE>(&tm_h, &tm_wd, &tm_unused, p);
}

// ---------------------------------------------------------------------------
// host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, fetched through the runtime, so the
// library links against no driver library
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a bf16 row-major [rows, cols] matrix read in 128-byte-swizzled boxes of
// box_rows x 64
inline bool tensor_map(CUtensorMap* map, const void* ptr, uint64_t rows,
                       uint64_t cols, uint32_t box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)PANEL, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

typedef void (*Sm90Kernel)(const CUtensorMap, const CUtensorMap,
                           const CUtensorMap, const Params);

inline cudaError_t launch_one(Sm90Kernel fn, size_t smem, int blocks,
                              const CUtensorMap& m0, const CUtensorMap& m1,
                              const CUtensorMap& m2, const Params& p,
                              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fn<<<blocks, NTHREADS, smem, stream>>>(m0, m1, m2, p);
  return cudaGetLastError();
}

// B5, B6 or B7 (mode) on the sm_90 core: the gate-up launch, then the down
// launch, each checked. a: aligned rows [n_tiles * BM, h] (B5) or x
// [n_x, h] (B6, B7); probs: [n_tiles * BM] (B5) or [n_x * top_k]; hidden:
// [n_tiles * BM, inter] scratch; out: bf16 [n_tiles * BM, h] (B5, B6) or
// zeroed fp32 [n_x, h] (B7).
inline cudaError_t ffn(Mode mode, const void* a, const float* probs,
                       const int* gid, const int* pair_src, const void* wg,
                       const void* wu, const void* wd, void* hidden, void* out,
                       int n_tiles, int num_experts, int h, int inter,
                       int top_k, cudaStream_t stream) {
  const uint64_t m_pad = (uint64_t)n_tiles * BM;
  CUtensorMap tm_a{}, tm_wg{}, tm_wu{}, tm_h{}, tm_wd{};
  // the gathering gate-up reads x itself: no map of a
  if ((mode == ALIGNED && !tensor_map(&tm_a, a, m_pad, h, BM)) ||
      !tensor_map(&tm_wg, wg, (uint64_t)num_experts * h, inter, BK) ||
      !tensor_map(&tm_wu, wu, (uint64_t)num_experts * h, inter, BK) ||
      !tensor_map(&tm_h, hidden, m_pad, inter, BM) ||
      !tensor_map(&tm_wd, wd, (uint64_t)num_experts * inter, h, BK))
    return cudaErrorInvalidValue;
  Params p{};
  p.x = static_cast<const __nv_bfloat16*>(a);
  p.probs = probs;
  p.pair_src = pair_src;
  p.gid = gid;
  p.hidden = static_cast<__nv_bfloat16*>(hidden);
  p.out = out;
  p.h = h;
  p.inter = inter;
  p.top_k = top_k;
  p.n_col_blocks = (inter + BN_GATE_UP - 1) / BN_GATE_UP;
  cudaError_t err = launch_one(
      mode == ALIGNED ? ffn_sm90_gate_up_aligned : ffn_sm90_gate_up_gather,
      smem_bytes(2), n_tiles * p.n_col_blocks, tm_a, tm_wg, tm_wu, p, stream);
  if (err != cudaSuccess) return err;
  static const Sm90Kernel down[3] = {ffn_sm90_down_aligned,
                                     ffn_sm90_down_gather,
                                     ffn_sm90_down_combine};
  p.n_col_blocks = (h + BN_DOWN - 1) / BN_DOWN;
  return launch_one(down[mode], smem_bytes(1), n_tiles * p.n_col_blocks,
                    tm_h, tm_wd, tm_wd, p, stream);
}

}  // namespace sm90
}  // namespace d9d
