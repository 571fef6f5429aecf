// The multi-token flash attention main loop for sm_90a, shared by flash.cu
// (bf16 cache) and flash_quant.cu (int8 / packed-int4 cache).
//
// What bounds the kernel on an H100: at the prefill shapes (GQA 32/8, head_dim
// 64, causal) the two matrix products need 4*D FLOPs per visible (query head,
// key) pair against a few bytes of K/V per key, so tensor-core operations
// bound it, and at head_dim 64 the exponential unit (16 ex2 a clock and SM)
// is as tight a ceiling as the tensor cores. On the card the softmax
// arithmetic (about six instructions a logit on the one warp a scheduler has
// for a warpgroup) costs as much time as the products and the two mostly add
// (PERF.md has the clock stamps). What the design does about it:
//
// * Both products run on wgmma (m64nNk16, bf16 in, f32 accumulate). One block
//   holds 128 (query head, time) rows of one kv head: G heads by 128/G
//   consecutive positions, head-major, so each of the two consumer warpgroups
//   owns 64 rows of M. S = Q.K^T reads Q and K from shared memory through
//   matrix descriptors; O += P.V takes P from the S accumulator registers
//   (converted to bf16 in place: the accumulator fragment of 16 key columns is
//   the A fragment of one k16 step) and V from its key-major tile as the
//   transposed B operand.
// * Tiles lie in shared memory as wgmma reads them: rows of 128 bytes (64 bf16
//   channels; head_dim 128 is two such panels, 256 four) under the 128-byte swizzle,
//   1,024-byte aligned. They are filled with 16-byte cp.async copies to
//   hand-swizzled addresses rather than with TMA: the quantized kernel has to
//   write its widened tiles by hand anyway, the payload rows of a tile are one
//   contiguous run of device memory, and no tensor map (encoded on the host for
//   every cache buffer) is needed.
// * A producer warpgroup keeps a ring of four K/V stages full, with one "full"
//   and one "empty" mbarrier per stage in place of block-wide barriers. The
//   copies of a bf16 tile arrive on the stage's full barrier themselves
//   (cp.async.mbarrier.arrive), so the producer never waits for data and runs
//   as far ahead as the ring allows. For a quantized cache the raw payload
//   arrives asynchronously in a ring of its own and the producer warps widen
//   tile n + 1 into a bf16 stage (written swizzled) while the consumers run
//   wgmma on tile n. Key scales fold into logit columns and value scales into
//   probability columns after the row sum, as the Pallas kernel folds them.
// * Softmax beside the products. Inside a warpgroup a tile's S = Q.K^T is
//   started together with the previous tile's O += P.V; and the two consumer
//   warpgroups start theirs in turns (a pair of named barriers), so that one is in
//   its softmax while the other's products are on the tensor cores. Registers
//   move from the producer warpgroup to the consumers (setmaxnreg). exp(x - m)
//   is one FMA and one ex2.approx (sm_scale * log2(e) folded into the FMA),
//   and the output is rescaled only when a row's running max has moved.
// * Masking only where a tile needs it. Each consumer warp classifies a tile
//   from the keep-mask bytes in its stage (a word a lane and two votes): a
//   tile with no keep-bit is skipped, and a tile with every keep-bit set that
//   lies wholly below the diagonal and inside the window takes no per-element
//   test.
// * Head_dim 256 (Gemma-3 1B/4B/12B). Q alone is 4 panels x 128 rows = 64 KB,
//   and a consumer warpgroup's output accumulator 64 rows x 256 f32 = 128
//   registers a thread. A key tile is 16 KB of bf16 keys at every head_dim
//   (NK = 8192 / D: 128, 64, 32 keys), so the ring keeps its four stages of
//   K and V (128 KB) beside Q; only an int8 cache, whose three raw slots take
//   48 KB more, drops to three stages. The 32-key tile keeps S (16 f32) and
//   P (8 words) small beside O, so the consumers stay within the same
//   setmaxnreg split and neither role spills; S = Q.K^T runs on m64n32k16,
//   P.V on the same m64n64k16 a 64-channel panel as at 64 and 128. Splitting
//   O's channels over the two warpgroups would make each compute S twice,
//   and two stages of 64-key tiles would leave the producer no tile ahead
//   while the consumers hold one stage for S and one for P.V.
// * Head_dim 96 (Phi-3-mini) is no whole number of 64-channel panels. A row
//   is laid out as head_dim 128's two panels, the second half used: Q and
//   each K/V tile take head_dim 128's room (64-key tiles, four stages), the
//   producers copy 12 of a row's 16 chunks, S = Q.K^T runs 6 k16 steps (none
//   touches channels 96-127 of Q or K), and P.V runs head_dim 128's two
//   m64n64k16 products a k16 step: the V channels 96-127 of every stage are
//   written as zeros once, before the ring starts, and no copy or widening
//   writes them after, so the accumulator columns 96-127 stay 0 and are not
//   stored. (A 32-channel panel under the 64-byte swizzle would save a
//   quarter of the P.V products but needs descriptors and copies of its own.)
// * The same-image or-mask (OR = true, bf16 caches only, as in the Pallas
//   kernel): a row whose image id gq is >= 0 also sees every key whose id
//   equals it. An image spans at most or_span slots, so a q-tile's key range
//   reaches or_span - 1 slots past its last row and starts
//   max(window - 1, or_span - 1) slots behind its first. The keys' ids ride
//   in each ring stage beside the keep-mask bytes. A tile wholly below the
//   diagonal and inside the window gains nothing from the or-mask and keeps
//   its cheap class; every other visible tile takes the per-element test,
//   where a key is allowed if wlim < x <= lim or gq == gk[x], then the
//   keep-bit applies. Rows only gain keys, so no row that had a live key
//   loses it.
// * Few query rows over a long cache (a question forward): the key range of a
//   q-tile is split over `nsplit` blocks, each of which writes its
//   unnormalised f32 output, running max and sum to scratch; a second kernel
//   merges the ranges in a fixed order (no atomics: the same bits every run).
//
// Numerics follow the Pallas kernels (kvpress_tpu/ops/flash.py): logits and
// softmax statistics in float32, bf16 operands for both products. A masked
// logit is -inf and the running max of a row that has met no live key stays
// -inf (its exponent is taken against 0), so such a row stores 0 and LSE -inf.
//
// The same loop without V is the row logsumexp pass of the column sums
// (observed_colsum.cu): KIND = LSE_ONLY drops the V stages, the P.V product
// and output rescale, the keep-mask bytes (a tile is classified from its
// position alone) and the output store, and writes only the LSE.
#pragma once

#include "attn_common.cuh"

namespace kvp {
namespace sm90 {

constexpr int BLOCK_ROWS = 128;  // (head, time) rows of a block: 64 per consumer warpgroup
constexpr int CONSUMERS = 256;   // threads of the two consumer warpgroups
constexpr int THREADS = 384;     // + one producer warpgroup
constexpr int LAG = 2;           // quantized caches: raw tiles in flight behind the widening
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr uint32_t ANY_LIVE = 1u, ALL_LIVE = 2u;
constexpr int LSE_ONLY = 3;      // KIND of the row-logsumexp instantiation: bf16 K, no V

struct FlashParams {
  const __nv_bfloat16* q;  // (B, Hq, T, D)
  const void* k;           // (B, Hkv, S, D) bf16/int8 | (B, Hkv, S, D/2) uint8
  const void* v;
  const float* ks;         // (B, Hkv, S) f32 or null
  const float* vs;
  const uint8_t* mask;     // (B, Hkv, mask_pitch) or null
  const int* qg;           // (B, T) image ids of the queries (-1: text); OR only
  const int* kg;           // (B, kg_pitch) image ids of the slots, padded with -1
  __nv_bfloat16* out;      // (B, Hq, T, D)
  float* lse;              // (B, Hq, T) or null
  float* part_o;           // (nsplit, B, Hq, T, D) f32, nsplit > 1
  float* part_ml;          // (nsplit, B, Hq, T, 2) f32: max (in log2 units), sum
  int B, Hq, Hkv, T, S, G, bq, prior, window, mask_pitch, nsplit;
  int kg_pitch, or_span;   // OR only: slots of a k_groups row; the longest image span
  float sm_scale, softcap;
};

// ----------------------------------------------------------------------- //
// PTX pieces

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed. A wait that
// lasts seconds is a fault of the pipeline: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if ((tries & 0xFFFFu) == 0xFFFFu) {
      if (t0 == 0) t0 = clock64();
      else if (clock64() - t0 > 6000000000LL) __trap();
    }
  }
}

// Orders this thread's shared-memory writes before reads of the asynchronous
// proxy (wgmma reads its operands through it).
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Registers move from the producer warpgroup to the consumers (the sum over
// the block's three warpgroups stays within the SM's 64K registers).
constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;

// One arrival on `bar` once all of this thread's earlier cp.async copies have
// landed (counted in the barrier's expected arrivals: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async16_to(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0));
}

// wgmma runs asynchronously: the compiler must neither read its accumulators
// nor reuse its register operands before the wait. Naming the registers as
// read and written here pins both to this point.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory matrix descriptor of a tile of 128-byte rows under the
// 128-byte swizzle: start address, leading and stride byte offsets in units of
// 16 bytes, swizzle mode 1 in bits 62-63. 8 rows are one 1,024-byte swizzle
// atom, so the stride offset (from one group of 8 rows to the next) is 1,024.
// The leading offset is not read for these layouts (one atom wide).
__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Byte offset of 16-byte chunk c (0..7) of row r in such a tile.
__host__ __device__ __forceinline__ int swizzled(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// d (64 x 128, f32) = or += A (64 x 16, shared memory) * B^T (B: 128 x 16, shared
// memory), both K-major under the 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) = or += A (64 x 16, shared memory) * B^T (B: 64 x 16, shared
// memory), both K-major under the 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32, f32) = or += A (64 x 16, shared memory) * B^T (B: 32 x 16, shared
// memory), both K-major under the 128-byte swizzle: S of a 32-key tile.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared memory,
// stored key-major: the transposed, "MN-major" B operand).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Channels of a row as the tiles lay it out: whole 64-channel panels (head_dim
// 96 takes 128's two, the second half used). Also the column sums' layout.
__host__ __device__ constexpr int panel_channels(int D) { return (D + 63) / 64 * 64; }

// ----------------------------------------------------------------------- //
// Shared memory of a block

// Q (128 rows), a ring of STAGES bf16 K/V stages of NK keys (K alone for the
// row-logsumexp pass), per-stage key and value scales (quantized caches) and
// keep-mask bytes, and the stages' barriers. A quantized cache adds a ring of
// raw payload slots that only the producer warps touch. Every tile is a whole
// number of 1,024-byte swizzle atoms; head_dim 128 is two 64-channel panels,
// 256 four, one after the other. The row-logsumexp pass reads neither scales nor
// keep-mask bytes but keeps their room: without it the pass measured slower
// on the H100, and a ring of eight K stages no faster (PERF.md). With the
// or-mask (OR) every stage also holds its keys' image ids.
template <int D, int KIND, bool OR = false>
struct Ring {
  static constexpr int DP = panel_channels(D);
  static constexpr int NK = 8192 / DP;  // 16 KB of bf16 keys: 128, 64 or 32
  // Four stages; at head_dim 256 an int8 cache's raw slots leave room for three.
  static constexpr int STAGES = D == 256 && KIND == KV_INT8 ? 3 : 4;
  static constexpr bool BF16 = KIND == KV_BF16 || KIND == LSE_ONLY;  // copied as it is
  static constexpr int KV = KIND == LSE_ONLY ? 1 : 2;                // tiles of a stage
  static constexpr int RAW_SLOTS = BF16 ? 0 : LAG + 1;
  static constexpr int ROW = row_bytes<D, BF16 ? KV_BF16 : KIND>();
  static constexpr int PANELS = DP / 64;
  static constexpr int Q_PANEL = BLOCK_ROWS * 128;
  static constexpr int KV_PANEL = NK * 128;
  static constexpr int TILE = PANELS * KV_PANEL;  // one bf16 K or V tile
  static constexpr int RAW = 2 * NK * ROW;        // one raw K and V payload tile
  static constexpr int OFF_STAGE = PANELS * Q_PANEL;
  static constexpr int OFF_RAW = OFF_STAGE + STAGES * KV * TILE;
  static constexpr int OFF_SCALE = OFF_RAW + RAW_SLOTS * RAW;
  static constexpr int OFF_RAW_SCALE = OFF_SCALE + STAGES * 2 * NK * 4;
  static constexpr int OFF_MASK = OFF_RAW_SCALE + RAW_SLOTS * 2 * NK * 4;
  static constexpr int OFF_RAW_MASK = OFF_MASK + STAGES * NK;
  static constexpr int OFF_GROUP = OFF_RAW_MASK + RAW_SLOTS * NK;
  static constexpr int OFF_BAR = OFF_GROUP + (OR ? STAGES * NK * 4 : 0);
  static_assert(OFF_GROUP % 16 == 0, "image ids are copied 16 bytes at a time");
  static_assert(!OR || KIND == KV_BF16, "the or-mask is a branch of the bf16 kernel only");
  // Arrivals that complete a stage's full barrier: every producer thread
  // (through its copies, for a bf16 tile) and, for a bf16 tile with a
  // keep-mask, the thread that wrote the keep-mask bytes.
  static constexpr int FULL_ARRIVALS = KIND == KV_BF16 ? 129 : 128;
  static constexpr int BYTES = OFF_BAR + 2 * STAGES * 8;
  static_assert(BYTES + 1024 <= 232448, "a block has 227 KB of shared memory");

  unsigned char* base;  // 1,024-byte aligned

  __device__ unsigned char* q() const { return base; }
  __device__ unsigned char* k(int s) const { return base + OFF_STAGE + s * KV * TILE; }
  __device__ unsigned char* v(int s) const { return k(s) + TILE; }
  __device__ float* ks(int s) const { return reinterpret_cast<float*>(base + OFF_SCALE) + s * 2 * NK; }
  __device__ float* vs(int s) const { return ks(s) + NK; }
  __device__ uint8_t* mask(int s) const { return base + OFF_MASK + s * NK; }
  __device__ unsigned char* raw_k(int r) const { return base + OFF_RAW + r * RAW; }
  __device__ unsigned char* raw_v(int r) const { return raw_k(r) + NK * ROW; }
  __device__ float* raw_ks(int r) const {
    return reinterpret_cast<float*>(base + OFF_RAW_SCALE) + r * 2 * NK;
  }
  __device__ float* raw_vs(int r) const { return raw_ks(r) + NK; }
  __device__ uint8_t* raw_mask(int r) const { return base + OFF_RAW_MASK + r * NK; }
  __device__ int* groups(int s) const { return reinterpret_cast<int*>(base + OFF_GROUP) + s * NK; }
  __device__ uint64_t* full(int s) const { return reinterpret_cast<uint64_t*>(base + OFF_BAR) + s; }
  __device__ uint64_t* empty(int s) const { return full(STAGES) + s; }
};

// What a block walks: key tiles [i0, i1) of NK keys counted from slot kfirst,
// for the query positions from t0 on of kv head h of batch row b.
struct Walk {
  int t0, kfirst, i0, i1, h, b, split;
};

// ----------------------------------------------------------------------- //
// The producer warpgroup

// Keep-mask bytes of keys [key0, key0 + NK) into dst: copied asynchronously,
// or, with no mask, written as "the slot exists".
template <int NK>
__device__ __forceinline__ void load_mask(uint8_t* dst, const uint8_t* mask, int key0,
                                          const FlashParams& p) {
  if (mask != nullptr) {
#pragma unroll
    for (int c = 0; c < NK / 16; ++c) {
      const bool in = key0 + c * 16 < p.mask_pitch;
      cp_async16(dst + c * 16, mask + (in ? key0 + c * 16 : 0), in);
    }
  } else {
    for (int w = 0; w < NK / 4; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) word |= (key0 + 4 * w + j < p.S ? 1u : 0u) << (8 * j);
      reinterpret_cast<uint32_t*>(dst)[w] = word;
    }
  }
}

// ANY_LIVE if a keep-byte of the tile is set, ALL_LIVE if every one is
// (bytes are 0 or 1): a word a lane, two votes. Called by a whole warp.
template <int NK>
__device__ __forceinline__ uint32_t tile_flags(const uint8_t* mask, int lane) {
  const uint32_t word = reinterpret_cast<const uint32_t*>(mask)[lane % (NK / 4)];
  return (__any_sync(0xffffffffu, word != 0u) ? ANY_LIVE : 0u) |
         (__all_sync(0xffffffffu, word == 0x01010101u) ? ALL_LIVE : 0u);
}

__device__ __forceinline__ void store_chunk(unsigned char* tile, int panel_bytes, int row, int oc,
                                            const uint32_t* w) {
  *reinterpret_cast<uint4*>(tile + (oc >> 3) * panel_bytes + swizzled(row, oc & 7)) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// Quantized caches: widen NK raw payload rows into a swizzled bf16 tile. int8
// payloads and the +8-offset nibbles of int4 (channel c in the low nibble,
// c + D/2 in the high) are small integers, exact in bf16.
template <int D, int KIND>
__device__ __forceinline__ void widen(const unsigned char* raw, unsigned char* tile, int pt) {
  constexpr int NK = Ring<D, KIND>::NK, PANEL = Ring<D, KIND>::KV_PANEL;
  if (KIND == KV_INT8) {
    constexpr int CPR = D / 16;  // 16 int8 channels per raw chunk
    for (int c = pt; c < NK * CPR; c += 128) {
      const int row = c / CPR, oc = 2 * (c % CPR);
      const uint4 rw = *reinterpret_cast<const uint4*>(raw + c * 16);
      const int8_t* b = reinterpret_cast<const int8_t*>(&rw);
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = pack_bf16x2((float)b[2 * i], (float)b[2 * i + 1]);
      store_chunk(tile, PANEL, row, oc, w);
      store_chunk(tile, PANEL, row, oc + 1, w + 4);
    }
  } else {
    constexpr int D2 = D / 2;
    constexpr int CPR = D2 / 16;  // 16 bytes: channels col.. (low) and D/2 + col.. (high)
    for (int c = pt; c < NK * CPR; c += 128) {
      const int row = c / CPR, oc = 2 * (c % CPR);
      const uint4 rw = *reinterpret_cast<const uint4*>(raw + c * 16);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&rw);
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b0 = b[2 * i], b1 = b[2 * i + 1];
        lo[i] = pack_bf16x2((float)((b0 & 0xF) - 8), (float)((b1 & 0xF) - 8));
        hi[i] = pack_bf16x2((float)((b0 >> 4) - 8), (float)((b1 >> 4) - 8));
      }
      store_chunk(tile, PANEL, row, oc, lo);
      store_chunk(tile, PANEL, row, oc + 1, lo + 4);
      store_chunk(tile, PANEL, row, D2 / 8 + oc, hi);
      store_chunk(tile, PANEL, row, D2 / 8 + oc + 1, hi + 4);
    }
  }
}

// A bf16 tile is copied straight into its stage once the consumers have
// released it, and its copies arrive on the stage's full barrier themselves.
// A quantized tile is copied into a raw slot and widened into its stage LAG
// iterations later: iteration n hands tile n - LAG over and then starts the
// copies of tile n. The producers' barrier of an iteration lies between the
// last read of a raw slot (the widening of iteration n - 1) and the next copy
// into it.
template <int D, int KIND, bool OR>
__device__ __forceinline__ void produce(const FlashParams& p, const Ring<D, KIND, OR>& ring,
                                        const Walk& w, int pt) {
  using R = Ring<D, KIND, OR>;
  constexpr int NK = R::NK, ROW = R::ROW, STAGES = R::STAGES;
  const size_t kvh = (size_t)w.b * p.Hkv + w.h;
  const char* kg = reinterpret_cast<const char*>(p.k) + kvh * p.S * ROW;
  const char* vg = reinterpret_cast<const char*>(p.v) + kvh * p.S * ROW;
  const uint8_t* mg = p.mask ? p.mask + kvh * p.mask_pitch : nullptr;
  const int ntiles = w.i1 - w.i0;
  if constexpr (R::BF16) {
    // Thread pt copies chunk pt % CPT of rows pt / CPT + RPI * it, and at
    // head_dim 256 the same chunk of the second pair of panels (HALVES): RPI
    // is a multiple of 8, so the swizzle phase is the thread's own. At
    // head_dim 96 the chunks are counted over the padded row (16), and the
    // threads of chunks 12-15 copy nothing.
    constexpr int CPR = D / 8;                 // 16-byte chunks of a bf16 row
    constexpr int CPP = R::DP / 8;             // the same over the padded row
    constexpr int CPT = CPP < 16 ? CPP : 16;   // of them, a thread's row covers one
    constexpr int HALVES = CPP / CPT;
    constexpr int RPI = 128 / CPT;             // rows the 128 threads cover at once
    static_assert(RPI % 8 == 0, "a thread keeps its swizzle phase");
    const int r0 = pt / CPT, cc = pt % CPT;
    const bool copies = CPR == CPP || cc < CPR;  // false past head_dim 96's 12 chunks
    const uint32_t dst = (cc >> 3) * R::KV_PANEL + swizzled(r0, cc & 7);
    for (int n = 0; n < ntiles; ++n) {
      const int key0 = w.kfirst + (w.i0 + n) * NK, stage = n % STAGES;
      mbar_wait(ring.empty(stage), ((n / STAGES) & 1) ^ 1);
      const uint32_t kt = smem_addr(ring.k(stage)) + dst, vt = smem_addr(ring.v(stage)) + dst;
      const long long src = (long long)(key0 + r0) * ROW + cc * 16;
#pragma unroll
      for (int it = 0; it < NK / RPI; ++it) {
        const bool in = key0 + r0 + RPI * it < p.S;
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
          if (!copies) break;
          const long long off = in ? src + (long long)it * RPI * ROW + h * CPT * 16 : 0;
          const uint32_t at = h * (CPT / 8) * R::KV_PANEL + it * RPI * 128;
          cp_async16_to(kt + at, kg + off, in);
          if constexpr (KIND == KV_BF16) cp_async16_to(vt + at, vg + off, in);
        }
      }
      if constexpr (KIND == KV_BF16) {
        if (pt == 0) load_mask<NK>(ring.mask(stage), mg, key0, p);
      }
      if constexpr (OR) {  // the keys' image ids, 4 a copy
        if (pt < NK / 4) {
          const bool in = key0 + 4 * pt < p.kg_pitch;
          cp_async16(ring.groups(stage) + 4 * pt,
                     p.kg + (size_t)w.b * p.kg_pitch + (in ? key0 + 4 * pt : 0), in);
        }
      }
      cp_async_arrive(ring.full(stage));
      if constexpr (KIND == KV_BF16) {
        if (pt == 0) mbar_arrive(ring.full(stage));  // orders the mask bytes written by hand
      }
    }
  } else {
    for (int n = 0; n < ntiles + LAG; ++n) {
      if (n >= LAG) {
        const int j = n - LAG, stage = j % STAGES, slot = j % R::RAW_SLOTS;
        cp_async_wait<LAG - 1>();  // this thread's copies of tile j have landed
        bar_sync(1, 128);          // and every other producer thread's
        mbar_wait(ring.empty(stage), ((j / STAGES) & 1) ^ 1);
        widen<D, KIND>(ring.raw_k(slot), ring.k(stage), pt);
        widen<D, KIND>(ring.raw_v(slot), ring.v(stage), pt);
        if (pt < NK) {
          ring.ks(stage)[pt] = ring.raw_ks(slot)[pt];
          ring.vs(stage)[pt] = ring.raw_vs(slot)[pt];
        }
        if (pt < NK / 16)
          reinterpret_cast<uint4*>(ring.mask(stage))[pt] =
              reinterpret_cast<const uint4*>(ring.raw_mask(slot))[pt];
        fence_async_proxy();
        mbar_arrive(ring.full(stage));
      }
      if (n < ntiles) {
        const int key0 = w.kfirst + (w.i0 + n) * NK, slot = n % R::RAW_SLOTS;
        const long long end = (long long)p.S * ROW;
        for (int c = pt; c < NK * ROW / 16; c += 128) {
          const long long at = (long long)key0 * ROW + (long long)c * 16;
          const bool in = at < end;
          cp_async16(ring.raw_k(slot) + c * 16, kg + (in ? at : 0), in);
          cp_async16(ring.raw_v(slot) + c * 16, vg + (in ? at : 0), in);
        }
        if (pt < NK) {
          const bool in = key0 + pt < p.S;
          const size_t at = kvh * p.S + (in ? key0 + pt : 0);
          cp_async4(ring.raw_ks(slot) + pt, p.ks + at, in);
          cp_async4(ring.raw_vs(slot) + pt, p.vs + at, in);
        }
        if (pt == 0) load_mask<NK>(ring.raw_mask(slot), mg, key0, p);
      }
      cp_async_commit();
    }
  }
}

// ----------------------------------------------------------------------- //
// A consumer warpgroup

// 64 rows of the block: warp w of the warpgroup holds rows 16w..16w+15, a
// thread rows g = lane / 4 and g + 8 and, of every 8 columns, 2 (lane % 4)
// and the next (element 4n + i of an accumulator: 8-column group n, row
// g + 8 (i / 2), column 2 (lane % 4) + i % 2).
template <int D, int KIND, bool OR>
__device__ __forceinline__ void consume(const FlashParams& p, const Ring<D, KIND, OR>& ring,
                                        const Walk& w, int tid) {
  using R = Ring<D, KIND, OR>;
  constexpr int NK = R::NK, STAGES = R::STAGES, PANELS = R::PANELS;
  constexpr bool QUANT = KIND != KV_BF16;
  // The warpgroup index, broadcast from lane 0 so that the compiler sees a
  // warp-uniform value: every branch around a wgmma below depends on it.
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  // This thread's two rows: head gi, position t of the call, cache slot qs,
  // image id gq (OR; -1 for text and for rows past the call).
  bool valid[2];
  int qs[2], gq[2] = {-1, -1};
  size_t orow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wg * 64 + warp * 16 + g + 8 * r;
    const int gi = row / p.bq, t = w.t0 + row % p.bq;
    valid[r] = gi < p.G && t < p.T;
    qs[r] = valid[r] ? p.prior + t : -(1 << 30);
    orow[r] = ((size_t)w.b * p.Hq + w.h * p.G + (valid[r] ? gi : 0)) * p.T + (valid[r] ? t : 0);
    if constexpr (OR) gq[r] = valid[r] ? p.qg[(size_t)w.b * p.T + t] : -1;
  }
  // The slots of the warpgroup's real rows lie in [qmin, qmax] (the bounds may
  // be loose; the per-element test is exact).
  const int lo = wg * 64, hi = min(lo + 63, p.G * p.bq - 1);
  int ti_lo = 0, ti_hi = p.bq - 1;
  if (hi >= lo && lo / p.bq == hi / p.bq) {
    ti_lo = lo % p.bq;
    ti_hi = hi % p.bq;
  }
  ti_hi = min(ti_hi, p.T - 1 - w.t0);
  const bool active = hi >= lo && ti_lo <= ti_hi;
  const int qmin = p.prior + w.t0 + ti_lo, qmax = p.prior + w.t0 + ti_hi;
  // How far the or-mask reaches past the diagonal (up), and how far behind
  // a row a key may lie and still be visible to it (less than back slots).
  const int up = OR ? p.or_span - 1 : 0;
  const int back = OR ? max(p.window, p.or_span) : p.window;

  float o[PANELS][32];
#pragma unroll
  for (int pn = 0; pn < PANELS; ++pn)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[pn][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, in the units of the logits below
  float l[2] = {0.f, 0.f};              // this thread's share of the running sum
  // exp(x - m) = ex2(x * c - m * c). Without softcap x is the raw product and
  // c carries sm_scale (> 0, so the max commutes with it).
  const bool capped = p.softcap > 0.f;
  const float c = (capped ? 1.f : p.sm_scale) * LOG2E;
  const float cap_scale = capped ? p.sm_scale / p.softcap : 0.f;
  const uint64_t qdesc = tile_desc(ring.q() + wg * 64 * 128);

  // The loop is software-pipelined: a tile's S = Q.K^T is started together with
  // the previous tile's O += P.V, whose P waits in `pa`. The two warpgroups
  // take turns (named barriers 2 and 3), which keeps one in its softmax
  // while the other's products run. Every wgmma group is started and awaited
  // inside one branch of straight-line code: ptxas serialises groups whose
  // start and wait lie in different conditional blocks (it says so: C7514,
  // C7520), and it needs the warpgroup index as a warp-uniform value.
  float s[NK / 2];
  uint32_t pa[NK / 16][4];
  float alpha[2];
  bool have_p = false;  // `pa` holds a tile's P whose product is not started yet
  int p_stage = 0;      // that tile's stage: released once the product is done
  const int turn = 2 + wg, others = 2 + (wg ^ 1);
  if (wg == 1) bar_arrive(2, CONSUMERS);  // warpgroup 0 goes first

  auto start_s = [&](int stage) {
    const uint64_t kdesc = tile_desc(ring.k(stage));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t qoff = ((kk >> 2) * R::Q_PANEL + (kk & 3) * 32) >> 4;
      const uint64_t koff = ((kk >> 2) * R::KV_PANEL + (kk & 3) * 32) >> 4;
      wgmma_ss(s, qdesc + qoff, kdesc + koff, kk > 0);
    }
    wgmma_commit();
  };
  auto start_pv = [&]() {
    const uint64_t vdesc = tile_desc(ring.v(p_stage));
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NK / 16; ++j)
#pragma unroll
      for (int pn = 0; pn < PANELS; ++pn)
        wgmma_rs_t(o[pn], pa[j], vdesc + ((pn * R::KV_PANEL + j * 2048) >> 4));
    wgmma_commit();
  };
  auto finish_pv = [&]() {
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < PANELS; ++pn) keep(o[pn]);
    keep(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(p_stage));
  };
  // s: logits of the tile -> unnormalised probabilities (times the value
  // scales of a quantized cache); updates m and l, sets alpha.
  auto softmax = [&](int stage, int key0, uint32_t flags) {
    // A tile whose keys are all live, below the diagonal of every row and
    // inside every row's window takes no per-element test.
    const bool all_live = (flags & ALL_LIVE) != 0u;
    const bool below_diagonal = key0 + NK - 1 <= qmin;
    const bool in_window = p.window <= 0 || key0 > qmax - p.window;

    if (QUANT || capped) {
      const float* ksc = ring.ks(stage);
#pragma unroll
      for (int nn = 0; nn < NK / 8; ++nn) {
        float2 sc = make_float2(1.f, 1.f);
        if (QUANT) sc = *reinterpret_cast<const float2*>(ksc + nn * 8 + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * nn + e] * ((e & 1) ? sc.y : sc.x);
          if (capped) x = tanhf(x * cap_scale) * p.softcap;
          s[4 * nn + e] = x;
        }
      }
    }
    const uint8_t* mk = ring.mask(stage);
    if (below_diagonal && in_window) {
      if (!all_live) {  // the keep-bits alone
#pragma unroll
        for (int nn = 0; nn < NK / 8; ++nn) {
          const uint32_t bits = *reinterpret_cast<const uint16_t*>(mk + nn * 8 + 2 * tq);
          const bool k0 = (bits & 0xFFu) != 0u, k1 = (bits >> 8) != 0u;
          s[4 * nn + 0] = k0 ? s[4 * nn + 0] : -INFINITY;
          s[4 * nn + 1] = k1 ? s[4 * nn + 1] : -INFINITY;
          s[4 * nn + 2] = k0 ? s[4 * nn + 2] : -INFINITY;
          s[4 * nn + 3] = k1 ? s[4 * nn + 3] : -INFINITY;
        }
      }
    } else {
      // Tile column x of a row is visible iff wlim < x <= lim, or (OR) the
      // row's image id is >= 0 and equals the key's.
      int lim[2], wlim[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lim[r] = qs[r] - key0 - 2 * tq;
        wlim[r] = p.window > 0 ? lim[r] - p.window : -(1 << 30);
      }
#pragma unroll
      for (int nn = 0; nn < NK / 8; ++nn) {
        const uint32_t bits = *reinterpret_cast<const uint16_t*>(mk + nn * 8 + 2 * tq);
        int2 gk = make_int2(-1, -1);
        if constexpr (OR) gk = *reinterpret_cast<const int2*>(ring.groups(stage) + nn * 8 + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = nn * 8 + (e & 1);
          bool in = x <= lim[e >> 1] && x > wlim[e >> 1];
          if constexpr (OR) in = in || (gq[e >> 1] >= 0 && gq[e >> 1] == ((e & 1) ? gk.y : gk.x));
          const bool ok = ((bits >> (8 * (e & 1))) & 0xFFu) != 0u && in;
          s[4 * nn + e] = ok ? s[4 * nn + e] : -INFINITY;
        }
      }
    }

    // Four running maxima (and sums) a row keep the dependency chains short.
    float mx[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) mx[r][u] = -INFINITY;
#pragma unroll
    for (int e = 0; e < NK / 2; ++e)
      mx[(e >> 1) & 1][(e >> 2) & 3] = fmaxf(mx[(e >> 1) & 1][(e >> 2) & 3], s[e]);
    float mc[2], sum[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mrow = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
      const float mnew = fmaxf(m[r], quad_max(mrow));
      const float msafe = mnew == -INFINITY ? 0.f : mnew;  // no live key so far
      alpha[r] = ex2((m[r] - msafe) * c);                  // 0 while m is -inf
      mc[r] = msafe * c;
      m[r] = mnew;
#pragma unroll
      for (int u = 0; u < 4; ++u) sum[r][u] = 0.f;
    }
    const float* vsc = ring.vs(stage);
#pragma unroll
    for (int nn = 0; nn < NK / 8; ++nn) {
      float2 sc = make_float2(1.f, 1.f);
      if (QUANT) sc = *reinterpret_cast<const float2*>(vsc + nn * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(fmaf(s[4 * nn + e], c, -mc[e >> 1]));
        sum[e >> 1][nn & 3] += pe;
        s[4 * nn + e] = QUANT ? pe * ((e & 1) ? sc.y : sc.x) : pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * alpha[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
  };

  for (int i = w.i0; i < w.i1; ++i) {
    const int n = i - w.i0, stage = n % STAGES;
    mbar_wait(ring.full(stage), (n / STAGES) & 1);
    const uint32_t flags = tile_flags<NK>(ring.mask(stage), lane);
    const int key0 = w.kfirst + i * NK;
    // Some key of the tile is live and visible to some row of the warpgroup.
    const bool visible = active && (flags & ANY_LIVE) != 0u && key0 <= qmax + up &&
                         (p.window <= 0 || key0 + NK - 1 > qmin - back);
    bar_sync(turn, CONSUMERS);
    if (!visible) {
      // Nothing to add. A waiting P is multiplied out now: its stage must not
      // stay taken while the ring moves on.
      if (have_p) {
        start_pv();
        bar_arrive(others, CONSUMERS);
        finish_pv();
        have_p = false;
      } else {
        bar_arrive(others, CONSUMERS);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(ring.empty(stage));
      continue;
    }
    if (have_p) {
      start_s(stage);
      start_pv();
      bar_arrive(others, CONSUMERS);
      wgmma_wait<1>();  // S is done, P.V runs on
      keep(s);
      softmax(stage, key0, flags);
      finish_pv();
    } else {
      start_s(stage);
      bar_arrive(others, CONSUMERS);
      wgmma_wait<0>();
      keep(s);
      softmax(stage, key0, flags);
    }
    // The running max of a long row seldom moves: skip the rescale when no
    // row of the warp needs it.
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int pn = 0; pn < PANELS; ++pn)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[pn][e] *= alpha[(e >> 1) & 1];
    }
    // The S fragment of key columns 16j..16j+15 is the A fragment of k16 step
    // j of P.V.
#pragma unroll
    for (int j = 0; j < NK / 16; ++j) {
      pa[j][0] = pack_bf16x2(s[8 * j + 0], s[8 * j + 1]);
      pa[j][1] = pack_bf16x2(s[8 * j + 2], s[8 * j + 3]);
      pa[j][2] = pack_bf16x2(s[8 * j + 4], s[8 * j + 5]);
      pa[j][3] = pack_bf16x2(s[8 * j + 6], s[8 * j + 7]);
    }
    have_p = true;
    p_stage = stage;
  }
  if (have_p) {
    start_pv();
    finish_pv();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    if (!valid[r]) continue;
    if (p.nsplit == 1) {
      const float inv = lsum == 0.f ? 1.f : 1.f / lsum;
      __nv_bfloat16* dst = p.out + orow[r] * D;
#pragma unroll
      for (int pn = 0; pn < PANELS; ++pn)
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          if (pn * 64 + nn * 8 < D)  // head_dim 96: the padded columns are not stored
          *reinterpret_cast<uint32_t*>(dst + pn * 64 + nn * 8 + 2 * tq) =
              pack_bf16x2(o[pn][4 * nn + 2 * r] * inv, o[pn][4 * nn + 2 * r + 1] * inv);
      if (p.lse != nullptr && tq == 0)
        p.lse[orow[r]] = lsum > 0.f ? m[r] * (c * LN2) + logf(lsum) : -INFINITY;
    } else {
      const size_t part = (size_t)w.split * p.B * p.Hq * p.T + orow[r];
      float* dst = p.part_o + part * D;
#pragma unroll
      for (int pn = 0; pn < PANELS; ++pn)
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          if (pn * 64 + nn * 8 < D)
          *reinterpret_cast<float2*>(dst + pn * 64 + nn * 8 + 2 * tq) =
              make_float2(o[pn][4 * nn + 2 * r], o[pn][4 * nn + 2 * r + 1]);
      if (tq == 0)
        *reinterpret_cast<float2*>(p.part_ml + part * 2) =
            make_float2(m[r] == -INFINITY ? -INFINITY : m[r] * c, lsum);
    }
  }
}

// A consumer warpgroup of the row-logsumexp pass (KIND = LSE_ONLY): the loop
// above with S = Q.K^T alone. Per logit: a max, one FMA, one ex2 and one add.
// The queries are slot-aligned with the keys (prior 0, no window, no
// keep-mask), so a tile is classified from its position: wholly below the
// diagonal of the warpgroup's rows (no test) or across it (the causal test;
// a tile past every row is masked whole). With no P.V to overlap, the
// warpgroup keeps two S accumulators and starts the next tile's product
// before this tile's exponentials; the warpgroups do not take turns (both
// measured faster on the card: PERF.md).
template <int D>
__device__ __forceinline__ void consume_lse(const FlashParams& p, const Ring<D, LSE_ONLY>& ring,
                                            const Walk& w, int tid) {
  using R = Ring<D, LSE_ONLY>;
  constexpr int NK = R::NK, STAGES = R::STAGES;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  bool valid[2];
  int qs[2];
  size_t orow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wg * 64 + warp * 16 + g + 8 * r;
    const int gi = row / p.bq, t = w.t0 + row % p.bq;
    valid[r] = gi < p.G && t < p.T;
    qs[r] = valid[r] ? t : -(1 << 30);
    orow[r] = ((size_t)w.b * p.Hq + w.h * p.G + (valid[r] ? gi : 0)) * p.T + (valid[r] ? t : 0);
  }
  // The first position of the warpgroup's rows (loose where its rows span
  // two heads; the per-element test is exact).
  const int lo = wg * 64, hi = min(lo + 63, p.G * p.bq - 1);
  const int qmin = w.t0 + (hi >= lo && lo / p.bq == hi / p.bq ? lo % p.bq : 0);

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const bool capped = p.softcap > 0.f;
  const float c = (capped ? 1.f : p.sm_scale) * LOG2E;
  const float cap_scale = capped ? p.sm_scale / p.softcap : 0.f;
  const uint64_t qdesc = tile_desc(ring.q() + wg * 64 * 128);
  float sa[NK / 2], sb[NK / 2];

  auto start = [&](float (&s)[NK / 2], int i) {
    const int n = i - w.i0, stage = n % STAGES;
    mbar_wait(ring.full(stage), (n / STAGES) & 1);
    const uint64_t kdesc = tile_desc(ring.k(stage));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t qoff = ((kk >> 2) * R::Q_PANEL + (kk & 3) * 32) >> 4;
      const uint64_t koff = ((kk >> 2) * R::KV_PANEL + (kk & 3) * 32) >> 4;
      wgmma_ss(s, qdesc + qoff, kdesc + koff, kk > 0);
    }
    wgmma_commit();
  };
  // The tile's logits (in s, product done) into the running max and sum;
  // then its stage is released.
  auto finish = [&](float (&s)[NK / 2], int i) {
    const int key0 = w.kfirst + i * NK;
    if (capped) {
#pragma unroll
      for (int e = 0; e < NK / 2; ++e) s[e] = tanhf(s[e] * cap_scale) * p.softcap;
    }
    if (key0 + NK - 1 > qmin) {  // across the diagonal: column x of a row is visible iff x <= lim
      int lim[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) lim[r] = qs[r] - key0 - 2 * tq;
#pragma unroll
      for (int e = 0; e < NK / 2; ++e)
        s[e] = (e >> 2) * 8 + (e & 1) <= lim[(e >> 1) & 1] ? s[e] : -INFINITY;
    }
    float mx[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) mx[r][u] = -INFINITY;
#pragma unroll
    for (int e = 0; e < NK / 2; ++e)
      mx[(e >> 1) & 1][(e >> 2) & 3] = fmaxf(mx[(e >> 1) & 1][(e >> 2) & 3], s[e]);
    float mc[2], sum[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mrow = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
      const float mnew = fmaxf(m[r], quad_max(mrow));
      const float msafe = mnew == -INFINITY ? 0.f : mnew;
      l[r] *= ex2((m[r] - msafe) * c);
      mc[r] = msafe * c;
      m[r] = mnew;
#pragma unroll
      for (int u = 0; u < 4; ++u) sum[r][u] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < NK / 2; ++e)
      sum[(e >> 1) & 1][(e >> 2) & 3] += ex2(fmaf(s[e], c, -mc[(e >> 1) & 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] += (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]);
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty((i - w.i0) % STAGES));
  };

  // Two tiles a turn of the loop, sa and sb in turn, so that every start and
  // every wait lies in straight-line code (ptxas serialises wgmma groups it
  // cannot follow across branches).
  int i = w.i0;
  if (i < w.i1) {
    start(sa, i);
    for (; i + 2 < w.i1; i += 2) {
      start(sb, i + 1);
      wgmma_wait<1>();
      keep(sa);
      finish(sa, i);
      start(sa, i + 2);
      wgmma_wait<1>();
      keep(sb);
      finish(sb, i + 1);
    }
    if (i + 1 < w.i1) {
      start(sb, i + 1);
      wgmma_wait<1>();
      keep(sa);
      finish(sa, i);
      wgmma_wait<0>();
      keep(sb);
      finish(sb, i + 1);
    } else {
      wgmma_wait<0>();
      keep(sa);
      finish(sa, i);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    if (valid[r] && tq == 0)
      p.lse[orow[r]] = lsum > 0.f ? m[r] * (c * LN2) + logf(lsum) : -INFINITY;
  }
}

// ----------------------------------------------------------------------- //
// The kernels

// One block per (q-tile, key range, kv head, batch row). Causal work grows
// with the q-tile index: the longest q-tiles start first. The body of
// flash_sm90_kernel and of observed_colsum.cu's observed_lse_kernel.
template <int D, int KIND, bool OR = false>
__device__ __forceinline__ void flash_block(const FlashParams& p) {
  using R = Ring<D, KIND, OR>;
  constexpr int NK = R::NK;
  extern __shared__ unsigned char smem_dyn[];
  const R ring{smem_dyn + ((1024u - (smem_addr(smem_dyn) & 1023u)) & 1023u)};
  const int tid = threadIdx.x;
  const int nq = (p.T + p.bq - 1) / p.bq;
  Walk w;
  w.split = blockIdx.x % p.nsplit;
  w.h = blockIdx.y;
  w.b = blockIdx.z;
  w.t0 = (nq - 1 - (int)blockIdx.x / p.nsplit) * p.bq;
  const int last_t = min(w.t0 + p.bq, p.T) - 1;
  // The or-mask widens the range by the reach of an image span: up to
  // or_span - 1 slots past the last row, and as far behind the first.
  const int up = OR ? p.or_span - 1 : 0;
  const int kend = min(p.S, p.prior + last_t + 1 + up);
  const int back = OR ? max(p.window - 1, up) : p.window - 1;
  const int first = p.window > 0 ? max(0, p.prior + w.t0 - back) : 0;
  w.kfirst = first / NK * NK;
  const int ntiles = kend > w.kfirst ? (kend - w.kfirst + NK - 1) / NK : 0;
  const int per = (ntiles + p.nsplit - 1) / p.nsplit;
  w.i0 = min(ntiles, w.split * per);
  w.i1 = min(ntiles, w.i0 + per);

  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(ring.full(s), R::FULL_ARRIVALS);
      mbar_init(ring.empty(s), CONSUMERS / 32); // one lane of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q: row r of the block is head r / bq, position t0 + r % bq; rows past the
  // group or past T are zeros.
  constexpr int CPR = D / 8;
  for (int ch = tid; ch < BLOCK_ROWS * CPR; ch += THREADS) {
    const int row = ch / CPR, cc = ch % CPR;
    const int gi = row / p.bq, t = w.t0 + row % p.bq;
    const bool ok = gi < p.G && t < p.T;
    const size_t at = (((size_t)w.b * p.Hq + w.h * p.G + (ok ? gi : 0)) * p.T + (ok ? t : 0)) * D;
    cp_async16(ring.q() + (cc >> 3) * R::Q_PANEL + swizzled(row, cc & 7), p.q + at + cc * 8, ok);
  }
  // Head_dim 96: the V channels past D that P.V reads in every stage are
  // zeros, written once here (nothing writes them later).
  if constexpr (R::KV == 2 && R::DP != D) {
    constexpr int PAD = (R::DP - D) / 8;  // 16-byte chunks of a row past D
    for (int i = tid; i < R::STAGES * NK * PAD; i += THREADS) {
      const int s = i / (NK * PAD), row = i / PAD % NK, cc = CPR + i % PAD;
      *reinterpret_cast<uint4*>(ring.v(s) + (cc >> 3) * R::KV_PANEL + swizzled(row, cc & 7)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_proxy();
  __syncthreads();

  // The two roles never meet again: setmaxnreg needs that.
  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    produce<D, KIND, OR>(p, ring, w, tid - CONSUMERS);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if constexpr (KIND == LSE_ONLY) consume_lse<D>(p, ring, w, tid);
    else consume<D, KIND, OR>(p, ring, w, tid);
  }
}

template <int D, int KIND, bool OR>
__global__ void __launch_bounds__(THREADS, 1) flash_sm90_kernel(const FlashParams p) {
  flash_block<D, KIND, OR>(p);
}

// Merge of the key ranges of a split launch, ranges in index order: one thread
// per 4 channels of a row.
template <int D>
__global__ void flash_sm90_merge_kernel(const float* __restrict__ part_o,
                                        const float* __restrict__ part_ml,
                                        __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                        size_t rows, int nsplit) {
  constexpr int TPR = D / 4;
  const size_t row = (size_t)blockIdx.x * (blockDim.x / TPR) + threadIdx.x / TPR;
  const int c4 = threadIdx.x % TPR;
  if (row >= rows) return;
  float mmax = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mmax = fmaxf(mmax, part_ml[(s * rows + row) * 2]);
  float lsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (mmax != -INFINITY) {
    for (int s = 0; s < nsplit; ++s) {
      const float2 ml = *reinterpret_cast<const float2*>(part_ml + (s * rows + row) * 2);
      const float wgt = ex2(ml.x - mmax);  // 0 for a range that met no live key
      const float4 po = *reinterpret_cast<const float4*>(part_o + (s * rows + row) * D + 4 * c4);
      lsum += wgt * ml.y;
      acc.x += wgt * po.x;
      acc.y += wgt * po.y;
      acc.z += wgt * po.z;
      acc.w += wgt * po.w;
    }
  }
  const float inv = lsum == 0.f ? 1.f : 1.f / lsum;
  uint2 packed;
  packed.x = pack_bf16x2(acc.x * inv, acc.y * inv);
  packed.y = pack_bf16x2(acc.z * inv, acc.w * inv);
  *reinterpret_cast<uint2*>(out + row * D + 4 * c4) = packed;
  if (lse != nullptr && c4 == 0) lse[row] = lsum > 0.f ? mmax * LN2 + logf(lsum) : -INFINITY;
}

// Host side. 128 rows a block: G heads by 128 / G positions.
inline int block_q(int G) { return BLOCK_ROWS / G; }

template <int D, int KIND, bool OR = false>
inline cudaError_t launch_flash(FlashParams p, cudaStream_t stream) {
  if (p.G < 1 || p.G > BLOCK_ROWS || p.nsplit < 1 || p.T < 1 ||
      (p.nsplit > 1 && (p.part_o == nullptr || p.part_ml == nullptr)) ||
      (OR && (p.qg == nullptr || p.kg == nullptr || p.or_span < 1)))
    return cudaErrorInvalidValue;
  constexpr int smem = Ring<D, KIND, OR>::BYTES + 1024;  // room to align the base
  cudaError_t err = cudaFuncSetAttribute(flash_sm90_kernel<D, KIND, OR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.bq = block_q(p.G);
  const int nq = (p.T + p.bq - 1) / p.bq;
  dim3 grid(nq * p.nsplit, p.Hkv, p.B);
  flash_sm90_kernel<D, KIND, OR><<<grid, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  const size_t rows = (size_t)p.B * p.Hq * p.T;
  // A whole number of rows a block (head_dim 96: 10 rows of 24 threads).
  constexpr int rows_per_block = 256 / (D / 4), threads = rows_per_block * (D / 4);
  flash_sm90_merge_kernel<D><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), threads,
                               0, stream>>>(p.part_o, p.part_ml, p.out, p.lse, rows, p.nsplit);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace kvp
