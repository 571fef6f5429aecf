// The few-token attention kernels for sm_90a, shared by decode.cu (a bf16,
// int8 or packed-int4 cache under a keep-mask) and decode_headwise.cu (a
// bf16 cache read over each head's own prefix and the shared tail).
//
// What bounds them on an H100: bytes. At T = 1 and GQA 32/8 a kv head has
// G * T = 4 query rows, so each K/V byte feeds a handful of operations and
// the least time is the K/V (and scale and keep-mask) bytes over 3.35 TB/s.
// What the design does about it:
//
// * The key range of each (row group, kv head, batch row) is split over
//   `nsplit` blocks (chosen on the host from the shapes alone), so that even
//   batch 1 puts hundreds of blocks on the 132 SMs. Each block writes its
//   unnormalised f32 output, row max (log2 units) and sum to scratch, and a
//   second kernel merges the ranges in index order (no atomics: the same
//   bits every run). The merge takes a block of 128 threads a row, so its
//   loads over the ranges are in flight together (flash_sm90.cuh's merge
//   has a thread walk the ranges one after another). With nsplit = 1 the
//   block stores the output itself.
// * Steps of NK keys (16 KB of K+V payload: 64 keys of bf16 at head_dim 64,
//   128 of int8, 256 of int4) go through a ring of four stages behind full /
//   empty mbarriers. One producer warp fills it: a step's K, V, per-token
//   scales and keep-mask bytes are each one contiguous run of device memory
//   in the (B, Hkv, S, .) layout, so each is one bulk copy
//   (cp.async.bulk ... mbarrier::complete_tx) issued by one lane. A run that
//   is not 16-byte aligned or sized (scales or mask bytes of a head that
//   starts off a 16-byte boundary, the last partial step) is copied by the
//   producer's 32 lanes, and the V rows and value scales past it are zeroed
//   (stale shared memory could hold NaN, which a zero probability would not
//   cancel).
// * Four consumer warps each take a quarter of every step and never meet at
//   a block-wide barrier until the end. Operands are widened in registers
//   straight from the raw stage: no bf16 tile pass. The products are
//   mma.sync m16n8k16 (a kv head's 4 rows fill 16-row tiles; wgmma's 64 rows
//   would be 94% padding, and bytes, not the tensor cores, are the limit).
//   Channels are permuted to suit the loads (a product sums over channels
//   and the output is written back through the same map): for S = Q.K^T a
//   lane reads its own contiguous quarter of a key row, for O += P.V its own
//   contiguous eighth of four value rows.
// * Masking only where a step needs it. A step whose slots all exist and lie
//   below every row's diagonal and inside its window tests only the
//   keep-bits, and none if they are all set: a consumer warp's own
//   instruction chain, more than the copies, sets the pace of a block.
// * Head_dim 256 (Gemma-3 1B/4B/12B). A consumer warp's output for 16 rows x
//   256 channels is 128 f32 a lane, and its Q fragments would be 64 more. So
//   at 256 the Q fragments wait in shared memory (8 KB, written once, one
//   16-byte load a k-step), and K and V words are loaded 16 bytes at a time,
//   each load feeding the k-steps or n-tiles it holds: a lane keeps about 70
//   registers beside O, within the 255 of one block an SM. A step keeps its
//   floor of 64 keys (16 a consumer warp), so a bf16 stage is 64 KB and the
//   ring has three of them (int8 and int4 keep four); the final merge still
//   fits over the stages.
// * Head_dim 96 (Phi-3-mini). A step keeps 8 KB of K payload rounded down
//   to whole 64-key steps (64 keys of bf16 and int8, 128 of int4), so that
//   each consumer warp takes whole 16-key blocks. A lane's quarter of a key
//   row is 24 channels (48, 24 or 12 bytes) and its eighth of a value row 12
//   (24 bytes of bf16, 12 of int8 or int4): whole rows of 16-byte words do
//   not fit those, so the loads are 16 bytes wide where the run is a
//   multiple of 16, else 8 or 4 (load_words), from rows that lie on 16-byte
//   boundaries (192, 96 and 48 bytes).
// * decode.cu reads each block's keep-mask bytes once before its walk (1
//   byte a slot against 72 bytes of int4 K+V and scales), builds the list of
//   its live steps in shared memory (a vote per step, then a ballot and a
//   prefix sum), and walks only those.
//
// Numerics: logits and softmax statistics in float32, bf16 operands for both
// products, exponentials as ex2 with log2(e) folded into the logit scale. A
// masked logit is the finite NEG_INF: a run of keys that is wholly masked for
// a row adds exp(0) terms that the next live key's rescale wipes out, and a
// key range with no live key for a row gets a weight of 0 in the merge, so a
// real row (one that sees a live key) matches the dense path and a padding
// row is finite. A block that walks no step stores max -inf and sum 0, and a
// row that met no key in any range stores 0.
#pragma once

#include <type_traits>

#include "flash_sm90.cuh"

namespace kvp {
namespace few {

using sm90::ex2;
using sm90::fence_async_proxy;
using sm90::LOG2E;
using sm90::mbar_arrive;
using sm90::mbar_init;
using sm90::mbar_wait;

constexpr int CWARPS = 4;                    // consumer warps
constexpr int THREADS = 32 * (CWARPS + 1);   // and one producer warp
constexpr int MAX_SPLITS = 64;               // ops/decode.py MAX_SPLITS
constexpr int MERGE_THREADS = 128;

// Keys of one step: 8 KB of K payload in whole 64-key steps, at least 64 (16
// keys a consumer warp; head_dim 96: 64, 64 and 128 for bf16, int8 and int4).
template <int D, int KIND>
__host__ __device__ constexpr int step_keys() {
  return 8192 / row_bytes<D, KIND>() / 64 > 1 ? 8192 / row_bytes<D, KIND>() / 64 * 64 : 64;
}

struct FewParams {
  const __nv_bfloat16* q;   // (B, Hq, T, D)
  const void* k;            // (B, Hkv, S, D) bf16/int8 | (B, Hkv, S, D/2) uint8
  const void* v;
  const float* ks;          // (B, Hkv, S) f32 or null
  const float* vs;
  const uint8_t* mask;      // (B, Hkv, S) keep-bytes or null
  const int* prefix_lens;   // head-wise: (B, Hkv)
  const int* tail;          // head-wise: tail_start, tail_len
  __nv_bfloat16* out;       // (B, Hq, T, D)
  float* part_o;            // (nsplit, B, Hq, T, D) f32, nsplit > 1
  float* part_ml;           // (nsplit, B, Hq, T, 2) f32: max (log2 units), sum
  int B, Hq, Hkv, T, S, G, length, nsplit, window;
  float sm_scale, softcap;
};

// One step of a walk: slots [key0, key0 + NK), of which those below hi exist
// for it; with `causal` a row at cache slot qs sees only slots <= qs. Its
// mode says which tests its logits take: DENSE, none (every slot exists,
// carries a set keep-bit, and every row sees it); INSIDE, the keep-bits alone
// (every row sees every slot); EDGE, all of them.
enum StepMode { EDGE = 0, INSIDE = 1, DENSE = 2 };
struct Step {
  int key0, hi, causal, mode;
};

// Shared memory: STAGES stages of (K, V, key scales, value scales, keep-mask
// bytes) of NK keys each at payload width, as the bulk copies lay them; the
// stages' barriers; at head_dim 256 the consumers' Q fragments; a count and a
// list of live steps (decode.cu). At the end the consumers' partial softmax
// states are merged over the stages.
template <int D, int KIND>
struct Stages {
  static constexpr int NK = step_keys<D, KIND>();
  static constexpr int ROW = row_bytes<D, KIND>();
  static constexpr bool QUANT = KIND != KV_BF16;
  // Four stages; a bf16 stage at head_dim 256 is 64 KB, and three fit.
  static constexpr int STAGES = D == 256 && KIND == KV_BF16 ? 3 : 4;
  static constexpr bool Q_SMEM = D == 256;  // Q fragments in shared memory
  static constexpr int KV = NK * ROW;
  static constexpr int STAGE = 2 * KV + (QUANT ? 8 * NK : 0) + NK;
  static constexpr int OFF_BAR = STAGES * STAGE;
  static constexpr int OFF_Q = OFF_BAR + 2 * STAGES * 8;  // (k-step, lane) x 16 bytes
  static constexpr int OFF_LIST = OFF_Q + (Q_SMEM ? D / 16 * 32 * 16 : 0) + 16;
  static_assert(STAGE % 16 == 0, "bulk copy destinations are 16-byte aligned");
  static_assert(STAGES * STAGE >= CWARPS * 16 * (D + 2) * 4, "room for the final merge");

  unsigned char* base;
  __device__ unsigned char* k(int s) const { return base + s * STAGE; }
  __device__ unsigned char* v(int s) const { return k(s) + KV; }
  __device__ float* ks(int s) const { return reinterpret_cast<float*>(v(s) + KV); }
  __device__ float* vs(int s) const { return ks(s) + NK; }
  __device__ uint8_t* mask(int s) const { return v(s) + KV + (QUANT ? 8 * NK : 0); }
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + OFF_BAR) + s;
  }
  __device__ uint64_t* empty(int s) const { return full(STAGES) + s; }
  __device__ int* count() const { return reinterpret_cast<int*>(base + OFF_LIST - 16); }
  __device__ int* list() const { return reinterpret_cast<int*>(base + OFF_LIST); }
  __device__ uint4* qfrag() const { return reinterpret_cast<uint4*>(base + OFF_Q); }

  __device__ void init_barriers() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 32);        // every producer lane (lane 0 with the bulk bytes)
      mbar_init(empty(s), CWARPS);   // one lane of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// ----------------------------------------------------------------------- //
// PTX pieces

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One contiguous run of device memory into shared memory; completes `bytes`
// of `bar`'s transaction count. Addresses and size are multiples of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// bf16x2 (n0 - 8, n1 - 8) of two nibbles n0, n1 held in bytes 0 and 2 of x
// (the others 0): 0x4300 | n is the bf16 of 128 + n, exact below 128.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t x) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(x | 0x43004300u), "r"(0x3F803F80u), "r"(0xC308C308u));  // * 1 - 136
  return r;
}

__device__ __forceinline__ uint32_t s8_bf16(uint32_t a, uint32_t b) {
  return pack_bf16x2((float)(int8_t)a, (float)(int8_t)b);
}

// N 32-bit words from shared memory, 16 bytes a load when N is a multiple
// of 4, else 8 when N is even, else 4 (head_dim 96's runs of 12 and 24
// bytes); the address is aligned to the width of the loads.
template <int N>
__device__ __forceinline__ void load_words(uint32_t (&w)[N], const unsigned char* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[j];
      w[4 * j] = x.x;
      w[4 * j + 1] = x.y;
      w[4 * j + 2] = x.z;
      w[4 * j + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[j];
      w[2 * j] = x.x;
      w[2 * j + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) w[j] = reinterpret_cast<const uint32_t*>(p)[j];
  }
}

// ----------------------------------------------------------------------- //
// Channel maps. A product sums over channels, so Q and K may take any one
// order; O takes the order of its B operand and is stored back through it.

// S = Q.K^T, k-step ks of lane t: logical channels (2t, 2t+1) and (2t+8,
// 2t+9) are the physical channels kphys(ks, t, 0..1) and (.., 2..3), all
// within the lane's quarter of a key row (bytes t * ROW / 4 ..): channels
// t*D/4 + 4ks .. for bf16 and int8. For int4, k-step ks takes word ks / 2 of
// the lane's bytes, its low nibbles (ks even: channels t*D/8 + 2ks ..) or its
// high ones (D/2 + ..), bytes 0 and 2 into b0 and bytes 1 and 3 into b1: a
// nibble of each half of the word is one mask and one FMA from a bf16 pair.
template <int D, int KIND>
__device__ __forceinline__ int kphys(int ks, int t, int e) {
  if constexpr (KIND == KV_INT4) {
    return (ks & 1) * (D / 2) + t * (D / 8) + 4 * (ks >> 1) + ((e >> 1) | ((e & 1) << 1));
  }
  return t * (D / 4) + 4 * ks + e;
}

// The B fragment (b0, b1) of k-step ks from the lane's words of one key row.
template <int D, int KIND, int W>
__device__ __forceinline__ void kfrag(const uint32_t (&w)[W], int ks, uint32_t& b0,
                                      uint32_t& b1) {
  if constexpr (KIND == KV_BF16) {
    b0 = w[2 * ks];
    b1 = w[2 * ks + 1];
  } else if constexpr (KIND == KV_INT8) {
    b0 = s8_bf16(w[ks], w[ks] >> 8);
    b1 = s8_bf16(w[ks] >> 16, w[ks] >> 24);
  } else {
    const uint32_t x = w[ks >> 1] >> (4 * (ks & 1));
    b0 = nibbles_bf16(x & 0x000F000Fu);
    b1 = nibbles_bf16((x >> 8) & 0x000F000Fu);
  }
}

// O += P.V: column j (0..7) of n-tile n is physical channel vphys(n, j). The
// lane with g = j reads D/8 channels of a value row: bf16 and int8 channels
// j*D/8 .., int4 the low (j < 4) or high nibbles of bytes (j % 4) * D/8 ...
template <int D, int KIND>
__device__ __forceinline__ int vphys(int n, int j) {
  if constexpr (KIND == KV_INT4) return (j >> 2) * (D / 2) + (j & 3) * (D / 8) + n;
  return j * (D / 8) + n;
}

// bf16x2 (row a, row b) of element n of two value rows' words.
template <int KIND, int VW>
__device__ __forceinline__ uint32_t vpair(const uint32_t (&a)[VW], const uint32_t (&b)[VW], int n) {
  if constexpr (KIND == KV_BF16) {
    return __byte_perm(a[n / 2], b[n / 2], (n & 1) ? 0x7632 : 0x5410);
  } else if constexpr (KIND == KV_INT8) {
    return s8_bf16(a[n / 4] >> (8 * (n % 4)), b[n / 4] >> (8 * (n % 4)));
  } else {  // words already shifted to the lane's nibble and masked
    const uint32_t sel = (n % 4) | ((4 + n % 4) << 8);
    return nibbles_bf16(__byte_perm(a[n / 4], b[n / 4], sel) & 0x00FF00FFu);
  }
}

// ----------------------------------------------------------------------- //
// The producer warp

template <int D, int KIND, class Walk>
__device__ __forceinline__ void produce(const FewParams& p, const Stages<D, KIND>& st,
                                        const Walk& w, size_t kvh, int lane) {
  using St = Stages<D, KIND>;
  constexpr int NK = St::NK, ROW = St::ROW, STAGES = St::STAGES;
  const char* kg = reinterpret_cast<const char*>(p.k) + kvh * p.S * ROW;
  const char* vg = reinterpret_cast<const char*>(p.v) + kvh * p.S * ROW;
  for (int i = 0; i < w.n; ++i) {
    const int s = i % STAGES;
    mbar_wait(st.empty(s), ((i / STAGES) & 1) ^ 1);
    const Step step = w.step(i);
    const int n = min(NK, step.hi - step.key0);  // keys of the step that exist
    const size_t at = kvh * p.S + step.key0;      // its first slot in the scales and mask
    const bool bulk_sc = St::QUANT && n % 4 == 0 && aligned16(p.ks + at) && aligned16(p.vs + at);
    const bool bulk_mk = p.mask != nullptr && n % 16 == 0 && aligned16(p.mask + at);
    if (St::QUANT && !bulk_sc) {
      for (int j = lane; j < n; j += 32) {
        st.ks(s)[j] = p.ks[at + j];
        st.vs(s)[j] = p.vs[at + j];
      }
    }
    if (p.mask != nullptr && !bulk_mk)
      for (int j = lane; j < n; j += 32) st.mask(s)[j] = p.mask[at + j];
    if (n < NK) {
      for (int c = n * ROW / 16 + lane; c < NK * ROW / 16; c += 32)
        reinterpret_cast<uint4*>(st.v(s))[c] = make_uint4(0u, 0u, 0u, 0u);
      if (St::QUANT)
        for (int j = n + lane; j < NK; j += 32) st.vs(s)[j] = 0.f;
    }
    fence_async_proxy();  // these writes before later bulk copies into the stage
    if (lane == 0) {
      const uint32_t kv = (uint32_t)n * ROW;
      mbar_arrive_tx(st.full(s), 2 * kv + (bulk_sc ? 8u * n : 0u) + (bulk_mk ? (uint32_t)n : 0u));
      bulk_copy(st.k(s), kg + (size_t)step.key0 * ROW, kv, st.full(s));
      bulk_copy(st.v(s), vg + (size_t)step.key0 * ROW, kv, st.full(s));
      if (bulk_sc) {
        bulk_copy(st.ks(s), p.ks + at, 4u * n, st.full(s));
        bulk_copy(st.vs(s), p.vs + at, 4u * n, st.full(s));
      }
      if (bulk_mk) bulk_copy(st.mask(s), p.mask + at, (uint32_t)n, st.full(s));
    } else {
      mbar_arrive(st.full(s));
    }
  }
}

// ----------------------------------------------------------------------- //
// A consumer warp: keys [warp * NC, warp * NC + NC) of every step, 16 query
// rows (row group rg of the kv head's G * T (head, time) rows). A thread
// holds rows g and g + 8 and, of every 8 columns, 2t and 2t + 1. Without HI
// rows 8..15 of the group are padding (G * T = 4 at T = 1): their logits and
// exponentials are not computed.

template <int D, int KIND, bool HI, class Walk>
__device__ __forceinline__ void consume(const FewParams& p, const Stages<D, KIND>& st,
                                        const Walk& w, int rg, int split, size_t qoff,
                                        int warp, int lane) {
  using St = Stages<D, KIND>;
  constexpr int NK = St::NK, ROW = St::ROW, NC = NK / CWARPS, STAGES = St::STAGES;
  constexpr bool QUANT = St::QUANT;
  constexpr int KW = ROW / 16;                               // words of a lane's K quarter
  constexpr int VB = KIND == KV_BF16 ? D / 4 : D / 8;        // bytes of a lane's V eighth
  constexpr int VW = VB / 4;
  // Words a lane loads at once: its whole K quarter (V eighth) below head_dim
  // 256, there 16 bytes, each load feeding the k-steps (n-tiles) it holds.
  constexpr int KC = D == 256 ? 4 : KW, VC = D == 256 ? 4 : VW;
  constexpr int KPC = D / 16 * KC / KW;                      // k-steps of a K load
  constexpr int NPC = D / 8 * VC / VW;                       // n-tiles of a V load
  const int g = lane >> 2, t = lane & 3;
  const int rows = p.G * p.T;
  int row[2], qs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = rg * 16 + g + 8 * r;
    qs[r] = w.qbase + row[r] % p.T;
  }

  // Q in the channel order of kphys: a[0] row g, a[1] row g + 8, a[2..3] the
  // same 8 logical channels on. At head_dim 256 in shared memory: the warps
  // write a quarter of the k-steps each.
  uint32_t qa[St::Q_SMEM ? 1 : D / 16][4];
  auto qpair = [&](int r, int c0_, int c1_) -> uint32_t {
    if (row[r] >= rows) return 0u;
    const unsigned short* qr =
        reinterpret_cast<const unsigned short*>(p.q + (qoff + row[r]) * D);
    return (uint32_t)qr[c0_] | ((uint32_t)qr[c1_] << 16);
  };
  if constexpr (St::Q_SMEM) {
    for (int ks = warp; ks < D / 16; ks += CWARPS) {
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i & 1, e = (i >> 1) * 2;
        a[i] = qpair(r, kphys<D, KIND>(ks, t, e), kphys<D, KIND>(ks, t, e + 1));
      }
      st.qfrag()[ks * 32 + lane] = make_uint4(a[0], a[1], a[2], a[3]);
    }
    sm90::bar_sync(1, 32 * CWARPS);
  } else {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i & 1, e = (i >> 1) * 2;
        qa[ks][i] = qpair(r, kphys<D, KIND>(ks, t, e), kphys<D, KIND>(ks, t, e + 1));
      }
    }
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const bool capped = p.softcap > 0.f;
  const float scale = capped ? p.sm_scale : p.sm_scale * LOG2E;
  const float cap_inv = capped ? 1.f / p.softcap : 0.f, cap_out = p.softcap * LOG2E;
  const int c0 = warp * NC;
  const int vsh = KIND == KV_INT4 ? 4 * (g >> 2) : 0;
  const int voff = KIND == KV_INT4 ? (g & 3) * (D / 8) : g * VB;

  for (int i = 0; i < w.n; ++i) {
    const int s = i % STAGES;
    mbar_wait(st.full(s), (i / STAGES) & 1);
    const Step step = w.step(i);

    float sc[NC / 8][4];
#pragma unroll
    for (int n = 0; n < NC / 8; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      const unsigned char* kr = st.k(s) + (c0 + n * 8 + g) * ROW + t * (ROW / 4);
#pragma unroll
      for (int kc = 0; kc < KW / KC; ++kc) {
        uint32_t kw[KC];
        load_words<KC>(kw, kr + kc * KC * 4);
#pragma unroll
        for (int j = 0; j < KPC; ++j) {
          uint32_t b0, b1;
          kfrag<D, KIND, KC>(kw, j, b0, b1);
          if constexpr (St::Q_SMEM) {
            const uint4 x = st.qfrag()[(kc * KPC + j) * 32 + lane];
            const uint32_t a[4] = {x.x, x.y, x.z, x.w};
            mma16816(sc[n], a, b0, b1);
          } else {
            mma16816(sc[n], qa[kc * KPC + j], b0, b1);
          }
        }
      }
    }

    // Logits: the key scales folded into the columns. A dense step keeps them
    // unscaled (the exponent takes sm_scale * log2 e in one FMA); every other
    // step scales them and sets a masked one to NEG_INF, testing the keep-bits
    // alone (INSIDE) or everything (EDGE). One loop for each, so that each
    // is straight-line code.
    const bool raw = step.mode == DENSE && !capped;
    float mx[2] = {NEG_INF, NEG_INF};
    auto logits = [&](auto mode) {
      constexpr int MODE = decltype(mode)::value;
#pragma unroll
      for (int n = 0; n < NC / 8; ++n) {
        const int col = c0 + n * 8 + 2 * t;
        float2 ksc = make_float2(1.f, 1.f);
        if (QUANT) ksc = *reinterpret_cast<const float2*>(st.ks(s) + col);
        uint32_t keep = 0x0101u;
        if (MODE != DENSE && p.mask != nullptr)
          keep = *reinterpret_cast<const uint16_t*>(st.mask(s) + col);
#pragma unroll
        for (int e = 0; e < (HI ? 4 : 2); ++e) {
          float x = sc[n][e];
          if (QUANT) x *= (e & 1) ? ksc.y : ksc.x;
          if (MODE != DENSE || capped) {
            x *= scale;
            if (capped) x = tanhf(x * cap_inv) * cap_out;
          }
          if (MODE != DENSE) {
            const int slot = step.key0 + col + (e & 1), r = e >> 1;
            bool ok = ((keep >> (8 * (e & 1))) & 0xFFu) != 0;
            if (MODE == EDGE)
              ok = ok && slot < step.hi && (!step.causal || slot <= qs[r]) &&
                   (p.window <= 0 || slot > qs[r] - p.window);
            x = ok ? x : NEG_INF;
          }
          sc[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    };
    if (step.mode == DENSE) logits(std::integral_constant<int, DENSE>{});
    else if (step.mode == INSIDE) logits(std::integral_constant<int, INSIDE>{});
    else logits(std::integral_constant<int, EDGE>{});
    const float pscale = raw ? scale : 1.f;
    float alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int r = 0; r < (HI ? 2 : 1); ++r) {
      const float mnew = fmaxf(m[r], quad_max(mx[r]) * pscale);
      alpha[r] = ex2(m[r] - mnew);  // 0 on the first step (m = -inf)
      m[r] = mnew;
      l[r] *= alpha[r];
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a max moved
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int n = 0; n < NC / 8; ++n) {
      float2 vsc = make_float2(1.f, 1.f);
      if (QUANT) vsc = *reinterpret_cast<const float2*>(st.vs(s) + c0 + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!HI && e >= 2) {
          sc[n][e] = 0.f;
          continue;
        }
        const float pr = ex2(fmaf(sc[n][e], pscale, -m[e >> 1]));
        l[e >> 1] += pr;
        sc[n][e] = QUANT ? pr * ((e & 1) ? vsc.y : vsc.x) : pr;
      }
    }

#pragma unroll
    for (int kb = 0; kb < NC / 16; ++kb) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(sc[2 * kb][0], sc[2 * kb][1]);
      pa[1] = pack_bf16x2(sc[2 * kb][2], sc[2 * kb][3]);
      pa[2] = pack_bf16x2(sc[2 * kb + 1][0], sc[2 * kb + 1][1]);
      pa[3] = pack_bf16x2(sc[2 * kb + 1][2], sc[2 * kb + 1][3]);
      // Value rows 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of the 16-key block.
      const unsigned char* vr = st.v(s) + (c0 + kb * 16 + 2 * t) * ROW + voff;
#pragma unroll
      for (int ch = 0; ch < VW / VC; ++ch) {
        uint32_t va[VC], vb[VC], vc[VC], vd[VC];
        load_words<VC>(va, vr + ch * VC * 4);
        load_words<VC>(vb, vr + ROW + ch * VC * 4);
        load_words<VC>(vc, vr + 8 * ROW + ch * VC * 4);
        load_words<VC>(vd, vr + 9 * ROW + ch * VC * 4);
        if constexpr (KIND == KV_INT4) {
#pragma unroll
          for (int j = 0; j < VC; ++j) {
            va[j] = (va[j] >> vsh) & 0x0F0F0F0Fu;
            vb[j] = (vb[j] >> vsh) & 0x0F0F0F0Fu;
            vc[j] = (vc[j] >> vsh) & 0x0F0F0F0Fu;
            vd[j] = (vd[j] >> vsh) & 0x0F0F0F0Fu;
          }
        }
#pragma unroll
        for (int j = 0; j < NPC; ++j)
          mma16816(o[ch * NPC + j], pa, vpair<KIND, VC>(va, vb, j), vpair<KIND, VC>(vc, vd, j));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(st.empty(s));
  }

  // Merge the four warps' states over the stages (every warp is past its
  // last step, so no copy is in flight), then store the rows or this range.
  sm90::bar_sync(1, 32 * CWARPS);
  float* cm = reinterpret_cast<float*>(st.base);
  float* cl = cm + CWARPS * 16;
  float* co = cl + CWARPS * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    const int rr = g + 8 * r;
    if (t == 0) {
      cm[warp * 16 + rr] = m[r];
      cl[warp * 16 + rr] = lsum;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      co[(warp * 16 + rr) * D + vphys<D, KIND>(n, 2 * t)] = o[n][2 * r];
      co[(warp * 16 + rr) * D + vphys<D, KIND>(n, 2 * t + 1)] = o[n][2 * r + 1];
    }
  }
  sm90::bar_sync(1, 32 * CWARPS);
  const size_t all_rows = (size_t)p.B * p.Hq * p.T;
  for (int idx = warp * 32 + lane; idx < 16 * D; idx += 32 * CWARPS) {
    const int rr = idx / D, col = idx % D, r = rg * 16 + rr;
    if (r >= rows) continue;
    float mm = -INFINITY;
#pragma unroll
    for (int v = 0; v < CWARPS; ++v) mm = fmaxf(mm, cm[v * 16 + rr]);
    float lsum = 0.f, acc = 0.f;
    if (mm != -INFINITY) {  // -inf only when no step was walked
#pragma unroll
      for (int v = 0; v < CWARPS; ++v) {
        const float a = ex2(cm[v * 16 + rr] - mm);
        lsum += a * cl[v * 16 + rr];
        acc += a * co[(v * 16 + rr) * D + col];
      }
    }
    const size_t orow = qoff + r;
    if (p.nsplit == 1) {
      p.out[orow * D + col] = __float2bfloat16(acc * (lsum == 0.f ? 1.f : 1.f / lsum));
    } else {
      p.part_o[((size_t)split * all_rows + orow) * D + col] = acc;
      if (col == 0) {
        p.part_ml[((size_t)split * all_rows + orow) * 2] = mm;
        p.part_ml[((size_t)split * all_rows + orow) * 2 + 1] = lsum;
      }
    }
  }
}

// The block's two roles, after the barriers are initialised and the walk
// is known to every thread.
template <int D, int KIND, class Walk>
__device__ __forceinline__ void run_block(const FewParams& p, const Stages<D, KIND>& st,
                                          const Walk& w, int rg, int split, int h, int b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t kvh = (size_t)b * p.Hkv + h;
  if (warp == CWARPS) {
    produce<D, KIND>(p, st, w, kvh, lane);
  } else {
    const size_t qoff = ((size_t)b * p.Hq + (size_t)h * p.G) * p.T;  // rows (g, t) of kv head h
    if (rg * 16 + 8 < p.G * p.T)
      consume<D, KIND, true>(p, st, w, rg, split, qoff, warp, lane);
    else
      consume<D, KIND, false>(p, st, w, rg, split, qoff, warp, lane);
  }
}

// Host side: the block kernel over (row groups x nsplit, Hkv, B), then, for
// nsplit > 1, the merge kernel over B * Hq * T rows.
template <int D>
inline cudaError_t launch_few(void (*kernel)(FewParams),
                              void (*merge)(const float*, const float*, __nv_bfloat16*, size_t,
                                            int),
                              const FewParams& p, size_t smem, cudaStream_t stream) {
  if (p.G < 1 || p.T < 1 || p.nsplit < 1 || p.nsplit > MAX_SPLITS ||
      (p.nsplit > 1 && (p.part_o == nullptr || p.part_ml == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = (p.G * p.T + 15) / 16;
  dim3 grid(groups * p.nsplit, p.Hkv, p.B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  const size_t rows = (size_t)p.B * p.Hq * p.T;
  merge<<<(unsigned)rows, MERGE_THREADS, 0, stream>>>(p.part_o, p.part_ml, p.out, rows,
                                                      p.nsplit);
  return cudaGetLastError();
}

// The merge kernel's body, one block per row: the ranges' weights
// (exp2(max - the row's max), 0 for a range that met no key), then thread
// (g, c) sums channel c of the ranges g, g + GROUPS, ... in order, and the
// groups are added in order: the same bits every run.
template <int D>
__device__ __forceinline__ void merge_block(const float* __restrict__ part_o,
                                            const float* __restrict__ part_ml,
                                            __nv_bfloat16* __restrict__ out, size_t rows,
                                            int nsplit) {
  // Head_dim 256 has more channels than the block has threads: a thread
  // takes channels c and c + 128, each over the ranges in order. At head_dim
  // 96 one group of 96 threads sums and the other 32 wait.
  constexpr int GROUPS = MERGE_THREADS >= D ? MERGE_THREADS / D : 1;
  __shared__ float ml[MAX_SPLITS][2];
  __shared__ float wgt[MAX_SPLITS];
  __shared__ float part[GROUPS][D];
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < nsplit) {
    const float2 x = *reinterpret_cast<const float2*>(part_ml + (tid * rows + row) * 2);
    ml[tid][0] = x.x;
    ml[tid][1] = x.y;
  }
  __syncthreads();
  float mmax = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mmax = fmaxf(mmax, ml[s][0]);
  if (tid < nsplit) wgt[tid] = mmax == -INFINITY ? 0.f : ex2(ml[tid][0] - mmax);
  __syncthreads();
  float lsum = 0.f;
  for (int s = 0; s < nsplit; ++s) lsum += wgt[s] * ml[s][1];
  if constexpr (D > MERGE_THREADS) {
    for (int c = tid; c < D; c += MERGE_THREADS) {
      float acc = 0.f;
#pragma unroll 4
      for (int s = 0; s < nsplit; ++s) acc += wgt[s] * part_o[(s * rows + row) * D + c];
      out[row * D + c] = __float2bfloat16(acc * (lsum == 0.f ? 1.f : 1.f / lsum));
    }
    return;
  }
  const int c = tid % D, grp = tid / D;
  float acc = 0.f;
  if (grp < GROUPS) {
#pragma unroll 4
    for (int s = grp; s < nsplit; s += GROUPS) acc += wgt[s] * part_o[(s * rows + row) * D + c];
    part[grp][c] = acc;
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int g = 1; g < GROUPS; ++g) acc += part[g][c];
    out[row * D + c] = __float2bfloat16(acc * (lsum == 0.f ? 1.f : 1.f / lsum));
  }
}

}  // namespace few
}  // namespace kvp
