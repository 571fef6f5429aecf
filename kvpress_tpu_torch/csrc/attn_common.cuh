// Shared pieces of the Hopper attention kernels (flash.cu, flash_quant.cu,
// decode.cu, decode_headwise.cu, observed_colsum.cu): bf16 m16n8k16 tensor-core products (mma.sync), a two-stage
// cp.async pipeline that brings K/V tiles of a bf16, int8 or packed-int4 cache
// into shared memory while the previous tile is being used, and the per-warp
// online-softmax step over a run of keys.
//
// Numerics follow the Pallas kernels of kvpress_tpu/ops/flash.py and
// ops/decode.py: logits and softmax statistics in float32, bf16 operands for
// both products; masked logits take the finite NEG_INF = -2e38 (not -inf), and
// a row whose running sum is 0 stores 0. A run of keys that is wholly masked
// adds exp(0) terms that the next live run's rescale factor wipes out, so a
// real row (one that sees a live key) matches the dense path and a row that
// never does is padding, never NaN.
//
// Quantized caches (cache.quantize_kv layout) are copied at payload width and
// widened to bf16 in shared memory: int8 payloads and the +8-offset nibbles of
// int4 (channel c in the low nibble, c + D/2 in the high) are small integers,
// exact in bf16. The per-token scales are folded as the TPU kernels fold
// them: key scales into logit columns, value scales into probability rows
// (after the row sum). No dequantized buffer exists in device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kvp {

constexpr float NEG_INF = -2.0e38f;

enum KvKind { KV_BF16 = 0, KV_INT8 = 1, KV_INT4 = 2 };

// Bytes of one key's (or value's) payload row in device memory.
template <int D, int KIND>
__host__ __device__ constexpr int row_bytes() {
  return KIND == KV_BF16 ? 2 * D : (KIND == KV_INT8 ? D : D / 2);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (16x8, f32) += A (16x16, bf16, row-major) * B (16x8, bf16, col-major).
// Fragment layout, with g = lane / 4 and t = lane % 4:
//   a[0]: (row g,   k 2t..2t+1)   a[1]: (row g+8, k 2t..2t+1)
//   a[2]: (row g,   k 2t+8..+9)   a[3]: (row g+8, k 2t+8..+9)
//   b0:   (k 2t..2t+1, col g)     b1:   (k 2t+8..+9, col g)
//   d[0..1]: (row g, cols 2t, 2t+1)   d[2..3]: (row g+8, cols 2t, 2t+1)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices, transposed on the way: lane i holds elements
// (rows 2(i%4), 2(i%4)+1; column i/4) of each, which is the B fragment of
// mma16816 read from a row-major (k, n) tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Asynchronous global -> shared copies; a false predicate writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A fragments of 16 rows of D bf16 channels read straight from device memory:
// row0 is row g, row1 row g + 8 (null = a row of zeros).
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4], const __nv_bfloat16* row0,
                                            const __nv_bfloat16* row1, int tq) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * tq;
    a[kk][0] = row0 ? *reinterpret_cast<const uint32_t*>(row0 + c) : 0u;
    a[kk][1] = row1 ? *reinterpret_cast<const uint32_t*>(row1 + c) : 0u;
    a[kk][2] = row0 ? *reinterpret_cast<const uint32_t*>(row0 + c + 8) : 0u;
    a[kk][3] = row1 ? *reinterpret_cast<const uint32_t*>(row1 + c + 8) : 0u;
  }
}

// s (16 x NC, f32) = A (16 x D) * B^T, where B is NC rows of a row-major
// shared-memory tile with a pitch of D + 8 elements, read from `tile`.
template <int D, int NC>
__device__ __forceinline__ void mma_rows(float (&s)[NC / 8][4], const uint32_t (&a)[D / 16][4],
                                         const __nv_bfloat16* tile, int lane) {
  constexpr int KP = D + 8;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < NC / 8; ++n) {
      const __nv_bfloat16* br = tile + (n * 8 + g) * KP + kk * 16 + 2 * tq;
      mma16816(s[n], a[kk], *reinterpret_cast<const uint32_t*>(br),
               *reinterpret_cast<const uint32_t*>(br + 8));
    }
  }
}

// One (batch, kv head)'s cache rows in device memory.
struct KvSource {
  const char* k;        // slot 0 of the payload rows
  const char* v;
  const float* ks;      // per-slot scales (quantized caches) or null
  const float* vs;
  const uint8_t* mask;  // keep-bits, row padded with 0 to mask_pitch, or null
  int S;                // slots in the buffer
  int mask_pitch;       // a multiple of 16
};

// Shared memory of the K/V pipeline: NK keys a stage, two stages. K and V
// tiles are bf16, key-major, with an 8-element pad that keeps both the 32-bit
// K fragment reads and the ldmatrix V reads free of bank conflicts. A bf16
// cache is copied straight into a tile of each stage; a quantized one into a
// raw payload buffer of each stage, widened into one tile just before use.
template <int D, int NK, int KIND>
struct KvTiles {
  static constexpr int KP = D + 8;
  static constexpr int ROW = row_bytes<D, KIND>();
  static constexpr int STAGES = 2;
  static constexpr int NT = KIND == KV_BF16 ? STAGES : 1;
  static constexpr int NR = KIND == KV_BF16 ? 0 : STAGES;
  static constexpr size_t TILE = (size_t)2 * NK * KP * sizeof(__nv_bfloat16);
  static constexpr size_t RAW = (size_t)2 * NK * ROW;
  static constexpr size_t OFF_RAW = NT * TILE;
  static constexpr size_t OFF_KS = OFF_RAW + NR * RAW;
  static constexpr size_t OFF_VS = OFF_KS + (size_t)STAGES * NK * 4;
  static constexpr size_t OFF_MASK = OFF_VS + (size_t)STAGES * NK * 4;
  static constexpr size_t BYTES = OFF_MASK + (size_t)STAGES * NK;

  unsigned char* base;

  __device__ __nv_bfloat16* k(int t) { return reinterpret_cast<__nv_bfloat16*>(base + t * TILE); }
  __device__ __nv_bfloat16* v(int t) { return k(t) + NK * KP; }
  __device__ unsigned char* rawk(int s) { return base + OFF_RAW + s * RAW; }
  __device__ unsigned char* rawv(int s) { return rawk(s) + NK * ROW; }
  __device__ float* ks(int s) { return reinterpret_cast<float*>(base + OFF_KS) + s * NK; }
  __device__ float* vs(int s) { return reinterpret_cast<float*>(base + OFF_VS) + s * NK; }
  __device__ uint8_t* mask(int s) { return base + OFF_MASK + s * NK; }

  // Start copying keys [key0, key0 + NK) into stage s (the caller commits).
  // The NK payload rows are one contiguous run of device memory.
  __device__ void issue(const KvSource& src, int s, int key0, int tid, int nthreads) {
    constexpr int CPR = ROW / 16;
    const long long end = (long long)src.S * ROW;
    for (int c = tid; c < NK * CPR; c += nthreads) {
      const long long off = (long long)key0 * ROW + (long long)c * 16;
      const bool in = off < end;
      void *dk, *dv;
      if (KIND == KV_BF16) {
        dk = k(s) + (c / CPR) * KP + (c % CPR) * 8;
        dv = v(s) + (c / CPR) * KP + (c % CPR) * 8;
      } else {
        dk = rawk(s) + c * 16;
        dv = rawv(s) + c * 16;
      }
      cp_async16(dk, src.k + (in ? off : 0), in);
      cp_async16(dv, src.v + (in ? off : 0), in);
    }
    if (KIND != KV_BF16) {
      for (int i = tid; i < NK; i += nthreads) {
        const bool in = key0 + i < src.S;
        cp_async4(ks(s) + i, src.ks + (in ? key0 + i : 0), in);
        cp_async4(vs(s) + i, src.vs + (in ? key0 + i : 0), in);
      }
    }
    if (src.mask != nullptr) {
      for (int c = tid; c < NK / 16; c += nthreads) {
        const bool in = key0 + c * 16 < src.mask_pitch;
        cp_async16(mask(s) + c * 16, src.mask + (in ? key0 + c * 16 : 0), in);
      }
    }
  }

  // Quantized caches: widen stage s's payload into tile 0.
  __device__ void unpack(int s, int tid, int nthreads) {
    if (KIND == KV_INT8) {
      constexpr int CPR = D / 16;  // 16 int8 channels per chunk
      for (int c = tid; c < 2 * NK * CPR; c += nthreads) {
        const bool is_v = c >= NK * CPR;
        const int cc = is_v ? c - NK * CPR : c;
        const int row = cc / CPR, col = (cc % CPR) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>((is_v ? rawv(s) : rawk(s)) + cc * 16);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
        uint32_t p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = pack_bf16x2((float)b[2 * i], (float)b[2 * i + 1]);
        uint4* dst = reinterpret_cast<uint4*>((is_v ? v(0) : k(0)) + row * KP + col);
        dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
        dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
      }
    } else if (KIND == KV_INT4) {
      constexpr int D2 = D / 2;
      constexpr int CPR = D2 / 16;  // 16 bytes = channels col.. (low) and D/2 + col.. (high)
      for (int c = tid; c < 2 * NK * CPR; c += nthreads) {
        const bool is_v = c >= NK * CPR;
        const int cc = is_v ? c - NK * CPR : c;
        const int row = cc / CPR, col = (cc % CPR) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>((is_v ? rawv(s) : rawk(s)) + cc * 16);
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
        uint32_t lo[8], hi[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int b0 = b[2 * i], b1 = b[2 * i + 1];
          lo[i] = pack_bf16x2((float)((b0 & 0xF) - 8), (float)((b1 & 0xF) - 8));
          hi[i] = pack_bf16x2((float)((b0 >> 4) - 8), (float)((b1 >> 4) - 8));
        }
        __nv_bfloat16* dst = (is_v ? v(0) : k(0)) + row * KP;
        uint4* dlo = reinterpret_cast<uint4*>(dst + col);
        uint4* dhi = reinterpret_cast<uint4*>(dst + D2 + col);
        dlo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        dlo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
        dhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        dhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
      }
    }
  }
};

// What one step of a warp reads: a bf16 K/V tile and, per tile column, the
// scales (quantized caches) and keep-bits.
struct TileView {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* ks;      // or null
  const float* vs;
  const uint8_t* mask;  // or null
};

// The TileView of stage s: waits for its copy (all but the newest commit
// group) and, for a quantized cache, widens it. Ends with the block in sync.
template <int D, int NK, int KIND>
__device__ __forceinline__ TileView ready(KvTiles<D, NK, KIND>& t, int s, bool masked,
                                          int tid, int nthreads) {
  cp_async_wait<1>();
  __syncthreads();
  if (KIND != KV_BF16) {
    t.unpack(s, tid, nthreads);
    __syncthreads();
    return TileView{t.k(0), t.v(0), t.ks(s), t.vs(s), masked ? t.mask(s) : nullptr};
  }
  return TileView{t.k(s), t.v(s), nullptr, nullptr, masked ? t.mask(s) : nullptr};
}

// One warp's 16 query rows: Q as A fragments, the output accumulator, and
// the running max / sum of the two rows (g and g + 8) this thread touches.
// `l` is this thread's partial over its own columns, summed over the quad at
// the end.
template <int D>
struct WarpState {
  uint32_t qa[D / 16][4];
  float o[D / 8][4];
  float m[2];
  float l[2];

  __device__ __forceinline__ void init(const __nv_bfloat16* row0,
                                       const __nv_bfloat16* row1, int tq) {
    load_a_rows<D>(qa, row0, row1, tq);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
};

struct MaskArgs {
  int qslot0, qslot1;  // slot of query rows g and g + 8
  int S;               // slots >= S are dead
  int window;          // 0 = none
  float sm_scale;
  float softcap;       // 0 = none
};

// Online-softmax step of one warp over NC keys of a tile, from tile column c0;
// key0 is the cache slot of tile column 0.
template <int D, int NC, int KIND>
__device__ __forceinline__ void attend(WarpState<D>& st, const TileView& t, int c0, int key0,
                                       const MaskArgs& a, int lane) {
  constexpr int KP = D + 8;
  const int tq = lane & 3;
  float s[NC / 8][4];
  mma_rows<D, NC>(s, st.qa, t.k + c0 * KP, lane);
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = c0 + n * 8 + 2 * tq + (i & 1);
      const int slot = key0 + col;
      const int qs = (i < 2) ? a.qslot0 : a.qslot1;
      float x = s[n][i];
      if (KIND != KV_BF16) x *= t.ks[col];
      x *= a.sm_scale;
      if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
      const bool ok = slot < a.S && (t.mask == nullptr || t.mask[col] != 0) && slot <= qs &&
                      (a.window <= 0 || slot > qs - a.window);
      x = ok ? x : NEG_INF;
      s[n][i] = x;
      mx[i >> 1] = fmaxf(mx[i >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mnew = fmaxf(st.m[r], quad_max(mx[r]));
    alpha[r] = __expf(st.m[r] - mnew);  // 0 on the first step (m = -inf)
    st.m[r] = mnew;
    st.l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.o[n][0] *= alpha[0];
    st.o[n][1] *= alpha[0];
    st.o[n][2] *= alpha[1];
    st.o[n][3] *= alpha[1];
  }
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = __expf(s[n][i] - st.m[i >> 1]);
      st.l[i >> 1] += p;
      s[n][i] = (KIND != KV_BF16) ? p * t.vs[c0 + n * 8 + 2 * tq + (i & 1)] : p;
    }
  }
  // V rows for ldmatrix: lanes 0-7 / 8-15 address keys 0-7 / 8-15 of the
  // 16-key block at dims n*8.., lanes 16-31 the same keys at dims n*8+8..
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;
#pragma unroll
  for (int kb = 0; kb < NC / 16; ++kb) {
    uint32_t pa[4];
    pa[0] = pack_bf16x2(s[2 * kb][0], s[2 * kb][1]);
    pa[1] = pack_bf16x2(s[2 * kb][2], s[2 * kb][3]);
    pa[2] = pack_bf16x2(s[2 * kb + 1][0], s[2 * kb + 1][1]);
    pa[3] = pack_bf16x2(s[2 * kb + 1][2], s[2 * kb + 1][3]);
    const __nv_bfloat16* vb = t.v + (c0 + kb * 16 + vrow) * KP + vcol;
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vb + n * 8);
      mma16816(st.o[n], pa, b[0], b[1]);
      mma16816(st.o[n + 1], pa, b[2], b[3]);
    }
  }
}

// Epilogue of the few-token kernels (decode.cu, decode_headwise.cu): the
// block's WARPS warps each hold a partial softmax state of the same 16 rows
// (row group rg of a kv head's `rows` (group, time) rows, `out` pointing at
// the first of them). Merges the states through shared memory (cm/cl (warp,
// row), co (warp, row, dim), laid over the K/V tiles) and stores the rows.
// A row that met no key at all (m = -inf) stores 0.
template <int D, int WARPS>
__device__ __forceinline__ void merge_warps_store(WarpState<D>& st, unsigned char* smem,
                                                  __nv_bfloat16* out, int rg, int rows,
                                                  int tid, int nthreads) {
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  cp_async_wait<0>();
  __syncthreads();
  float* cm = reinterpret_cast<float*>(smem);
  float* cl = cm + WARPS * 16;
  float* co = cl + WARPS * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(st.l[r]);
    const int row = g + 8 * r;
    if (tq == 0) {
      cm[warp * 16 + row] = st.m[r];
      cl[warp * 16 + row] = l;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      co[(warp * 16 + row) * D + n * 8 + 2 * tq] = st.o[n][2 * r];
      co[(warp * 16 + row) * D + n * 8 + 2 * tq + 1] = st.o[n][2 * r + 1];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < 16 * D; idx += nthreads) {
    const int row = idx / D, col = idx % D;
    const int r = rg * 16 + row;
    if (r >= rows) continue;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, cm[w * 16 + row]);
    float l = 0.f, acc = 0.f;
    if (m != -INFINITY) {  // -inf only when no key step was walked
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float a = __expf(cm[w * 16 + row] - m);
        l += a * cl[w * 16 + row];
        acc += a * co[(w * 16 + row) * D + col];
      }
    }
    out[(size_t)r * D + col] = __float2bfloat16(acc * ((l == 0.f) ? 1.f : 1.f / l));
  }
}

// Shared memory the merge needs.
template <int D, int WARPS>
__host__ __device__ constexpr size_t merge_bytes() {
  return (size_t)WARPS * 16 * (D + 2) * sizeof(float);
}

// Multi-token flash attention, one block per (q-tile, kv-head, batch). The
// block holds all G query heads of its q-tile (warp w: head w / (bq/16),
// 16 rows), so each K/V tile is read from device memory once per kv head.
// The KV axis, a sequential grid axis on the TPU, is a loop inside the block
// that skips tiles above the causal diagonal (and below the window), with
// the next tile's copy in flight while the current one is used.
struct FlashParams {
  const __nv_bfloat16* q;  // (B, Hq, T, D)
  const void* k;           // (B, Hkv, S, D) bf16/int8 | (B, Hkv, S, D/2) uint8
  const void* v;
  const float* ks;         // (B, Hkv, S) f32 or null
  const float* vs;
  const uint8_t* mask;     // (B, Hkv, mask_pitch) or null
  __nv_bfloat16* out;      // (B, Hq, T, D)
  float* lse;              // (B, Hq, T) or null
  int B, Hq, Hkv, T, S, G, bq, prior, window, mask_pitch;
  float sm_scale, softcap;
};

constexpr int FLASH_KEYS = 64;

template <int D, int KIND>
__global__ void __launch_bounds__(256) flash_fwd_kernel(const FlashParams p) {
  constexpr int NK = FLASH_KEYS;
  constexpr int ROW = row_bytes<D, KIND>();
  extern __shared__ __align__(16) unsigned char smem[];
  KvTiles<D, NK, KIND> tiles{smem};
  // Causal work grows with the q-tile index: start the longest tiles first.
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wph = p.bq >> 4;  // warps per query head
  const int hq = h * p.G + warp / wph;
  const int t0 = qt * p.bq;
  const int trow = t0 + (warp % wph) * 16 + g;

  const size_t qoff = ((size_t)b * p.Hq + hq) * p.T;
  const __nv_bfloat16* row0 = trow < p.T ? p.q + (qoff + trow) * D : nullptr;
  const __nv_bfloat16* row1 = trow + 8 < p.T ? p.q + (qoff + trow + 8) * D : nullptr;
  WarpState<D> st;
  st.init(row0, row1, tq);

  const size_t kvh = (size_t)b * p.Hkv + h;
  KvSource src{reinterpret_cast<const char*>(p.k) + kvh * p.S * ROW,
               reinterpret_cast<const char*>(p.v) + kvh * p.S * ROW,
               p.ks ? p.ks + kvh * p.S : nullptr, p.vs ? p.vs + kvh * p.S : nullptr,
               p.mask ? p.mask + kvh * p.mask_pitch : nullptr, p.S, p.mask_pitch};

  const int last_t = min(t0 + p.bq, p.T) - 1;
  const int kend = min(p.S, p.prior + last_t + 1);
  int kfirst = 0;
  if (p.window > 0) kfirst = max(0, p.prior + t0 - p.window + 1);
  kfirst = (kfirst / NK) * NK;
  const int nsteps = kend > kfirst ? (kend - kfirst + NK - 1) / NK : 0;
  MaskArgs ma{p.prior + trow, p.prior + trow + 8, p.S, p.window, p.sm_scale, p.softcap};

  if (nsteps > 0) tiles.issue(src, 0, kfirst, tid, nthreads);
  cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) tiles.issue(src, (s + 1) & 1, kfirst + (s + 1) * NK, tid, nthreads);
    cp_async_commit();
    const TileView view = ready(tiles, s & 1, src.mask != nullptr, tid, nthreads);
    attend<D, NK, KIND>(st, view, 0, kfirst + s * NK, ma, lane);
    __syncthreads();  // the stage is refilled two steps on
  }
  cp_async_wait<0>();

  const __nv_bfloat16* rows[2] = {row0, row1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(st.l[r]);
    if (rows[r] == nullptr) continue;
    const float inv = (l == 0.f) ? 1.f : 1.f / l;
    __nv_bfloat16* orow = p.out + (qoff + trow + 8 * r) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * tq) =
          pack_bf16x2(st.o[n][2 * r] * inv, st.o[n][2 * r + 1] * inv);
    if (p.lse != nullptr && tq == 0)
      p.lse[qoff + trow + 8 * r] = (l > 0.f) ? st.m[r] + logf(l) : -INFINITY;
  }
}

// Host side: block geometry shared by both flash entry points. bq query rows
// per head, G heads, 16 rows per warp: at most 8 warps (G <= 8).
inline int flash_block_q(int G) { return 16 * (G >= 8 ? 1 : 8 / G); }

template <int D, int KIND>
inline cudaError_t launch_flash(const FlashParams& p, cudaStream_t stream) {
  constexpr size_t smem = KvTiles<D, FLASH_KEYS, KIND>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  FlashParams q = p;
  q.bq = flash_block_q(p.G);
  const int warps = p.G * q.bq / 16;
  dim3 grid((p.T + q.bq - 1) / q.bq, p.Hkv, p.B);
  flash_fwd_kernel<D, KIND><<<grid, warps * 32, smem, stream>>>(q);
  return cudaGetLastError();
}

}  // namespace kvp
