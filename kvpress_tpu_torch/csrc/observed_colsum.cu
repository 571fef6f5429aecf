// Causal softmax column sums of a prefill's attention matrix, without the
// matrix: the score of ObservedAttentionPress.
//
// Replaces the two Pallas kernels of
// kvpress_tpu/ops/observed_colsum.py::observed_colsums_flash:
//   pass 1 (_lse_kernel)    lse[b, hq, i] = log sum_{j <= i} exp(s_ij)
//   pass 2 (_colsum_kernel) out[b, hq, j] = sum_{i >= j} exp(s_ij - lse[b, hq, i])
// with s = softcap(scale * q k^T), queries slot-aligned with keys (S == T,
// nothing before them in the cache, no keep-mask). Pass 2 also takes the
// row LSE the flash prefill kernel wrote (flash.cu), and pass 1 is then
// skipped. A row whose LSE is -inf (it saw no key) adds 0.
//
// What bounds them on the H100: operations. At the prefill shape (GQA 32/8,
// D 64, S 32K) a pass does 2*D FLOPs and one exp per visible (query head,
// key) pair, 2.2e12 FLOPs and 1.7e10 exp a layer, against 0.17 GB of q, k and
// lse: 2.2 ms of tensor-core time at 989 TFLOP/s. The exp unit (16 results
// a clock and SM, ~4e12 a second) needs about twice as long as the
// products at head_dim 64, so it is the resource that decides.
// What the design does about it: the products run on the tensor cores
// (mma.sync m16n8k16, f32 accumulate) and the logits never leave registers.
//   Pass 1 is the flash kernel without V and without the keep-mask: one block
//   per (q-tile, kv head) holds all G query heads, walks the key tiles up to
//   the diagonal (cp.async double buffer) and keeps the running max and sum
//   in registers.
//   Pass 2 turns the product round: a block owns 64 keys of one kv head and
//   holds them as A fragments in registers, and the query tiles at or below
//   the diagonal stream through shared memory as the B operand (all G heads,
//   cp.async double buffer, their LSE beside them). The accumulator
//   fragment is then (key, query), so the sum over queries is a sum over
//   each thread's own registers, finished by one shuffle reduction over the
//   quad. Every output element belongs to one warp and is added up in a
//   fixed order and stored once: no atomics, the same bits on every run.
//   Key tile 0 meets every query tile and the last meets one; blocks start
//   in tile order, the longest first.
// Not yet done (later work): wgmma, TMA, per-element masking only on the
// diagonal tiles' own code path.
#include "attn_common.cuh"

namespace kvp {

constexpr int OC_KEYS = 64;  // keys per tile, both passes

// Query rows per head that pass 2 brings in per step: 64, or 32 where two
// stages of G heads would not fit in shared memory (G 8 at head_dim 128).
template <int D, int G>
__host__ __device__ constexpr int oc_qrows() {
  return (size_t)2 * G * 64 * (D + 8) * 2 > 200 * 1024 ? 32 : 64;
}

// Two stages of NR bf16 rows of D channels in shared memory, with the
// 8-element pad of the K/V tiles (conflict-free B-fragment reads).
template <int D, int NR>
struct RowTiles {
  static constexpr int RP = D + 8;
  static constexpr size_t TILE = (size_t)NR * RP * sizeof(__nv_bfloat16);
  static constexpr size_t BYTES = 2 * TILE;

  unsigned char* base;

  __device__ __nv_bfloat16* rows(int s) {
    return reinterpret_cast<__nv_bfloat16*>(base + s * TILE);
  }

  // Start copying n contiguous rows from src into rows [r0, r0 + n) of
  // stage s (the caller commits); rows from `valid` on are zeros.
  __device__ void issue(int s, int r0, const __nv_bfloat16* src, int n, int valid, int tid,
                        int nthreads) {
    constexpr int CPR = D / 8;  // 16-byte chunks a row
    for (int c = tid; c < n * CPR; c += nthreads) {
      const int r = c / CPR, ch = (c % CPR) * 8;
      const bool in = r < valid;
      cp_async16(rows(s) + (r0 + r) * RP + ch, src + (in ? (size_t)r * D + ch : 0), in);
    }
  }
};

struct ColsumParams {
  const __nv_bfloat16* q;  // (B, Hq, S, D)
  const __nv_bfloat16* k;  // (B, Hkv, S, D)
  const float* lse;        // (B, Hq, S): read by pass 2
  float* out;              // (B, Hq, S): the LSE (pass 1) or the column sums (pass 2)
  int B, Hq, Hkv, S, G, bq;
  float sm_scale, softcap;  // softcap 0 = none
};

__device__ __forceinline__ float scaled_logit(float x, float sm_scale, float softcap) {
  x *= sm_scale;
  return softcap > 0.f ? tanhf(x / softcap) * softcap : x;
}

// Pass 1. Block geometry (flash_block_q): warp w holds 16 rows of query
// head w / (bq / 16).
template <int D>
__global__ void __launch_bounds__(256) observed_lse_kernel(const ColsumParams p) {
  constexpr int NK = OC_KEYS;
  extern __shared__ __align__(16) unsigned char smem[];
  RowTiles<D, NK> tiles{smem};
  // Causal work grows with the q-tile index: start the longest tiles first.
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wph = p.bq >> 4;
  const int hq = h * p.G + warp / wph;
  const int t0 = qt * p.bq;
  const int trow = t0 + (warp % wph) * 16 + g;

  const size_t qoff = ((size_t)b * p.Hq + hq) * p.S;
  const __nv_bfloat16* row0 = trow < p.S ? p.q + (qoff + trow) * D : nullptr;
  const __nv_bfloat16* row1 = trow + 8 < p.S ? p.q + (qoff + trow + 8) * D : nullptr;
  uint32_t qa[D / 16][4];
  load_a_rows<D>(qa, row0, row1, tq);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const __nv_bfloat16* kbase = p.k + ((size_t)b * p.Hkv + h) * p.S * D;
  const int kend = min(p.S, t0 + p.bq);  // one past the last key the tile's rows see
  const int nsteps = (kend + NK - 1) / NK;
  tiles.issue(0, 0, kbase, NK, p.S, tid, nthreads);
  cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    const int key0 = s * NK;
    if (s + 1 < nsteps)
      tiles.issue((s + 1) & 1, 0, kbase + (size_t)(key0 + NK) * D, NK, p.S - key0 - NK, tid,
                  nthreads);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float sc[NK / 8][4];
    mma_rows<D, NK>(sc, qa, tiles.rows(s & 1), lane);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kslot = key0 + n * 8 + 2 * tq + (i & 1);
        const int qslot = trow + 8 * (i >> 1);
        const float x = scaled_logit(sc[n][i], p.sm_scale, p.softcap);
        sc[n][i] = (kslot <= qslot && kslot < p.S) ? x : NEG_INF;
        mx[i >> 1] = fmaxf(mx[i >> 1], sc[n][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mnew = fmaxf(m[r], quad_max(mx[r]));
      l[r] *= __expf(m[r] - mnew);  // 0 on the first step (m = -inf)
      m[r] = mnew;
    }
#pragma unroll
    for (int n = 0; n < NK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) l[i >> 1] += __expf(sc[n][i] - m[i >> 1]);
    }
    __syncthreads();  // the stage is refilled two steps on
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    if (tq == 0 && trow + 8 * r < p.S)
      p.out[qoff + trow + 8 * r] = m[r] + logf(fmaxf(lsum, 1e-30f));
  }
}

// Pass 2. 4 warps share the block's 64 keys (16 each); with G > 1 a second
// set of 4 warps takes the other half of the query heads.
template <int D, int G>
__global__ void __launch_bounds__(G == 1 ? 128 : 256)
    observed_colsum_kernel(const ColsumParams p) {
  constexpr int BQ = oc_qrows<D, G>();
  constexpr int NR = G * BQ;            // rows of a stage: (head, query)
  constexpr int HG = G == 1 ? 1 : 2;    // sets of warps
  constexpr int HPW = G / HG;           // query heads a warp sums
  constexpr int RP = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  RowTiles<D, NR> tiles{smem};
  float* lse_s = reinterpret_cast<float*>(smem + RowTiles<D, NR>::BYTES);  // [2][NR]
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int head0 = (warp >> 2) * HPW;  // first head (within the group) of this warp
  const int k0 = kt * OC_KEYS;
  const int krow = k0 + (warp & 3) * 16 + g;

  const __nv_bfloat16* kbase = p.k + ((size_t)b * p.Hkv + h) * p.S * D;
  const __nv_bfloat16* row0 = krow < p.S ? kbase + (size_t)krow * D : nullptr;
  const __nv_bfloat16* row1 = krow + 8 < p.S ? kbase + (size_t)(krow + 8) * D : nullptr;
  uint32_t ka[D / 16][4];
  load_a_rows<D>(ka, row0, row1, tq);
  float acc[HPW][2];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) acc[hh][0] = acc[hh][1] = 0.f;

  // Query tiles [qt0, nq) hold a row at or below this key tile's diagonal.
  const int nq = (p.S + BQ - 1) / BQ, qt0 = k0 / BQ;
  auto issue = [&](int stage, int qt) {
    const int q0 = qt * BQ;
#pragma unroll
    for (int hd = 0; hd < G; ++hd) {
      const size_t off = ((size_t)b * p.Hq + h * G + hd) * p.S + q0;
      tiles.issue(stage, hd * BQ, p.q + off * D, BQ, p.S - q0, tid, nthreads);
      for (int i = tid; i < BQ; i += nthreads) {
        const bool in = q0 + i < p.S;
        cp_async4(lse_s + stage * NR + hd * BQ + i, p.lse + off + (in ? i : 0), in);
      }
    }
  };

  issue(0, qt0);
  cp_async_commit();
  for (int qt = qt0; qt < nq; ++qt) {
    const int stage = (qt - qt0) & 1, q0 = qt * BQ;
    if (qt + 1 < nq) issue(stage ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // Only a tile on the diagonal or at the ragged end needs the mask.
    const bool edge = q0 < k0 + OC_KEYS || q0 + BQ > p.S;
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int r0 = (head0 + hh) * BQ;
      float sc[BQ / 8][4];
      mma_rows<D, BQ>(sc, ka, tiles.rows(stage) + r0 * RP, lane);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const int col = n * 8 + 2 * tq;
        float2 lse = *reinterpret_cast<const float2*>(lse_s + stage * NR + r0 + col);
        // A row that saw no key (the flash kernel stores -inf) adds 0.
        if (lse.x == -INFINITY) lse.x = INFINITY;
        if (lse.y == -INFINITY) lse.y = INFINITY;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qslot = q0 + col + (i & 1), kslot = krow + 8 * (i >> 1);
          const float x = scaled_logit(sc[n][i], p.sm_scale, p.softcap);
          const bool ok = !edge || (kslot <= qslot && qslot < p.S);
          acc[hh][i >> 1] += ok ? __expf(x - ((i & 1) ? lse.y : lse.x)) : 0.f;
        }
      }
    }
    __syncthreads();  // the stage is refilled two steps on
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(acc[hh][r]);
      if (tq == 0 && krow + 8 * r < p.S)
        p.out[((size_t)b * p.Hq + h * G + head0 + hh) * p.S + krow + 8 * r] = sum;
    }
  }
}

template <int D>
cudaError_t launch_lse(ColsumParams p, cudaStream_t stream) {
  constexpr size_t smem = RowTiles<D, OC_KEYS>::BYTES;
  p.bq = flash_block_q(p.G);
  dim3 grid((p.S + p.bq - 1) / p.bq, p.Hkv, p.B);
  observed_lse_kernel<D><<<grid, p.G * p.bq * 2, smem, stream>>>(p);  // 16 rows a warp
  return cudaGetLastError();
}

template <int D, int G>
cudaError_t launch_colsum(const ColsumParams& p, cudaStream_t stream) {
  constexpr int NR = G * oc_qrows<D, G>();
  constexpr size_t smem = RowTiles<D, NR>::BYTES + (size_t)2 * NR * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(observed_colsum_kernel<D, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + OC_KEYS - 1) / OC_KEYS, p.Hkv, p.B);
  observed_colsum_kernel<D, G><<<grid, G == 1 ? 128 : 256, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_colsum_d(const ColsumParams& p, cudaStream_t stream) {
  switch (p.G) {
    case 1: return launch_colsum<D, 1>(p, stream);
    case 2: return launch_colsum<D, 2>(p, stream);
    case 4: return launch_colsum<D, 4>(p, stream);
    case 8: return launch_colsum<D, 8>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

inline ColsumParams colsum_params(const void* q, const void* k, const void* lse, void* out,
                                  int B, int Hq, int Hkv, int S, float sm_scale,
                                  float softcap) {
  ColsumParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.lse = static_cast<const float*>(lse);
  p.out = static_cast<float*>(out);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.S = S; p.G = Hq / Hkv;
  p.sm_scale = sm_scale; p.softcap = softcap;
  return p;
}

}  // namespace kvp

extern "C" int kvp_observed_lse(const void* q, const void* k, void* lse, int B, int Hq,
                                int Hkv, int S, int D, float sm_scale, float softcap,
                                void* stream) {
  const kvp::ColsumParams p =
      kvp::colsum_params(q, k, nullptr, lse, B, Hq, Hkv, S, sm_scale, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return kvp::launch_lse<64>(p, st);
    case 128: return kvp::launch_lse<128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int kvp_observed_colsum(const void* q, const void* k, const void* lse, void* out,
                                   int B, int Hq, int Hkv, int S, int D, float sm_scale,
                                   float softcap, void* stream) {
  const kvp::ColsumParams p =
      kvp::colsum_params(q, k, lse, out, B, Hq, Hkv, S, sm_scale, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return kvp::launch_colsum_d<64>(p, st);
    case 128: return kvp::launch_colsum_d<128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}
