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
// What bounds them on the H100: operations, and of those the exponentials.
// At the prefill shape (GQA 32/8, D 64, S 32K) a pass does 2*D FLOPs and one
// exp per visible (query head, key) pair: 2.2e12 FLOPs and 1.7e10 exp a
// layer, against 0.17 GB of q, k and lse. The products need 2.2 ms of
// tensor-core time at 989 TFLOP/s; the exp unit (16 results a clock and SM,
// ~4.2e12 a second) ~4.1 ms, so it is the ceiling that decides. What the
// design does about it: both passes run their product on wgmma and spend
// about three instructions a logit besides (one FMA, one ex2.approx, one add;
// pass 1 also a max), with the causal test only where a tile crosses the
// diagonal.
//   Pass 1 (observed_lse_kernel) is the flash main loop of flash_sm90.cuh
//   instantiated without V (KIND = LSE_ONLY): a producer warpgroup keeps a
//   ring of K stages full behind mbarriers, two consumer warpgroups hold 64
//   (query head, position) rows each and keep a running max and sum, each
//   starting its next tile's product before its exponentials.
//   Pass 2 (observed_colsum_kernel) turns the product round: a block owns
//   192 keys of one kv head (64 per consumer warpgroup, three of them) in
//   swizzled shared memory for its whole life, and computes S^T = K.Q^T on
//   wgmma m64n128k16 with the keys as the A operand. The query rows at or
//   below the diagonal stream through a ring of stages as the B operand,
//   each stage all G query heads by 128 / G positions with the rows' LSE
//   beside it (times log2 e, -inf turned into +inf, and +inf past the end of
//   the sequence, so such a row adds ex2(-inf) = 0 with no test). The
//   accumulator fragment is (key, query row): a thread adds its own columns
//   into per-(key, head) registers, and one quad shuffle finishes each sum at
//   the end. Every output element has one owner and one order of addition:
//   no atomics, the same bits on every launch. Blocks start in key-tile
//   order, the longest (tile 0 meets every query stage) first. Three
//   consumer warpgroups without turns, and the LSE copied asynchronously,
//   measured faster on the H100 than two that take turns (PERF.md).
//   At head_dim 256 the 192 resident keys alone take 96 KB, so a query
//   stage holds 64 rows (G heads by 64 / G positions) and S^T runs on
//   m64n64k16: four stages of 32 KB fit beside the keys in 227 KB, and the
//   consumers' accumulators shrink with the stage.
//   At head_dim 96 rows are laid out as head_dim 128's two panels, the
//   second half used (flash_sm90.cuh): the producers copy 12 chunks of a
//   query row, and S^T runs 6 k16 steps, so no product reads channels
//   96-127 of the keys or the queries.
#include "flash_sm90.cuh"

namespace kvp {
namespace colsum {

constexpr int CONSUMERS = 384;  // three consumer warpgroups
constexpr int THREADS = 512;    // + one producer warpgroup
constexpr int KEYS = 192;       // keys a block owns: 64 per consumer warpgroup
constexpr int STAGES = 4;
constexpr int LAG = 2;          // stages in flight behind the hand-over
// Registers move from the producer warpgroup to the consumers (the sum over
// the block's four warpgroups stays within the SM's 64K registers).
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 144;

// Shared memory of a column-sum block: the key tile, a ring of query stages,
// the stages' row LSE (log2 units) and their barriers. Tiles are rows of 128
// bytes under the 128-byte swizzle (head_dim 128 is two panels, 256 four).
template <int D>
struct Ring {
  // (query head, position) rows of a query stage: 64 at head_dim 256
  static constexpr int ROWS = D == 256 ? 64 : 128;
  static constexpr int DP = sm90::panel_channels(D);
  static constexpr int PANELS = DP / 64;
  static constexpr int K_PANEL = KEYS * 128;
  static constexpr int Q_PANEL = ROWS * 128;
  static constexpr int OFF_Q = PANELS * K_PANEL;
  static constexpr int OFF_LSE = OFF_Q + STAGES * PANELS * Q_PANEL;
  static constexpr int OFF_BAR = OFF_LSE + STAGES * ROWS * 4;
  // Every producer thread arrives once on a stage's full barrier, when its
  // copies have landed and its row's LSE is converted.
  static constexpr int FULL_ARRIVALS = 128;
  static constexpr int BYTES = OFF_BAR + 2 * STAGES * 8;
  static_assert(BYTES + 1024 <= 232448, "a block has 227 KB of shared memory");

  unsigned char* base;  // 1,024-byte aligned

  __device__ unsigned char* k() const { return base; }
  __device__ unsigned char* q(int s) const { return base + OFF_Q + s * PANELS * Q_PANEL; }
  __device__ float* lse(int s) const { return reinterpret_cast<float*>(base + OFF_LSE) + s * ROWS; }
  __device__ uint64_t* full(int s) const { return reinterpret_cast<uint64_t*>(base + OFF_BAR) + s; }
  __device__ uint64_t* empty(int s) const { return full(STAGES) + s; }
};

struct Params {
  const __nv_bfloat16* q;  // (B, Hq, S, D)
  const __nv_bfloat16* k;  // (B, Hkv, S, D)
  const float* lse;        // (B, Hq, S), natural log
  float* out;              // (B, Hq, S)
  int B, Hq, Hkv, S;
  float sm_scale, softcap;  // softcap 0 = none
};

// What a block walks: query stages [qt0, qt0 + nst) of BQ positions, for the
// keys from k0 on of kv head h of batch row b.
struct Walk {
  int k0, qt0, nst, h, b;
};

// The producer warpgroup: query stage n is row r = head * BQ + i of the ring
// (position qt * BQ + i of query head h * G + head), copied with cp.async to
// swizzled addresses, and thread pt copies row pt's LSE beside it. LAG stages
// later, once its copies have landed, the thread turns that LSE into log2
// units (a row that saw no key, or past the end, +inf: it adds 0) and hands
// the stage over.
template <int D, int G>
__device__ __forceinline__ void produce(const Params& p, const Ring<D>& ring, const Walk& w,
                                        int pt) {
  // As in flash_sm90.cuh's producer: thread pt copies chunk pt % CPT of rows
  // pt / CPT + RPI * it, at head_dim 256 also of the second pair of panels;
  // at head_dim 96 the threads of chunks 12-15 of the padded row copy nothing.
  constexpr int ROWS = Ring<D>::ROWS, BQ = ROWS / G, CPR = D / 8, CPP = Ring<D>::DP / 8;
  constexpr int CPT = CPP < 16 ? CPP : 16, HALVES = CPP / CPT, RPI = 128 / CPT;
  static_assert(LAG < STAGES, "the producer waits for a stage LAG hand-overs back");
  const int r0 = pt / CPT, cc = pt % CPT;
  const bool copies = CPR == CPP || cc < CPR;
  const uint32_t dst = (cc >> 3) * Ring<D>::Q_PANEL + sm90::swizzled(r0, cc & 7);
  const size_t head0 = (size_t)w.b * p.Hq + (size_t)w.h * G;
  // Offsets from the group's first query row stay 32-bit (the entry point
  // refuses G * S * D >= 2^31): the producer warps run with PRODUCER_REGS
  // registers.
  const __nv_bfloat16* qg = p.q + head0 * p.S * D + cc * 8;
  const bool has_row = pt < ROWS;  // the thread that copies row pt's LSE
  const float* lg = p.lse + (head0 + (has_row ? pt / BQ : 0)) * p.S + pt % BQ;
  for (int n = 0; n < w.nst + LAG; ++n) {
    if (n < w.nst) {
      const int qt = w.qt0 + n, stage = n % STAGES;
      sm90::mbar_wait(ring.empty(stage), ((n / STAGES) & 1) ^ 1);
      const uint32_t qs = smem_addr(ring.q(stage)) + dst;
#pragma unroll
      for (int it = 0; it < ROWS / RPI; ++it) {
        const int row = r0 + it * RPI, t = qt * BQ + row % BQ;
        const bool in = t < p.S;
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
          if (copies)
          sm90::cp_async16_to(qs + h * (CPT / 8) * Ring<D>::Q_PANEL + it * RPI * 128,
                              qg + ((row / BQ) * p.S + (in ? t : 0)) * D + h * CPT * 8, in);
      }
      const bool in = qt * BQ + pt % BQ < p.S;
      if (has_row) cp_async4(ring.lse(stage) + pt, lg + (in ? qt * BQ : 0), in);
    }
    cp_async_commit();
    if (n >= LAG) {
      const int j = n - LAG, stage = j % STAGES;
      cp_async_wait<LAG>();  // this thread's copies of stage j have landed
      if (has_row) {
        float* l = ring.lse(stage) + pt;
        const float x = *l;
        *l = (w.qt0 + j) * BQ + pt % BQ >= p.S || x == -INFINITY ? INFINITY : x * sm90::LOG2E;
      }
      sm90::fence_async_proxy();  // the copies are read by wgmma
      sm90::mbar_arrive(ring.full(stage));
    }
  }
}

// A consumer warpgroup: keys kw .. kw + 63 (warp w of the warpgroup holds keys
// 16w .. 16w + 15 of them, a thread keys g and g + 8), every column of every
// query stage. Element 4n + i of the accumulator is key g + 8 (i / 2) and
// stage row 8n + 2 (lane % 4) + i % 2, so query head (8n) / BQ.
template <int D, int G, bool CAPPED>
__device__ __forceinline__ void consume(const Params& p, const Ring<D>& ring, const Walk& w,
                                        int tid) {
  constexpr int ROWS = Ring<D>::ROWS, BQ = ROWS / G;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kw = w.k0 + wg * 64;
  const int key[2] = {kw + warp * 16 + g, kw + warp * 16 + g + 8};
  const float c = (CAPPED ? 1.f : p.sm_scale) * sm90::LOG2E;
  const float cap_scale = CAPPED ? p.sm_scale / p.softcap : 0.f;
  const uint64_t kdesc = sm90::tile_desc(ring.k() + wg * 64 * 128);

  float acc[G][2];
#pragma unroll
  for (int hd = 0; hd < G; ++hd) acc[hd][0] = acc[hd][1] = 0.f;
  float s[ROWS / 2];

  // p = ex2(x c - lse2) of every element, added into its (key, head) sum;
  // across the diagonal only where the key is at or before the position.
  auto add = [&](const float* lse2, int t0, bool diagonal) {
#pragma unroll
    for (int n = 0; n < ROWS / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + n * 8 + 2 * tq);
      const int t = t0 + (n * 8) % BQ + 2 * tq;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[4 * n + i];
        if (CAPPED) x = tanhf(x * cap_scale) * p.softcap;
        float e = sm90::ex2(fmaf(x, c, -((i & 1) ? l2.y : l2.x)));
        if (diagonal) e = key[i >> 1] <= t + (i & 1) ? e : 0.f;
        acc[(n * 8) / BQ][i >> 1] += e;
      }
    }
  };

  for (int n = 0; n < w.nst; ++n) {
    const int stage = n % STAGES, t0 = (w.qt0 + n) * BQ;
    sm90::mbar_wait(ring.full(stage), (n / STAGES) & 1);
    if (t0 + BQ - 1 >= kw) {  // else every position lies before every key of the warpgroup
      const uint64_t qdesc = sm90::tile_desc(ring.q(stage));
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t koff = ((kk >> 2) * Ring<D>::K_PANEL + (kk & 3) * 32) >> 4;
        const uint64_t qoff = ((kk >> 2) * Ring<D>::Q_PANEL + (kk & 3) * 32) >> 4;
        sm90::wgmma_ss(s, kdesc + koff, qdesc + qoff, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::keep(s);
      // Only a stage that crosses the diagonal takes the causal test; past
      // the end of the sequence the LSE is +inf.
      add(ring.lse(stage), t0, t0 < kw + 63);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(ring.empty(stage));
  }

#pragma unroll
  for (int hd = 0; hd < G; ++hd) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(acc[hd][r]);
      if (tq == 0 && key[r] < p.S)
        p.out[((size_t)w.b * p.Hq + (size_t)w.h * G + hd) * p.S + key[r]] = sum;
    }
  }
}

// One block per (key tile, kv head, batch row); x runs over the key tiles
// with the kv heads inside, so the blocks of key tile 0 (the longest) start
// first.
template <int D, int G>
__global__ void __launch_bounds__(THREADS, 1) observed_colsum_kernel(const Params p) {
  constexpr int BQ = Ring<D>::ROWS / G;
  extern __shared__ unsigned char smem_dyn[];
  const Ring<D> ring{smem_dyn + ((1024u - (smem_addr(smem_dyn) & 1023u)) & 1023u)};
  const int tid = threadIdx.x;
  Walk w;
  w.h = blockIdx.x % p.Hkv;
  w.b = blockIdx.y;
  w.k0 = (blockIdx.x / p.Hkv) * KEYS;
  w.qt0 = w.k0 / BQ;
  w.nst = (p.S + BQ - 1) / BQ - w.qt0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(ring.full(s), Ring<D>::FULL_ARRIVALS);
      sm90::mbar_init(ring.empty(s), CONSUMERS / 32);  // one lane of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The key tile; keys past S are zeros (their sums are not stored).
  constexpr int CPR = D / 8;
  const __nv_bfloat16* kg = p.k + ((size_t)w.b * p.Hkv + w.h) * p.S * D;
  for (int ch = tid; ch < KEYS * CPR; ch += THREADS) {
    const int row = ch / CPR, cc = ch % CPR;
    const bool ok = w.k0 + row < p.S;
    cp_async16(ring.k() + (cc >> 3) * Ring<D>::K_PANEL + sm90::swizzled(row, cc & 7),
               kg + (size_t)(ok ? w.k0 + row : 0) * D + cc * 8, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  sm90::fence_async_proxy();
  __syncthreads();

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    produce<D, G>(p, ring, w, tid - CONSUMERS);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if (p.softcap > 0.f) consume<D, G, true>(p, ring, w, tid);
    else consume<D, G, false>(p, ring, w, tid);
  }
}

template <int D, int G>
cudaError_t launch_colsum(const Params& p, cudaStream_t stream) {
  constexpr int smem = Ring<D>::BYTES + 1024;  // room to align the base
  cudaError_t err = cudaFuncSetAttribute(observed_colsum_kernel<D, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + KEYS - 1) / KEYS * p.Hkv, p.B);
  observed_colsum_kernel<D, G><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_colsum_d(const Params& p, cudaStream_t stream) {
  switch (p.Hq / p.Hkv) {
    case 1: return launch_colsum<D, 1>(p, stream);
    case 2: return launch_colsum<D, 2>(p, stream);
    case 4: return launch_colsum<D, 4>(p, stream);
    case 8: return launch_colsum<D, 8>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace colsum

// Pass 1: the flash main loop without V, under its own name.
template <int D>
__global__ void __launch_bounds__(sm90::THREADS, 1) observed_lse_kernel(const sm90::FlashParams p) {
  sm90::flash_block<D, sm90::LSE_ONLY>(p);
}

template <int D>
cudaError_t launch_lse(sm90::FlashParams p, cudaStream_t stream) {
  if (p.G < 1 || p.G > sm90::BLOCK_ROWS) return cudaErrorInvalidValue;
  constexpr int smem = sm90::Ring<D, sm90::LSE_ONLY>::BYTES + 1024;
  cudaError_t err = cudaFuncSetAttribute(observed_lse_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.bq = sm90::block_q(p.G);
  dim3 grid((p.T + p.bq - 1) / p.bq, p.Hkv, p.B);
  observed_lse_kernel<D><<<grid, sm90::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace kvp

extern "C" int kvp_observed_lse(const void* q, const void* k, void* lse, int B, int Hq,
                                int Hkv, int S, int D, float sm_scale, float softcap,
                                void* stream) {
  kvp::sm90::FlashParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.lse = static_cast<float*>(lse);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.T = S; p.S = S; p.G = Hq / Hkv;
  p.nsplit = 1;
  p.sm_scale = sm_scale; p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return kvp::launch_lse<64>(p, st);
    case 96: return kvp::launch_lse<96>(p, st);
    case 128: return kvp::launch_lse<128>(p, st);
    case 256: return kvp::launch_lse<256>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int kvp_observed_colsum(const void* q, const void* k, const void* lse, void* out,
                                   int B, int Hq, int Hkv, int S, int D, float sm_scale,
                                   float softcap, void* stream) {
  kvp::colsum::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.lse = static_cast<const float*>(lse);
  p.out = static_cast<float*>(out);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.S = S;
  p.sm_scale = sm_scale; p.softcap = softcap;
  // The producer's query offsets within a group of G query heads are 32-bit.
  if ((long long)(Hq / Hkv) * S * D >= (1ll << 31)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return kvp::colsum::launch_colsum_d<64>(p, st);
    case 96: return kvp::colsum::launch_colsum_d<96>(p, st);
    case 128: return kvp::colsum::launch_colsum_d<128>(p, st);
    case 256: return kvp::colsum::launch_colsum_d<256>(p, st);
    default: return cudaErrorInvalidValue;
  }
}
