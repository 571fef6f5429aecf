// Few-token attention over a bf16 KV cache whose heads were compacted one by
// one: head (b, h) reads only its own live prefix [0, prefix_len[b, h]) and
// the tail [tail_start, tail_start + tail_len) that every head shares (the
// tokens appended since the compaction, this call's T among them).
//
// Replaces the Pallas kernel
// kvpress_tpu/ops/decode_headwise.py::decode_attention_headwise (body
// _kernel): prefix columns are visible to every row, tail columns are causal
// (row t of the call is slot tail_end - T + t), and a head with nothing to
// read stores 0.
//
// What bounds it on the H100: bytes. A head reads its own prefix_len + tail
// rows of K and V and does ~4 FLOPs per byte, so the least time is the sum
// of the heads' live rows over 3.35 TB/s, not B * Hkv times the longest
// head. What the design does about it: the block for (batch, kv head,
// 16-row group) reads its own trip count from device memory (prefix_lens and
// the tail pair are device tensors, no host round trip: the counterpart of
// the TPU kernel's scalar prefetch), walks ceil(prefix_len / 256) prefix
// steps and then the tail steps with the cp.async double buffer of
// decode.cu, its 8 warps splitting every step, and merges their softmax
// states at the end. Range tests are in global slot coordinates; a tail
// step starts at the first tail slot itself (any row is 16-byte aligned), so
// no aligned-down block overlaps the prefix. Like decode.cu it runs B * Hkv
// blocks; splitting a head's range across blocks is the later fix.
#include "attn_common.cuh"

namespace kvp {

constexpr int DHW_WARPS = 8;

// Keys each block step takes: 256 at head_dim 64, 128 at 128 (two bf16
// stages of K and V inside shared memory).
template <int D>
__host__ __device__ constexpr int dhw_keys() { return DHW_WARPS * (D == 64 ? 32 : 16); }

struct HeadwiseParams {
  const __nv_bfloat16* q;   // (B, Hq, T, D)
  const __nv_bfloat16* k;   // (B, Hkv, S, D)
  const __nv_bfloat16* v;
  const int* prefix_lens;   // (B, Hkv)
  const int* tail;          // (2): tail_start, tail_len
  __nv_bfloat16* out;       // (B, Hq, T, D)
  int B, Hq, Hkv, T, S, G;
  float sm_scale, softcap;
};

template <int D>
__global__ void __launch_bounds__(32 * DHW_WARPS) decode_headwise_kernel(const HeadwiseParams p) {
  constexpr int NK = dhw_keys<D>();
  constexpr int NCW = NK / DHW_WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  KvTiles<D, NK, KV_BF16> tiles{smem};
  const int rg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rows = p.G * p.T;  // (group, time) rows of this kv head
  const int r0 = rg * 16 + g, r1 = r0 + 8;

  // Rows (g, t) of one kv head are contiguous in (B, Hq, T, D).
  const size_t qoff = ((size_t)b * p.Hq + (size_t)h * p.G) * p.T;
  const __nv_bfloat16* row0 = r0 < rows ? p.q + (qoff + r0) * D : nullptr;
  const __nv_bfloat16* row1 = r1 < rows ? p.q + (qoff + r1) * D : nullptr;
  WarpState<D> st;
  st.init(row0, row1, tq);

  const size_t kvh = (size_t)b * p.Hkv + h;
  KvSource src{reinterpret_cast<const char*>(p.k + kvh * p.S * D),
               reinterpret_cast<const char*>(p.v + kvh * p.S * D),
               nullptr, nullptr, nullptr, p.S, 0};
  const int prefix_len = min(p.prefix_lens[kvh], p.S);
  const int tail_end = min(p.tail[0] + p.tail[1], p.S);
  // The live set is the union of the two ranges: a head whose prefix reaches
  // into the tail (the longest head absorbs the appended tokens) reads those
  // slots once, as prefix.
  const int tail_lo = max(p.tail[0], prefix_len);
  const int n_pref = (prefix_len + NK - 1) / NK;
  const int n_tail = tail_end > tail_lo ? (tail_end - tail_lo + NK - 1) / NK : 0;
  const int nsteps = n_pref + n_tail;
  auto key_of = [&](int s) { return s < n_pref ? s * NK : tail_lo + (s - n_pref) * NK; };
  // Prefix steps: slots below prefix_len, visible to every row. Tail steps
  // (they start at tail_lo): slots below tail_end, causal.
  const int far = 1 << 30;
  const int tslot0 = tail_end - p.T + r0 % p.T, tslot1 = tail_end - p.T + r1 % p.T;

  if (nsteps > 0) tiles.issue(src, 0, key_of(0), tid, nthreads);
  cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) tiles.issue(src, (s + 1) & 1, key_of(s + 1), tid, nthreads);
    cp_async_commit();
    const TileView view = ready(tiles, s & 1, false, tid, nthreads);
    const bool pref = s < n_pref;
    const MaskArgs ma{pref ? far : tslot0, pref ? far : tslot1, pref ? prefix_len : tail_end, 0,
                      p.sm_scale, p.softcap};
    attend<D, NCW, KV_BF16>(st, view, warp * NCW, key_of(s), ma, lane);
    __syncthreads();
  }
  merge_warps_store<D, DHW_WARPS>(st, smem, p.out + qoff * D, rg, rows, tid, nthreads);
}

template <int D>
cudaError_t launch_headwise(const HeadwiseParams& p, cudaStream_t stream) {
  constexpr size_t merge = merge_bytes<D, DHW_WARPS>();
  constexpr size_t tiles = KvTiles<D, dhw_keys<D>(), KV_BF16>::BYTES;
  constexpr size_t smem = tiles > merge ? tiles : merge;
  cudaError_t err = cudaFuncSetAttribute(decode_headwise_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.G * p.T + 15) / 16, p.Hkv, p.B);
  decode_headwise_kernel<D><<<grid, 32 * DHW_WARPS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace kvp

extern "C" int kvp_decode_attention_headwise(const void* q, const void* k, const void* v,
                                             const void* prefix_lens, const void* tail,
                                             void* out, int B, int Hq, int Hkv, int T, int S,
                                             int D, float sm_scale, float softcap,
                                             void* stream) {
  kvp::HeadwiseParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.prefix_lens = static_cast<const int*>(prefix_lens);
  p.tail = static_cast<const int*>(tail);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.T = T; p.S = S; p.G = Hq / Hkv;
  p.sm_scale = sm_scale; p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return kvp::launch_headwise<64>(p, st);
    case 128: return kvp::launch_headwise<128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}
