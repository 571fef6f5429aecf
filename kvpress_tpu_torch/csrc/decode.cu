// Few-token attention (decode steps, short question forwards) over a bf16,
// int8 or packed-int4 KV cache that may carry a keep-mask.
//
// Replaces the Pallas kernel kvpress_tpu/ops/decode.py::decode_attention
// (body _kernel, with live_block_table): query row r of the call attends slot
// s iff s <= (length - T) + r % T and the keep-mask bit of s is set; only the
// tiles that hold a live slot are read, at payload width, with the per-token
// scales folded into logit columns and probability rows.
//
// What bounds it on the H100: bytes. A decode step at the main-path shape
// (B 4, GQA 32/8, D 64, 16K kept slots, 16 layers) reads ~2.1 GB of bf16 K/V
// (0.64 ms at 3.35 TB/s) or ~0.54 GB of int4 payload plus scales (0.16 ms),
// and does ~4 FLOPs per byte. What the design does about it: the block for
// (batch, kv head, 16-row group) walks only the live tiles of the table, in
// steps of 256 keys (128 at head_dim 128) copied with cp.async at payload
// width, the next step's copy in flight while the current one is used; its
// 8 warps split each step between them (their own running max/sum/
// accumulator, merged through shared memory at the end). All G query heads
// of a kv head share the block's rows, so K/V are read once per kv head. At
// B 4 that is only B*Hkv = 32 blocks for 132 SMs; splitting the KV axis
// across blocks (flash-decoding, with a second merge pass) is the later fix.
#include "attn_common.cuh"

namespace kvp {

constexpr int DEC_WARPS = 8;

// Keys each warp takes per block step: 32 at head_dim 64, 16 at 128 (keeps
// the two-stage bf16 tiles inside shared memory).
template <int D>
__host__ __device__ constexpr int dec_keys() { return DEC_WARPS * (D == 64 ? 32 : 16); }

struct DecodeParams {
  const __nv_bfloat16* q;  // (B, Hq, T, D)
  const void* k;           // (B, Hkv, S, D) bf16/int8 | (B, Hkv, S, D/2) uint8
  const void* v;
  const float* ks;         // (B, Hkv, S) or null
  const float* vs;
  const uint8_t* mask;     // (B, Hkv, mask_pitch) or null
  const int* table;        // (B, Hkv, nb) live tile indices, front-compacted
  const int* count;        // (B, Hkv)
  __nv_bfloat16* out;      // (B, Hq, T, D)
  int B, Hq, Hkv, T, S, G, length, block_k, nb, window, mask_pitch;
  float sm_scale, softcap;
};

template <int D, int KIND>
__global__ void __launch_bounds__(32 * DEC_WARPS) decode_kernel(const DecodeParams p) {
  constexpr int NK = dec_keys<D>();
  constexpr int NCW = NK / DEC_WARPS;
  constexpr int ROW = row_bytes<D, KIND>();
  extern __shared__ __align__(16) unsigned char smem[];
  KvTiles<D, NK, KIND> tiles{smem};
  const int rg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rows = p.G * p.T;  // (group, time) rows of this kv head
  const int r0 = rg * 16 + g, r1 = r0 + 8;
  const int prior = p.length - p.T;

  // Rows (g, t) of one kv head are contiguous in (B, Hq, T, D).
  const size_t qoff = ((size_t)b * p.Hq + (size_t)h * p.G) * p.T;
  const __nv_bfloat16* row0 = r0 < rows ? p.q + (qoff + r0) * D : nullptr;
  const __nv_bfloat16* row1 = r1 < rows ? p.q + (qoff + r1) * D : nullptr;
  WarpState<D> st;
  st.init(row0, row1, tq);

  const size_t kvh = (size_t)b * p.Hkv + h;
  KvSource src{reinterpret_cast<const char*>(p.k) + kvh * p.S * ROW,
               reinterpret_cast<const char*>(p.v) + kvh * p.S * ROW,
               p.ks ? p.ks + kvh * p.S : nullptr, p.vs ? p.vs + kvh * p.S : nullptr,
               p.mask ? p.mask + kvh * p.mask_pitch : nullptr, p.S, p.mask_pitch};
  // The live-tile table of this (batch, kv head), in shared memory after the
  // tiles: the copy addresses of every step read it.
  int* table = reinterpret_cast<int*>(smem + KvTiles<D, NK, KIND>::BYTES);
  const int count = p.count[kvh];
  for (int i = tid; i < count; i += nthreads) table[i] = p.table[kvh * p.nb + i];
  __syncthreads();
  MaskArgs ma{prior + r0 % p.T, prior + r1 % p.T, p.S, p.window, p.sm_scale, p.softcap};

  // Block steps: NK keys each, over the live tiles only. Tiles are in slot
  // order and only the last can reach past `length`.
  const int subs = p.block_k / NK;
  int nsteps = 0;
  if (count > 0) {
    const int tail = p.length - table[count - 1] * p.block_k;
    nsteps = (count - 1) * subs + max(0, min(subs, (tail + NK - 1) / NK));
  }
  auto key_of = [&](int s) { return table[s / subs] * p.block_k + (s % subs) * NK; };

  if (nsteps > 0) tiles.issue(src, 0, key_of(0), tid, nthreads);
  cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) tiles.issue(src, (s + 1) & 1, key_of(s + 1), tid, nthreads);
    cp_async_commit();
    const TileView view = ready(tiles, s & 1, src.mask != nullptr, tid, nthreads);
    attend<D, NCW, KIND>(st, view, warp * NCW, key_of(s), ma, lane);
    __syncthreads();
  }
  merge_warps_store<D, DEC_WARPS>(st, smem, p.out + qoff * D, rg, rows, tid, nthreads);
}

template <int D, int KIND>
cudaError_t launch_decode(const DecodeParams& p, cudaStream_t stream) {
  if (p.block_k % dec_keys<D>() != 0) return cudaErrorInvalidValue;
  constexpr size_t merge = merge_bytes<D, DEC_WARPS>();
  const size_t tiles = KvTiles<D, dec_keys<D>(), KIND>::BYTES + (size_t)p.nb * sizeof(int);
  const size_t smem = tiles > merge ? tiles : merge;
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<D, KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.G * p.T + 15) / 16, p.Hkv, p.B);
  decode_kernel<D, KIND><<<grid, 32 * DEC_WARPS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace kvp

extern "C" int kvp_decode_attention(const void* q, const void* k, const void* v,
                                    const void* k_scales, const void* v_scales,
                                    const void* mask, const void* table,
                                    const void* count, void* out, int B, int Hq,
                                    int Hkv, int T, int S, int D, int bits, int length,
                                    int block_k, int nb, int mask_pitch, float sm_scale,
                                    float softcap, int window, void* stream) {
  kvp::DecodeParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.mask = static_cast<const uint8_t*>(mask);
  p.table = static_cast<const int*>(table);
  p.count = static_cast<const int*>(count);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.T = T; p.S = S; p.G = Hq / Hkv;
  p.length = length; p.block_k = block_k; p.nb = nb; p.window = window;
  p.mask_pitch = mask_pitch;
  p.sm_scale = sm_scale; p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace kvp;
  if (bits == 0) {
    switch (D) {
      case 64: return launch_decode<64, KV_BF16>(p, st);
      case 128: return launch_decode<128, KV_BF16>(p, st);
    }
  } else if (bits == 8) {
    switch (D) {
      case 64: return launch_decode<64, KV_INT8>(p, st);
      case 128: return launch_decode<128, KV_INT8>(p, st);
    }
  } else if (bits == 4) {
    switch (D) {
      case 64: return launch_decode<64, KV_INT4>(p, st);
      case 128: return launch_decode<128, KV_INT4>(p, st);
    }
  }
  return cudaErrorInvalidValue;
}
