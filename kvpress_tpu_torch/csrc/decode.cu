// Few-token attention (decode steps, short question forwards) over a bf16,
// int8 or packed-int4 KV cache that may carry a keep-mask.
//
// Replaces the Pallas kernel kvpress_tpu/ops/decode.py::decode_attention
// (body _kernel, with live_block_table): query row r of the call attends slot
// s iff s <= (length - T) + r % T, s < length, the keep-mask bit of s is set
// and, with a window, s > (length - T) + r % T - window; only the key steps
// that hold a live slot are read, at payload width, with the per-token
// scales folded into logit columns and probability rows.
//
// What bounds it on the H100: bytes. A decode step at the main-path shape
// (B 4, GQA 32/8, D 64, 16K kept slots, 16 layers) reads ~2.1 GB of bf16 K/V
// (0.64 ms at 3.35 TB/s) or ~0.54 GB of int4 payload plus scales (0.16 ms),
// and does ~4 FLOPs per byte. What the design does about it
// (decode_sm90.cuh): the key range of each (16-row group, kv head, batch row)
// is split over `nsplit` blocks chosen from the shapes (ops/decode.py
// decode_splits), so that batch 1 and batch 4 both put several blocks on
// every SM; each block reads its own range's keep-mask bytes, lists its live
// steps in shared memory and walks only those through a four-stage ring of
// bulk copies (three at head_dim 256 in bf16, decode_sm90.cuh says why); the
// ranges are merged in index order by decode_kernel_merge
// (named so that a profiler search for "decode_kernel" finds both kernels of
// a launch). All G query heads of a kv head share a block's rows, so K/V are
// read once per kv head and row group.
#include "decode_sm90.cuh"

namespace kvp {
namespace few {

template <int D, int KIND>
__global__ void __launch_bounds__(THREADS, D == 64 ? 3 : D <= 128 ? 2 : 1)
    decode_kernel(const FewParams p) {
  using St = Stages<D, KIND>;
  constexpr int NK = St::NK;
  extern __shared__ __align__(16) unsigned char smem[];
  const St st{smem};
  const int rg = blockIdx.x / p.nsplit, split = blockIdx.x % p.nsplit;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t kvh = (size_t)b * p.Hkv + h;
  if (tid == 0) st.init_barriers();

  // This block's steps: NK keys each from the first slot any row can see
  // (a window starts it late) up to length, cut into nsplit runs.
  const int prior = p.length - p.T;
  const int first = p.window > 0 ? max(0, prior - p.window + 1) : 0;
  const int kfirst = first / NK * NK;
  const int nst = (p.length - kfirst + NK - 1) / NK;
  const int per = (nst + p.nsplit - 1) / p.nsplit;
  const int i0 = min(nst, split * per);
  const int n = min(nst, i0 + per) - i0;

  // A step is live if it holds a keep-bit set below length, and full if
  // every one of its slots is below length with its keep-bit set: one vote
  // of a warp per step, then warp 0 compacts the live ones (a ballot and a
  // prefix sum per 32 steps, in place: a step moves only to a lower index),
  // each as (index << 1) | full.
  int* live = st.list();
  for (int j = warp; j < n; j += CWARPS + 1) {
    const int key0 = kfirst + (i0 + j) * NK;
    bool any = false, all = true;
    for (int e = lane; e < NK; e += 32) {
      const int slot = key0 + e;
      const bool set = slot < p.length && (p.mask == nullptr || p.mask[kvh * p.S + slot] != 0);
      any |= set;
      all &= set;
    }
    any = __any_sync(0xffffffffu, any);
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) live[j] = any ? 1 + all : 0;
  }
  __syncthreads();
  if (warp == 0) {
    int total = 0;
    for (int c = 0; c < n; c += 32) {
      const int j = c + lane;
      const int v = j < n ? live[j] : 0;
      const unsigned votes = __ballot_sync(0xffffffffu, v != 0);
      if (v != 0) live[total + __popc(votes & ((1u << lane) - 1u))] = (j << 1) | (v == 2);
      total += __popc(votes);
    }
    if (lane == 0) *st.count() = total;
  }
  __syncthreads();

  // A step inside every row's view (below row 0's diagonal, above the last
  // row's window) tests its keep-bits alone, and none if it is full.
  struct Walk {
    const int* live;
    int n, base, hi, qbase, inside_below, inside_above;
    __device__ Step step(int i) const {
      const int key0 = base + (live[i] >> 1) * NK;
      const bool inside = key0 + NK - 1 <= inside_below && key0 > inside_above;
      return Step{key0, hi, 1, inside ? ((live[i] & 1) ? DENSE : INSIDE) : EDGE};
    }
  } const w{live, *st.count(), kfirst + i0 * NK, p.length, prior, prior,
            p.window > 0 ? prior + p.T - 1 - p.window : -1};
  run_block<D, KIND>(p, st, w, rg, split, h, b);
}

template <int D>
__global__ void decode_kernel_merge(const float* part_o, const float* part_ml,
                                    __nv_bfloat16* out, size_t rows, int nsplit) {
  merge_block<D>(part_o, part_ml, out, rows, nsplit);
}

template <int D, int KIND>
cudaError_t launch_decode(const FewParams& p, cudaStream_t stream) {
  using St = Stages<D, KIND>;
  if (p.length < p.T || p.length > p.S) return cudaErrorInvalidValue;
  // The list holds at most one range's steps (the most without a window).
  const int most = ((p.length + St::NK - 1) / St::NK + p.nsplit - 1) / p.nsplit;
  const size_t smem = St::OFF_LIST + (size_t)most * sizeof(int);
  return launch_few<D>(decode_kernel<D, KIND>, decode_kernel_merge<D>, p, smem, stream);
}

}  // namespace few
}  // namespace kvp

extern "C" int kvp_decode_attention(const void* q, const void* k, const void* v,
                                    const void* k_scales, const void* v_scales,
                                    const void* mask, void* out, void* part_o, void* part_ml,
                                    int B, int Hq, int Hkv, int T, int S, int D, int bits,
                                    int length, int nsplit, float sm_scale, float softcap,
                                    int window, void* stream) {
  kvp::few::FewParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.T = T; p.S = S; p.G = Hq / Hkv;
  p.length = length; p.nsplit = nsplit; p.window = window;
  p.sm_scale = sm_scale; p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace kvp;
  using few::launch_decode;
  if ((bits != 0) != (k_scales != nullptr && v_scales != nullptr)) return cudaErrorInvalidValue;
  if (bits == 0) {
    switch (D) {
      case 64: return launch_decode<64, KV_BF16>(p, st);
      case 96: return launch_decode<96, KV_BF16>(p, st);
      case 128: return launch_decode<128, KV_BF16>(p, st);
      case 256: return launch_decode<256, KV_BF16>(p, st);
    }
  } else if (bits == 8) {
    switch (D) {
      case 64: return launch_decode<64, KV_INT8>(p, st);
      case 96: return launch_decode<96, KV_INT8>(p, st);
      case 128: return launch_decode<128, KV_INT8>(p, st);
      case 256: return launch_decode<256, KV_INT8>(p, st);
    }
  } else if (bits == 4) {
    switch (D) {
      case 64: return launch_decode<64, KV_INT4>(p, st);
      case 96: return launch_decode<96, KV_INT4>(p, st);
      case 128: return launch_decode<128, KV_INT4>(p, st);
      case 256: return launch_decode<256, KV_INT4>(p, st);
    }
  }
  return cudaErrorInvalidValue;
}
