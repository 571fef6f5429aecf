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
// head. What the design does about it (decode_sm90.cuh): a head's live set,
// its prefix steps of NK keys and then its tail steps (from the first tail
// slot the prefix does not cover, so a tail that the longest head's prefix
// absorbs is read once, as prefix), is laid out as one list of steps, cut
// into `nsplit` chunks of a length fixed by S (which the host knows; the
// ranges are device tensors, read by the blocks themselves, no host round
// trip). A chunk past its head's live set writes an empty range, so a long
// head is spread over as many blocks as a short one and holds up no launch.
// The steps go through the ring of bulk copies (four stages, three at head_dim
// 256; a tail step may start at any slot: a bf16 row is 16-byte aligned), and
// decode_headwise_kernel_merge merges the chunks in index order; a head with
// nothing to read stores 0.
#include "decode_sm90.cuh"

namespace kvp {
namespace few {

template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 3 : D <= 128 ? 2 : 1)
    decode_headwise_kernel(const FewParams p) {
  using St = Stages<D, KV_BF16>;
  constexpr int NK = St::NK;
  extern __shared__ __align__(16) unsigned char smem[];
  const St st{smem};
  const int rg = blockIdx.x / p.nsplit, split = blockIdx.x % p.nsplit;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t kvh = (size_t)b * p.Hkv + h;
  if (threadIdx.x == 0) st.init_barriers();

  const int prefix_len = min(p.prefix_lens[kvh], p.S);
  const int tail_end = min(p.tail[0] + p.tail[1], p.S);
  const int tail_lo = max(p.tail[0], prefix_len);
  const int n_pref = (prefix_len + NK - 1) / NK;
  const int n_tail = tail_end > tail_lo ? (tail_end - tail_lo + NK - 1) / NK : 0;
  // Chunks of `per` steps: the most a head can have is a whole buffer of
  // prefix steps and one more for a tail that starts off a step boundary.
  const int per = ((p.S + NK - 1) / NK + 1 + p.nsplit - 1) / p.nsplit;
  const int i0 = min(n_pref + n_tail, split * per);
  const int n = min(n_pref + n_tail, i0 + per) - i0;

  // Prefix steps are visible to every row: a whole one takes no
  // per-element test. Tail steps are causal and test everything.
  struct Walk {
    int i0, n, n_pref, prefix_len, tail_lo, tail_end, qbase;
    __device__ Step step(int i) const {
      const int j = i0 + i;
      return j < n_pref ? Step{j * NK, prefix_len, 0, (j + 1) * NK <= prefix_len ? DENSE : EDGE}
                        : Step{tail_lo + (j - n_pref) * NK, tail_end, 1, EDGE};
    }
  } const w{i0, n, n_pref, prefix_len, tail_lo, tail_end, tail_end - p.T};
  __syncthreads();
  run_block<D, KV_BF16>(p, st, w, rg, split, h, b);
}

template <int D>
__global__ void decode_headwise_kernel_merge(const float* part_o, const float* part_ml,
                                             __nv_bfloat16* out, size_t rows, int nsplit) {
  merge_block<D>(part_o, part_ml, out, rows, nsplit);
}

template <int D>
cudaError_t launch_headwise(const FewParams& p, cudaStream_t stream) {
  return launch_few<D>(decode_headwise_kernel<D>, decode_headwise_kernel_merge<D>, p,
                       Stages<D, KV_BF16>::OFF_LIST, stream);
}

}  // namespace few
}  // namespace kvp

extern "C" int kvp_decode_attention_headwise(const void* q, const void* k, const void* v,
                                             const void* prefix_lens, const void* tail,
                                             void* out, void* part_o, void* part_ml, int B,
                                             int Hq, int Hkv, int T, int S, int D, int nsplit,
                                             float sm_scale, float softcap, void* stream) {
  kvp::few::FewParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.prefix_lens = static_cast<const int*>(prefix_lens);
  p.tail = static_cast<const int*>(tail);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.T = T; p.S = S; p.G = Hq / Hkv;
  p.nsplit = nsplit;
  p.sm_scale = sm_scale; p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return kvp::few::launch_headwise<64>(p, st);
    case 96: return kvp::few::launch_headwise<96>(p, st);
    case 128: return kvp::few::launch_headwise<128>(p, st);
    case 256: return kvp::few::launch_headwise<256>(p, st);
    default: return cudaErrorInvalidValue;
  }
}
