// Multi-token causal attention over a bf16 KV cache.
//
// Replaces the Pallas kernel kvpress_tpu/ops/flash.py::flash_attention
// (body _kernel): online-softmax attention with GQA folding, slot-index
// causality (query i of the call sees slot s iff s <= prior + i), the
// (B, Hkv, S) keep-mask, optional sliding window, logit softcap and f32 LSE.
//
// What bounds it on the H100: at the main-path prefill shape (GQA 32/8,
// D 64, T = S = 32K, causal) the products need 4*D FLOPs per visible
// (query head, key) pair, ~70 TFLOP for 16 layers, against ~4 GB of q/k/v/o
// bytes: tensor-core operations, not memory, bound it (989 TFLOP/s bf16).
// What the design does about it: both products run on the tensor cores
// (mma.sync m16n8k16, f32 accumulate); one block holds all G query heads of
// a q-tile so a K/V tile leaves device memory once per kv head; tiles above
// the causal diagonal are never loaded, and the next tile's copy (cp.async)
// is in flight while the current one is used. Not yet done (later work):
// wgmma, TMA, a deeper shared-memory ring and warp specialisation.
#include "attn_common.cuh"

extern "C" int kvp_flash_attention(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* lse, int B,
                                   int Hq, int Hkv, int T, int S, int D, int prior,
                                   int mask_pitch, float sm_scale, float softcap,
                                   int window, void* stream) {
  kvp::FlashParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.ks = nullptr;
  p.vs = nullptr;
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.T = T; p.S = S; p.G = Hq / Hkv;
  p.prior = prior; p.mask_pitch = mask_pitch; p.window = window;
  p.sm_scale = sm_scale; p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return kvp::launch_flash<64, kvp::KV_BF16>(p, st);
    case 128: return kvp::launch_flash<128, kvp::KV_BF16>(p, st);
    default: return cudaErrorInvalidValue;
  }
}
