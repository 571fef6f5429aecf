// Multi-token causal attention over a bf16 KV cache.
//
// Replaces the Pallas kernel kvpress_tpu/ops/flash.py::flash_attention
// (body _kernel): online-softmax attention with GQA folding, slot-index
// causality (query i of the call sees slot s iff s <= prior + i), the
// (B, Hkv, S) keep-mask, optional sliding window, logit softcap and f32 LSE,
// and the same-image or-mask of Gemma3's multimodal prefill (q_groups,
// k_groups, or_span): a query whose image id is >= 0 also sees every slot of
// its image, ahead of it or behind its window.
//
// What bounds it on the H100: at the main-path prefill shape (GQA 32/8,
// D 64, T = S = 32K, causal) the products need 4*D FLOPs per visible
// (query head, key) pair, ~70 TFLOP for 16 layers, against ~4 GB of q/k/v/o
// bytes: tensor-core operations, not memory, bound it (989 TFLOP/s bf16), and
// at D 64 the exponential unit is as tight a ceiling. What the design does
// about it is the main loop of flash_sm90.cuh, instantiated here for a bf16
// cache: wgmma for both products, K/V tiles copied by a producer warpgroup
// into a four-stage swizzled ring behind per-stage mbarriers, two consumer
// warpgroups whose exponentials and products overlap, masking only in tiles
// that need it, and a split of the key range (merged by a second kernel) when
// the launch has too few q-tiles to fill the card (head_dim 64, 96, 128 and
// 256: 128-, 64-, 64- and 32-key tiles, flash_sm90.cuh says why). The or-mask is a second
// instantiation of the loop (OR = true): each q-tile's key range widens by
// or_span - 1 slots on both sides, the keys' image ids ride in the ring
// beside the keep-mask bytes, and every tile outside the causal window takes
// the per-element test; a launch without groups runs the loop unchanged.
#include "flash_sm90.cuh"

extern "C" int kvp_flash_attention(const void* q, const void* k, const void* v,
                                   const void* mask, const void* q_groups,
                                   const void* k_groups, void* out, void* lse, void* part_o,
                                   void* part_ml, int B, int Hq, int Hkv, int T, int S, int D,
                                   int prior, int mask_pitch, int kg_pitch, int or_span,
                                   int nsplit, float sm_scale, float softcap, int window,
                                   void* stream) {
  kvp::sm90::FlashParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.ks = nullptr;
  p.vs = nullptr;
  p.mask = static_cast<const uint8_t*>(mask);
  p.qg = static_cast<const int*>(q_groups);
  p.kg = static_cast<const int*>(k_groups);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.T = T; p.S = S; p.G = Hq / Hkv;
  p.prior = prior; p.mask_pitch = mask_pitch; p.window = window; p.nsplit = nsplit;
  p.kg_pitch = kg_pitch; p.or_span = or_span;
  p.sm_scale = sm_scale; p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (or_span > 0) {
    if (q_groups == nullptr || k_groups == nullptr || kg_pitch < S || kg_pitch % 4 != 0)
      return cudaErrorInvalidValue;
    switch (D) {
      case 64: return kvp::sm90::launch_flash<64, kvp::KV_BF16, true>(p, st);
      case 96: return kvp::sm90::launch_flash<96, kvp::KV_BF16, true>(p, st);
      case 128: return kvp::sm90::launch_flash<128, kvp::KV_BF16, true>(p, st);
      case 256: return kvp::sm90::launch_flash<256, kvp::KV_BF16, true>(p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 64: return kvp::sm90::launch_flash<64, kvp::KV_BF16>(p, st);
    case 96: return kvp::sm90::launch_flash<96, kvp::KV_BF16>(p, st);
    case 128: return kvp::sm90::launch_flash<128, kvp::KV_BF16>(p, st);
    case 256: return kvp::sm90::launch_flash<256, kvp::KV_BF16>(p, st);
    default: return cudaErrorInvalidValue;
  }
}
