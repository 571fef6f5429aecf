// Multi-token causal attention over an int8 or packed-int4 KV cache, with
// the dequantization fused in.
//
// Replaces the Pallas kernel kvpress_tpu/ops/flash.py::flash_attention_quant
// (body _qkernel): the contract of flash.cu over quantized payloads. Key
// scales fold into logit columns (q.(k_int*s) = (q.k_int)*s) and value scales
// into probability rows, after the row sum, exactly as _qkernel does.
//
// What bounds it on the H100: the main-path caller is the question forward
// of an int8 run (T > 128 new tokens over a compressed cache of ~16K slots).
// At T = 256, prior 16K, GQA 32/8, D 64 that is ~8.6 GFLOP per layer against
// ~18 MB of int8 K/V plus scales: operations bound it, if narrowly (8.7 us of
// tensor-core time against 5.3 us of memory time). The payload is read
// once per (kv head, q-tile) at payload width and widened to bf16 in shared
// memory (integers of at most 8 bits are exact in bf16), so both products
// run on the tensor cores like flash.cu; no dequantized buffer exists.
#include "attn_common.cuh"

extern "C" int kvp_flash_attention_quant(const void* q, const void* k, const void* v,
                                         const void* k_scales, const void* v_scales,
                                         const void* mask, void* out, void* lse, int B,
                                         int Hq, int Hkv, int T, int S, int D, int bits,
                                         int prior, int mask_pitch, float sm_scale,
                                         float softcap, int window, void* stream) {
  kvp::FlashParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.T = T; p.S = S; p.G = Hq / Hkv;
  p.prior = prior; p.mask_pitch = mask_pitch; p.window = window;
  p.sm_scale = sm_scale; p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8) {
    switch (D) {
      case 64: return kvp::launch_flash<64, kvp::KV_INT8>(p, st);
      case 128: return kvp::launch_flash<128, kvp::KV_INT8>(p, st);
    }
  } else if (bits == 4) {
    switch (D) {
      case 64: return kvp::launch_flash<64, kvp::KV_INT4>(p, st);
      case 128: return kvp::launch_flash<128, kvp::KV_INT4>(p, st);
    }
  }
  return cudaErrorInvalidValue;
}
