// Small pieces shared by the Hopper attention kernels: cache kinds and row
// widths, bf16 packing, the m16n8k16 tensor-core product (mma.sync), the
// cp.async wrappers and the quad reductions. The multi-token flash kernels
// (flash.cu, flash_quant.cu) and the column sums (observed_colsum.cu) are
// built on flash_sm90.cuh (wgmma, rings of stages behind mbarriers); the
// few-token kernels (decode.cu, decode_headwise.cu) on decode_sm90.cuh
// (a key range split over blocks, a ring of bulk copies behind mbarriers,
// mma.sync on operands widened in registers).
//
// Numerics follow the Pallas kernels of kvpress_tpu/ops/flash.py and
// ops/decode.py: logits and softmax statistics in float32, bf16 operands for
// both products. Quantized caches (cache.quantize_kv layout) are read at
// payload width: int8 payloads and the +8-offset nibbles of int4 (channel c
// in the low nibble, c + D/2 in the high) are small integers, exact in bf16.
// The per-token scales are folded as the TPU kernels fold them: key scales
// into logit columns, value scales into probability rows (after the row
// sum). No dequantized buffer exists in device memory.
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

}  // namespace kvp
