// Helpers shared by the ragged attention kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dx {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 2^x in one MUFU instruction (flushes results below 2^-126 to zero;
// the softmax only takes x <= 0, where that is an underflow to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A raw q.k as the softmax takes it, in log2 units: times the scale,
// then, with a softcap (gemma2), cap * tanh(s / cap) in natural units,
// then times log2(e). tanhf is the accurate one (about 2 ulp): the
// approximate instruction's 2^-11 times a cap of 50 would move scores
// by about 0.02. The softcap is a template argument, so the families
// without one run no tanh and no branch per score: as a run-time branch
// it slowed the bf16 mixed kernel at llama-8b's shapes by 7.5 % (15.6 %
// at verify spans) on an H100 (tools/torch_kernel_probe.py --parent).
template <bool kCapped>
struct Scorer {
  float mul;  // scale * log2(e), or scale / cap under a softcap
  float cap;  // cap * log2(e)
  __device__ __forceinline__ Scorer(float scale, float softcap) {
    constexpr float kLog2e = 1.4426950408889634f;
    cap = kCapped ? softcap * kLog2e : 0.f;
    mul = kCapped ? scale / softcap : scale * kLog2e;
  }
  __device__ __forceinline__ float operator()(float s) const {
    if constexpr (kCapped) return cap * tanhf(s * mul);
    return s * mul;
  }
};

// (page slot, offset in page) of kv token `tok`: shifts when the page
// size is a power of two (ps_log2 >= 0), a division otherwise.
__device__ __forceinline__ void page_split(int tok, int ps, int ps_log2, int& slot,
                                           int& off) {
  if (ps_log2 >= 0) {
    slot = tok >> ps_log2;
    off = tok & (ps - 1);
  } else {
    slot = tok / ps;
    off = tok - slot * ps;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; `bytes` is 16 or 0 (0
// fills the 16 destination bytes with zeros and reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages kChunk kv tokens of one kv head, K as [kChunk][LD] and V as
// [kChunk][LDV] elements, into shared memory with 16-byte cp.async
// (zeros past the bound), kThreads threads together; thread e handles vector e of the
// chunk, so neighbouring threads read neighbouring bytes of a token.
// The page-table entries of a chunk are loaded into registers one step
// ahead (`lookup`), so staging that chunk (`issue`) never waits on a
// table read. Pages past the table are clamped and masked by the bound.
template <typename T, int D, int kChunk, int kThreads, int LD, int LDV = LD>
struct KvStager {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int VPT = D / VEC;  // vectors per token
  static constexpr int NV = kChunk * VPT / kThreads;
  static_assert(kChunk * VPT % kThreads == 0, "a chunk must split evenly");
  int page[NV];  // -1: past the bound
  int c0 = 0;

  __device__ __forceinline__ void lookup(const int32_t* __restrict__ table_row, int chunk0,
                                         int bound, int ps, int ps_log2, int pmax) {
    c0 = chunk0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int tok = c0 + (threadIdx.x + i * kThreads) / VPT;
      int slot, in_page;
      page_split(tok, ps, ps_log2, slot, in_page);
      page[i] = tok < bound ? table_row[min(slot, pmax - 1)] : -1;
    }
  }

  __device__ __forceinline__ void issue(const T* __restrict__ k, const T* __restrict__ v,
                                        int ps, int ps_log2, int fused, int kvh, T* k_s,
                                        T* v_s) const {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int t = e / VPT, c = (e % VPT) * VEC;
      int slot, in_page;
      page_split(c0 + t, ps, ps_log2, slot, in_page);
      const bool live = page[i] >= 0;
      const size_t off =
          live ? ((size_t)page[i] * ps + in_page) * fused + kvh * D + c : 0;
      cp_async16(k_s + t * LD + c, k + off, live ? 16 : 0);
      cp_async16(v_s + t * LDV + c, v + off, live ? 16 : 0);
    }
  }
};

}  // namespace dx
