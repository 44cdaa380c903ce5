// Ragged paged attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_ragged_kernel`
// (dynamo_exp_tpu/ops/ragged_attention.py:123, launched at :345) and
// computes what it computes: causal GQA attention of a flat query
// stream q[N, H, D] against a paged KV pool [P, ps, Hkv*D]. A token at
// position p attends to its row's kv positions <= p; online softmax
// with float32 accumulators; a fully empty tile (every position -1)
// writes exact zeros. Padding slots inside a live tile write zeros too
// (the TPU kernel leaves them unspecified; callers ignore them).
//
// Design (not the TPU's blocks carried over):
// - One block per (query tile, kv head); grid = (N / q_tile, Hkv). The
//   block reads its own row (row_of[first token]) and kv bound (max
//   position in the tile + 1): no scalar prefetch.
// - The block keeps the qpk*q_tile query rows of its kv head in
//   (group, query) order in shared memory as float32, and walks the
//   row's live pages in chunks of 32 tokens staged in shared memory,
//   each thread issuing all of its 16-byte K/V loads for a chunk before
//   using any (the pools must be 16-byte aligned). Page indices past
//   the table are clamped and their tokens masked, as the TPU kernel
//   does.
// - Each warp owns rows (warp, warp+4, ...). For a chunk, lane j scores
//   token j of the chunk (the full D-long dot product, K padded to
//   D+1 floats a row so the 32 lanes hit 32 banks), the warp reduces
//   the chunk max and sum, and the PV product broadcasts each lane's
//   probability with a shuffle while every lane accumulates D/32
//   output dims in registers.
//
// Numerics follow the TPU kernel, not the plain reference: q and k are
// taken to float32 for QK (the reference rounds q to the pool dtype
// first), and the unnormalised probabilities are rounded to the pool
// dtype before PV, with the softmax sum kept from the unrounded ones.
//
// What bounds it on this card: the bytes of K/V it reads. A row's
// context is Hkv*D*2 values a token; every query tile of the row reads
// it again (from L2 when it is warm). Staging a chunk once per block
// lets all qpk*q_tile queries of a kv head (32 at q_tile=8 for
// llama-8b) reuse each K/V element from shared memory, which is what
// keeps the mixed shape from reading K/V once per query head. What
// this first version does not do (later work): split-KV for decode
// (the decode grid is only rows*Hkv blocks), cp.async/TMA double
// buffering of the chunks, and tensor-core (wgmma) products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;  // kv tokens per staged chunk: one per lane
constexpr int kMaxQTile = 8;

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

// Stage kv tokens [c0, c0 + kChunk) of kv head `kvh` into shared
// memory as float32 (zeros past kvlen). Each thread issues all of its
// 16-byte loads before it converts and stores any of them, so a chunk
// costs about one round trip to memory rather than one per element.
template <typename T, int D>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ k,
                                            const T* __restrict__ v,
                                            const int32_t* __restrict__ table_row,
                                            int c0, int kvlen, int ps, int pmax,
                                            int fused, int kvh, float* k_s,
                                            float* v_s, int tid) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPT = D / VEC;         // loads per token
  constexpr int NV = kChunk * VPT / kThreads;
  static_assert(kChunk * VPT % kThreads == 0, "chunk must split evenly");
  uint4 kr[NV], vr[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int e = tid + i * kThreads;
    const int tok = c0 + e / VPT;
    kr[i] = make_uint4(0u, 0u, 0u, 0u);
    vr[i] = kr[i];
    if (tok < kvlen) {
      // Pages past the table are clamped here and masked by kvlen.
      const int page = table_row[min(tok / ps, pmax - 1)];
      const size_t off =
          ((size_t)page * ps + tok % ps) * fused + kvh * D + (e % VPT) * VEC;
      kr[i] = *reinterpret_cast<const uint4*>(k + off);
      vr[i] = *reinterpret_cast<const uint4*>(v + off);
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int e = tid + i * kThreads;
    const int t = e / VPT, d0 = (e % VPT) * VEC;
    const T* kx = reinterpret_cast<const T*>(&kr[i]);
    const T* vx = reinterpret_cast<const T*>(&vr[i]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      k_s[t * (D + 1) + d0 + j] = to_f32<T>(kx[j]);
      v_s[t * D + d0 + j] = to_f32<T>(vx[j]);
    }
  }
}

// T: element type of q, the pools and out. D: head dim. RPW: query
// rows a warp owns (ceil(qpk * q_tile / kWarps), rounded up to a
// power of two so a few instantiations cover every shape).
template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kThreads)
    ragged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int32_t* __restrict__ page_table,
                            const int32_t* __restrict__ row_of,
                            const int32_t* __restrict__ positions,
                            T* __restrict__ out, int H, int Hkv, int ps,
                            int pmax, int qt, float scale) {
  constexpr int DPL = D / 32;  // output dims per lane
  extern __shared__ float smem[];
  __shared__ int pos_s[kMaxQTile];

  const int qpk = H / Hkv;
  const int R = qpk * qt;
  float* q_s = smem;                    // [R][D]
  float* k_s = q_s + R * D;             // [kChunk][D + 1]
  float* v_s = k_s + kChunk * (D + 1);  // [kChunk][D]

  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int fused = Hkv * D;
  const int row = row_of[tile * qt];

  if (tid < qt) pos_s[tid] = positions[tile * qt + tid];
  // Stage this kv head's query rows, r = g * qt + i, as float32.
  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int g = r / qt, i = r % qt;
    q_s[e] = to_f32<T>(q[((size_t)(tile * qt + i) * H + kvh * qpk + g) * D + d]);
  }
  __syncthreads();

  int kvlen = 0;  // the tile's causal horizon: max position + 1
  for (int i = 0; i < qt; ++i) kvlen = max(kvlen, pos_s[i] + 1);
  kvlen = min(kvlen, pmax * ps);  // kv past the page table does not exist

  float m_i[RPW], l_i[RPW], acc[RPW][DPL];
  int qpos[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = warp + j * kWarps;
    m_i[j] = -1e30f;
    l_i[j] = 0.f;
    qpos[j] = r < R ? pos_s[r % qt] : -1;
#pragma unroll
    for (int x = 0; x < DPL; ++x) acc[j][x] = 0.f;
  }

  const int32_t* table_row = page_table + (size_t)row * pmax;
  for (int c0 = 0; c0 < kvlen; c0 += kChunk) {
    __syncthreads();  // every warp is done with the previous chunk
    stage_chunk<T, D>(k, v, table_row, c0, kvlen, ps, pmax, fused, kvh, k_s, v_s, tid);
    __syncthreads();

    const int tok = c0 + lane;
    const float* kr = k_s + lane * (D + 1);
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = warp + j * kWarps;
      if (r < R) {  // uniform across the warp
        const float* qr = q_s + r * D;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        s *= scale;
        const bool live = tok < kvlen && tok <= qpos[j];
        s = live ? s : -1e30f;
        const float m_new = fmaxf(m_i[j], warp_max(s));
        const float alpha = expf(m_i[j] - m_new);
        const float p = live ? expf(s - m_new) : 0.f;
        l_i[j] = l_i[j] * alpha + warp_sum(p);
        m_i[j] = m_new;
        // PV takes the probabilities in the pool dtype (TPU kernel rule).
        const float pv = to_f32<T>(from_f32<T>(p));
#pragma unroll
        for (int x = 0; x < DPL; ++x) acc[j][x] *= alpha;
#pragma unroll 4
        for (int t2 = 0; t2 < kChunk; ++t2) {
          const float pt = __shfl_sync(0xffffffffu, pv, t2);
          const float* vr = v_s + t2 * D + lane;
#pragma unroll
          for (int x = 0; x < DPL; ++x) acc[j][x] = fmaf(pt, vr[32 * x], acc[j][x]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = warp + j * kWarps;
    if (r < R) {
      const int g = r / qt, i = r % qt;
      const float l = l_i[j] == 0.f ? 1.f : l_i[j];
      T* o = out + ((size_t)(tile * qt + i) * H + kvh * qpk + g) * D + lane;
#pragma unroll
      for (int x = 0; x < DPL; ++x) o[32 * x] = from_f32<T>(acc[j][x] / l);
    }
  }
}

template <typename T, int D, int RPW>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* page_table, const void* row_of,
                   const void* positions, void* out, int n_tiles, int H,
                   int Hkv, int ps, int pmax, int qt, float scale,
                   cudaStream_t stream) {
  const int R = (H / Hkv) * qt;
  const size_t smem = (size_t)(R * D + kChunk * (D + 1) + kChunk * D) * sizeof(float);
  auto kern = ragged_attention_kernel<T, D, RPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_tiles, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(row_of),
      static_cast<const int32_t*>(positions), static_cast<T*>(out), H, Hkv,
      ps, pmax, qt, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_rows(int rpw, const void* q, const void* k, const void* v,
                    const void* page_table, const void* row_of,
                    const void* positions, void* out, int n_tiles, int H,
                    int Hkv, int ps, int pmax, int qt, float scale,
                    cudaStream_t stream) {
#define DX_LAUNCH(N)                                                        \
  return launch<T, D, N>(q, k, v, page_table, row_of, positions, out,      \
                         n_tiles, H, Hkv, ps, pmax, qt, scale, stream)
  if (rpw <= 1) DX_LAUNCH(1);
  if (rpw <= 2) DX_LAUNCH(2);
  if (rpw <= 4) DX_LAUNCH(4);
  if (rpw <= 8) DX_LAUNCH(8);
  if (rpw <= 16) DX_LAUNCH(16);
#undef DX_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
// Shapes are checked by the Python wrapper; this re-checks only what
// would index out of the instantiations.
extern "C" int dx_ragged_attention(const void* q, const void* k, const void* v,
                                   const void* page_table, const void* row_of,
                                   const void* positions, void* out,
                                   int n_tokens, int H, int Hkv, int D, int ps,
                                   int pmax, int q_tile, float scale,
                                   int is_bf16, void* stream) {
  if (q_tile < 1 || q_tile > kMaxQTile || n_tokens % q_tile != 0 ||
      Hkv < 1 || H % Hkv != 0 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (n_tokens == 0) return 0;
  const int n_tiles = n_tokens / q_tile;
  const int rpw = ((H / Hkv) * q_tile + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = D == 64 ? by_rows<__nv_bfloat16, 64>(rpw, q, k, v, page_table, row_of,
                                               positions, out, n_tiles, H, Hkv,
                                               ps, pmax, q_tile, scale, s)
                  : by_rows<__nv_bfloat16, 128>(rpw, q, k, v, page_table,
                                                row_of, positions, out, n_tiles,
                                                H, Hkv, ps, pmax, q_tile, scale, s);
  } else {
    err = D == 64 ? by_rows<float, 64>(rpw, q, k, v, page_table, row_of,
                                       positions, out, n_tiles, H, Hkv, ps,
                                       pmax, q_tile, scale, s)
                  : by_rows<float, 128>(rpw, q, k, v, page_table, row_of,
                                        positions, out, n_tiles, H, Hkv, ps,
                                        pmax, q_tile, scale, s);
  }
  return (int)err;
}
