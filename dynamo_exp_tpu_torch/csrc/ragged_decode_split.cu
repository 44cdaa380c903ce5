// Ragged paged attention, pure-decode shape (one query per row), as a
// split-KV ("flash-decoding") pair of kernels for Hopper (sm_90a),
// hand-written CUDA C++, for bf16 and float32 pools.
//
// Replaces the Pallas TPU kernel `_ragged_kernel`
// (dynamo_exp_tpu/ops/ragged_attention.py:123, launched at :345) at
// q_tile=1 as entered through `ragged_decode_attention` (:353): row b's
// query attends to its own `lengths[b]` tokens of the paged KV pool
// [P, ps, Hkv*D]; rows of length 0 write exact zeros.
//
// What bounds it on this card: the bytes of K/V. Each row's context is
// read once and used by only qpk query heads per kv head (4 for
// llama-8b), about 2 flop per byte, so tensor cores cannot help; what
// matters is keeping enough bytes in flight on enough SMs. The previous
// design ran one block per (row, kv head), 64 blocks for 8 rows of
// llama-8b on 132 SMs, each walking its context alone one chunk after
// another. This design:
// - pass 1 (`decode_split_kernel`): grid (split, kv head, row), a split
//   being `split` consecutive tokens of the row (64 by default); the
//   number of splits comes from the page table's width, so no host sync;
//   blocks past their row's length exit at once. A block streams its
//   split's K/V in the pool dtype through a ring of three 32-token
//   chunks filled by 16-byte cp.async (rows padded by 16 bytes so the
//   lanes' row reads hit distinct banks; page-table entries read one
//   chunk ahead), scores the qpk query rows on CUDA cores in float32
//   (one token a lane), and writes a partial (max in log2 units, sum,
//   unnormalised output) in float32 to scratch;
// - pass 2 (`decode_combine_kernel`): one block per (row, q head)
//   merges the row's splits and writes the output in the pool dtype.
// Numerics, those of the TPU kernel: q.k in float32; the unnormalised
// probabilities are rounded to the pool dtype before PV, relative to the
// split's running max; the softmax sum is kept from the unrounded ones.
// The combine changes only the order of the sums.
// What holds it back now: a fixed cost of about half its time at the
// main path's decode shape (two launches, the blocks' first loads of
// lengths, page table and q before any K/V arrives, the combine pass)
// and, per chunk, one block of 4 warps waiting on its own chains of
// shuffles and FMAs. Fusing the combine into pass 1 (the last split of
// a row merges) and more rows per block are the next steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3; bound with
// ctypes (plain C interface below).

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;  // kv tokens per staged chunk: one per lane
constexpr int kStages = 3;  // chunks in the ring

// T: pool dtype. D: head dim. RPW: query rows a warp owns, rows
// (warp, warp + 4, ...) of the kv head's qpk.
template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int32_t* __restrict__ page_table,
                        const int32_t* __restrict__ lengths, float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int H, int Hkv, int ps, int pmax,
                        int split, int n_splits, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LD = D + VEC;
  constexpr int DPL = D / 32;  // output dims per lane, contiguous
  struct alignas(DPL * sizeof(T)) VRow {
    T x[DPL];
  };
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(lengths[b], pmax * ps);
  const int t0 = sp * split;
  if (t0 >= len) return;  // past the row's length (or an inactive row)
  const int t1 = min(t0 + split, len);
  const int qpk = H / Hkv;
  const int fused = Hkv * D;
  const int ps_log2 = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* q_s = reinterpret_cast<float*>(smem_raw);  // [qpk][D]
  T* kv_s = reinterpret_cast<T*>(q_s + qpk * D);    // [kStages][K|V][kChunk][LD]

  const int32_t* table_row = page_table + (size_t)b * pmax;
  const int nch = (t1 - t0 + kChunk - 1) / kChunk;
  // A ring of kStages chunk buffers: chunks c+1 .. c+kStages-1 load
  // while chunk c is computed.
  dx::KvStager<T, D, kChunk, kThreads, LD> stager;
  stager.lookup(table_row, t0, t1, ps, ps_log2, pmax);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nch) {
      T* buf = kv_s + st * 2 * kChunk * LD;
      stager.issue(k, v, ps, ps_log2, fused, kvh, buf, buf + kChunk * LD);
      if (st + 1 < nch)
        stager.lookup(table_row, t0 + (st + 1) * kChunk, t1, ps, ps_log2, pmax);
    }
    dx::cp_async_commit();
  }
  // The query rows, in float32, while the first chunks are in flight.
  for (int e = tid; e < qpk * D; e += kThreads)
    q_s[e] = dx::to_f32<T>(q[((size_t)b * H + kvh * qpk) * D + e]);
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units

  float m_i[RPW], l_i[RPW], acc[RPW][DPL];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    m_i[j] = -1e30f;
    l_i[j] = 0.f;
#pragma unroll
    for (int x = 0; x < DPL; ++x) acc[j][x] = 0.f;
  }

  for (int c = 0; c < nch; ++c) {
    const int nx = c + kStages - 1;
    if (nx < nch) {
      T* buf = kv_s + (nx % kStages) * 2 * kChunk * LD;
      stager.issue(k, v, ps, ps_log2, fused, kvh, buf, buf + kChunk * LD);
      if (nx + 1 < nch)
        stager.lookup(table_row, t0 + (nx + 1) * kChunk, t1, ps, ps_log2, pmax);
    }
    dx::cp_async_commit();
    dx::cp_async_wait<kStages - 1>();  // chunk c landed
    __syncthreads();

    const T* k_s = kv_s + (c % kStages) * 2 * kChunk * LD;
    const T* v_s = k_s + kChunk * LD;
    const bool live = t0 + c * kChunk + lane < t1;
    // Lane j scores token j: its K row in 16-byte pieces.
    // Four partial sums a row keep the FMA chains short.
    float part[RPW][4];
#pragma unroll
    for (int j = 0; j < RPW; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += VEC) {
      const uint4 kr = *reinterpret_cast<const uint4*>(k_s + lane * LD + d0);
      const T* kx = reinterpret_cast<const T*>(&kr);
      float kf[VEC];
#pragma unroll
      for (int x = 0; x < VEC; ++x) kf[x] = dx::to_f32<T>(kx[x]);
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int r = warp + j * kWarps;
        if (r < qpk) {
          const float* qr = q_s + r * D + d0;
#pragma unroll
          for (int x = 0; x < VEC; ++x) part[j][x & 3] = fmaf(qr[x], kf[x], part[j][x & 3]);
        }
      }
    }
    float sc[RPW];
#pragma unroll
    for (int j = 0; j < RPW; ++j) sc[j] = (part[j][0] + part[j][1]) + (part[j][2] + part[j][3]);
    float pv[RPW], al[RPW];
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const float s = live ? sc[j] * sl2 : -1e30f;
      const float m_new = fmaxf(m_i[j], dx::warp_max(s));
      al[j] = dx::fast_exp2(m_i[j] - m_new);
      const float p = live ? dx::fast_exp2(s - m_new) : 0.f;
      l_i[j] = l_i[j] * al[j] + dx::warp_sum(p);
      m_i[j] = m_new;
      pv[j] = dx::to_f32<T>(dx::from_f32<T>(p));  // PV in the pool dtype
#pragma unroll
      for (int x = 0; x < DPL; ++x) acc[j][x] *= al[j];
    }
#pragma unroll 4
    for (int t2 = 0; t2 < kChunk; ++t2) {
      // The lane's DPL contiguous dims of token t2's V row, one load.
      const VRow vr = *reinterpret_cast<const VRow*>(v_s + t2 * LD + lane * DPL);
      float vf[DPL];
#pragma unroll
      for (int x = 0; x < DPL; ++x) vf[x] = dx::to_f32<T>(vr.x[x]);
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const float pt = __shfl_sync(0xffffffffu, pv[j], t2);
#pragma unroll
        for (int x = 0; x < DPL; ++x) acc[j][x] = fmaf(pt, vf[x], acc[j][x]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  dx::cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = warp + j * kWarps;
    if (r < qpk) {
      const size_t idx = ((size_t)b * H + kvh * qpk + r) * n_splits + sp;
      if (lane == 0) {
        part_ml[2 * idx] = m_i[j];
        part_ml[2 * idx + 1] = l_i[j];
      }
#pragma unroll
      for (int x = 0; x < DPL; ++x) part_acc[idx * D + lane * DPL + x] = acc[j][x];
    }
  }
}

// One block of D threads per (row, q head): merge the row's splits.
template <typename T, int D>
__global__ void __launch_bounds__(D)
    decode_combine_kernel(const int32_t* __restrict__ lengths,
                          const float* __restrict__ part_ml,
                          const float* __restrict__ part_acc, T* __restrict__ out, int H,
                          int ps, int pmax, int split, int n_splits) {
  const int b = blockIdx.x / H;
  const int d = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * n_splits;  // (b * H + h) * n_splits
  const int len = min(lengths[b], pmax * ps);
  const int ns = len > 0 ? (len + split - 1) / split : 0;
  float m = -1e30f;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, part_ml[2 * (base + s)]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float w = dx::fast_exp2(part_ml[2 * (base + s)] - m);
    l += part_ml[2 * (base + s) + 1] * w;
    o += part_acc[(base + s) * D + d] * w;
  }
  out[(size_t)blockIdx.x * D + d] = dx::from_f32<T>(o / (l == 0.f ? 1.f : l));
}

template <typename T, int D, int RPW>
cudaError_t launch(const void* q, const void* k, const void* v, const void* page_table,
                   const void* lengths, float* part_ml, float* part_acc, void* out, int B,
                   int H, int Hkv, int ps, int pmax, int split, int n_splits, float scale,
                   cudaStream_t stream) {
  constexpr int LD = D + 16 / sizeof(T);
  const size_t smem =
      (size_t)(H / Hkv) * D * sizeof(float) + (size_t)kStages * 2 * kChunk * LD * sizeof(T);
  auto kern = decode_split_kernel<T, D, RPW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(page_table), static_cast<const int32_t*>(lengths),
      part_ml, part_acc, H, Hkv, ps, pmax, split, n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D><<<B * H, D, 0, stream>>>(
      static_cast<const int32_t*>(lengths), part_ml, part_acc, static_cast<T*>(out), H, ps,
      pmax, split, n_splits);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_rows(int rpw, const void* q, const void* k, const void* v,
                    const void* page_table, const void* lengths, float* part_ml,
                    float* part_acc, void* out, int B, int H, int Hkv, int ps, int pmax,
                    int split, int n_splits, float scale, cudaStream_t stream) {
#define DX_LAUNCH(N)                                                                     \
  return launch<T, D, N>(q, k, v, page_table, lengths, part_ml, part_acc, out, B, H, Hkv, \
                         ps, pmax, split, n_splits, scale, stream)
  if (rpw <= 1) DX_LAUNCH(1);
  if (rpw <= 2) DX_LAUNCH(2);
  if (rpw <= 4) DX_LAUNCH(4);
  if (rpw <= 8) DX_LAUNCH(8);
  if (rpw <= 16) DX_LAUNCH(16);
#undef DX_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Both passes on `stream`; returns the first failing launch's
// cudaError_t (0 = ok). `part_ml` [B, H, n_splits, 2] and `part_acc`
// [B, H, n_splits, D] are float32 scratch from the caller, with
// n_splits = ceil(pmax * ps / split).
extern "C" int dx_ragged_decode_split(const void* q, const void* k, const void* v,
                                      const void* page_table, const void* lengths,
                                      void* part_ml, void* part_acc, void* out, int B, int H,
                                      int Hkv, int D, int ps, int pmax, int split,
                                      float scale, int is_bf16, void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || (D != 64 && D != 128) || split < kChunk ||
      split % kChunk != 0 || (H / Hkv) > 16 * kWarps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int n_splits = (pmax * ps + split - 1) / split;
  const int rpw = (H / Hkv + kWarps - 1) / kWarps;
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = D == 64 ? by_rows<__nv_bfloat16, 64>(rpw, q, k, v, page_table, lengths, ml, acc,
                                               out, B, H, Hkv, ps, pmax, split, n_splits,
                                               scale, s)
                  : by_rows<__nv_bfloat16, 128>(rpw, q, k, v, page_table, lengths, ml, acc,
                                                out, B, H, Hkv, ps, pmax, split, n_splits,
                                                scale, s);
  } else {
    err = D == 64 ? by_rows<float, 64>(rpw, q, k, v, page_table, lengths, ml, acc, out, B,
                                       H, Hkv, ps, pmax, split, n_splits, scale, s)
                  : by_rows<float, 128>(rpw, q, k, v, page_table, lengths, ml, acc, out, B,
                                        H, Hkv, ps, pmax, split, n_splits, scale, s);
  }
  return (int)err;
}
