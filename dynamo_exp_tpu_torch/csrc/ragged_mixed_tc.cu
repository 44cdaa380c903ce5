// Ragged paged attention, mixed prefill + decode shape, bf16 pools, on
// Hopper's tensor cores (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_ragged_kernel`
// (dynamo_exp_tpu/ops/ragged_attention.py:123, launched at :345) for
// `ragged_paged_attention` with bf16 pools, and computes what it
// computes: causal GQA attention of a flat query stream q[N, H, D]
// against a paged KV pool [P, ps, Hkv*D]. A token at position p attends
// to its row's kv positions in (p - window, p]; online softmax with
// float32 accumulators over the scores scale * q.k, capped to
// cap * tanh(s / cap) under a softcap (gemma2). The TPU kernel has no
// window or softcap: the JAX package computes those in XLA's
// paged_attention (dynamo_exp_tpu/ops/attention.py), and this kernel
// computes what that function computes. Tiles of q_tile tokens each belong to one row; a tile
// whose positions are all -1 writes exact zeros, and so does every
// padding slot (position -1) inside a live tile.
//
// Numerics, those of the TPU kernel: QK takes bf16 q and k with float32
// accumulation (every bf16 x bf16 product is exact in float32, so these
// are the TPU kernel's float32 q.k values up to summation order); the
// unnormalised probabilities are rounded to bf16 before PV, and the
// softmax sum is kept from the unrounded ones.
//
// What bounds it on this card: the operations. At the main path's
// mixed shape (llama-8b, prefill chunks of 512 next to decode rows) QK
// and PV are about 24 GFLOP per call against about 57 MB of q, K/V and
// output, far above the 295 flop/byte where bf16 tensor cores, not
// memory, set the pace. The previous design ran both products in
// float32 on CUDA cores, staged K/V as float32 behind two barriers per
// chunk, and had every q tile read its row's whole context again. This
// design:
// - runs QK and PV on tensor cores: mma.sync m16n8k16 (bf16 in, float32
//   accumulate), fed by ldmatrix from shared memory; the probabilities
//   go from the QK accumulators straight into PV's A fragments in
//   registers. Each of 8 warps owns one 16-row m-tile of query rows and
//   takes the staged tokens 32 at a time;
// - stages K/V in bf16 with 16-byte cp.async into a ring of two 64-token
//   chunks, so chunk c+1 loads while chunk c is computed; rows are
//   padded by 16 bytes so ldmatrix hits distinct banks; the page-table
//   lookup stays in the kernel (no gather, no host sync), one chunk
//   ahead of its copies;
// - lets one block take a run of up to `run` consecutive q tiles of one
//   row (128 query rows: 4 tiles of 8 tokens x 4 q heads per kv head for
//   llama-8b), found from row_of at tile starts: a tile leads a run if
//   its index is a multiple of `run` or its row differs from the
//   previous tile's; other tiles' blocks exit at once. Each K/V chunk is
//   staged once for all of the run's query rows, up to the run's causal
//   horizon, which divides the re-reading of K/V by the run length.
//   Warps skip the tokens past their own rows' horizon, and mask only
//   where a row's causal bound, its window's start, the run's bound or
//   a padding row falls;
// - with a sliding window, starts the chunk walk at the chunk holding
//   the run's earliest visible key, and warps skip the steps before
//   their rows' windows, so a windowed layer reads about `window` keys
//   a row however long the context.
// Rows in a block are laid out (query, q head of the kv head): for one
// query token the kv head's q heads are adjacent in q, so the rows of a
// run are contiguous in memory. Layouts whose row count is not a
// multiple of 16 (Qwen2-7B: 7 q heads per kv head) pad the last m-tile.
// What holds it back now: with one block of 8 warps on an SM, every part
// of a step (fragment loads and products, the per-thread cp.async
// staging, the softmax) waits on latency; the main path's time is the
// critical path of its longest runs. TMA copies and wgmma, with a
// producer warp, would take the staging and the B-fragment loads off
// the warps (ROADMAP Queue 2).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3; bound with
// ctypes (plain C interface below).

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;    // kv tokens per staged chunk
constexpr int kStages = 2;    // chunks in the ring
constexpr int kSub = 32;      // kv tokens per softmax step
// 16-row m-tiles per warp. Two (4 warps of 32 rows) read each K/V
// fragment from shared memory half as often and ran long prefill-only
// batches faster on an H100, but the main path's mixed batch slower:
// its time is the critical path of its longest runs, which 8 warps of
// one m-tile walk faster.
constexpr int kMT = 1;
constexpr int kMaxRows = 128;  // query rows a block takes at most
constexpr int kWarps = kMaxRows / (16 * kMT);
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRun = 8;       // q tiles per block at most
// The largest q_tile (the tuning grid's 16); a block's rows stay within
// kMaxRows, so a run of 16-token tiles is shorter, never wider.
constexpr int kMaxQTile = 16;
constexpr int kMaxRunQ = kMaxRun * kMaxQTile;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(dx::smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(dx::smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// One warp's share of kSub staged kv tokens: S = Q K^T for its kMT
// m-tiles (each K and V fragment read from shared memory serves all of
// them), the online softmax (in the log2 domain: `score` maps q.k to
// log2 units, so exp2 gives the same probabilities), and O += P V.
// kMasked: the tokens cross a row's causal bound, its window's start
// `qlo`, the run's kv bound or the warp holds a padding row, so scores
// are masked and n-tile pairs past the warp's horizon `whor` are
// skipped; otherwise every score is live. Thread state is indexed [m-tile][h], h = 0 for
// row g of the m-tile and 1 for row g + 8.
template <int D, bool kMasked, bool kCapped>
__device__ __forceinline__ void warp_step(const bf16* q_w, const bf16* k_s, const bf16* v_s,
                                          int c0, int whor, int kvlen,
                                          const int (&qpos)[kMT][2],
                                          const int (&qlo)[kMT][2],
                                          const dx::Scorer<kCapped>& score,
                                          float (&m)[kMT][2], float (&l)[kMT][2],
                                          float (&acc)[kMT][D / 8][4]) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;
  constexpr int KS = D / 16;
  constexpr int SN = kSub / 8;
  const int lane = threadIdx.x & 31, tig = lane & 3;
  const int pairs = kMasked ? min(SN / 2, (whor - c0 + 15) / 16) : SN / 2;
  float s[kMT][SN][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < SN; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
  // S = Q K^T on tensor cores.
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
      ldmatrix_x4(a[mt], q_w + (mt * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < SN / 2; ++np) {
      if (!kMasked || np < pairs) {
        uint32_t b[4];
        ldmatrix_x4(b, k_s + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  // Online softmax; a row's 4 threads (one quad) share its max.
  float al[kMT][2];
  bool moved = false;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kMasked) {
          const int tok = c0 + n * 8 + tig * 2 + (j & 1);
          const bool live =
              tok < kvlen && tok <= qpos[mt][j >> 1] && tok >= qlo[mt][j >> 1];
          s[mt][n][j] = live ? score(s[mt][n][j]) : -1e30f;
        } else {
          s[mt][n][j] = score(s[mt][n][j]);
        }
        mx[j >> 1] = fmaxf(mx[j >> 1], s[mt][n][j]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o));
      const float mn = fmaxf(m[mt][h], mx[h]);
      al[mt][h] = dx::fast_exp2(m[mt][h] - mn);
      moved |= al[mt][h] != 1.f;
      m[mt][h] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = dx::fast_exp2(s[mt][n][j] - m[mt][j >> 1]);
        s[mt][n][j] = kMasked && s[mt][n][j] <= -1e29f ? 0.f : p;
        sum[j >> 1] += s[mt][n][j];
      }
    }
    // Per-thread partial sums; quad-reduced at the end.
    l[mt][0] = l[mt][0] * al[mt][0] + sum[0];
    l[mt][1] = l[mt][1] * al[mt][1] + sum[1];
  }
  // Rescale the output only when some row's max moved (warp-uniform).
  if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[mt][n][0] *= al[mt][0];
        acc[mt][n][1] *= al[mt][0];
        acc[mt][n][2] *= al[mt][1];
        acc[mt][n][3] *= al[mt][1];
      }
  }
  // O += P V: P rounded to bf16 from the S accumulators, V^T fragments
  // by a transposing ldmatrix.
#pragma unroll
  for (int kk = 0; kk < SN / 2; ++kk) {
    if (!kMasked || kk < pairs) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                 dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * dp], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * dp + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
}

template <int D, bool kCapped>
__global__ void __launch_bounds__(kThreads)
    mixed_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ row_of,
                    const int32_t* __restrict__ positions, bf16* __restrict__ out,
                    int n_tiles, int H, int Hkv, int ps, int pmax, int qt, int run,
                    float scale, int window, float softcap) {
  constexpr int LD = D + 8;  // smem row stride (bf16): 16-byte pad
  constexpr int NT = D / 8;  // output n-tiles
  constexpr int WR = 16 * kMT;  // rows a warp owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int pos_s[kMaxRunQ];
  __shared__ int n_run_s;

  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qpk = H / Hkv;
  const int fused = Hkv * D;
  const int ps_log2 = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
  const int t0 = tile * qt;  // first token of the run
  const int row = row_of[t0];

  // Only a run's first tile does work (block-uniform branch).
  if (tile % run != 0 && row_of[t0 - qt] == row) return;
  if (warp == 0) {  // the run: tiles of this row up to the next multiple of `run`
    const int limit = min(n_tiles, (tile / run + 1) * run);
    const bool same = tile + lane < limit && row_of[(tile + lane) * qt] == row;
    const unsigned more = ~__ballot_sync(0xffffffffu, same);
    if (lane == 0) n_run_s = more ? __ffs(more) - 1 : 32;
  }
  __syncthreads();
  const int nq = n_run_s * qt;  // queries of the run
  const int rows = nq * qpk;    // (query, group) rows
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kMaxRows][LD]
  bf16* kv_s = q_s + kMaxRows * LD;               // [kStages][K|V][kChunk][LD]

  for (int i = tid; i < nq; i += kThreads) pos_s[i] = positions[t0 + i];
  // Query rows: row r = i * qpk + g is q[t0 + i, kvh * qpk + g, :], so
  // the rows of query i are qpk * D contiguous values.
  for (int e = tid; e < kMaxRows * (D / 8); e += kThreads) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    const bool ok = r < rows;
    const size_t off =
        ok ? ((size_t)(t0 + r / qpk) * H + kvh * qpk + r % qpk) * D + c : 0;
    dx::cp_async16(q_s + r * LD + c, q + off, ok ? 16 : 0);
  }
  __syncthreads();

  int kvlen = 0;       // the run's causal horizon: max position + 1
  int pmin = 1 << 30;  // its earliest live position
  for (int i = 0; i < nq; ++i) {
    kvlen = max(kvlen, pos_s[i] + 1);
    if (pos_s[i] >= 0) pmin = min(pmin, pos_s[i]);
  }
  kvlen = min(kvlen, pmax * ps);  // kv past the page table does not exist
  // The run's earliest visible key: its walk starts at that key's chunk.
  const int ch0 = kvlen > 0 ? max(0, pmin - window + 1) / kChunk : 0;

  // This thread's rows (two per m-tile) and the first key each sees;
  // the warp's horizon (tokens any of its rows attends) and full span
  // (tokens all of its rows attend: 0 if it holds a padding row), and
  // its window's starts: the first key any live row sees (wlo) and the
  // first key every row sees (wlo_all).
  const int g = lane >> 2, tig = lane & 3;
  int qpos[kMT][2], qlo[kMT][2];
  int wmax = -1, wmin = 1 << 30, wlo = 1 << 30, wlo_all = -(1 << 30);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * WR + mt * 16 + g + 8 * h;
      qpos[mt][h] = r < rows ? pos_s[r / qpk] : -1;
      qlo[mt][h] = qpos[mt][h] - window + 1;
      wmax = max(wmax, qpos[mt][h]);
      wmin = min(wmin, qpos[mt][h]);
      if (qpos[mt][h] >= 0) wlo = min(wlo, qlo[mt][h]);
      wlo_all = max(wlo_all, qlo[mt][h]);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, o));
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, o));
    wlo_all = max(wlo_all, __shfl_xor_sync(0xffffffffu, wlo_all, o));
  }
  const int whor = min(kvlen, wmax + 1);
  const int wfull = min(kvlen, wmin + 1);
  const dx::Scorer<kCapped> score(scale, softcap);

  float m[kMT][2], l[kMT][2], acc[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    m[mt][0] = m[mt][1] = -1e30f;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  }

  const int32_t* table_row = page_table + (size_t)row * pmax;
  const bf16* q_w = q_s + warp * WR * LD;
  // Chunks ch0 .. nchunks-1; chunk ch0 + i lives in ring slot i % kStages.
  const int nch = (kvlen + kChunk - 1) / kChunk - ch0;
  // A ring of kStages chunk buffers: chunks c+1 .. c+kStages-1 load
  // while chunk c is computed. The first group also holds q.
  dx::KvStager<bf16, D, kChunk, kThreads, LD> stager;
  if (nch > 0) stager.lookup(table_row, ch0 * kChunk, kvlen, ps, ps_log2, pmax);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nch) {
      bf16* nb = kv_s + st * 2 * kChunk * LD;
      stager.issue(k, v, ps, ps_log2, fused, kvh, nb, nb + kChunk * LD);
      if (st + 1 < nch)
        stager.lookup(table_row, (ch0 + st + 1) * kChunk, kvlen, ps, ps_log2, pmax);
    }
    dx::cp_async_commit();
  }

  for (int i = 0; i < nch; ++i) {
    const int c0 = (ch0 + i) * kChunk;
    const int nx = i + kStages - 1;
    if (nx < nch) {
      bf16* nb = kv_s + (nx % kStages) * 2 * kChunk * LD;
      stager.issue(k, v, ps, ps_log2, fused, kvh, nb, nb + kChunk * LD);
      if (nx + 1 < nch)
        stager.lookup(table_row, (ch0 + nx + 1) * kChunk, kvlen, ps, ps_log2, pmax);
    }
    dx::cp_async_commit();
    dx::cp_async_wait<kStages - 1>();  // this chunk (and q) landed
    __syncthreads();

    const bf16* k_s = kv_s + (i % kStages) * 2 * kChunk * LD;
    const bf16* v_s = k_s + kChunk * LD;
#pragma unroll
    for (int sub = 0; sub < kChunk / kSub; ++sub) {
      // Warp-uniform: tokens past the warp's rows, or before their
      // windows, are skipped.
      const int c = c0 + sub * kSub;
      const bf16* ksub = k_s + sub * kSub * LD;
      const bf16* vsub = v_s + sub * kSub * LD;
      if (c >= wlo_all && c + kSub <= wfull)
        warp_step<D, false>(q_w, ksub, vsub, c, whor, kvlen, qpos, qlo, score, m, l, acc);
      else if (c < whor && c + kSub > wlo)
        warp_step<D, true>(q_w, ksub, vsub, c, whor, kvlen, qpos, qlo, score, m, l, acc);
    }
    __syncthreads();  // every warp is done with this buffer
  }
  dx::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[mt][h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.f / (lt == 0.f ? 1.f : lt);
      const int r = warp * WR + mt * 16 + g + 8 * h;
      if (r < rows) {
        bf16* o = out + ((size_t)(t0 + r / qpk) * H + kvh * qpk + r % qpk) * D + tig * 2;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<__nv_bfloat162*>(o + n * 8) =
              __floats2bfloat162_rn(acc[mt][n][2 * h] * inv, acc[mt][n][2 * h + 1] * inv);
      }
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* page_table,
                   const void* row_of, const void* positions, void* out, int n_tiles,
                   int H, int Hkv, int ps, int pmax, int qt, int run, float scale,
                   int window, float softcap, cudaStream_t stream) {
  // D = 256: 67,584 B of q rows and a 135,168 B ring, within 227 KB.
  const size_t smem = (size_t)(kMaxRows + 2 * kStages * kChunk) * (D + 8) * sizeof(bf16);
  auto kern = softcap > 0.f ? mixed_tc_kernel<D, true> : mixed_tc_kernel<D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_tiles, Hkv), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(row_of), static_cast<const int32_t*>(positions),
      static_cast<bf16*>(out), n_tiles, H, Hkv, ps, pmax, qt, run, scale, window, softcap);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
// Shapes are checked by the Python wrapper; this re-checks only what
// would index out of the kernel's fixed arrays. `run` (q tiles a block
// may take) is the largest that keeps a block within 128 query rows.
// `window` >= 1 (1 << 30: none); `softcap` 0: none.
extern "C" int dx_ragged_mixed_tc(const void* q, const void* k, const void* v,
                                  const void* page_table, const void* row_of,
                                  const void* positions, void* out, int n_tokens, int H,
                                  int Hkv, int D, int ps, int pmax, int q_tile, float scale,
                                  int window, float softcap, void* stream) {
  if (q_tile < 1 || q_tile > kMaxQTile || n_tokens % q_tile != 0 || Hkv < 1 ||
      H % Hkv != 0 || (H / Hkv) * q_tile > kMaxRows || window < 1 || softcap < 0.f ||
      (D != 64 && D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  if (n_tokens == 0) return 0;
  const int run = max(1, min(kMaxRun, kMaxRows / ((H / Hkv) * q_tile)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_tokens / q_tile;
#define DX_LAUNCH(DIM)                                                                   \
  return (int)launch<DIM>(q, k, v, page_table, row_of, positions, out, n_tiles, H, Hkv, ps, \
                          pmax, q_tile, run, scale, window, softcap, s)
  if (D == 64) DX_LAUNCH(64);
  if (D == 128) DX_LAUNCH(128);
  DX_LAUNCH(256);
#undef DX_LAUNCH
}
