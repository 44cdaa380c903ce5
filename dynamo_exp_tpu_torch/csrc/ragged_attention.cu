// Ragged paged attention, mixed prefill + decode shape, float32 pools,
// on Hopper's tensor cores in 3xTF32 (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_ragged_kernel`
// (dynamo_exp_tpu/ops/ragged_attention.py:123, launched at :345) for
// `ragged_paged_attention` with float32 pools, and computes what it
// computes: causal GQA attention of a flat query stream q[N, H, D]
// against a paged KV pool [P, ps, Hkv*D]. A token at position p attends
// to its row's kv positions <= p; online softmax with float32
// accumulators. Tiles of q_tile tokens each belong to one row; a tile
// whose positions are all -1 writes exact zeros, and so does every
// padding slot (position -1) inside a live tile. bf16 pools go to
// ragged_mixed_tc.cu and the decode shape to ragged_decode_split.cu.
//
// Numerics. Float32 pools are where the port is held to exact tokens,
// at atol 1e-4 against the plain version; one-term TF32 (10-bit
// mantissas) misses that by about 10x. So every product runs as
// 3xTF32: x = hi + lo with hi = tf32(x) (cvt.rna) and lo = x - hi
// (exact in float32; the tensor core reads its top 19 bits), and
// a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi with float32 accumulators.
// The dropped a_lo.b_lo and the truncation of lo are about 2^-21 of a
// product. The unnormalised probabilities go from the QK accumulators
// into PV unrounded (the pool dtype is float32), split the same way;
// the softmax sum is taken from the same values.
//
// Batch invariance, a hard rule: a query row's output depends only on
// its q, its position, its row's page table and the pool, never on the
// other rows of the dispatch, its tile's place in the stream or the run
// it falls in (float32 token identity between a pressured batch and
// requests run alone rests on it). Every product is per row (mma.sync
// computes each output element from its own row of A); chunks and
// softmax steps sit at absolute kv positions (every block walks its
// row from position 0), and which of a row's two states takes a step
// is fixed by the step's position; a step in which a row has no live
// token is an exact no-op for it (probabilities 0, the rescale factor
// exactly 1), so a warp may skip the steps past its rows' horizon.
//
// What bounds it on this card: the operations. At the main path's
// mixed shape (llama-8b, prefill chunks of 512 next to decode rows) QK
// and PV are about 24 GFLOP against about 114 MB of q, K/V and output;
// at 3xTF32 the tensor cores give 494.7 / 3 = 164.9 TFLOP/s of such
// products, 2.5x float32 outside them (67 TFLOP/s). The previous design
// ran on CUDA cores, where two shared-memory loads fed each FMA, staged
// K/V behind two barriers a chunk and had every q tile re-read its
// row's context. This design:
// - runs QK and PV with mma.sync m16n8k8 tf32 (three products per
//   fragment pair). The k order inside each 8-wide step is permuted
//   (slot t <-> element 2t, slot t+4 <-> 2t+1) so that QK's
//   accumulators are PV's A fragments in registers as they stand, and
//   q and K fragments are 8-byte shared loads. QK keeps its three
//   terms in three accumulators, three independent chains of products;
//   the online softmax runs in the log2 domain (scores scaled by
//   scale * log2(e), exp2);
// - has two warps share each 16-row m-tile of query rows (8 warps, 64
//   rows a block): one takes the even 32-token softmax steps of the
//   row, the other the odd ones, each with its own online-softmax state,
//   and the two states are combined at the end, in a fixed order,
//   through shared memory. A block's walk of a long context is half as
//   long: verify spans and lone decode rows, where one or two m-tiles
//   of a block hold live rows, are bound by that walk's latency;
// - stages K/V as float32 with 16-byte cp.async (dx::KvStager) into a
//   ring of kStages chunks of kChunk tokens, one barrier a chunk, the
//   page-table lookup one chunk ahead of its copies. Rows are padded so
//   fragment loads hit distinct banks: q and K by 8 floats (8-byte
//   loads, rows g and t vary), V by 4 (4-byte loads, rows 2t and 2t+1);
// - lets one block take a run of up to `run` consecutive q tiles of one
//   row (64 query rows: 2 tiles of 8 tokens x 4 q heads per kv head
//   for llama-8b), the rule of ragged_mixed_tc.cu: a tile leads a run if
//   its index is a multiple of `run` or its row differs from the
//   previous tile's; other tiles' blocks exit at once. Each staged chunk
//   serves all of the run's query rows, up to the run's horizon;
// - launches blocks in reverse stream order, the kv heads of a tile
//   together, so the last tiles of a row, which walk the longest
//   context, start first and the tail of the grid is short blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3; bound with
// ctypes (plain C interface below).

#include "common.cuh"

namespace {

// Warps an m-tile, chunk and ring depth: chosen with
// tools/torch_kernel_probe.py's float32 sweep on an H100 (PERF.md
// section 6). One warp an m-tile (128 rows a block) ran prefill-only
// batches a few percent faster and verify spans half again slower; a
// third 64-token stage does not fit in a block's shared memory.
constexpr int kSplit = 2;      // warps per 16-row m-tile, each on every kSplit-th step
constexpr int kChunk = 64;     // kv tokens per staged chunk
constexpr int kStages = 2;     // chunks in the ring
constexpr int kSub = 32;       // kv tokens per softmax step
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTiles = kWarps / kSplit;  // 16-row m-tiles of a block
constexpr int kMaxRows = 16 * kMTiles;    // query rows a block takes at most
static_assert(kChunk % (kSub * kSplit) == 0, "a chunk holds whole rounds of steps");
constexpr int kMaxRun = 8;  // q tiles per block at most
constexpr int kMaxQTile = 8;
constexpr int kMaxRunQ = kMaxRun * kMaxQTile;

// Shared-memory row strides in floats (see the header: bank-free
// fragment loads) and the floats of one ring stage.
template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;
  static constexpr int LDK = D + 8;
  static constexpr int LDV = D + 4;
  static constexpr int STAGE = kChunk * (LDK + LDV);
  static constexpr size_t kSmemBytes = (size_t)(kMaxRows * LDQ + kStages * STAGE) * 4;
  // After the walk the ring holds the other parts' states for the
  // combine: per m-tile and lane, the accumulators, max and sum.
  static constexpr int XS = D / 2 + 4;
  static_assert((kSplit - 1) * kMTiles * XS * 32 <= kStages * STAGE, "combine space");
};
static_assert(Layout<128>::kSmemBytes <= 232448 - 1024, "ring too deep for one block");

// The two tf32 halves of x: hi rounded to nearest (ties away), lo the
// float32 remainder.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// c += a (16x8 tf32, row) * b (8x8 tf32, col), float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 into one accumulator: c += a_lo b_hi + a_hi b_lo + a_hi b_hi
// (small terms first).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// 3xTF32 into three accumulators (big: a_hi b_hi; sa: a_lo b_hi; sb:
// a_hi b_lo), three independent chains of products.
__device__ __forceinline__ void mma_3xtf32_apart(float (&big)[4], float (&sa)[4],
                                                 float (&sb)[4], const uint32_t (&ah)[4],
                                                 const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(sa, al, bh0, bh1);
  mma_tf32(sb, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

// Split one A fragment, given in slot order (row g, slot t), (g+8, t),
// (g, t+4), (g+8, t+4).
__device__ __forceinline__ void split_a(float x0, float x1, float x2, float x3,
                                        uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split_tf32(x0, ah[0], al[0]);
  split_tf32(x1, ah[1], al[1]);
  split_tf32(x2, ah[2], al[2]);
  split_tf32(x3, ah[3], al[3]);
}

// One warp's share of kSub staged kv tokens: S = Q K^T for its 16 rows,
// the online softmax and O += P V. kMasked: the tokens cross a row's
// causal bound, the run's kv bound or the warp holds a padding row, so
// scores are masked and the 8-token n-tiles past the warp's horizon
// `whor` are skipped; otherwise every score is live. Thread state is
// indexed by h: 0 for row g of the m-tile, 1 for row g + 8.
template <int D, bool kMasked>
__device__ __forceinline__ void warp_step(const float* q_w, const float* k_s,
                                          const float* v_s, int c0, int whor, int kvlen,
                                          const int (&qpos)[2], float sl2, float (&m)[2],
                                          float (&l)[2], float (&acc)[D / 8][4]) {
  using L = Layout<D>;
  constexpr int NT = D / 8;    // output n-tiles
  constexpr int KS = D / 8;    // k-steps of QK
  constexpr int SN = kSub / 8;  // score n-tiles
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int nn = kMasked ? min(SN, (whor - c0 + 7) / 8) : SN;
  // S = Q K^T, its three terms in accumulators of their own (the
  // k-steps of one accumulator are a chain of dependent products), added
  // at the end. Slot t of a k-step is dim 2t, slot t+4 dim 2t+1, so a
  // thread's two A values of a row, and its two B values, are adjacent.
  float s[SN][4], sa[SN][4], sb[SN][4];
#pragma unroll
  for (int n = 0; n < SN; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[n][j] = sa[n][j] = sb[n][j] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < KS; ++ks) {
    const float2 qa = *reinterpret_cast<const float2*>(q_w + g * L::LDQ + ks * 8 + 2 * tig);
    const float2 qb =
        *reinterpret_cast<const float2*>(q_w + (g + 8) * L::LDQ + ks * 8 + 2 * tig);
    uint32_t ah[4], al[4];
    split_a(qa.x, qb.x, qa.y, qb.y, ah, al);
#pragma unroll
    for (int n = 0; n < SN; ++n) {
      if (!kMasked || n < nn) {
        const float2 kb =
            *reinterpret_cast<const float2*>(k_s + (n * 8 + g) * L::LDK + ks * 8 + 2 * tig);
        mma_3xtf32_apart(s[n], sa[n], sb[n], ah, al, kb.x, kb.y);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < SN; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[n][j] += sa[n][j] + sb[n][j];
  // Online softmax; a row's 4 threads (one quad) share its max. Score
  // s[n][j] is token c0 + n * 8 + 2 * tig + (j & 1) of row h = j >> 1.
  float alpha[2];
  bool moved = false;
  {
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kMasked) {
          const int tok = c0 + n * 8 + tig * 2 + (j & 1);
          const bool live = tok < kvlen && tok <= qpos[j >> 1];
          s[n][j] = live ? s[n][j] * sl2 : -1e30f;
        } else {
          s[n][j] *= sl2;
        }
        mx[j >> 1] = fmaxf(mx[j >> 1], s[n][j]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o));
      const float mn = fmaxf(m[h], mx[h]);
      // Exactly 1 when the max stays: a step with no live token of a
      // row leaves its state bit for bit.
      alpha[h] = mn == m[h] ? 1.f : dx::fast_exp2(m[h] - mn);
      moved |= mn != m[h];
      m[h] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = dx::fast_exp2(s[n][j] - m[j >> 1]);
        s[n][j] = kMasked && s[n][j] <= -1e29f ? 0.f : p;
        sum[j >> 1] += s[n][j];
      }
    }
    // Per-thread partial sums; quad-reduced at the end.
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
  }
  // Rescale the output only when some row's max moved (warp-uniform).
  if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
  }
  // O += P V. Slot t of n-tile kk is token 2t, slot t+4 token 2t+1: the
  // S accumulators of the n-tile are the A fragment, and V's B values
  // are rows kk * 8 + 2t and 2t + 1 at dim n * 8 + g.
#pragma unroll
  for (int kk = 0; kk < SN; ++kk) {
    if (!kMasked || kk < nn) {
      uint32_t ah[4], al[4];
      split_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3], ah, al);
      const float* vr = v_s + (kk * 8 + 2 * tig) * L::LDV + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_3xtf32(acc[n], ah, al, vr[n * 8], vr[L::LDV + n * 8]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    ragged_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int32_t* __restrict__ page_table,
                            const int32_t* __restrict__ row_of,
                            const int32_t* __restrict__ positions, float* __restrict__ out,
                            int n_tiles, int H, int Hkv, int ps, int pmax, int qt, int run,
                            float scale) {
  using L = Layout<D>;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) float smem[];
  __shared__ int pos_s[kMaxRunQ];
  __shared__ int n_run_s;

  // Reverse stream order, the kv heads of a tile together.
  const int tile = n_tiles - 1 - (int)(blockIdx.x / Hkv);
  const int kvh = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mt = warp % kMTiles;    // this warp's m-tile
  const int part = warp / kMTiles;  // its steps: part, part + kSplit, ...
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
  float* q_s = smem;                       // [kMaxRows][LDQ]
  float* kv_s = q_s + kMaxRows * L::LDQ;  // [kStages][K [kChunk][LDK] | V [kChunk][LDV]]

  for (int i = tid; i < nq; i += kThreads) pos_s[i] = positions[t0 + i];
  // Query rows: row r = i * qpk + g is q[t0 + i, kvh * qpk + g, :], so
  // the rows of query i are qpk * D contiguous values.
  for (int e = tid; e < kMaxRows * (D / 4); e += kThreads) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const bool ok = r < rows;
    const size_t off = ok ? ((size_t)(t0 + r / qpk) * H + kvh * qpk + r % qpk) * D + c : 0;
    dx::cp_async16(q_s + r * L::LDQ + c, q + off, ok ? 16 : 0);
  }
  __syncthreads();

  int kvlen = 0;  // the run's causal horizon: max position + 1
  for (int i = 0; i < nq; ++i) kvlen = max(kvlen, pos_s[i] + 1);
  kvlen = min(kvlen, pmax * ps);  // kv past the page table does not exist

  // This thread's two rows; the warp's horizon (tokens any of its rows
  // attends) and full span (tokens all of its rows attend: 0 if it
  // holds a padding row).
  const int g = lane >> 2, tig = lane & 3;
  int qpos[2];
  int wmax = -1, wmin = 1 << 30;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = mt * 16 + g + 8 * h;
    qpos[h] = r < rows ? pos_s[r / qpk] : -1;
    wmax = max(wmax, qpos[h]);
    wmin = min(wmin, qpos[h]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, o));
  }
  const int whor = min(kvlen, wmax + 1);
  const int wfull = min(kvlen, wmin + 1);
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int32_t* table_row = page_table + (size_t)row * pmax;
  const float* q_w = q_s + mt * 16 * L::LDQ;
  const int nchunks = (kvlen + kChunk - 1) / kChunk;
  // A ring of kStages chunk buffers: chunks c+1 .. c+kStages-1 load
  // while chunk c is computed. The first group also holds q.
  dx::KvStager<float, D, kChunk, kThreads, L::LDK, L::LDV> stager;
  if (nchunks > 0) stager.lookup(table_row, 0, kvlen, ps, ps_log2, pmax);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nchunks) {
      float* nb = kv_s + st * L::STAGE;
      stager.issue(k, v, ps, ps_log2, fused, kvh, nb, nb + kChunk * L::LDK);
      if (st + 1 < nchunks)
        stager.lookup(table_row, (st + 1) * kChunk, kvlen, ps, ps_log2, pmax);
    }
    dx::cp_async_commit();
  }

  for (int ch = 0; ch < nchunks; ++ch) {
    dx::cp_async_wait<kStages - 2>();  // this chunk (and q) landed
    // Every thread's copies of this chunk are visible, and every warp
    // is done with the buffer the next copies overwrite.
    __syncthreads();
    const int nx = ch + kStages - 1;
    if (nx < nchunks) {
      float* nb = kv_s + (nx % kStages) * L::STAGE;
      stager.issue(k, v, ps, ps_log2, fused, kvh, nb, nb + kChunk * L::LDK);
      if (nx + 1 < nchunks)
        stager.lookup(table_row, (nx + 1) * kChunk, kvlen, ps, ps_log2, pmax);
    }
    dx::cp_async_commit();

    const int c0 = ch * kChunk;
    const float* k_s = kv_s + (ch % kStages) * L::STAGE;
    const float* v_s = k_s + kChunk * L::LDK;
#pragma unroll
    for (int sub = part; sub < kChunk / kSub; sub += kSplit) {
      // Warp-uniform: tokens past the warp's rows are skipped.
      const int c = c0 + sub * kSub;
      const float* ksub = k_s + sub * kSub * L::LDK;
      const float* vsub = v_s + sub * kSub * L::LDV;
      if (c + kSub <= wfull)
        warp_step<D, false>(q_w, ksub, vsub, c, whor, kvlen, qpos, sl2, m, l, acc);
      else if (c < whor)
        warp_step<D, true>(q_w, ksub, vsub, c, whor, kvlen, qpos, sl2, m, l, acc);
    }
  }
  dx::cp_async_wait<0>();

  // The parts of an m-tile combine in a fixed order: part 0 takes the
  // states of parts 1, 2, ... through the ring's memory.
  if (kSplit > 1) {
    __syncthreads();  // every warp is done with the ring
    if (part > 0) {
      float* x = kv_s + ((part - 1) * kMTiles + mt) * L::XS * 32 + lane;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[(n * 4 + j) * 32] = acc[n][j];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        x[(NT * 4 + h) * 32] = m[h];
        x[(NT * 4 + 2 + h) * 32] = l[h];
      }
    }
    __syncthreads();
    if (part > 0) return;
#pragma unroll
    for (int p = 1; p < kSplit; ++p) {
      const float* x = kv_s + ((p - 1) * kMTiles + mt) * L::XS * 32 + lane;
      float a[2], b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m2 = x[(NT * 4 + h) * 32];
        const float mn = fmaxf(m[h], m2);
        // Exactly 1 for the larger max: a part with no live token of a
        // row leaves the other's state bit for bit.
        a[h] = m[h] == mn ? 1.f : dx::fast_exp2(m[h] - mn);
        b[h] = m2 == mn ? 1.f : dx::fast_exp2(m2 - mn);
        l[h] = l[h] * a[h] + x[(NT * 4 + 2 + h) * 32] * b[h];
        m[h] = mn;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[n][j] = acc[n][j] * a[j >> 1] + x[(n * 4 + j) * 32] * b[j >> 1];
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / (lt == 0.f ? 1.f : lt);
    const int r = mt * 16 + g + 8 * h;
    if (r < rows) {
      float* o = out + ((size_t)(t0 + r / qpk) * H + kvh * qpk + r % qpk) * D + tig * 2;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(o + n * 8) =
            make_float2(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* page_table,
                   const void* row_of, const void* positions, void* out, int n_tiles,
                   int H, int Hkv, int ps, int pmax, int qt, int run, float scale,
                   cudaStream_t stream) {
  const size_t smem = Layout<D>::kSmemBytes;
  auto kern = ragged_attention_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<n_tiles * Hkv, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(row_of), static_cast<const int32_t*>(positions),
      static_cast<float*>(out), n_tiles, H, Hkv, ps, pmax, qt, run, scale);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
// Float32 pools only. Shapes are checked by the Python wrapper; this
// re-checks only what would index out of the kernel's fixed arrays.
// `run` (q tiles a block may take) is the largest that keeps a block
// within kMaxRows query rows.
extern "C" int dx_ragged_attention(const void* q, const void* k, const void* v,
                                   const void* page_table, const void* row_of,
                                   const void* positions, void* out, int n_tokens, int H,
                                   int Hkv, int D, int ps, int pmax, int q_tile, float scale,
                                   void* stream) {
  if (q_tile < 1 || q_tile > kMaxQTile || n_tokens % q_tile != 0 || Hkv < 1 ||
      H % Hkv != 0 || (H / Hkv) * q_tile > kMaxRows || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (n_tokens == 0) return 0;
  const int run = max(1, min(kMaxRun, kMaxRows / ((H / Hkv) * q_tile)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_tokens / q_tile;
  return (int)(D == 64 ? launch<64>(q, k, v, page_table, row_of, positions, out, n_tiles,
                                    H, Hkv, ps, pmax, q_tile, run, scale, s)
                       : launch<128>(q, k, v, page_table, row_of, positions, out,
                                     n_tiles, H, Hkv, ps, pmax, q_tile, run, scale, s));
}
