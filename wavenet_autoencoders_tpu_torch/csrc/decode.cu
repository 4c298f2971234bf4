// Fused WaveNet AR decode for Hopper (sm_90a): the whole sampling loop over
// T steps in one cooperative kernel launch.
//
// Replaces the TPU kernel wavenet_decode_pallas
// (wavenet_autoencoders_tpu/kernels/decode.py:352, body _mk_kernel at :81),
// which runs grid=(T,) steps in order on one core with every layer weight
// loaded to VMEM once and kept resident across all T steps.
//
// Per step and batch row the network is a chain of small products:
//   gate_l  : ab = [tap0 | tap1 | h | c_t] @ [wconv_l ; wc_l] + bconv + g_add,
//             act_l = tanh(ab[:G/2]) * sigmoid(ab[G/2:])
//   out_l   : the ring slot t mod 2d receives h_in,
//             h = (act_l @ wout + bout + h_in) * sqrt(1/2)
//   skip_l  : skip += act_l @ wskip + bskip
//   post1   : y1 = relu(relu(skip * sqrt(1/L)) @ wp1 + bp1)
//   logits  : logits = y1 @ wp2 + bp2
//   sample  : in-kernel sampling per row, and the next step's input row
// What bounds it. Per row and step the network does ~8.1 M multiply-adds at
// svqwae width (20 x (3*256*368 + 64*368 + 2*184*256) plus the head): at
// B=256, T=5120 that is ~21 TFLOP, ~22 ms at the 989 TFLOP/s bf16
// tensor-core peak, while the bytes that must move (inputs once, logits
// once) take well under 1 ms. So the bound is operations. What bounds a
// design in practice is the chain: 2L+3 dependent stages a step, each a
// small (B x K) @ (K x N) product, at B=4 only a few hundred kFLOP.
//
// bf16 storage (the main path; decode_tc_kernel). The TPU kernel's VMEM
// residency is carried over onto the grid: the ~16 MB of bf16 weights at
// svqwae width fit the 132 SMs' shared memory (~124 KB a block). The
// wrapper (kernels/decode.py:block_plan) cuts every product into tiles of 16
// output columns, gives each tile to one block and the tiles of one stage to
// different blocks, and packs each block's share once per call in the order
// its mma fragments are read; a block copies its share into shared memory
// with cp.async before step 0 and keeps it for all T steps. A tile's product
// runs on the tensor cores transposed, out^T = W^T X^T (mma.sync m16n8k16
// bf16 -> f32): the 16 weight columns fill the fragment's m and the batch
// rows its n = 8, so B <= 8 pads only to 8. A lane reads its weight
// fragment from shared memory as one 16-byte load, and its input fragments
// straight from L2 as one 16-byte load per 8 rows x 32 k (the packing
// permutes k within each 32 so that a lane's 8 inputs are contiguous). The
// 8 warps split the batch rows, and the k range where there are few rows;
// their partial sums meet in shared memory and are added in a fixed order.
// Gate columns are packed so that rows i and i + 8 of a fragment are the
// pair (a_i, b_i): the gate is applied where ab is produced. Every K segment
// (taps, c, h) is zero-padded to 32 in the packing, so any width is taken.
// The gate's taps and c are ready before this step's h: their products run
// before the block waits for h, so a layer's critical chain holds the h
// product (K = C) and the out product (K = G/2), not K = 3C + cin.
//
// Stages are ordered by monotonic arrival counters, not grid barriers: a
// block that produced a stage's tile adds one to that stage's counter with
// release semantics after its stores; a consumer spins with acquire loads
// until the counter reaches (producers of the stage) x (steps done). Blocks
// with no tile in a stage neither arrive nor wait. The skip columns hang off
// the chain: one block owns a skip column tile in every layer (its f32 sum
// stays with it), waits only on gate_l and runs beside gate_{l+1}. Hazards,
// each covered by a wait or by a chain of waits (stage(t) = at step t):
//   ring slot: out_l(t) writes slot t mod 2d after waiting for every gate_l(t)
//     tile (tap0 of step t; tap1 of step t - d came earlier on the chain);
//     gate_l(t) waits for out_l(t-1), so every earlier ring write is seen.
//   h, hb: gate_{l+1}(t) waits for out_l(t); out_{l+1}(t) waits for
//     gate_{l+1}(t); sample(t) rewrites h after out_{L-1}(t).
//   act_l (one buffer per layer): gate_l(t+1) waits for out_l(t), and comes
//     after skip_l(t) on the chain (sample(t) <- logits <- post1 <- skip).
// Each block runs its tiles in chain order and every wait is on an earlier
// (step, stage), so no wait can close a cycle; the cooperative launch keeps
// every block resident.
//
// Two builds for checks and measurements only (compiled with -D into
// libraries of their own; the port loads the plain build):
//   WAE_JITTER: a block that passes a wait sleeps ~4 us one time in 8
//     (a hash of block, counter and target), so a stage's producers arrive
//     late and out of order. A wait short of its stage then lets the
//     consumer read data not yet written, and the logits differ from the
//     plain build's; since every sum is added in a fixed order, a sound
//     kernel gives the same bits (chip_smoke phase 1 holds them equal).
//   WAE_STAMPS: thread 0 of each block records %globaltimer when it starts
//     to wait, when its waits pass and when it has released its arrival,
//     for every tile of steps STAMP_T0 .. STAMP_T0 + 3; wae_stamps copies
//     them out (k1_stages.py reads the per-stage split from them).
//
// f32 storage (the accuracy check, not the main path: its 32.8 MB of weights
// do not fit the grid's shared memory; decode_f32_kernel). One block per SM
// and a grid-wide barrier between stages; each block works on 2-D output
// tiles (up to 16 batch rows x 64 columns) with the weights streaming from L2
// and the 8 warps splitting the k range; products on CUDA cores.
//
// Rings live in one device-memory arena (sum 2*d_l, B, C) allocated and
// zeroed by the wrapper. Sampling uses a counter-based Philox4x32-10 keyed
// by (seed, row, step, draw). Biases, g_add, h, the skip sums, the scalar
// path's first 1x1 and the logits are f32; accumulation is f32. The first
// input is mu-law code 127 (or 0.0 for scalar input); teacher mode feeds
// teach[:, t] instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAXL 64
#define NT 256           // threads per block
#define NW (NT / 32)     // warps per block
#define TM 16            // f32 path: batch rows per tile
#define XS (TM + 1)      // f32 path: padded row stride of the staged input tile
#define TN 64            // f32 path: output columns per tile: lane and lane + 32
#define RED_FLOATS 4096  // bf16 path: partial sums of one tile chunk (16 columns x 256 rows)
#define CSTRIDE 32       // bf16 path: counters 128 bytes apart

#ifdef WAE_STAMPS
#define STAMP_T0 64
#define STAMP_STEPS 4
#define STAMP_U 48  // per block and step: STAMP_U - 1 tiles, then the sample stage
__device__ unsigned long long g_stamp[256 * STAMP_STEPS * STAMP_U * 3];
__shared__ unsigned long long s_stamp[3];
__device__ __forceinline__ void stamp(int i) {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  s_stamp[i] = v;
}
__device__ __forceinline__ void stamp_save(int t, int slot) {
  if (threadIdx.x == 0 && t >= STAMP_T0 && t < STAMP_T0 + STAMP_STEPS)
    for (int i = 0; i < 3; ++i)
      g_stamp[((blockIdx.x * STAMP_STEPS + (t - STAMP_T0)) * STAMP_U + slot) * 3 + i] = s_stamp[i];
}
__device__ __forceinline__ void stamp_unit(int t, int i) {
  if (i < STAMP_U - 1) stamp_save(t, i);
}
__device__ __forceinline__ void stamp_sample(int t) { stamp_save(t, STAMP_U - 1); }
extern "C" int wae_stamps(unsigned long long* host, size_t n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamp, n * sizeof(unsigned long long));
}
#else
__device__ __forceinline__ void stamp(int) {}
__device__ __forceinline__ void stamp_unit(int, int) {}
__device__ __forceinline__ void stamp_sample(int) {}
#endif

#ifdef WAE_JITTER
__device__ __forceinline__ void jitter(int c, unsigned n) {
  unsigned h = blockIdx.x * 0x9E3779B1u ^ (unsigned)c * 0x85EBCA77u ^ n * 0xC2B2AE3Du;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  if ((h & 7) == 0) __nanosleep(4000);
}
#else
__device__ __forceinline__ void jitter(int, unsigned) {}
#endif

// Mirrored field for field (all 8-byte) by _DecodeArgs in kernels/decode.py.
// The weight pointers wconv .. wp2 and bar are read by the f32 path only
// (null on the bf16 path); the fields after `stream` by the bf16 path only.
struct DecodeArgs {
  int64_t B, T, L, C, G, S, O, CIN;
  int64_t store_bf16, scalar, teacher, normal, has_c, has_g, seed;
  int64_t dil[MAXL];
  int64_t ring_off[MAXL];
  const void* w1;
  const float* b1;
  const void* wconv;
  const float* bconv;
  const void* wc;
  const void* wout;
  const float* bout;
  const void* wskip;
  const float* bskip;
  const void* wp1;
  const float* bp1;
  const void* wp2;
  const float* bp2;
  const void* c_up;
  const float* g_add;
  const void* teach;
  void* ring;
  float* h;
  void* act;
  float* skip;
  void* y1;
  unsigned int* bar;
  void* codes;
  float* logits;
  void* stream;
  int64_t NB, NST, NGT, NOT, NPT, NLT, CP, G2P, SP, CINP, smem;
  const void* wbuf;
  const int* units;
  const int64_t* blk;
  void* hb;
  void* ys;
  unsigned int* cnt;
};

// ---- storage-type helpers -------------------------------------------------
// ldw: read-only data (weights, c_up); ldx: data other blocks write during
// the launch, read at L2 (.cg) so no stale L1 line is ever used.
__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float ldx(const float* p) { return __ldcg(p); }

// ---- grid-wide barrier (f32 path; all blocks resident: cooperative launch) --
// bar[0] counts arrivals, bar[1] is the generation. A block reads the
// generation before it arrives, so the last arrival's increment releases it.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* vgen = bar + 1;
    unsigned int gen = *vgen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*vgen == gen) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// ---- Philox4x32-10 --------------------------------------------------------
__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    unsigned int hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    unsigned int hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Uniform in [lo, 1 - lo) for draw `idx` of stream `stream` at (row, t).
__device__ __forceinline__ float uniform(int64_t seed, int row, int t, int idx, int stream, float lo) {
  uint4 r = philox(make_uint4((unsigned)(idx >> 2), (unsigned)row, (unsigned)t, (unsigned)stream),
                   make_uint2((unsigned)seed, (unsigned)(seed >> 32) ^ 0x5EEDu));
  unsigned int w = (idx & 3) == 0 ? r.x : (idx & 3) == 1 ? r.y : (idx & 3) == 2 ? r.z : r.w;
  float u = (float)(w >> 8) * (1.0f / 16777216.0f);
  return u * (1.0f - 2.0f * lo) + lo;
}

// ---- f32 path: products on CUDA cores --------------------------------------
// acc[r][j] += X[r, k] * W_j[k] for k in [k0, k1) and R rows; X is staged
// as Xs[k * XS + r], column j's weights are read at w_j + k * ld_j.
template <int R>
__device__ __forceinline__ void dot_rows(const float* Xs, int k0, int k1, const float* w0, int64_t ld0,
                                         const float* w1, int64_t ld1, float (&acc)[R][2]) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float wa = ldw(w0 + k * ld0), wb = ldw(w1 + k * ld1);
    const float* x = Xs + k * XS;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r][0] = fmaf(x[r], wa, acc[r][0]);
      acc[r][1] = fmaf(x[r], wb, acc[r][1]);
    }
  }
}

// The two weight columns of one lane: segment A (k < Ka) at a[j] + k * lda[j],
// segment B (Ka <= k < Ka + Kb) at b[j] + (k - Ka) * ldb.
struct Cols {
  const float* a[2];
  int64_t lda[2];
  const float* b[2];
  int64_t ldb;
};

// One output tile of R rows x (2 columns per lane): stage the input rows
// (load_x(row, k); zero past `rows`), split k over the warps so each warp
// keeps many independent loads in flight, add the warps' partial sums in
// shared memory, and call epi(row, lane, sum0, sum1) for the valid rows.
template <int R, typename LoadX, typename ColsOf, typename Epi>
__device__ void tile(int m0, int rows, int Ka, int Kb, float* Xs, float* red, LoadX load_x,
                     ColsOf cols_of, Epi epi) {
  const int K = Ka + Kb;
  for (int i = threadIdx.x; i < R * K; i += NT) {
    const int r = i / K, k = i - r * K;
    Xs[k * XS + r] = r < rows ? load_x(m0 + r, k) : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kw = (K + NW - 1) / NW, k0 = min(K, warp * kw), k1 = min(K, k0 + kw);
  float acc[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.0f;
  Cols c;
  if (cols_of(lane, c)) {
    if (k0 < Ka) dot_rows<R>(Xs, k0, min(k1, Ka), c.a[0], c.lda[0], c.a[1], c.lda[1], acc);
    if (k1 > Ka) dot_rows<R>(Xs + Ka * XS, max(k0, Ka) - Ka, k1 - Ka, c.b[0], c.ldb, c.b[1], c.ldb, acc);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* q = red + ((warp * R + r) * 32 + lane) * 2;
    q[0] = acc[r][0];
    q[1] = acc[r][1];
  }
  __syncthreads();
  for (int u = threadIdx.x; u < rows * 32; u += NT) {
    const int r = u >> 5, ln = u & 31;
    float s0 = 0.0f, s1 = 0.0f;
    for (int w = 0; w < NW; ++w) {
      const float* q = red + ((w * R + r) * 32 + ln) * 2;
      s0 += q[0];
      s1 += q[1];
    }
    epi(m0 + r, ln, s0, s1);
  }
  __syncthreads();
}

// Walk a stage's (row tile x column tile) grid over the blocks; a tile of
// at most 4 valid rows (small batches) takes the 4-row path.
// cols_of(ct, lane, Cols&) -> bool and epi(ct, row, lane, s0, s1) get the
// column-tile index ct.
template <typename LoadX, typename ColsOf, typename Epi>
__device__ void stage(int B, int n_ct, int Ka, int Kb, float* Xs, float* red, LoadX load_x, ColsOf cols_of,
                      Epi epi) {
  const int n_tiles = ((B + TM - 1) / TM) * n_ct;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int m0 = (t / n_ct) * TM, ct = t % n_ct, rows = min(TM, B - m0);
    auto cols = [&](int lane, Cols& c) { return cols_of(ct, lane, c); };
    auto out = [&](int b, int lane, float s0, float s1) { epi(ct, b, lane, s0, s1); };
    if (rows <= 4) tile<4>(m0, rows, Ka, Kb, Xs, red, load_x, cols, out);
    else tile<TM>(m0, rows, Ka, Kb, Xs, red, load_x, cols, out);
  }
}

// Input row of step t for batch row b: mu-law code row gather of W1 (a code
// outside [0, O), i.e. the start code 127 when O <= 127, is an all-zero
// one-hot), or the scalar sample times W1 (f32). The f32 path also clears
// the row's skip sum; the bf16 path writes the bf16 copy hb of h that the
// gate products read (row stride CP).
template <typename S>
__device__ void set_input(const DecodeArgs& a, int b, float x) {
  const int C = (int)a.C, code = (int)x;
  const bool row = code >= 0 && code < (int)a.O;
  for (int c = threadIdx.x; c < C; c += NT) {
    float w = a.scalar ? x * ((const float*)a.w1)[c]
                       : (row ? ldw((const S*)a.w1 + (int64_t)code * C + c) : 0.0f);
    const float h = w + a.b1[c];
    a.h[(int64_t)b * C + c] = h;
    if (a.hb) ((__nv_bfloat16*)a.hb)[(int64_t)b * a.CP + c] = __float2bfloat16(h);
  }
  if (!a.hb)
    for (int s = threadIdx.x; s < (int)a.S; s += NT) a.skip[(int64_t)b * a.S + s] = 0.0f;
}

__device__ __forceinline__ float teach_at(const DecodeArgs& a, int b, int t) {
  return a.scalar ? ((const float*)a.teach)[(int64_t)b * a.T + t]
                  : (float)((const int*)a.teach)[(int64_t)b * a.T + t];
}

// gate_l: ab over [tap0 | tap1 | h | c_t] and act = tanh(ab[p]) * sigmoid(ab[p + G/2]);
// lane = gate pair p, so both halves of a pair meet in one thread.
__device__ void stage_gate(const DecodeArgs& a, int t, int l, float* Xs, float* red) {
  const int B = (int)a.B, C = (int)a.C, G = (int)a.G, G2 = G / 2, CIN = a.has_c ? (int)a.CIN : 0;
  const int d = (int)a.dil[l], n = 2 * d;
  const int64_t BC = (int64_t)B * C;
  const float* tap0 = (const float*)a.ring + (a.ring_off[l] + t % n) * BC;
  const float* tap1 = (const float*)a.ring + (a.ring_off[l] + (t + d) % n) * BC;
  const float* wl = (const float*)a.wconv + (int64_t)l * 3 * C * G;
  const float* wcl = CIN ? (const float*)a.wc + (int64_t)l * CIN * G : wl;
  const float* bc = a.bconv + (int64_t)l * G;
  stage(
      B, (G2 + 31) / 32, 3 * C, CIN, Xs, red,
      [&](int b, int k) {
        if (k < C) return ldx(tap0 + (int64_t)b * C + k);
        if (k < 2 * C) return ldx(tap1 + (int64_t)b * C + (k - C));
        if (k < 3 * C) return ldx(a.h + (int64_t)b * C + (k - 2 * C));
        return ldw((const float*)a.c_up + ((int64_t)b * a.T + t) * CIN + (k - 3 * C));
      },
      [&](int ct, int lane, Cols& c) {
        const int p = ct * 32 + lane;
        c.a[0] = wl + p, c.a[1] = wl + p + G2, c.lda[0] = c.lda[1] = G;
        c.b[0] = wcl + p, c.b[1] = wcl + p + G2, c.ldb = G;
        return p < G2;
      },
      [&](int ct, int b, int lane, float sa, float sb) {
        const int p = ct * 32 + lane;
        if (p >= G2) return;
        float xa = sa + bc[p], xb = sb + bc[p + G2];
        if (a.has_g) {
          const float* ga = a.g_add + ((int64_t)l * B + b) * G;
          xa += ga[p];
          xb += ga[p + G2];
        }
        ((float*)a.act)[(int64_t)b * G2 + p] = tanhf(xa) * (1.0f / (1.0f + expf(-xb)));
      });
}

// Columns n = ct * TN + lane + 32 j (j = 0, 1) of a single weight matrix w
// (K x N, row stride N) for the out, post1 and logits stages.
__device__ __forceinline__ bool plain_cols(const float* w, int N, int ct, int lane, Cols& c) {
  const int n0 = ct * TN + lane, n1 = n0 + 32 < N ? n0 + 32 : n0;
  c.a[0] = w + n0, c.a[1] = w + n1, c.lda[0] = c.lda[1] = N;
  c.b[0] = c.b[1] = w, c.ldb = N;
  return n0 < N;
}

// out_l over the C residual columns followed by the S skip columns.
__device__ void stage_out(const DecodeArgs& a, int t, int l, float* Xs, float* red) {
  const int B = (int)a.B, C = (int)a.C, G2 = (int)a.G / 2, SK = (int)a.S, N = C + SK;
  float* slot = (float*)a.ring + (a.ring_off[l] + t % (2 * a.dil[l])) * (int64_t)B * C;
  const float* act = (const float*)a.act;
  const float* wout = (const float*)a.wout + (int64_t)l * G2 * C;
  const float* wskip = (const float*)a.wskip + (int64_t)l * G2 * SK;
  const float* bout = a.bout + (int64_t)l * C;
  const float* bskip = a.bskip + (int64_t)l * SK;
  auto col = [&](int n, const float** w, int64_t* ld) {
    if (n < C) *w = wout + n, *ld = C;
    else *w = wskip + (n - C), *ld = SK;
  };
  stage(
      B, (N + TN - 1) / TN, G2, 0, Xs, red,
      [&](int b, int k) { return ldx(act + (int64_t)b * G2 + k); },
      [&](int ct, int lane, Cols& c) {
        const int n0 = ct * TN + lane, n1 = n0 + 32 < N ? n0 + 32 : n0;
        if (n0 >= N) return false;
        col(n0, &c.a[0], &c.lda[0]);
        col(n1, &c.a[1], &c.lda[1]);
        c.b[0] = c.b[1] = c.a[0], c.ldb = 0;
        return true;
      },
      [&](int ct, int b, int lane, float s0, float s1) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = ct * TN + lane + 32 * j;
          if (n >= N) continue;
          const float acc = j ? s1 : s0;
          if (n < C) {
            float* hp = a.h + (int64_t)b * C + n;
            const float h_in = ldx(hp);
            slot[(int64_t)b * C + n] = h_in;  // read-before-write: taps were read in gate_l
            *hp = (acc + bout[n] + h_in) * 0.70710678118654752f;
          } else {
            float* sp = a.skip + (int64_t)b * SK + (n - C);
            *sp = ldx(sp) + acc + bskip[n - C];
          }
        }
      });
}

// post1: y1 = relu(relu(skip * sqrt(1/L)) @ wp1 + bp1), in storage precision.
__device__ void stage_post1(const DecodeArgs& a, float* Xs, float* red) {
  const int SK = (int)a.S;
  const float scale = sqrtf(1.0f / (float)a.L);
  stage(
      (int)a.B, (SK + TN - 1) / TN, SK, 0, Xs, red,
      [&](int b, int k) { return fmaxf(ldx(a.skip + (int64_t)b * SK + k) * scale, 0.0f); },
      [&](int ct, int lane, Cols& c) { return plain_cols((const float*)a.wp1, SK, ct, lane, c); },
      [&](int ct, int b, int lane, float s0, float s1) {
        for (int j = 0; j < 2; ++j) {
          const int n = ct * TN + lane + 32 * j;
          if (n < SK) ((float*)a.y1)[(int64_t)b * SK + n] = fmaxf((j ? s1 : s0) + a.bp1[n], 0.0f);
        }
      });
}

// logits = y1 @ wp2 + bp2, written to the (B, T, O) output.
__device__ void stage_logits(const DecodeArgs& a, int t, float* Xs, float* red) {
  const int SK = (int)a.S, O = (int)a.O;
  stage(
      (int)a.B, (O + TN - 1) / TN, SK, 0, Xs, red,
      [&](int b, int k) { return ldx((const float*)a.y1 + (int64_t)b * SK + k); },
      [&](int ct, int lane, Cols& c) { return plain_cols((const float*)a.wp2, O, ct, lane, c); },
      [&](int ct, int b, int lane, float s0, float s1) {
        for (int j = 0; j < 2; ++j) {
          const int n = ct * TN + lane + 32 * j;
          if (n < O) a.logits[((int64_t)b * a.T + t) * O + n] = (j ? s1 : s0) + a.bp2[n];
        }
      });
}

// sample: in-kernel sampling from the logits of rows b0, b0 + step, ... and
// the next input row of each.
template <typename S>
__device__ void stage_sample(const DecodeArgs& a, int t, float* sm, int b0, int step) {
  const int O = (int)a.O, T = (int)a.T;
  float* rv = sm;             // [NT]
  int* ri = (int*)(rv + NT);  // [NT]
  __shared__ float next_x;
  for (int b = b0; b < (int)a.B; b += step) {
    const float* lg = a.logits + ((int64_t)b * T + t) * O;
    float best = -INFINITY;
    int bi = 0x7fffffff;
    if (!a.scalar) {  // Gumbel-argmax; log_softmax's shift does not move the argmax
      for (int o = threadIdx.x; o < O; o += NT) {
        const float z = ldx(lg + o) - logf(-logf(uniform(a.seed, b, t, o, 0, 1e-7f)));
        if (z > best) best = z, bi = o;
      }
    }
    rv[threadIdx.x] = best;
    ri[threadIdx.x] = bi;
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {  // block argmax, ties to the lower index
      if (threadIdx.x < s) {
        const float v = rv[threadIdx.x + s];
        const int i = ri[threadIdx.x + s];
        if (v > rv[threadIdx.x] || (v == rv[threadIdx.x] && i < ri[threadIdx.x])) {
          rv[threadIdx.x] = v;
          ri[threadIdx.x] = i;
        }
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      float x;
      if (!a.scalar) {
        x = (float)ri[0];
        ((int*)a.codes)[(int64_t)b * T + t] = ri[0];
      } else {  // MoL / MoG: Gumbel pick over logit_probs, then the noise
        const int M = O / 3;
        int pick = 0;
        float pb = -INFINITY;
        for (int m = 0; m < M; ++m) {
          const float z = ldx(lg + m) - logf(-logf(uniform(a.seed, b, t, m, 0, 1e-5f)));
          if (z > pb) pb = z, pick = m;
        }
        float noise;
        if (!a.normal) {
          const float u = uniform(a.seed, b, t, 0, 1, 1e-5f);
          noise = logf(u) - logf(1.0f - u);
        } else {  // Box-Muller
          const float u1 = uniform(a.seed, b, t, 0, 1, 1e-7f), u2 = uniform(a.seed, b, t, 1, 1, 1e-7f);
          noise = sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
        }
        x = fminf(fmaxf(ldx(lg + M + pick) + expf(ldx(lg + 2 * M + pick)) * noise, -1.0f), 1.0f);
        ((float*)a.codes)[(int64_t)b * T + t] = x;
      }
      next_x = (a.teacher && t + 1 < T) ? teach_at(a, b, t + 1) : x;
    }
    __syncthreads();
    if (t + 1 < T) set_input<S>(a, b, next_x);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT, 1) decode_f32_kernel(const DecodeArgs a) {
  extern __shared__ float smem[];
  float* red = smem;                // [NW][TM][32][2] partial sums
  float* Xs = smem + NW * TM * 64;  // staged input rows
  const float x0 = a.scalar ? 0.0f : 127.0f;  // mu-law silence / scalar zero
  for (int b = blockIdx.x; b < (int)a.B; b += gridDim.x) set_input<float>(a, b, a.teacher ? teach_at(a, b, 0) : x0);
  grid_sync(a.bar);
  for (int t = 0; t < (int)a.T; ++t) {
    for (int l = 0; l < (int)a.L; ++l) {
      stage_gate(a, t, l, Xs, red);
      grid_sync(a.bar);
      stage_out(a, t, l, Xs, red);
      grid_sync(a.bar);
    }
    stage_post1(a, Xs, red);
    grid_sync(a.bar);
    stage_logits(a, t, Xs, red);
    grid_sync(a.bar);
    stage_sample<float>(a, t, red, blockIdx.x, gridDim.x);
    grid_sync(a.bar);
  }
}

static size_t smem_f32_bytes(const DecodeArgs& a) {
  const int64_t cin = a.has_c ? a.CIN : 0;
  int64_t k = 3 * a.C + cin;          // gate
  k = k > a.G / 2 ? k : a.G / 2;      // out
  k = k > a.S ? k : a.S;              // post1, logits
  return (size_t)((NW * TM * 64 + k * XS) * (int64_t)sizeof(float));
}

// ---- bf16 path: resident weights, tensor cores, arrival counters ------------
// Unit kinds of the block plan (kernels/decode.py:block_plan); a unit row is
// (kind, layer, tile, offset of its fragments in the block's share, in
// 16-byte words). A skip unit covers one column tile in every layer.
enum { U_GATE = 0, U_OUT = 1, U_SKIP = 2, U_POST1 = 3, U_LOGITS = 4 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Counter c of the arena: c = 0..L-1 gate_l, L..2L-1 out_l, then skip,
// post1, logits, sample.
__device__ __forceinline__ unsigned* counter(const DecodeArgs& a, int c) { return a.cnt + (int64_t)c * CSTRIDE; }

// Wait until counter c0 >= n0 and counter c1 >= n1 (c1 < 0: none); one
// thread spins with acquire loads, then the block passes.
__device__ __forceinline__ void wait2(const DecodeArgs& a, int c0, unsigned n0, int c1, unsigned n1) {
  if (threadIdx.x == 0) {
    stamp(0);
    const unsigned* p0 = counter(a, c0);
    while (ld_acquire(p0) < n0) __nanosleep(20);
    if (c1 >= 0) {
      const unsigned* p1 = counter(a, c1);
      while (ld_acquire(p1) < n1) __nanosleep(20);
    }
    stamp(1);
    jitter(c0, n0);
  }
  __syncthreads();
}

// The block's stores of a stage are done: add one to counter c, released
// (the barrier orders the other threads' stores before thread 0's release).
__device__ __forceinline__ void arrive(const DecodeArgs& a, int c) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter(a, c)) : "memory");
    stamp(2);
  }
}

// D(16 x 8) += A(16 x 16) B(16 x 8), bf16 in, f32 accumulate. A is one
// lane's packed weight fragment, (b0, b1) its input fragment.
__device__ __forceinline__ void mma_tc(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The input of a tile's product: up to 4 segments of bf16 rows (row b of
// segment s at p + b * ld), each nkb blocks of 32 k deep (zero-padded).
struct XSrc {
  const bf16* p[4];
  int64_t ld[4];
  int nkb[4];
};

// 16 bytes at L2 (data other blocks write during the launch); volatile, so
// the loads stay where the prefetch puts them.
__device__ __forceinline__ uint4 ld16(const bf16* p) {
  uint4 v;
  asm volatile("ld.global.cg.v4.u32 {%0,%1,%2,%3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// out[b, 16 columns] = X[b, :] @ W for all B rows, in chunks of 256 rows,
// then epi(b, j, out[b, j], out[b, j + 8], pre(b, j)) for j < 8 and every
// row b. X's first kl k blocks are ready before the call; the rest only
// after wait(), which every thread calls. pre's loads (biases, h_in, the
// skip sum) are issued first, so their latency hides under the product.
// w is the tile's packed fragments in shared memory: fragment (kb, s) of
// lane at w[(2 kb + s) * 32 + lane]. Warps split a chunk's 8-row groups
// (WB ways) and, where there are fewer than 16 groups, the k range (WK
// ways); each loads the input fragments of its next k block (16-byte L2
// loads straight into registers) while the tensor cores take the current
// one, and keeps two accumulators per fragment (k steps s = 0, 1), so the
// mma chain is half as long; red holds the warps' sums, added in warp
// order. (Deeper prefetch, 2 or 4 k blocks ahead, measured no faster.)
template <typename Wait, typename Pre, typename Epi>
__device__ void tile_product(const uint4* w, const XSrc& x, int B, float* red, int kl, Wait wait, Pre pre,
                             Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, r8 = lane >> 2, q = lane & 3;
  const int e0 = x.nkb[0], e1 = e0 + x.nkb[1], e2 = e1 + x.nkb[2], nkb = e2 + x.nkb[3];
  for (int b0 = 0; b0 < B; b0 += 256) {
    const int rows = min(256, B - b0), nf = (rows + 7) >> 3;
    const int WB = nf >= 16 ? 8 : nf >= 8 ? 4 : nf >= 4 ? 2 : 1, WK = NW / WB, F = (nf + WB - 1) / WB;
    const int wb = warp % WB, wk = warp / WB, RS = nf * 8;
    float2 pf[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int u = threadIdx.x + i * NT;
      pf[i] = u < rows * 8 ? pre(b0 + (u >> 3), u & 7) : make_float2(0.0f, 0.0f);
    }
    float acc[4][2][4];
    int brow[4];
    bool ok[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[f][i >> 2][i & 3] = 0.0f;
      brow[f] = b0 + (wb * F + f) * 8 + r8;
      ok[f] = f < F && wb * F + f < nf && brow[f] < B;
    }
    // input fragments of k block k for this lane's row groups
    auto fetch = [&](uint4(&v)[4], int k) {
      const bf16* p;
      int64_t ld;
      int kk;
      if (k < e0) p = x.p[0], ld = x.ld[0], kk = k;
      else if (k < e1) p = x.p[1], ld = x.ld[1], kk = k - e0;
      else if (k < e2) p = x.p[2], ld = x.ld[2], kk = k - e1;
      else p = x.p[3], ld = x.ld[3], kk = k - e2;
      p += 8 * q + kk * 32;
#pragma unroll
      for (int f = 0; f < 4; ++f) v[f] = ok[f] ? ld16(p + (int64_t)brow[f] * ld) : make_uint4(0, 0, 0, 0);
    };
    // k blocks [k0, k1), the next one's loads in flight
    auto run = [&](int k0, int k1) {
      uint4 v[4];
      if (k0 < k1) fetch(v, k0);
      for (int k = k0; k < k1; ++k) {
        const uint4 a0 = w[(2 * k) * 32 + lane], a1 = w[(2 * k + 1) * 32 + lane];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if (f < F) {
            mma_tc(acc[f][0], a0, v[f].x, v[f].y);
            mma_tc(acc[f][1], a1, v[f].z, v[f].w);
          }
        }
        if (k + 1 < k1) fetch(v, k + 1);
      }
    };
    run(kl * wk / WK, kl * (wk + 1) / WK);
    wait();
    run(kl + (nkb - kl) * wk / WK, kl + (nkb - kl) * (wk + 1) / WK);
    // D's row m = column r8 or r8 + 8 of the tile, its column = row 2q, 2q + 1 of the group
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int fr = wb * F + f;
      if (f < F && fr < nf) {
        float* c0 = red + (wk * 16 + r8) * RS + fr * 8 + 2 * q;
        float* c1 = c0 + 8 * RS;
        c0[0] = acc[f][0][0] + acc[f][1][0], c0[1] = acc[f][0][1] + acc[f][1][1];
        c1[0] = acc[f][0][2] + acc[f][1][2], c1[1] = acc[f][0][3] + acc[f][1][3];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int u = threadIdx.x + i * NT;
      if (u < rows * 8) {
        const int r = u >> 3, j = u & 7;
        float va = 0.0f, vb = 0.0f;
        for (int z = 0; z < WK; ++z) {
          va += red[(z * 16 + j) * RS + r];
          vb += red[(z * 16 + j + 8) * RS + r];
        }
        epi(b0 + r, j, va, vb, pf[i]);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int64_t slot_of(const DecodeArgs& a, int l, int t) {
  return (a.ring_off[l] + t % (2 * a.dil[l])) * a.B * a.CP;
}

// The two values of columns n0 = 16 tile + j and n0 + 8 (below N) at row b
// of v, which other blocks write during the launch (read at L2) ...
__device__ __forceinline__ float2 pair_at(const float* v, int64_t b, int64_t ld, int tile, int j, int N) {
  const int n = tile * 16 + j;
  return make_float2(n < N ? __ldcg(v + b * ld + n) : 0.0f, n + 8 < N ? __ldcg(v + b * ld + n + 8) : 0.0f);
}
// ... or of a read-only bias.
__device__ __forceinline__ float2 bias_pair(const float* v, int tile, int j, int N) {
  const int n = tile * 16 + j;
  return make_float2(n < N ? __ldg(v + n) : 0.0f, n + 8 < N ? __ldg(v + n + 8) : 0.0f);
}

// gate_l, gate pairs 8 tile .. 8 tile + 7: act_l = tanh(a) * sigmoid(b).
// The input segments are [tap0 | tap1 | c | h]: the taps (written at
// earlier steps) and c are ready once out_l(t-1) has arrived, so their
// products run before the wait for this step's h (out_{l-1}(t), or the
// sampler for l = 0), which leaves only h's product on the chain.
__device__ void unit_gate(const DecodeArgs& a, int l, int tile, const uint4* w, int t, float* red) {
  const int B = (int)a.B, L = (int)a.L, G = (int)a.G, G2 = G / 2, d = (int)a.dil[l];
  const unsigned nout = (unsigned)a.NOT;
  wait2(a, L + l, nout * t, -1, 0);  // ring writes of earlier steps; act_l read by out_l(t-1)
  const bf16* ring = (const bf16*)a.ring;
  XSrc x;
  x.p[0] = ring + slot_of(a, l, t), x.ld[0] = a.CP, x.nkb[0] = (int)a.CP / 32;
  x.p[1] = ring + slot_of(a, l, t + d), x.ld[1] = a.CP, x.nkb[1] = (int)a.CP / 32;
  x.p[2] = (const bf16*)a.c_up + (int64_t)t * a.CINP, x.ld[2] = a.T * a.CINP, x.nkb[2] = (int)a.CINP / 32;
  x.p[3] = (const bf16*)a.hb, x.ld[3] = a.CP, x.nkb[3] = (int)a.CP / 32;
  const float* bc = a.bconv + (int64_t)l * G;
  bf16* act = (bf16*)a.act + (int64_t)l * B * a.G2P;
  tile_product(
      w, x, B, red, x.nkb[0] + x.nkb[1] + x.nkb[2],
      [&] {
        if (l == 0) wait2(a, 2 * L + 3, (unsigned)min(B, (int)(a.NB - a.NST)) * (t + 1), -1, 0);
        else wait2(a, L + l - 1, nout * (t + 1), -1, 0);
      },
      [&](int b, int j) {  // bconv + g_add of the pair
        const int p = tile * 8 + j;
        if (p >= G2) return make_float2(0.0f, 0.0f);
        float2 c = make_float2(__ldg(bc + p), __ldg(bc + p + G2));
        if (a.has_g) {
          const float* ga = a.g_add + ((int64_t)l * B + b) * G;
          c.x += __ldg(ga + p), c.y += __ldg(ga + p + G2);
        }
        return c;
      },
      [&](int b, int j, float xa, float xb, float2 c) {
        const int p = tile * 8 + j;
        if (p >= G2) return;
        xa += c.x, xb += c.y;
        act[(int64_t)b * a.G2P + p] = __float2bfloat16(tanhf(xa) * (1.0f / (1.0f + expf(-xb))));
      });
}

// out_l, residual columns 16 tile .. 16 tile + 15.
__device__ void unit_out(const DecodeArgs& a, int l, int tile, const uint4* w, int t, float* red) {
  const int B = (int)a.B, C = (int)a.C;
  XSrc x = {};
  x.p[0] = (const bf16*)a.act + (int64_t)l * B * a.G2P, x.ld[0] = a.G2P, x.nkb[0] = (int)a.G2P / 32;
  bf16* slot = (bf16*)a.ring + slot_of(a, l, t);
  const float* bout = a.bout + (int64_t)l * C;
  tile_product(
      w, x, B, red, 0, [] {}, [&](int b, int j) { return pair_at(a.h, b, C, tile, j, C); },  // h_in
      [&](int b, int j, float v0, float v1, float2 h_in) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = tile * 16 + j + 8 * i;
          if (n >= C) continue;
          const float hi = i ? h_in.y : h_in.x;
          slot[(int64_t)b * a.CP + n] = __float2bfloat16(hi);  // the taps of step t were read in gate_l
          const float h = ((i ? v1 : v0) + __ldg(bout + n) + hi) * 0.70710678118654752f;
          a.h[(int64_t)b * C + n] = h;
          ((bf16*)a.hb)[(int64_t)b * a.CP + n] = __float2bfloat16(h);
        }
      });
}

// skip columns 16 tile .. 16 tile + 15 over all layers: the f32 sum stays
// with this block; after the last layer, ys = bf16(relu(skip * sqrt(1/L))).
__device__ void unit_skip(const DecodeArgs& a, int tile, const uint4* w, int t, float* red) {
  const int B = (int)a.B, L = (int)a.L, SK = (int)a.S, ngt = (int)a.NGT;
  const float scale = sqrtf(1.0f / (float)L);
  for (int l = 0; l < L; ++l) {
    wait2(a, l, ngt * (unsigned)(t + 1), -1, 0);
    XSrc x = {};
    x.p[0] = (const bf16*)a.act + (int64_t)l * B * a.G2P, x.ld[0] = a.G2P, x.nkb[0] = (int)a.G2P / 32;
    const float* bskip = a.bskip + (int64_t)l * SK;
    tile_product(
        w + (int64_t)l * 2 * a.G2P, x, B, red, 0, [] {},
        [&](int b, int j) { return l ? pair_at(a.skip, b, SK, tile, j, SK) : make_float2(0.0f, 0.0f); },
        [&](int b, int j, float v0, float v1, float2 prev) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int n = tile * 16 + j + 8 * i;
            if (n >= SK) continue;
            const float s = (i ? prev.y : prev.x) + (i ? v1 : v0) + __ldg(bskip + n);
            if (l + 1 < L) a.skip[(int64_t)b * SK + n] = s;
            else ((bf16*)a.ys)[(int64_t)b * a.SP + n] = __float2bfloat16(fmaxf(s * scale, 0.0f));
          }
        });
  }
}

// post1 (y1 = bf16(relu(ys @ wp1 + bp1))) or logits (ys = y1, @ wp2 + bp2),
// columns 16 tile .. 16 tile + 15.
__device__ void unit_head(const DecodeArgs& a, bool logits, int tile, const uint4* w, int t, float* red) {
  const int N = logits ? (int)a.O : (int)a.S;
  XSrc x = {};
  x.p[0] = (const bf16*)(logits ? a.y1 : a.ys), x.ld[0] = a.SP, x.nkb[0] = (int)a.SP / 32;
  const float* bias = logits ? a.bp2 : a.bp1;
  tile_product(
      w, x, (int)a.B, red, 0, [] {}, [&](int, int j) { return bias_pair(bias, tile, j, N); },
      [&](int b, int j, float v0, float v1, float2 c) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = tile * 16 + j + 8 * i;
          if (n >= N) continue;
          const float v = (i ? v1 : v0) + (i ? c.y : c.x);
          if (logits) a.logits[((int64_t)b * a.T + t) * N + n] = v;
          else ((bf16*)a.y1)[(int64_t)b * a.SP + n] = __float2bfloat16(fmaxf(v, 0.0f));
        }
      });
}

__global__ void __launch_bounds__(NT, 1) decode_tc_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);
  uint4* wsm = reinterpret_cast<uint4*>(smem_raw + RED_FLOATS * sizeof(float));
  const int64_t* blk = a.blk + (int64_t)blockIdx.x * 4;  // units [u0, u1), share at word off, n words
  const int u0 = (int)blk[0], u1 = (int)blk[1];
  const int64_t off = blk[2], n16 = blk[3];
  const int L = (int)a.L, T = (int)a.T, B = (int)a.B;
  const int R = (int)(a.NB - a.NST), rb = (int)blockIdx.x - (int)a.NST;
  const bool sampler = rb >= 0 && rb < B;  // samples rows rb, rb + R, ...
  const unsigned ngt = (unsigned)a.NGT, nout = (unsigned)a.NOT;
  const int c_skip = 2 * L, c_post1 = 2 * L + 1, c_logits = 2 * L + 2, c_sample = 2 * L + 3;
  if (u0 == u1 && !sampler) return;

  // the block's weights, once: resident for all T steps
  const uint4* src = reinterpret_cast<const uint4*>(a.wbuf) + off;
  for (int64_t i = threadIdx.x; i < n16; i += NT)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(wsm + i)), "l"(src + i) : "memory");
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  if (sampler) {
    const float x0 = a.scalar ? 0.0f : 127.0f;  // mu-law silence / scalar zero
    for (int b = rb; b < B; b += R) set_input<bf16>(a, b, a.teacher ? teach_at(a, b, 0) : x0);
    arrive(a, c_sample);
  }
  for (int t = 0; t < T; ++t) {
    const unsigned now = (unsigned)(t + 1);
    for (int u = u0; u < u1; ++u) {
      const int4 un = __ldg(reinterpret_cast<const int4*>(a.units) + u);
      const int l = un.y, tile = un.z;
      const uint4* w = wsm + un.w;
      switch (un.x) {
        case U_GATE:  // waits inside: ring writes of earlier steps, then this step's h
          unit_gate(a, l, tile, w, t, red);
          arrive(a, l);
          break;
        case U_OUT:
          wait2(a, l, ngt * now, -1, 0);
          unit_out(a, l, tile, w, t, red);
          arrive(a, L + l);
          break;
        case U_SKIP:
          unit_skip(a, tile, w, t, red);
          arrive(a, c_skip);
          break;
        case U_POST1:
          wait2(a, c_skip, (unsigned)a.NST * now, -1, 0);
          unit_head(a, false, tile, w, t, red);
          arrive(a, c_post1);
          break;
        case U_LOGITS:
          wait2(a, c_post1, (unsigned)a.NPT * now, -1, 0);
          unit_head(a, true, tile, w, t, red);
          arrive(a, c_logits);
          break;
      }
      stamp_unit(t, u - u0);
    }
    if (sampler) {  // after the logits and the last layer's reads of h
      wait2(a, c_logits, (unsigned)a.NLT * now, 2 * L - 1, nout * now);
      stage_sample<bf16>(a, t, red, rb, R);
      arrive(a, c_sample);
      stamp_sample(t);
    }
  }
}

extern "C" int wae_decode(const DecodeArgs* args) {
  DecodeArgs a = *args;
  const bool tc = a.store_bf16 != 0;
  const void* fn = tc ? (const void*)decode_tc_kernel : (const void*)decode_f32_kernel;
  const size_t smem = tc ? (size_t)a.smem : smem_f32_bytes(a);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, NT, smem);
  if (e != cudaSuccess) return (int)e;
  // every block resident, or the counters' waits could deadlock: the bf16
  // plan's grid must be one block per SM at most
  if (occ < 1 || (tc && a.NB > (int64_t)sms * occ)) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {(void*)&a};
  const dim3 grid(tc ? (unsigned)a.NB : (unsigned)sms);
  e = cudaLaunchCooperativeKernel(fn, grid, dim3(NT), kargs, smem, (cudaStream_t)a.stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* wae_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

