// Fused WaveNet AR decode for Hopper (sm_90a): the whole sampling loop over
// T steps in one cooperative kernel launch.
//
// Replaces the TPU kernel wavenet_decode_pallas
// (wavenet_autoencoders_tpu/kernels/decode.py:352, body _mk_kernel at :81).
// The TPU kernel runs grid=(T,) steps in order on one core with every weight
// resident in VMEM; the H100 has no such memory (227 KB of shared memory per
// block against ~16 MB of bf16 weights at svqwae width), so the tiling is
// not carried over, only the semantics.
//
// What bounds it on this card. Per batch row and step the network does
// ~8.1 M multiply-adds (20 layers x (3*256*368 + 64*368 + 2*184*256) plus
// the head): at B=256, T=5120 that is ~21 TFLOP, ~22 ms at the 989 TFLOP/s
// bf16 tensor-core peak, while the bytes that must move (inputs once,
// logits once) take well under 1 ms. So the bound is operations. What
// bounds this design in practice is different: a step is a chain of 2L+3
// dependent stages, each a small (B x K) @ (K x N) product, and the stages
// of one step cannot overlap.
//
// Design. One block per SM, launched cooperatively so all blocks are
// resident; a grid-wide barrier separates the stages of a step:
//   gate_l  : ab = [tap0 | tap1 | h | c_t] @ [wconv_l ; wc_l] + bconv + g_add,
//             act = tanh(ab[:G/2]) * sigmoid(ab[G/2:])   (lane = gate pair)
//   out_l   : out = act @ wout + bout, skip += act @ wskip + bskip; the ring
//             slot t mod 2d receives h_in, then h = (out + h_in) * sqrt(1/2)
//   post1   : y1 = relu(relu(skip * sqrt(1/L)) @ wp1 + bp1)
//   logits  : logits = y1 @ wp2 + bp2
//   sample  : in-kernel sampling per row, and the next step's input row
// Each block works on 2-D output tiles (up to 16 batch rows x 64 columns),
// so the weights are split across SMs and every weight byte is read from L2
// about once per step instead of once per batch row: a split over the batch
// alone would make each SM read all ~16 MB of weights every step. The input
// rows of a tile are staged in shared memory in f32; weights stream from
// L2 (they fit in its 50 MB). Within a tile the 8 warps split the k range
// and add their partial sums in shared memory, so each thread keeps many
// independent weight loads in flight (one warp walking all of k=832 is
// bound by L2 latency). Products run on CUDA cores with f32 accumulation;
// the tensor cores (wgmma) are left to a later change.
// Rings live in one device-memory arena (sum 2*d_l, B, C) allocated and
// zeroed by the wrapper. Sampling uses a counter-based Philox4x32-10 keyed
// by (seed, row, step, draw).
//
// Storage is f32 or bf16 (template S); biases, g_add and the scalar path's
// first 1x1 stay f32; accumulation is f32. The first input is mu-law code
// 127 (or 0.0 for scalar input); teacher mode feeds teach[:, t] instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAXL 64
#define NT 256          // threads per block
#define TM 16           // batch rows per tile
#define XS (TM + 1)     // padded row stride of the staged input tile
#define NW (NT / 32)    // warps per block: a tile's k range is split over them
#define TN 64           // output columns per tile: lane and lane + 32

// Mirrored field for field (all 8-byte) by _DecodeArgs in kernels/decode.py.
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
};

// ---- storage-type helpers -------------------------------------------------
// ldw: read-only data (weights, c_up); ldx: data other blocks write during
// the launch, read at L2 (.cg) so no stale L1 line is ever used.
__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float ldx(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldx(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void stx(float* p, float v) { *p = v; }
__device__ __forceinline__ void stx(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
template <typename S>
__device__ __forceinline__ float rnd(float v);  // round to storage precision
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---- grid-wide barrier (all blocks resident: cooperative launch) ----------
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

// acc[r][j] += X[r, k] * W_j[k] for k in [k0, k1) and R rows; X is staged
// as Xs[k * XS + r], column j's weights are read at w_j + k * ld_j.
template <typename S, int R>
__device__ __forceinline__ void dot_rows(const float* Xs, int k0, int k1, const S* w0, int64_t ld0,
                                         const S* w1, int64_t ld1, float (&acc)[R][2]) {
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
template <typename S>
struct Cols {
  const S* a[2];
  int64_t lda[2];
  const S* b[2];
  int64_t ldb;
};

// One output tile of R rows x (2 columns per lane): stage the input rows
// (load_x(row, k); zero past `rows`), split k over the warps so each warp
// keeps many independent loads in flight, add the warps' partial sums in
// shared memory, and call epi(row, lane, sum0, sum1) for the valid rows.
template <typename S, int R, typename LoadX, typename ColsOf, typename Epi>
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
  Cols<S> c;
  if (cols_of(lane, c)) {
    if (k0 < Ka) dot_rows<S, R>(Xs, k0, min(k1, Ka), c.a[0], c.lda[0], c.a[1], c.lda[1], acc);
    if (k1 > Ka) dot_rows<S, R>(Xs + Ka * XS, max(k0, Ka) - Ka, k1 - Ka, c.b[0], c.ldb, c.b[1], c.ldb, acc);
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
template <typename S, typename LoadX, typename ColsOf, typename Epi>
__device__ void stage(int B, int n_ct, int Ka, int Kb, float* Xs, float* red, LoadX load_x, ColsOf cols_of,
                      Epi epi) {
  const int n_tiles = ((B + TM - 1) / TM) * n_ct;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int m0 = (t / n_ct) * TM, ct = t % n_ct, rows = min(TM, B - m0);
    auto cols = [&](int lane, Cols<S>& c) { return cols_of(ct, lane, c); };
    auto out = [&](int b, int lane, float s0, float s1) { epi(ct, b, lane, s0, s1); };
    if (rows <= 4) tile<S, 4>(m0, rows, Ka, Kb, Xs, red, load_x, cols, out);
    else tile<S, TM>(m0, rows, Ka, Kb, Xs, red, load_x, cols, out);
  }
}

// Input row of step t for batch row b: mu-law code row gather of W1 (a code
// outside [0, O), i.e. the start code 127 when O <= 127, is an all-zero
// one-hot), or the scalar sample times W1 (f32). Also clears the row's skip.
template <typename S>
__device__ void set_input(const DecodeArgs& a, int b, float x) {
  const int C = (int)a.C, code = (int)x;
  const bool row = code >= 0 && code < (int)a.O;
  for (int c = threadIdx.x; c < C; c += NT) {
    float w = a.scalar ? x * ((const float*)a.w1)[c]
                       : (row ? ldw((const S*)a.w1 + (int64_t)code * C + c) : 0.0f);
    a.h[(int64_t)b * C + c] = w + a.b1[c];
  }
  for (int s = threadIdx.x; s < (int)a.S; s += NT) a.skip[(int64_t)b * a.S + s] = 0.0f;
}

__device__ __forceinline__ float teach_at(const DecodeArgs& a, int b, int t) {
  return a.scalar ? ((const float*)a.teach)[(int64_t)b * a.T + t]
                  : (float)((const int*)a.teach)[(int64_t)b * a.T + t];
}

// gate_l: ab over [tap0 | tap1 | h | c_t] and act = tanh(ab[p]) * sigmoid(ab[p + G/2]);
// lane = gate pair p, so both halves of a pair meet in one thread.
template <typename S>
__device__ void stage_gate(const DecodeArgs& a, int t, int l, float* Xs, float* red) {
  const int B = (int)a.B, C = (int)a.C, G = (int)a.G, G2 = G / 2, CIN = a.has_c ? (int)a.CIN : 0;
  const int d = (int)a.dil[l], n = 2 * d;
  const int64_t BC = (int64_t)B * C;
  const S* tap0 = (const S*)a.ring + (a.ring_off[l] + t % n) * BC;
  const S* tap1 = (const S*)a.ring + (a.ring_off[l] + (t + d) % n) * BC;
  const S* wl = (const S*)a.wconv + (int64_t)l * 3 * C * G;
  const S* wcl = CIN ? (const S*)a.wc + (int64_t)l * CIN * G : wl;
  const float* bc = a.bconv + (int64_t)l * G;
  stage<S>(
      B, (G2 + 31) / 32, 3 * C, CIN, Xs, red,
      [&](int b, int k) {
        if (k < C) return ldx(tap0 + (int64_t)b * C + k);
        if (k < 2 * C) return ldx(tap1 + (int64_t)b * C + (k - C));
        if (k < 3 * C) return rnd<S>(ldx(a.h + (int64_t)b * C + (k - 2 * C)));
        return ldw((const S*)a.c_up + ((int64_t)b * a.T + t) * CIN + (k - 3 * C));
      },
      [&](int ct, int lane, Cols<S>& c) {
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
        stx((S*)a.act + (int64_t)b * G2 + p, tanhf(xa) * (1.0f / (1.0f + expf(-xb))));
      });
}

// Columns n = ct * TN + lane + 32 j (j = 0, 1) of a single weight matrix w
// (K x N, row stride N) for the out, post1 and logits stages.
template <typename S>
__device__ __forceinline__ bool plain_cols(const S* w, int N, int ct, int lane, Cols<S>& c) {
  const int n0 = ct * TN + lane, n1 = n0 + 32 < N ? n0 + 32 : n0;
  c.a[0] = w + n0, c.a[1] = w + n1, c.lda[0] = c.lda[1] = N;
  c.b[0] = c.b[1] = w, c.ldb = N;
  return n0 < N;
}

// out_l over the C residual columns followed by the S skip columns.
template <typename S>
__device__ void stage_out(const DecodeArgs& a, int t, int l, float* Xs, float* red) {
  const int B = (int)a.B, C = (int)a.C, G2 = (int)a.G / 2, SK = (int)a.S, N = C + SK;
  S* slot = (S*)a.ring + (a.ring_off[l] + t % (2 * a.dil[l])) * (int64_t)B * C;
  const S* act = (const S*)a.act;
  const S* wout = (const S*)a.wout + (int64_t)l * G2 * C;
  const S* wskip = (const S*)a.wskip + (int64_t)l * G2 * SK;
  const float* bout = a.bout + (int64_t)l * C;
  const float* bskip = a.bskip + (int64_t)l * SK;
  auto col = [&](int n, const S** w, int64_t* ld) {
    if (n < C) *w = wout + n, *ld = C;
    else *w = wskip + (n - C), *ld = SK;
  };
  stage<S>(
      B, (N + TN - 1) / TN, G2, 0, Xs, red,
      [&](int b, int k) { return ldx(act + (int64_t)b * G2 + k); },
      [&](int ct, int lane, Cols<S>& c) {
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
            stx(slot + (int64_t)b * C + n, h_in);  // read-before-write: taps were read in gate_l
            *hp = (acc + bout[n] + h_in) * 0.70710678118654752f;
          } else {
            float* sp = a.skip + (int64_t)b * SK + (n - C);
            *sp = ldx(sp) + acc + bskip[n - C];
          }
        }
      });
}

// post1: y1 = relu(relu(skip * sqrt(1/L)) @ wp1 + bp1), in storage precision.
template <typename S>
__device__ void stage_post1(const DecodeArgs& a, float* Xs, float* red) {
  const int SK = (int)a.S;
  const float scale = sqrtf(1.0f / (float)a.L);
  stage<S>(
      (int)a.B, (SK + TN - 1) / TN, SK, 0, Xs, red,
      [&](int b, int k) { return rnd<S>(fmaxf(ldx(a.skip + (int64_t)b * SK + k) * scale, 0.0f)); },
      [&](int ct, int lane, Cols<S>& c) { return plain_cols<S>((const S*)a.wp1, SK, ct, lane, c); },
      [&](int ct, int b, int lane, float s0, float s1) {
        for (int j = 0; j < 2; ++j) {
          const int n = ct * TN + lane + 32 * j;
          if (n < SK) stx((S*)a.y1 + (int64_t)b * SK + n, fmaxf((j ? s1 : s0) + a.bp1[n], 0.0f));
        }
      });
}

// logits = y1 @ wp2 + bp2, written to the (B, T, O) output.
template <typename S>
__device__ void stage_logits(const DecodeArgs& a, int t, float* Xs, float* red) {
  const int SK = (int)a.S, O = (int)a.O;
  stage<S>(
      (int)a.B, (O + TN - 1) / TN, SK, 0, Xs, red,
      [&](int b, int k) { return ldx((const S*)a.y1 + (int64_t)b * SK + k); },
      [&](int ct, int lane, Cols<S>& c) { return plain_cols<S>((const S*)a.wp2, O, ct, lane, c); },
      [&](int ct, int b, int lane, float s0, float s1) {
        for (int j = 0; j < 2; ++j) {
          const int n = ct * TN + lane + 32 * j;
          if (n < O) a.logits[((int64_t)b * a.T + t) * O + n] = (j ? s1 : s0) + a.bp2[n];
        }
      });
}

// sample: in-kernel sampling from each row's logits and the next input row.
template <typename S>
__device__ void stage_sample(const DecodeArgs& a, int t, float* sm) {
  const int O = (int)a.O, T = (int)a.T;
  float* rv = sm;            // [NT]
  int* ri = (int*)(rv + NT);  // [NT]
  __shared__ float next_x;
  for (int b = blockIdx.x; b < (int)a.B; b += gridDim.x) {
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

template <typename S>
__global__ void __launch_bounds__(NT, 1) decode_kernel(const DecodeArgs a) {
  extern __shared__ float smem[];
  float* red = smem;                // [NW][TM][32][2] partial sums
  float* Xs = smem + NW * TM * 64;  // staged input rows
  const float x0 = a.scalar ? 0.0f : 127.0f;  // mu-law silence / scalar zero
  for (int b = blockIdx.x; b < (int)a.B; b += gridDim.x) set_input<S>(a, b, a.teacher ? teach_at(a, b, 0) : x0);
  grid_sync(a.bar);
  for (int t = 0; t < (int)a.T; ++t) {
    for (int l = 0; l < (int)a.L; ++l) {
      stage_gate<S>(a, t, l, Xs, red);
      grid_sync(a.bar);
      stage_out<S>(a, t, l, Xs, red);
      grid_sync(a.bar);
    }
    stage_post1<S>(a, Xs, red);
    grid_sync(a.bar);
    stage_logits<S>(a, t, Xs, red);
    grid_sync(a.bar);
    stage_sample<S>(a, t, red);
    grid_sync(a.bar);
  }
}

static size_t smem_bytes(const DecodeArgs& a) {
  const int64_t cin = a.has_c ? a.CIN : 0;
  int64_t k = 3 * a.C + cin;          // gate
  k = k > a.G / 2 ? k : a.G / 2;      // out
  k = k > a.S ? k : a.S;              // post1, logits
  return (size_t)((NW * TM * 64 + k * XS) * (int64_t)sizeof(float));
}

extern "C" int wae_decode(const DecodeArgs* args) {
  DecodeArgs a = *args;
  const void* fn = a.store_bf16 ? (const void*)decode_kernel<__nv_bfloat16> : (const void*)decode_kernel<float>;
  const size_t smem = smem_bytes(a);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  void* kargs[] = {(void*)&a};
  e = cudaLaunchCooperativeKernel(fn, dim3(sms), dim3(NT), kargs, smem, (cudaStream_t)a.stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* wae_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
