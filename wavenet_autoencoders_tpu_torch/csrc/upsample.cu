// The conditioning upsampler's stretch-and-smooth chain on Hopper (sm_90a):
// the forward of every scale in one launch; its backward (the gradient of
// the frame conditioning and of every scale's folded smoothing weight) in one
// launch and a fixed-order sum pass.
//
// Replaces no TPU kernel: the JAX package leaves the upsampler
// (wavenet_autoencoders_tpu/ops/upsample.py:upsample_network_apply) to XLA.
// Its plain version, kernels/upsample.py:upsample_reference, runs each scale
// as repeat_interleave and a one-channel F.conv2d over the (B, 1, cin, T_k)
// "image", which cuDNN serves with tensor-core tiles of which one row in 64
// is used: 11.3 ms forward and backward at svqwae's B=40 x 5120 on the H100,
// 8.3 ms of it the weight gradients.
//
// At freq_axis_kernel_size 1 (every preset) each (b, channel) row is a 1-D
// signal. Scale k (factor s) stretches y_{k-1} (length n_{k-1}) by s and
// correlates it with 2s+1 taps w, with s zeros on each side:
//   y_k[t] = sum_i w[i] * u[t - s + i],  u[j] = y_{k-1}[j / s]  (0 outside).
// For t = m*s + r the taps fall on three inputs only, so a stage is
//   y_k[m*s + r] = A_r y_{k-1}[m-1] + B_r y_{k-1}[m] + C_r y_{k-1}[m+1]
// with A_r, B_r, C_r the sums of the taps i < s-r, s-r <= i < 2s-r, i >= 2s-r.
// Its backward: du[j] = sum_i w[i] dy[j + s - i], rounded to the storage
// type; dx[m] = the sum of du over the s copies of m, rounded again (where
// autograd rounds the conv's input gradient and the repeat's backward sum);
// dw[i] = sum_t dy[t] u[t - s + i], which a lane gathers as the 3s sums of
// dy[m*s + r] * y_{k-1}[m - 1 + c] that the taps are read from.
//
// What bounds it: bytes. The forward writes the (B, T, cin) output once
// (26.2 MB in bf16 at svqwae's B=40 x T=5120 x cin=64) and the backward reads
// dy once (26.2 MB): 0.016 ms at 3.35 TB/s. The multiply-adds, ~3 an output
// forward and ~2s+4 an input position backward, are far below the card's
// rate. So every intermediate scale stays in shared memory:
// - A block owns kFrames frames and 32 channels (one a lane: rows of
//   (B, T, cin) are read and written 32 neighbouring channels at a time) of
//   one batch row. It holds each stage it needs over the range its work
//   needs, [position][lane], in the storage type (exact: every stage is
//   rounded to it), and computes each stage from the one below; a warp walks
//   a run of consecutive positions, with a window of inputs slid along in
//   registers.
// - Forward, a block writes only its frames' output. Backward, it recomputes every stage's input over the range
//   its frames need from the conditioning, in shared memory, instead of
//   saving them; then walks the scales back, computing dy_{k-1} wherever
//   the next scale down needs it. dx of a frame needs dy about 1.3 frames
//   beyond it on each side (the chain's halo, at scales 4,4,8,5), so
//   neighbouring blocks compute the top scale's dy_{K-1} there again, each
//   for its own frames; they read the same dy rows and meet in L2. The top
//   scale reads dy from device memory through a staging buffer in shared
//   memory, the next rows loaded into registers while the present ones are
//   used.
// - Each block sums its weight-gradient terms over the positions it owns,
//   lanes and warps in a fixed tree, into its own workspace slot; the sum
//   pass adds each tap's slots in block order. No float atomics: the results
//   are deterministic.
// Measured (H100, svqwae, bf16, device time): forward 0.035 ms, backward
// 0.16 ms, ~8 % of the bound. A warp's step along its run costs a few
// thousand cycles, well above its instructions' issue time; running the top
// scale's backward as a launch of its own, with no halo, took 0.13 ms.
//
// Storage type S (float or bf16): inputs, weights, every stage's output and
// every gradient are S, products accumulate in f32. The entry points launch
// on the caller's stream, allocate nothing and do not synchronise (a CUDA
// graph captures them).
//
// Entry points (plain C, ctypes; each returns a cudaError_t as int):
//   wae_up_forward(args)            out = the chain of x
//   wae_up_backward(args)           dx, dw[k] from dy (work: the blocks' slots)
//   wae_up_workspace_floats(args)   the floats `work` must hold
//   wae_up_error_string(e)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxScales = 8;
constexpr int kMaxScale = 8;  // the presets' largest
constexpr int kLanes = 32;  // channels a block, one a lane
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kSumThreads = 256;
constexpr int kMaxSmemBytes = 232448;
constexpr int kMaxTaps = 2 * kMaxScale + 1;
// The blocks' sizes (chosen on the H100 at svqwae's and inae's shapes, where
// 1 frame, 4 or 16 warps, 64 or 256 rows or 2 blocks an SM were slower):
// frames a block; dy rows the backward stages at a time; blocks an SM its
// registers allow.
constexpr int kFrames = 2;
constexpr int kChunkRows = 128;
constexpr int kMinBlocks = 3;

}  // namespace

// field for field kernels/upsample.py:_UpArgs
struct UpArgs {
  int64_t B, T0, cin, K, indent, bf16;
  int64_t scale[kMaxScales];
  const void* x;              // (B, T0, cin)
  const void* w[kMaxScales];  // scale k's 2s+1 taps
  void* out;                  // (B, T, cin), T = T0 * prod(scale) - 2 * indent
  const void* dy;             // (B, T, cin)
  void* dx;                   // (B, T0, cin)
  void* dw[kMaxScales];       // scale k's 2s+1 tap gradients
  float* work;                // wae_up_workspace_floats(args)
  cudaStream_t stream;
};

namespace {

struct Range {
  int lo, hi;
};


// A launch's geometry and its shared-memory layout: f32 tables first
// (offsets in floats), then the stage buffers in the storage type (offsets
// in its elements from byte `tbase`; a buffer holds rows of kLanes values).
struct Geo {
  int K, T0, cin, indent, backward;
  int s[kMaxScales];
  int n[kMaxScales + 1];        // stage k's length, n[0] = T0
  int tap_off[kMaxScales + 1];  // scale k's taps at tap_off[k]; tap_off[K] taps in all
  int coef_off[kMaxScales];     // scale k's (A, B, C) for r < s at 3 * coef_off[k]
  int taps, coefs, parts;       // the f32 tables
  int tbase;                    // byte offset of the storage-type buffers
  int ybuf[kMaxScales];         // y_k, k < K
  int dbuf[kMaxScales];         // backward: dy_k, 1 <= k < K
  int chunk;                    // backward: the top stage's staged dy rows
  int smem_bytes;
};

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// y_{k-1}'s range that y_k needs on r[k], for k = top .. 1 (clamped to the
// stage; empty where r[k] is)
__host__ __device__ inline void input_ranges(const Geo& g, int top, Range* r) {
  for (int k = top; k >= 1; --k) {
    const int s = g.s[k - 1];
    if (r[k].hi <= r[k].lo) {
      r[k - 1] = Range{0, 0};
      continue;
    }
    r[k - 1] = Range{imax(r[k].lo / s - 1, 0), imin((r[k].hi - 1) / s + 2, g.n[k - 1])};
  }
}

// The ranges of block bx (its kFrames frames): forward, y[k] for k <= K
// (y[K] the output, trimmed by indent); backward, y[k] for k < K (the
// recomputed inputs), own[k] (the positions whose weight-gradient terms it
// sums, k <= K) and d[k] (where dy_k is needed, k < K; d[0] = own[0], the
// frames whose gradient it writes).
struct BlockRanges {
  Range y[kMaxScales + 1], own[kMaxScales + 1], d[kMaxScales + 1];
};

__host__ __device__ inline int blocks_x(const Geo& g) { return (g.T0 + kFrames - 1) / kFrames; }

__host__ __device__ inline void block_ranges(const Geo& g, int bx, BlockRanges& br) {
  const int K = g.K;
  int p = 1;
  for (int k = 0; k <= K; ++k) {
    br.own[k] = Range{bx * kFrames * p, imin((bx + 1) * kFrames * p, g.n[k])};
    if (k < K) p *= g.s[k];
  }
  if (!g.backward) {
    br.y[K] = Range{imax(br.own[K].lo, g.indent), imin(br.own[K].hi, g.n[K] - g.indent)};
    input_ranges(g, K, br.y);
    return;
  }
  br.y[K - 1] = Range{imax(br.own[K - 1].lo - 1, 0), imin(br.own[K - 1].hi + 1, g.n[K - 1])};
  input_ranges(g, K - 1, br.y);
  br.d[0] = br.own[0];
  for (int k = 1; k < K; ++k) {
    const int s = g.s[k - 1];
    br.d[k] = Range{imax(s * br.d[k - 1].lo - s, 0), imin(s * br.d[k - 1].hi + s, g.n[k])};
  }
}

// The plan: stage lengths, and buffers as large as the largest block needs.
inline int plan(const UpArgs& a, bool backward, Geo& g) {
  if (a.K < 1 || a.K > kMaxScales || a.B < 1 || a.T0 < 1 || a.cin < 1 || a.indent < 0)
    return (int)cudaErrorInvalidValue;
  g = Geo{};
  g.K = (int)a.K;
  g.T0 = (int)a.T0;
  g.cin = (int)a.cin;
  g.indent = (int)a.indent;
  g.backward = backward;
  int64_t n = a.T0;
  g.n[0] = g.T0;
  int taps = 0, coefs = 0;
  for (int k = 0; k < g.K; ++k) {
    const int64_t s = a.scale[k];
    if (s < 1 || s > kMaxScale) return (int)cudaErrorInvalidValue;
    g.s[k] = (int)s;
    n *= s;
    if (n > (1 << 30)) return (int)cudaErrorInvalidValue;
    g.n[k + 1] = (int)n;
    g.tap_off[k] = taps;
    g.coef_off[k] = coefs;
    taps += 2 * (int)s + 1;
    coefs += (int)s;
  }
  g.tap_off[g.K] = taps;
  if (n - 2 * a.indent < 1) return (int)cudaErrorInvalidValue;
  int ylen[kMaxScales] = {}, dlen[kMaxScales] = {};
  for (int bx = 0; bx < blocks_x(g); ++bx) {
    BlockRanges br;
    block_ranges(g, bx, br);
    for (int k = 0; k < g.K; ++k) {
      ylen[k] = imax(ylen[k], br.y[k].hi - br.y[k].lo);
      if (backward && k >= 1) dlen[k] = imax(dlen[k], br.d[k].hi - br.d[k].lo);
    }
  }
  g.taps = 0;
  g.coefs = taps;
  g.parts = g.coefs + 3 * coefs;
  g.tbase = (4 * (g.parts + kWarps * kMaxTaps) + 15) / 16 * 16;
  int off = 0;
  for (int k = 0; k < g.K; ++k) {
    g.ybuf[k] = off;
    off += ylen[k] * kLanes;
  }
  for (int k = 1; k < g.K; ++k) {
    g.dbuf[k] = off;
    off += dlen[k] * kLanes;
  }
  g.chunk = off;
  if (backward) off += kChunkRows * kLanes;
  g.smem_bytes = g.tbase + off * (a.bf16 ? 2 : 4);
  if (g.smem_bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

template <typename T>
struct Ptrs {
  const T* w[kMaxScales];
  T* dw[kMaxScales];
};

template <typename T>
__device__ __forceinline__ float ldf(const T* p);
template <>
__device__ __forceinline__ float ldf<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float ldf<__nv_bfloat16>(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__device__ __forceinline__ void stf(T* p, float v);
template <>
__device__ __forceinline__ void stf<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void stf<__nv_bfloat16>(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// v rounded to T's precision
template <typename T>
__device__ __forceinline__ float rnd(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) { return __bfloat162float(__float2bfloat16(v)); }

// The taps of every scale, as floats, and each scale's (A_r, B_r, C_r).
template <typename T>
__device__ void load_taps(const Geo& g, const Ptrs<T>& p, float* sm) {
  float* taps = sm + g.taps;
  for (int k = 0; k < g.K; ++k)
    for (int i = threadIdx.x; i < 2 * g.s[k] + 1; i += kThreads) taps[g.tap_off[k] + i] = ldf(p.w[k] + i);
  __syncthreads();
  for (int k = 0; k < g.K; ++k) {
    const int s = g.s[k];
    const float* w = taps + g.tap_off[k];
    for (int r = threadIdx.x; r < s; r += kThreads) {
      float a = 0.f, b = 0.f, c = 0.f;
      for (int i = 0; i <= 2 * s; ++i) {
        const int q = (r + i) / s;
        if (q == 0) a += w[i];
        else if (q == 1) b += w[i];
        else c += w[i];
      }
      float* co = sm + g.coefs + 3 * (g.coef_off[k] + r);
      co[0] = a;
      co[1] = b;
      co[2] = c;
    }
  }
  __syncthreads();
}

// a stage buffer's value at position j of its stage (0 outside its range)
template <typename T>
__device__ __forceinline__ float at(const T* buf, Range r, int j, int lane) {
  return (j >= r.lo && j < r.hi) ? ldf(buf + (j - r.lo) * kLanes + lane) : 0.f;
}

// Stage k (factor S) over yr: y_k from y_{k-1} (buffer xb over xr), into a
// buffer (yb) or, where yb is null, to the output row `out` (position t at
// out[(t - indent) * cin]). Each warp walks a run of consecutive inputs m.
template <typename T, int S>
__device__ __forceinline__ void fwd_stage(const float* co, const T* xb, Range xr, Range yr, T* yb, T* out, int cin,
                                          int indent, bool lane_ok) {
  if (yr.hi <= yr.lo) return;
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int mlo = yr.lo / S, mhi = (yr.hi - 1) / S + 1, run = (mhi - mlo + kWarps - 1) / kWarps;
  const int mb = mlo + warp * run, me = imin(mb + run, mhi);
  float x0 = at(xb, xr, mb - 1, lane), x1 = at(xb, xr, mb, lane), x2;
  for (int m = mb; m < me; ++m, x0 = x1, x1 = x2) {
    x2 = at(xb, xr, m + 1, lane);
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const int t = m * S + r;
      if (t < yr.lo || t >= yr.hi) continue;
      const float v = rnd<T>(fmaf(co[3 * r + 2], x2, fmaf(co[3 * r + 1], x1, co[3 * r] * x0)));
      if (yb) {
        stf(yb + (t - yr.lo) * kLanes + lane, v);
      } else if (lane_ok) {
        stf(out + (int64_t)(t - indent) * cin, v);
      }
    }
  }
}

#define WAE_UP_SCALES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

template <typename T>
__device__ void fwd_dispatch(int s, const float* co, const T* xb, Range xr, Range yr, T* yb, T* out, int cin,
                             int indent, bool lane_ok) {
  switch (s) {
#define WAE_CASE(S) \
  case S:           \
    fwd_stage<T, S>(co, xb, xr, yr, yb, out, cin, indent, lane_ok); break;
    WAE_UP_SCALES(WAE_CASE)
#undef WAE_CASE
  }
}

// y_0 (the block's rows of x), then stages 1 .. last, into their buffers
template <typename T>
__device__ void fwd_stages(const Geo& g, const BlockRanges& br, int last, const T* xrow, const float* sm, T* st,
                           bool lane_ok) {
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const Range r = br.y[0];
  for (int j = r.lo + warp; j < r.hi; j += kWarps)
    stf(st + g.ybuf[0] + (j - r.lo) * kLanes + lane, lane_ok ? ldf(xrow + (int64_t)j * g.cin) : 0.f);
  __syncthreads();
  for (int k = 1; k <= last; ++k) {
    fwd_dispatch<T>(g.s[k - 1], sm + g.coefs + 3 * g.coef_off[k - 1], st + g.ybuf[k - 1], br.y[k - 1], br.y[k],
                    st + g.ybuf[k], (T*)nullptr, g.cin, 0, lane_ok);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) up_fwd_kernel(Geo g, const T* __restrict__ x, Ptrs<T> p,
                                                          T* __restrict__ out) {
  extern __shared__ float sm[];
  T* st = (T*)((char*)sm + g.tbase);
  const int lane = threadIdx.x % kLanes;
  const int ch = blockIdx.z * kLanes + lane;
  const bool lane_ok = ch < g.cin;
  const int b = blockIdx.y;
  BlockRanges br;
  block_ranges(g, blockIdx.x, br);
  if (br.y[g.K].hi <= br.y[g.K].lo) return;  // frames inside the trimmed edge
  load_taps(g, p, sm);
  fwd_stages<T>(g, br, g.K - 1, x + (int64_t)b * g.T0 * g.cin + ch, sm, st, lane_ok);
  const int t_out = g.n[g.K] - 2 * g.indent;
  fwd_dispatch<T>(g.s[g.K - 1], sm + g.coefs + 3 * g.coef_off[g.K - 1], st + g.ybuf[g.K - 1], br.y[g.K - 1],
                  br.y[g.K], nullptr, out + (int64_t)b * t_out * g.cin + ch, g.cin, g.indent, lane_ok);
}

template <typename T, int S>
__device__ __forceinline__ void bwd_frames(const float (&w)[2 * S + 1], float (&G)[S][3], const T* src, Range sr,
                                           int m0, int m1, int cin, Range mr, Range own, const T* xb, Range xr,
                                           T* dxb, T* dxg, bool lane_ok) {
  // frames [m0, m1) from dy in `src` over `sr`: each warp walks a run of
  // consecutive frames, its window win[j] = dy[m*S - S + j], j < 3S, slid by
  // S a frame
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int run = (m1 - m0 + kWarps - 1) / kWarps;
  const int mb = m0 + warp * run, me = imin(mb + run, m1);
  float win[3 * S];
#pragma unroll
  for (int j = 0; j < 3 * S; ++j) win[j] = at(src, sr, mb * S - S + j, lane);
  for (int m = mb; m < me; ++m) {
    if (m > mb) {
#pragma unroll
      for (int j = 0; j < 2 * S; ++j) win[j] = win[j + S];
#pragma unroll
      for (int j = 2 * S; j < 3 * S; ++j) win[j] = at(src, sr, m * S - S + j, lane);
    }
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < S; ++r) {
      float du = 0.f;
#pragma unroll
      for (int i = 0; i <= 2 * S; ++i) du = fmaf(w[i], win[r + 2 * S - i], du);
      acc += rnd<T>(du);
    }
    const float dx = rnd<T>(acc);
    if (dxb) stf(dxb + (m - mr.lo) * kLanes + lane, dx);
    else if (lane_ok) stf(dxg + (int64_t)m * cin, dx);
    if (m >= own.lo && m < own.hi) {
      const float x0 = at(xb, xr, m - 1, lane), x1 = at(xb, xr, m, lane), x2 = at(xb, xr, m + 1, lane);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        const float d = win[S + r];
        G[r][0] = fmaf(d, x0, G[r][0]);
        G[r][1] = fmaf(d, x1, G[r][1]);
        G[r][2] = fmaf(d, x2, G[r][2]);
      }
    }
  }
}

// Stage k (factor S) backward over the stretched input's frames mr (stage
// k-1 positions): dx[m] = S(sum_r S(sum_i w[i] dy[m*S + r + S - i])), into a
// buffer (dxb over mr) or, where dxb is null, the gradient row `dxg`. dy
// comes from a buffer (dyb over dyr) or, where dyb is null, from the
// gradient row `dyg` (position t at dyg[(t - indent) * cin], 0 outside dyr):
// staged through `chunk` kChunkRows rows at a time, the next rows loaded
// into registers while the present ones are used. Over the owned frames
// `own` it gathers the weight gradient's terms against y_{k-1} (xb over xr),
// and leaves the block's 2S+1 tap sums in `part` (one row of kMaxTaps a
// warp) for the caller to finish.
template <typename T, int S>
__device__ __forceinline__ void bwd_stage(const float* w_s, const T* dyb, const T* dyg, Range dyr, int cin,
                                          int indent, Range mr, Range own, const T* xb, Range xr, T* dxb, T* dxg,
                                          float* part, T* chunk, bool lane_ok) {
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  float w[2 * S + 1];
#pragma unroll
  for (int i = 0; i <= 2 * S; ++i) w[i] = w_s[i];
  float G[S][3];
#pragma unroll
  for (int r = 0; r < S; ++r) G[r][0] = G[r][1] = G[r][2] = 0.f;
  if (dyb) {
    bwd_frames<T, S>(w, G, dyb, dyr, mr.lo, mr.hi, cin, mr, own, xb, xr, dxb, dxg, lane_ok);
  } else {
    // chunks of mc frames, whose dy rows [m0*S - S, m1*S + 2S) fit kChunkRows
    constexpr int kPre = kChunkRows / kWarps;
    const int mc = imax(1, kChunkRows / S - 3);
    float pre[kPre];
    int m0 = mr.lo, m1 = imin(m0 + mc, mr.hi);
    Range cr = Range{imax(m0 * S - S, dyr.lo), imin(m1 * S + 2 * S, dyr.hi)};
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int t = cr.lo + warp + kWarps * j;
      pre[j] = (t < cr.hi && lane_ok) ? ldf(dyg + (int64_t)(t - indent) * cin) : 0.f;
    }
    while (m0 < mr.hi) {
      __syncthreads();  // the last chunk's rows are used
#pragma unroll
      for (int j = 0; j < kPre; ++j) {
        const int t = cr.lo + warp + kWarps * j;
        if (t < cr.hi) stf(chunk + (t - cr.lo) * kLanes + lane, pre[j]);
      }
      __syncthreads();
      const int n0 = m1, n1 = imin(m1 + mc, mr.hi);
      const Range nr = Range{imax(n0 * S - S, dyr.lo), imin(n1 * S + 2 * S, dyr.hi)};
      if (n0 < mr.hi) {
#pragma unroll
        for (int j = 0; j < kPre; ++j) {
          const int t = nr.lo + warp + kWarps * j;
          pre[j] = (t < nr.hi && lane_ok) ? ldf(dyg + (int64_t)(t - indent) * cin) : 0.f;
        }
      }
      bwd_frames<T, S>(w, G, chunk, cr, m0, m1, cin, mr, own, xb, xr, dxb, dxg, lane_ok);
      m0 = n0;
      m1 = n1;
      cr = nr;
    }
  }
  // tap i takes, from each r, the term of input m - 1 + (r + i) / S
#pragma unroll
  for (int i = 0; i <= 2 * S; ++i) {
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < S; ++r) v += G[r][(r + i) / S];
#pragma unroll
    for (int o = kLanes / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) part[warp * kMaxTaps + i] = v;
  }
}

template <typename T>
__device__ void bwd_dispatch(int s, const float* w_s, const T* dyb, const T* dyg, Range dyr, int cin, int indent,
                             Range mr, Range own, const T* xb, Range xr, T* dxb, T* dxg, float* part, T* chunk,
                             bool lane_ok) {
  switch (s) {
#define WAE_CASE(S)                                                                                   \
  case S:                                                                                             \
    bwd_stage<T, S>(w_s, dyb, dyg, dyr, cin, indent, mr, own, xb, xr, dxb, dxg, part, chunk, lane_ok); \
    break;
    WAE_UP_SCALES(WAE_CASE)
#undef WAE_CASE
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) up_bwd_kernel(Geo g, const T* __restrict__ x, Ptrs<T> p,
                                                                       const T* __restrict__ dy, T* __restrict__ dx,
                                                                       float* __restrict__ work) {
  extern __shared__ float sm[];
  T* st = (T*)((char*)sm + g.tbase);
  const int lane = threadIdx.x % kLanes;
  const int ch = blockIdx.z * kLanes + lane;
  const bool lane_ok = ch < g.cin;
  const int b = blockIdx.y;
  const int64_t slot = blockIdx.x + (int64_t)gridDim.x * (blockIdx.y + (int64_t)gridDim.y * blockIdx.z);
  BlockRanges br;
  block_ranges(g, blockIdx.x, br);
  load_taps(g, p, sm);
  fwd_stages<T>(g, br, g.K - 1, x + (int64_t)b * g.T0 * g.cin + ch, sm, st, lane_ok);
  const int t_out = g.n[g.K] - 2 * g.indent;
  for (int k = g.K; k >= 1; --k) {
    const bool top = k == g.K;
    const Range dyr = top ? Range{g.indent, g.n[g.K] - g.indent} : br.d[k];
    bwd_dispatch<T>(g.s[k - 1], sm + g.taps + g.tap_off[k - 1], top ? nullptr : st + g.dbuf[k],
                    dy + (int64_t)b * t_out * g.cin + ch, dyr, g.cin, g.indent, br.d[k - 1], br.own[k - 1],
                    st + g.ybuf[k - 1], br.y[k - 1], k == 1 ? nullptr : st + g.dbuf[k - 1],
                    dx + (int64_t)b * g.T0 * g.cin + ch, sm + g.parts, st + g.chunk, lane_ok);
    __syncthreads();
    const int nt = 2 * g.s[k - 1] + 1;
    if ((int)threadIdx.x < nt) {
      float v = 0.f;
      for (int wi = 0; wi < kWarps; ++wi) v += sm[g.parts + wi * kMaxTaps + threadIdx.x];
      work[slot * g.tap_off[g.K] + g.tap_off[k - 1] + threadIdx.x] = v;
    }
    __syncthreads();
  }
}

// dw: each tap's slots added in block order, then a fixed tree
template <typename T>
__global__ void __launch_bounds__(kSumThreads) up_wsum_kernel(Geo g, const float* __restrict__ work, int64_t slots,
                                                              Ptrs<T> p) {
  __shared__ float part[kSumThreads];
  const int tap = blockIdx.x, taps = g.tap_off[g.K];
  float v = 0.f;
  for (int64_t i = threadIdx.x; i < slots; i += kSumThreads) v += work[i * taps + tap];
  part[threadIdx.x] = v;
  __syncthreads();
  for (int o = kSumThreads / 2; o > 0; o /= 2) {
    if ((int)threadIdx.x < o) part[threadIdx.x] += part[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int k = 0;
    while (tap >= g.tap_off[k + 1]) ++k;
    stf(p.dw[k] + (tap - g.tap_off[k]), part[0]);
  }
}

dim3 grid_of(const Geo& g, const UpArgs& a) {
  return dim3((unsigned)blocks_x(g), (unsigned)a.B, (unsigned)((a.cin + kLanes - 1) / kLanes));
}

int64_t blocks_of(const Geo& g, const UpArgs& a) {
  const dim3 d = grid_of(g, a);
  return (int64_t)d.x * d.y * d.z;
}

template <typename T>
Ptrs<T> ptrs(const UpArgs& a) {
  Ptrs<T> p{};
  for (int k = 0; k < a.K; ++k) {
    p.w[k] = (const T*)a.w[k];
    p.dw[k] = (T*)a.dw[k];
  }
  return p;
}

template <typename T>
int forward_impl(const UpArgs& a) {
  Geo g;
  int e = plan(a, false, g);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(up_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_bytes);
  if (ce != cudaSuccess) return (int)ce;
  up_fwd_kernel<T><<<grid_of(g, a), kThreads, g.smem_bytes, a.stream>>>(g, (const T*)a.x, ptrs<T>(a), (T*)a.out);
  return (int)cudaGetLastError();
}

template <typename T>
int backward_impl(const UpArgs& a) {
  Geo g;
  int e = plan(a, true, g);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(up_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_bytes);
  if (ce != cudaSuccess) return (int)ce;
  up_bwd_kernel<T><<<grid_of(g, a), kThreads, g.smem_bytes, a.stream>>>(g, (const T*)a.x, ptrs<T>(a),
                                                                         (const T*)a.dy, (T*)a.dx, a.work);
  e = (int)cudaGetLastError();
  if (e) return e;
  up_wsum_kernel<T><<<g.tap_off[g.K], kSumThreads, 0, a.stream>>>(g, a.work, blocks_of(g, a), ptrs<T>(a));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wae_up_forward(const UpArgs* a) {
  return a->bf16 ? forward_impl<__nv_bfloat16>(*a) : forward_impl<float>(*a);
}

extern "C" int wae_up_backward(const UpArgs* a) {
  return a->bf16 ? backward_impl<__nv_bfloat16>(*a) : backward_impl<float>(*a);
}

extern "C" int64_t wae_up_workspace_floats(const UpArgs* a) {
  Geo g;
  return plan(*a, true, g) ? -1 : blocks_of(g, *a) * g.tap_off[g.K];
}

extern "C" const char* wae_up_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
