// Fused residual-GLU stack for training on Hopper (sm_90a): the forward (K2)
// and the exact backward (K3) of the whole L-layer stack.
//
// Replaces the TPU kernels of wavenet_autoencoders_tpu/kernels/glu_stack.py:
//   K2  _fwd_pallas (:157, call :197, body _fwd_kernel :67)
//   K3  _bwd_pallas (:355, call :412, body _bwd_kernel :227)
// The TPU kernels keep one batch row's whole (T, C) residual in VMEM across
// all layers (5 MB in f32 at T=5120) and walk the layers inside one grid
// step. An H100 block has 227 KB of shared memory, and a time tile cannot
// carry all layers either (the stack's receptive field is ~4,092 samples),
// so here the layer loop runs on the host inside the C entry point and each
// layer is a few passes over tiles of rows (b, t), with the residual h (f32),
// the skip sum (f32) and the pre-activations ab (storage type) in device
// memory between layers.
//
// K2, per layer l with dilation d (two launches):
//   gate: ab = sum_j S(h[t-(2-j)d]) @ wconv[l,j] + S(c) @ wc[l] + bconv[l]
//              + g_add[b,l], stored as ab_s = S(ab)          (K = 3C+cin)
//   out:  act = S(tanh(ab_s[:G/2]) * sigmoid(ab_s[G/2:])) from the STORED ab,
//         skip += act @ wskip[l] + bskip[l], h = (act @ wout[l] + bout[l] + h) / sqrt 2
// The final h is written in f32 (the JAX kernel writes it in the storage
// type; in bf16 the backward's inversion, which multiplies the error of h by
// sqrt 2 per layer, then turns that rounding into noise by layer 0).
// K3, walking l = L-1 .. 0 (ten launches per layer):
//   rebuild: h = h*sqrt 2 - (act @ wout[l] + bout[l])                (in place)
//   dact:    dab = gate'(S(dx/sqrt 2) @ wout[l]^T + S(dskip) @ wskip[l]^T)
//   sums:    dgadd[b,l] = sum_t dab, dbconv, dbout, dbskip  (column sums)
//   dW1:     [dwout | dwskip][l] = act^T [S(dx/sqrt 2) | S(dskip)]
//   dW2:     [dwconv | dwc][l]   = [S(h[t-(2-j)d]) | S(c)]^T S(dab)
//   dx:      dx = dx/sqrt 2 + sum_j S(dab[t+(2-j)d]) @ wconv[l,j]^T,
//            dc += S(dab) @ wc[l]^T   (one product, K = 3G)
// dx reads dab of FUTURE rows (t + d, t + 2d), which other blocks produce,
// hence the separate launch. The weight gradients are reductions over all
// B*T rows: each block sums a chunk of rows into its own slot of a
// workspace, and a second pass adds the slots in a fixed order, so the
// gradients are deterministic (no float atomics).
//
// What bounds it. At svqwae width (C=256, G=368, S=256, cin=64, L=20) and
// B=40 x T=5120: K2 does 2*(832*368 + 184*512) = 800,768 FLOP per row and
// layer, 3.28 TFLOP in all, 3.32 ms at the 989 TFLOP/s bf16 tensor-core
// peak; the bytes it must write (ab) take 0.90 ms at 3.35 TB/s. K3 does
// 6.95 TFLOP, 7.02 ms. Both are bound by operations. Every product is one
// generic 128x128-tiled GEMM whose operands are produced element by element
// by the pass's loaders (shifts, masks, the gate, storage rounding) into
// shared memory. In bf16 storage every operand is already a bf16 value, so
// the inner loop runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate: the same products as f32 FMAs, summed in another order); in
// f32 storage it runs on CUDA cores in f32 (8x8 outputs per thread). What
// bounds this design is the per-element loaders, not the products;
// wgmma, TMA and vectorised loads are later work.
//
// Storage S is f32 or bf16 (template): x, c, weights, ab, skips, dskips.
// Biases, g_add, h, skip, dx, dab, dc and all gradients are f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define MAXL 64
#define NT 256    // threads per GEMM block: a 16 x 16 grid, 8 x 8 outputs each
#define BM 128    // rows of a GEMM tile
#define BN 128    // columns of a GEMM tile
#define BK 16     // depth of one shared-memory stage (f32 path)
#define BKT 32    // depth of one shared-memory stage (tensor-core path)
#define PADS 4    // padding of the shared tiles' rows
#define CT 128    // threads of a column-sum block
#define CHUNK_ROWS 4096  // rows of (b, t) one block of a weight-gradient product sums
#define T_CHUNK 256      // time steps one block of a column sum sums
#define RS 0.70710678118654752f
#define IRS 1.41421356237309505f

// Mirrored field for field (all 8-byte) by _GluArgs in kernels/glu_stack.py.
struct GluArgs {
  int64_t B, T, L, C, G, S, CIN, store_bf16, has_c, has_g;
  int64_t dil[MAXL];
  const void* x;
  const void* c;
  const float* g_add;
  const void* wconv;
  const float* bconv;
  const void* wc;
  const void* wout;
  const float* bout;
  const void* wskip;
  const float* bskip;
  float* h;
  float* skip;
  void* skips;
  void* ab;
  const void* dskips;
  float* dx;
  float* dab;
  float* dc;
  float* dgadd;
  float* dwconv;
  float* dbconv;
  float* dwc;
  float* dwout;
  float* dbout;
  float* dwskip;
  float* dbskip;
  float* work;  // wae_glu_workspace_floats(args) floats, backward only
  void* stream;
};

// The backward's workspace: the per-chunk partial sums of the largest weight
// gradient (work_floats), then the per-(b, time chunk) column sums.
static int64_t n_row_chunks(const GluArgs& a) { return (a.B * a.T + CHUNK_ROWS - 1) / CHUNK_ROWS; }
static int64_t n_t_chunks(const GluArgs& a) { return (a.T + T_CHUNK - 1) / T_CHUNK; }
static int64_t work_floats(const GluArgs& a) {
  const int64_t cin = a.has_c ? a.CIN : 0;
  const int64_t w1 = a.G / 2 * (a.C + a.S), w2 = (3 * a.C + cin) * a.G;  // W1Op, W2Op: M x N
  return n_row_chunks(a) * (w1 > w2 ? w1 : w2);
}
static int64_t part_floats(const GluArgs& a) {
  const int64_t n = a.G > a.C ? a.G : a.C;  // widest column sum: dab, dres or dskip
  return a.B * n_t_chunks(a) * (n > a.S ? n : a.S);
}

// ---- storage-type helpers -------------------------------------------------
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
template <typename S>
__device__ __forceinline__ float rnd(float v);  // round to storage precision
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }
template <typename S>
__device__ __forceinline__ float gate_act(float a, float b) {
  return rnd<S>(tanhf(a) * sigmoidf(b));
}

// ---- one generic tiled product ---------------------------------------------
// C[m, n] = sum_k A(m, k) * B(k, n) over the k range of blockIdx.z, then
// op.epi(z, m, n, C[m, n]) for every valid (m, n). A and B are read through
// op.a / op.b, which apply the shifts, masks and storage roundings, into
// shared tiles. A_K_CONTIG / B_N_CONTIG say along which index the operand is
// contiguous in memory, so that neighbouring threads load neighbours.
// (Staging a whole stage's loads in registers with a prefetch of the next
// stage was measured slower: it doubled the registers, halving the blocks
// per SM.)

template <class Op>
__global__ void __launch_bounds__(NT) gemm_kernel(const Op op) {
  __shared__ __align__(16) float As[BK][BM + PADS];
  __shared__ __align__(16) float Bs[BK][BN + PADS];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  int k0, k1;
  op.k_range(blockIdx.z, k0, k1);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int kb = k0; kb < k1; kb += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int kk = Op::A_K_CONTIG ? i % BK : i / BM;
      const int mm = Op::A_K_CONTIG ? i / BK : i % BM;
      const int m = m0 + mm, k = kb + kk;
      As[kk][mm] = (m < op.M && k < k1) ? op.a(m, k) : 0.0f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += NT) {
      const int nn = Op::B_N_CONTIG ? i % BN : i / BK;
      const int kk = Op::B_N_CONTIG ? i / BN : i % BK;
      const int n = n0 + nn, k = kb + kk;
      Bs[kk][nn] = (n < op.N && k < k1) ? op.b(k, n) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 60 + ty * 4 + i);
    if (m >= op.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 60 + tx * 4 + j);
      if (n < op.N) op.epi(blockIdx.z, m, n, acc[i][j]);
    }
  }
}

// D += A(16x16, row-major) * B(16x8, column-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The same product on the tensor cores, for operands that are bf16 values
// (bf16 storage): the loaders' f32 results are stored to shared memory as
// bf16 without loss, A as As[m][k] and B as Bs[n][k] (k contiguous, so a
// 32-bit load gives the two k-neighbours an mma fragment register holds).
// 8 warps in a 2 x 4 grid, each a 64 x 32 tile of 4 x 4 m16n8 fragments.
template <class Op>
__global__ void __launch_bounds__(NT) gemm_tc_kernel(const Op op) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][BKT + 8];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][BKT + 8];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  int k0, k1;
  op.k_range(blockIdx.z, k0, k1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3, wm = warp >> 2, wn = warp & 3;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
  for (int kb = k0; kb < k1; kb += BKT) {
    for (int i = threadIdx.x; i < BM * BKT; i += NT) {
      const int kk = Op::A_K_CONTIG ? i % BKT : i / BM;
      const int mm = Op::A_K_CONTIG ? i / BKT : i % BM;
      const int m = m0 + mm, k = kb + kk;
      As[mm][kk] = __float2bfloat16((m < op.M && k < k1) ? op.a(m, k) : 0.0f);
    }
    for (int i = threadIdx.x; i < BKT * BN; i += NT) {
      const int nn = Op::B_N_CONTIG ? i % BN : i / BKT;
      const int kk = Op::B_N_CONTIG ? i / BN : i % BKT;
      const int n = n0 + nn, k = kb + kk;
      Bs[nn][kk] = __float2bfloat16((n < op.N && k < k1) ? op.b(k, n) : 0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BKT; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + gid;
        af[i][0] = ld32(&As[r][ks + tig * 2]);
        af[i][1] = ld32(&As[r + 8][ks + tig * 2]);
        af[i][2] = ld32(&As[r][ks + tig * 2 + 8]);
        af[i][3] = ld32(&As[r + 8][ks + tig * 2 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + gid;
        bf[j][0] = ld32(&Bs[n][ks + tig * 2]);
        bf[j][1] = ld32(&Bs[n][ks + tig * 2 + 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + gid + 8 * h;
      if (m >= op.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + tig * 2;
        if (n < op.N) op.epi(blockIdx.z, m, n, acc[i][j][2 * h]);
        if (n + 1 < op.N) op.epi(blockIdx.z, m, n + 1, acc[i][j][2 * h + 1]);
      }
    }
  }
}

// bf16 storage runs on the tensor cores, f32 storage on CUDA cores.
template <class Op>
static cudaError_t launch_gemm(const Op& op, int nz, cudaStream_t st) {
  dim3 grid((op.M + BM - 1) / BM, (op.N + BN - 1) / BN, nz);
  if constexpr (std::is_same<typename Op::Store, __nv_bfloat16>::value)
    gemm_tc_kernel<Op><<<grid, NT, 0, st>>>(op);
  else
    gemm_kernel<Op><<<grid, NT, 0, st>>>(op);
  return cudaGetLastError();
}

// The whole depth K in one block (no split).
struct FullK {
  int K;
  __device__ __forceinline__ void k_range(int, int& k0, int& k1) const { k0 = 0, k1 = K; }
};
// Chunk z of the rows (the reduction index of a weight gradient).
struct ChunkK {
  int K, chunk;
  __device__ __forceinline__ void k_range(int z, int& k0, int& k1) const {
    k0 = z * chunk;
    k1 = min(K, k0 + chunk);
  }
};

// Row m of layer l's ab: ab[b, l, t, :].
template <typename S>
__device__ __forceinline__ const S* ab_row(const S* ab, int m, int T, int L, int l, int G) {
  const int b = m / T, t = m - b * T;
  return ab + (((int64_t)b * L + l) * T + t) * G;
}

// ---- K2 ---------------------------------------------------------------------
template <typename S>
struct GateOp : FullK {
  static constexpr bool A_K_CONTIG = true, B_N_CONTIG = true;
  using Store = S;
  int M, N, T, C, CIN, G, L, l, d;
  const float* h;
  const S* c;
  const S* w;   // wconv[l] as (3C, G)
  const S* wc;  // wc[l] (CIN, G)
  const float* bconv;
  const float* gadd;  // (B, L, G) or null
  S* ab;
  __device__ float a(int m, int k) const {
    if (k < 3 * C) {
      const int j = k / C, cc = k - j * C, t = m % T, tt = t - (2 - j) * d;
      return tt >= 0 ? rnd<S>(h[(int64_t)(m - t + tt) * C + cc]) : 0.0f;
    }
    return ld(c + (int64_t)m * CIN + (k - 3 * C));
  }
  __device__ float b(int k, int n) const {
    return k < 3 * C ? ld(w + (int64_t)k * G + n) : ld(wc + (int64_t)(k - 3 * C) * G + n);
  }
  __device__ void epi(int, int m, int n, float acc) const {
    const int bb = m / T, t = m - bb * T;
    float v = acc + bconv[n];
    if (gadd) v += gadd[((int64_t)bb * L + l) * G + n];
    st(ab + (((int64_t)bb * L + l) * T + t) * G + n, v);
  }
};

template <typename S>
struct OutOp : FullK {
  static constexpr bool A_K_CONTIG = true, B_N_CONTIG = true;
  using Store = S;
  int M, N, T, C, SK, G, L, l, first, last;
  const S* ab;
  const S* wout;   // (G/2, C)
  const S* wskip;  // (G/2, SK)
  const float* bout;
  const float* bskip;
  float* h;
  float* skip;
  S* skips;
  __device__ float a(int m, int k) const {
    const S* row = ab_row(ab, m, T, L, l, G);
    return gate_act<S>(ld(row + k), ld(row + k + G / 2));
  }
  __device__ float b(int k, int n) const {
    return n < C ? ld(wout + (int64_t)k * C + n) : ld(wskip + (int64_t)k * SK + (n - C));
  }
  __device__ void epi(int, int m, int n, float acc) const {
    if (n < C) {
      float* p = h + (int64_t)m * C + n;
      *p = (acc + bout[n] + *p) * RS;
    } else {
      const int s = n - C;
      float* p = skip + (int64_t)m * SK + s;
      const float v = first ? acc + bskip[s] : *p + (acc + bskip[s]);
      *p = v;
      if (last) st(skips + (int64_t)m * SK + s, v);
    }
  }
};

template <typename S>
static cudaError_t forward_impl(const GluArgs& a) {
  cudaStream_t st = (cudaStream_t)a.stream;
  const int B = (int)a.B, T = (int)a.T, L = (int)a.L, C = (int)a.C, G = (int)a.G;
  const int G2 = G / 2, SK = (int)a.S, CIN = a.has_c ? (int)a.CIN : 0, M = B * T;
  for (int l = 0; l < L; ++l) {
    GateOp<S> g;
    g.K = 3 * C + CIN, g.M = M, g.N = G, g.T = T, g.C = C, g.CIN = CIN, g.G = G, g.L = L, g.l = l;
    g.d = (int)a.dil[l];
    g.h = a.h, g.c = (const S*)a.c;
    g.w = (const S*)a.wconv + (int64_t)l * 3 * C * G;
    g.wc = CIN ? (const S*)a.wc + (int64_t)l * CIN * G : nullptr;
    g.bconv = a.bconv + (int64_t)l * G;
    g.gadd = a.has_g ? a.g_add : nullptr;
    g.ab = (S*)a.ab;
    cudaError_t e = launch_gemm(g, 1, st);
    if (e != cudaSuccess) return e;
    OutOp<S> o;
    o.K = G2, o.M = M, o.N = C + SK, o.T = T, o.C = C, o.SK = SK, o.G = G, o.L = L, o.l = l;
    o.first = l == 0, o.last = l == L - 1;
    o.ab = (const S*)a.ab;
    o.wout = (const S*)a.wout + (int64_t)l * G2 * C;
    o.wskip = (const S*)a.wskip + (int64_t)l * G2 * SK;
    o.bout = a.bout + (int64_t)l * C, o.bskip = a.bskip + (int64_t)l * SK;
    o.h = a.h, o.skip = a.skip, o.skips = (S*)a.skips;
    e = launch_gemm(o, 1, st);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

// ---- K3 ---------------------------------------------------------------------
// rebuild: h = h * sqrt 2 - (act @ wout + bout), in place.
template <typename S>
struct RebuildOp : FullK {
  static constexpr bool A_K_CONTIG = true, B_N_CONTIG = true;
  using Store = S;
  int M, N, T, C, G, L, l;
  const S* ab;
  const S* wout;
  const float* bout;
  float* h;
  __device__ float a(int m, int k) const {
    const S* row = ab_row(ab, m, T, L, l, G);
    return gate_act<S>(ld(row + k), ld(row + k + G / 2));
  }
  __device__ float b(int k, int n) const { return ld(wout + (int64_t)k * C + n); }
  __device__ void epi(int, int m, int n, float acc) const {
    float* p = h + (int64_t)m * C + n;
    *p = *p * IRS - (acc + bout[n]);
  }
};

// dact = S(dx/sqrt 2) @ wout^T + S(dskip) @ wskip^T, then the gate backward
// into both halves of dab (lane n owns the gate pair n, n + G/2).
template <typename S>
struct DactOp : FullK {
  static constexpr bool A_K_CONTIG = true, B_N_CONTIG = false;
  using Store = S;
  int M, N, T, C, SK, G, L, l;
  const float* dx;
  const S* dskips;
  const S* ab;
  const S* wout;
  const S* wskip;
  float* dab;
  __device__ float a(int m, int k) const {
    return k < C ? rnd<S>(dx[(int64_t)m * C + k] * RS) : ld(dskips + (int64_t)m * SK + (k - C));
  }
  __device__ float b(int k, int n) const {
    return k < C ? ld(wout + (int64_t)n * C + k) : ld(wskip + (int64_t)n * SK + (k - C));
  }
  __device__ void epi(int, int m, int n, float acc) const {
    const S* row = ab_row(ab, m, T, L, l, G);
    const float ta = tanhf(ld(row + n)), sb = sigmoidf(ld(row + n + G / 2));
    float* q = dab + (int64_t)m * G;
    q[n] = acc * (sb * (1.0f - ta * ta));
    q[n + G / 2] = acc * (ta * sb * (1.0f - sb));
  }
};

// Partial [dwout | dwskip] over one chunk of rows: rows i of act^T, columns
// [S(dx/sqrt 2) | S(dskip)].
template <typename S>
struct W1Op : ChunkK {
  static constexpr bool A_K_CONTIG = false, B_N_CONTIG = true;
  using Store = S;
  int M, N, T, C, SK, G, L, l;
  const S* ab;
  const float* dx;
  const S* dskips;
  float* work;
  __device__ float a(int i, int r) const {
    const S* row = ab_row(ab, r, T, L, l, G);
    return gate_act<S>(ld(row + i), ld(row + i + G / 2));
  }
  __device__ float b(int r, int n) const {
    return n < C ? rnd<S>(dx[(int64_t)r * C + n] * RS) : ld(dskips + (int64_t)r * SK + (n - C));
  }
  __device__ void epi(int z, int i, int n, float acc) const {
    work[((int64_t)z * M + i) * N + n] = acc;
  }
};

// Partial [dwconv | dwc] over one chunk of rows: rows i of [S(h shifted by
// (2-j)d) | S(c)]^T, columns S(dab).
template <typename S>
struct W2Op : ChunkK {
  static constexpr bool A_K_CONTIG = false, B_N_CONTIG = true;
  using Store = S;
  int M, N, T, C, CIN, G, d;
  const float* h;
  const S* c;
  const float* dab;
  float* work;
  __device__ float a(int i, int r) const {
    if (i < 3 * C) {
      const int j = i / C, cc = i - j * C, t = r % T, tt = t - (2 - j) * d;
      return tt >= 0 ? rnd<S>(h[(int64_t)(r - t + tt) * C + cc]) : 0.0f;
    }
    return ld(c + (int64_t)r * CIN + (i - 3 * C));
  }
  __device__ float b(int r, int n) const { return rnd<S>(dab[(int64_t)r * G + n]); }
  __device__ void epi(int z, int i, int n, float acc) const {
    work[((int64_t)z * M + i) * N + n] = acc;
  }
};

// dx = dx/sqrt 2 + sum_j S(dab[t+(2-j)d]) @ wconv[l,j]^T (zero past T) in
// columns [0, C); dc += S(dab[t]) @ wc^T in columns [C, C+CIN), which is the
// j = 2 (unshifted) block of the same A.
template <typename S>
struct DxOp : FullK {
  static constexpr bool A_K_CONTIG = true, B_N_CONTIG = false;
  using Store = S;
  int M, N, T, C, CIN, G, d, first;
  const float* dab;
  const S* w;   // wconv[l] (3, C, G)
  const S* wc;  // wc[l] (CIN, G)
  float* dx;
  float* dc;
  __device__ float a(int m, int k) const {
    const int j = k / G, g = k - j * G, t = m % T, tt = t + (2 - j) * d;
    return tt < T ? rnd<S>(dab[(int64_t)(m - t + tt) * G + g]) : 0.0f;
  }
  __device__ float b(int k, int n) const {
    const int j = k / G, g = k - j * G;
    if (n < C) return ld(w + ((int64_t)j * C + n) * G + g);
    return j == 2 ? ld(wc + (int64_t)(n - C) * G + g) : 0.0f;
  }
  __device__ void epi(int, int m, int n, float acc) const {
    if (n < C) {
      float* p = dx + (int64_t)m * C + n;
      *p = *p * RS + acc;
    } else {
      float* q = dc + (int64_t)m * CIN + (n - C);
      *q = first ? acc : *q + acc;
    }
  }
};

// ---- the second pass of a weight gradient: add the chunks in order ----------
struct W1Store {
  int M, N, C, SK;
  float* dwout;
  float* dwskip;
  __device__ void store(int i, int n, float s) const {
    if (n < C) dwout[(int64_t)i * C + n] = s;
    else dwskip[(int64_t)i * SK + (n - C)] = s;
  }
};
struct W2Store {
  int M, N, C, G;
  float* dwconv;
  float* dwc;
  __device__ void store(int i, int n, float s) const {
    if (i < 3 * C) dwconv[(int64_t)i * G + n] = s;
    else dwc[(int64_t)(i - 3 * C) * G + n] = s;
  }
};

template <class R>
__global__ void reduce_kernel(const R r, const float* work, int nz) {
  const int64_t mn = (int64_t)r.M * r.N;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  float s = 0.0f;
  for (int z = 0; z < nz; ++z) s += work[(int64_t)z * mn + idx];
  r.store((int)(idx / r.N), (int)(idx % r.N), s);
}

template <class R>
static cudaError_t launch_reduce(const R& r, const float* work, int nz, cudaStream_t st) {
  const int64_t mn = (int64_t)r.M * r.N;
  reduce_kernel<R><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(r, work, nz);
  return cudaGetLastError();
}

// ---- column sums over time, per batch row and in total, in a fixed order -----
struct DabCol {
  int N;
  const float* dab;
  __device__ float operator()(int m, int n) const { return dab[(int64_t)m * N + n]; }
};
struct DresCol {
  int N;
  const float* dx;
  __device__ float operator()(int m, int n) const { return dx[(int64_t)m * N + n] * RS; }
};
template <typename S>
struct DskipCol {
  int N;
  const S* dskips;
  __device__ float operator()(int m, int n) const { return ld(dskips + (int64_t)m * N + n); }
};

// part[b, tc, n] = sum over t in chunk tc of x(b*T + t, n)
template <class X>
__global__ void colsum_partial(const X x, int T, int t_chunk, float* part) {
  const int n = blockIdx.z * CT + threadIdx.x;
  if (n >= x.N) return;
  const int b = blockIdx.y, tc = blockIdx.x;
  const int t0 = tc * t_chunk, t1 = min(T, t0 + t_chunk);
  float s = 0.0f;
  for (int t = t0; t < t1; ++t) s += x(b * T + t, n);
  part[((int64_t)b * gridDim.x + tc) * x.N + n] = s;
}

// per_b[b * stride + n] = sum_tc part[b, tc, n] (when per_b is set);
// total[n] = sum_b of those.
__global__ void colsum_final(const float* part, int B, int n_tc, int N, float* per_b, int64_t stride,
                             float* total) {
  const int n = blockIdx.x * CT + threadIdx.x;
  if (n >= N) return;
  float tot = 0.0f;
  for (int b = 0; b < B; ++b) {
    float s = 0.0f;
    for (int tc = 0; tc < n_tc; ++tc) s += part[((int64_t)b * n_tc + tc) * N + n];
    if (per_b) per_b[(int64_t)b * stride + n] = s;
    tot += s;
  }
  total[n] = tot;
}

template <class X>
static cudaError_t colsum(const X& x, const GluArgs& a, float* part, float* per_b, int64_t stride,
                          float* total, cudaStream_t st) {
  const int n_tc = (int)n_t_chunks(a);
  dim3 grid(n_tc, (unsigned)a.B, (x.N + CT - 1) / CT);
  colsum_partial<X><<<grid, CT, 0, st>>>(x, (int)a.T, T_CHUNK, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  colsum_final<<<(x.N + CT - 1) / CT, CT, 0, st>>>(part, (int)a.B, n_tc, x.N, per_b, stride, total);
  return cudaGetLastError();
}

template <typename S>
static cudaError_t backward_impl(const GluArgs& a) {
  cudaStream_t st = (cudaStream_t)a.stream;
  const int B = (int)a.B, T = (int)a.T, L = (int)a.L, C = (int)a.C, G = (int)a.G;
  const int G2 = G / 2, SK = (int)a.S, CIN = a.has_c ? (int)a.CIN : 0, M = B * T;
  const int nz = (int)n_row_chunks(a), chunk = CHUNK_ROWS;
  float* part = a.work + work_floats(a);
  const S* ab = (const S*)a.ab;
  const S* dskips = (const S*)a.dskips;
  cudaError_t e;
#define CHECK(x)                      \
  if ((e = (x)) != cudaSuccess) return e;

  // dbskip is the same sum for every layer
  DskipCol<S> ds;
  ds.N = SK, ds.dskips = dskips;
  float* dbskip_last = a.dbskip + (int64_t)(L - 1) * SK;
  CHECK(colsum(ds, a, part, nullptr, 0, dbskip_last, st));
  for (int l = L - 1; l >= 0; --l) {
    const int d = (int)a.dil[l];
    const S* wout = (const S*)a.wout + (int64_t)l * G2 * C;
    const S* wskip = (const S*)a.wskip + (int64_t)l * G2 * SK;

    RebuildOp<S> rb;
    rb.K = G2, rb.M = M, rb.N = C, rb.T = T, rb.C = C, rb.G = G, rb.L = L, rb.l = l;
    rb.ab = ab, rb.wout = wout, rb.bout = a.bout + (int64_t)l * C, rb.h = a.h;
    CHECK(launch_gemm(rb, 1, st));

    DactOp<S> da;
    da.K = C + SK, da.M = M, da.N = G2, da.T = T, da.C = C, da.SK = SK, da.G = G, da.L = L, da.l = l;
    da.dx = a.dx, da.dskips = dskips, da.ab = ab, da.wout = wout, da.wskip = wskip, da.dab = a.dab;
    CHECK(launch_gemm(da, 1, st));

    DabCol dc;
    dc.N = G, dc.dab = a.dab;
    CHECK(colsum(dc, a, part, a.has_g ? a.dgadd + (int64_t)l * G : nullptr, (int64_t)L * G,
                 a.dbconv + (int64_t)l * G, st));
    DresCol dr;
    dr.N = C, dr.dx = a.dx;
    CHECK(colsum(dr, a, part, nullptr, 0, a.dbout + (int64_t)l * C, st));
    if (l < L - 1)
      CHECK(cudaMemcpyAsync(a.dbskip + (int64_t)l * SK, dbskip_last, SK * sizeof(float),
                            cudaMemcpyDeviceToDevice, st));

    W1Op<S> w1;
    w1.K = M, w1.chunk = chunk, w1.M = G2, w1.N = C + SK, w1.T = T, w1.C = C, w1.SK = SK, w1.G = G;
    w1.L = L, w1.l = l, w1.ab = ab, w1.dx = a.dx, w1.dskips = dskips, w1.work = a.work;
    CHECK(launch_gemm(w1, nz, st));
    W1Store s1;
    s1.M = G2, s1.N = C + SK, s1.C = C, s1.SK = SK;
    s1.dwout = a.dwout + (int64_t)l * G2 * C, s1.dwskip = a.dwskip + (int64_t)l * G2 * SK;
    CHECK(launch_reduce(s1, a.work, nz, st));

    W2Op<S> w2;
    w2.K = M, w2.chunk = chunk, w2.M = 3 * C + CIN, w2.N = G, w2.T = T, w2.C = C, w2.CIN = CIN;
    w2.G = G, w2.d = d, w2.h = a.h, w2.c = (const S*)a.c, w2.dab = a.dab, w2.work = a.work;
    CHECK(launch_gemm(w2, nz, st));
    W2Store s2;
    s2.M = 3 * C + CIN, s2.N = G, s2.C = C, s2.G = G;
    s2.dwconv = a.dwconv + (int64_t)l * 3 * C * G;
    s2.dwc = CIN ? a.dwc + (int64_t)l * CIN * G : nullptr;
    CHECK(launch_reduce(s2, a.work, nz, st));

    DxOp<S> dxo;
    dxo.K = 3 * G, dxo.M = M, dxo.N = C + CIN, dxo.T = T, dxo.C = C, dxo.CIN = CIN, dxo.G = G;
    dxo.d = d, dxo.first = l == L - 1, dxo.dab = a.dab;
    dxo.w = (const S*)a.wconv + (int64_t)l * 3 * C * G;
    dxo.wc = CIN ? (const S*)a.wc + (int64_t)l * CIN * G : nullptr;
    dxo.dx = a.dx, dxo.dc = a.dc;
    CHECK(launch_gemm(dxo, 1, st));
  }
#undef CHECK
  return cudaGetLastError();
}

extern "C" int wae_glu_forward(const GluArgs* args) {
  return (int)(args->store_bf16 ? forward_impl<__nv_bfloat16>(*args) : forward_impl<float>(*args));
}

extern "C" int wae_glu_backward(const GluArgs* args) {
  return (int)(args->store_bf16 ? backward_impl<__nv_bfloat16>(*args) : backward_impl<float>(*args));
}

extern "C" int64_t wae_glu_workspace_floats(const GluArgs* args) {
  return work_floats(*args) + part_floats(*args);
}

extern "C" const char* wae_glu_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
