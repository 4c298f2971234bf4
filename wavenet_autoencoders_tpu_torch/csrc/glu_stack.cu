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
// Every operand of a product is a plain row-major matrix in the storage type
// S, written once by the pass that produces it (its epilogue) or packed once
// per call by the wrapper (the weights, kernels/glu_stack.py:pack_weights):
//   hb  = S(h)                 (B*T, C)    written by out / rebuild
//   act = S(gate(ab_s))        (B*T, G/2)  written by gate (K2), gate_act (K3)
//   dabs = S(dab)              (B*T, G)    written by dact
//   gy  = S(dx / sqrt 2)       (B*T, C)    written by dx
// Some are read shifted by d or 2d rows inside a batch row, zero past its
// edge (the dilated taps). The buffers are reused across layers.
//
// K2, per layer l with dilation d (two launches):
//   gate: ab = [hb[t-2d] | hb[t-d] | hb[t] | S(c)] @ wg[l] + bconv[l] + g_add[b,l]
//         (K = 3C+cin); wg's columns are permuted so that columns 2i, 2i+1 of
//         the product are the gate pair (i, G/2+i), which one thread holds:
//         the epilogue stores ab_s = S(ab) at the original columns and
//         act = S(tanh(ab_s[i]) * sigmoid(ab_s[G/2+i])).
//   out:  skip += act @ wskip[l] + bskip[l], h = (act @ wout[l] + bout[l] + h) / sqrt 2,
//         hb = S(h)
// The final h is written in f32 (the JAX kernel writes it in the storage
// type; in bf16 the backward's inversion, which multiplies the error of h by
// sqrt 2 per layer, then turns that rounding into noise by layer 0).
// K3, walking l = L-1 .. 0 (eleven launches per layer):
//   gate_act: act = S(gate(ab_s[l]))                                (elementwise)
//   rebuild:  h = h*sqrt 2 - (act @ wout[l] + bout[l]), hb = S(h)   (in place)
//   dact:     dab = gate'([gy | S(dskip)] @ [wout | wskip][l]^T), dabs = S(dab)
//   sums:     dgadd[b,l] = sum_t dab, dbconv, dbout, dbskip  (column sums)
//   dW1:      [dwout | dwskip][l] = act^T [gy | S(dskip)]
//   dW2:      [dwconv | dwc][l]   = [hb[t-2d] | hb[t-d] | hb[t] | S(c)]^T dabs
//   dx:       dx = dx/sqrt 2 + [dabs[t+2d] | dabs[t+d] | dabs[t]] @ wx[l],
//             gy = S(dx/sqrt 2); dc += dabs @ wc[l]^T (more columns of wx)
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
// pipelined core (gemm_pipe): 128 x 128 output tiles, a ring of k-stages in
// dynamic shared memory filled by 16-byte cp.async (zero-fill at the edges
// and past a batch row's edge), fragments by ldmatrix (.trans for operands
// whose reduction index is the row), mma.sync m16n8k16 bf16 -> f32 on the
// tensor cores. f32 storage (the accuracy check) runs the same loads and
// epilogues with f32 FMAs on CUDA cores. (wgmma m64n128k16 on the same
// cp.async ring was measured slower for the row passes; TMA-fed,
// warp-specialised wgmma is later work.)
//
// Storage S is f32 or bf16 (template): x, c, weights, ab, skips, dskips and
// the operand buffers above. Biases, g_add, h, skip, dx, dab, dc and all
// gradients are f32. Every width (C, G/2, S, cin) is a multiple of 8 (16-byte
// loads of bf16 operands, 8-column epilogue chunks), which the wrapper checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define MAXL 64
#define NT 256    // threads per GEMM block
#define BM 128    // rows of a GEMM tile
#define BN 128    // columns of a GEMM tile
#define BK 32     // depth of one k-stage
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
  const void* wg;  // (L, G, 3C+cin): gate weights, columns permuted, k contiguous
  const void* wo;  // (L, C+S, G/2): [wout | wskip]^T
  const void* wd;  // (L, G/2, C+S): [wout | wskip]
  const void* wx;  // (L, C+cin, 3G): the dx/dc product's weights, k contiguous
  const float* bconv;
  const float* bout;
  const float* bskip;
  float* h;
  float* skip;
  void* skips;
  void* ab;
  void* hb;
  void* act;
  const void* dskips;
  float* dx;
  float* dab;
  void* dabs;
  void* gy;
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
static int64_t col_width(const GluArgs& a) {  // widest column sum: dab, dres or dskip
  const int64_t n = a.G > a.C ? a.G : a.C;
  return n > a.S ? n : a.S;
}
static int64_t part_floats(const GluArgs& a) {  // per (b, time chunk), then per b
  return a.B * (n_t_chunks(a) + 1) * col_width(a);
}

// ---- storage-type helpers -------------------------------------------------
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// 8 (or 4) consecutive values in the storage type: 16 (8) bytes in bf16
__device__ __forceinline__ void ld8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    v[2 * k] = f.x, v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st8(float* p, const float* v) { st4(p, v), st4(p + 4, v + 4); }
__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf2(v[0], v[1]), pack_bf2(v[2], v[3]));
}
__device__ __forceinline__ void st8(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf2(v[0], v[1]), pack_bf2(v[2], v[3]), pack_bf2(v[4], v[5]), pack_bf2(v[6], v[7]));
}
template <typename S>
__device__ __forceinline__ float rnd(float v);  // round to storage precision
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// ---- operands: row-major matrices in segments of columns --------------------
// Column c of an operand lies in segment j (start[j] <= c < start[j+1]) and
// row r reads p[j][(r - shift[j]) * ld[j] + c - start[j]]. A segment with a
// shift reads zero where t - shift, t = r mod T, leaves [0, T): the rows are
// (b, t) and a shifted tap does not cross into another batch row. Segment
// widths are multiples of 8 values, so one 16-byte chunk never straddles two.
template <typename S>
struct Operand {
  const S* p[4];
  int64_t ld[4];
  int start[5];  // start[nseg] = width
  int shift[4];
  int nseg, width, T;
};

template <typename S>
static void add_seg(Operand<S>& o, const void* p, int64_t ld, int w, int shift) {
  const int j = o.nseg++;
  o.p[j] = (const S*)p, o.ld[j] = ld, o.start[j] = o.width, o.shift[j] = shift;
  o.width += w;
  o.start[j + 1] = o.width;
}

template <typename S>
static Operand<S> operand(int T) {
  Operand<S> o{};
  o.T = T;
  return o;
}

// Shared-memory geometry of one k-stage of depth KD. A tile stored with the
// reduction index contiguous is [128][KD + pad] (A of a row pass, or the
// packed weights as B); one whose reduction index is the row is [KD][128 +
// pad] (read with ldmatrix.trans). The pad of one 16-byte chunk puts the 8
// rows an ldmatrix reads on 8 different bank quads.
template <typename S, int KD = BK>
struct Tile {
  static constexpr int E = 16 / sizeof(S);  // elements per 16-byte chunk
  static constexpr int ROW_K = KD + E;      // row stride of a [128][KD] tile
  static constexpr int ROW_W = BM + E;      // row stride of a [KD][128] tile
  static constexpr int OPER = BM * ROW_K > KD * ROW_W ? BM * ROW_K : KD * ROW_W;
  static constexpr int STAGES = sizeof(S) == 2 ? (KD == BK ? 4 : 3) : 2;
  static constexpr int SMEM = STAGES * 2 * OPER * (int)sizeof(S);
};
// A pass's stage depth: bf16 row passes read 2 BK = 128 bytes (a cache
// line) of each A and B row a stage; the weight gradients read 256 bytes of
// each of BK rows.
template <class Op>
struct Geo {
  using S = typename Op::Store;
  static constexpr int KD = std::is_same<S, __nv_bfloat16>::value && !Op::WGRAD ? 2 * BK : BK;
  using T = Tile<S, KD>;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// 16 bytes from global to shared memory, asynchronously; zeros when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The fields of segment j of o, selected without indexing the parameter
// arrays by a runtime value.
template <typename S>
struct SegView {
  const S* p;
  int64_t ld;
  int start, width, shift;
};
template <typename S>
__device__ __forceinline__ SegView<S> seg_of(const Operand<S>& o, int j) {
  SegView<S> v{o.p[0], o.ld[0], 0, o.start[1], o.shift[0]};
#pragma unroll
  for (int s = 1; s < 4; ++s)
    if (s == j) v.p = o.p[s], v.ld = o.ld[s], v.start = o.start[s], v.width = o.start[s + 1] - o.start[s],
               v.shift = o.shift[s];
  return v;
}
// The segment that holds column c.
template <typename S>
__device__ __forceinline__ int seg_at(const Operand<S>& o, int c) {
  int j = 0;
#pragma unroll
  for (int s = 1; s < 4; ++s) j += s < o.nseg && c >= o.start[s];
  return j;
}

// One thread's share of a [128 rows][KD columns] tile whose rows stay fixed
// while the columns (the reduction index) advance: A of a row pass (rows m)
// and its packed weights (rows n). The row pointer and the rows' validity
// are set once per segment; a stage then costs one add and one compare per
// 16-byte chunk.
template <typename S, int KD>
struct RowSide {
  static constexpr int E = Tile<S, KD>::E, CPR = KD / E, U = BM * CPR / NT, RSTEP = NT / CPR;
  const S* base;  // column cc() of row r0 + rr(0) - shift of the segment
  int64_t step;   // RSTEP rows
  bool ok[U];
  __device__ __forceinline__ static int rr(int u) { return (int)threadIdx.x / CPR + u * RSTEP; }
  __device__ __forceinline__ static int cc() { return (int)(threadIdx.x % CPR) * E; }
  // rows r0 + rr(u) of segment v
  __device__ __forceinline__ void point(const SegView<S>& v, int T, int r0, int rlim) {
    const int t0 = v.shift != 0 ? r0 % T : 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = r0 + rr(u) < rlim;
      if (v.shift != 0) {
        int t = t0 + rr(u);
        while (t >= T) t -= T;
        ok[u] = ok[u] && (unsigned)(t - v.shift) < (unsigned)T;
      }
    }
    base = v.p + (int64_t)(r0 + rr(0) - v.shift) * v.ld + cc();
    step = (int64_t)RSTEP * v.ld;
  }
  // columns [c, c + KD) of the segment, those at or past w read as zeros
  // (safe: any valid address, for the chunks that read nothing)
  __device__ __forceinline__ void load(S* sm, int c, int w, const S* safe) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool v = ok[u] && c + cc() < w;
      cp_async16(sm + rr(u) * Tile<S, KD>::ROW_K + cc(), v ? base + u * step + c : safe, v);
    }
  }
};

// One thread's share of a [BK rows][128 columns] tile whose columns stay
// fixed while the rows (the reduction index) advance: both operands of a
// weight-gradient pass. A thread's columns lie in one segment for the whole
// block; its pointer and time index step by BK rows a stage.
template <typename S>
struct ColSide {
  static constexpr int E = Tile<S>::E, CPR = BM / E, U = BK * CPR / NT, RSTEP = NT / CPR;
  const S* p;  // row k0 + rr(0) - shift of this thread's column chunk
  int64_t ld;
  int t[U], shift, T;
  bool cok;
  __device__ __forceinline__ static int rr(int u) { return (int)threadIdx.x / CPR + u * RSTEP; }
  __device__ __forceinline__ static int cc() { return (int)(threadIdx.x % CPR) * E; }
  __device__ __forceinline__ void init(const Operand<S>& o, int c0, int k0) {
    const int c = c0 + cc();
    cok = c < o.width;
    const SegView<S> v = seg_of(o, seg_at(o, c));
    p = v.p + (int64_t)(k0 + rr(0) - v.shift) * v.ld + (c - v.start);
    ld = v.ld, shift = v.shift, T = o.T;
#pragma unroll
    for (int u = 0; u < U; ++u) t[u] = (k0 + rr(u)) % T;
  }
  // rows [r0, r0 + BK), those at or past k1 read as zeros (from safe, any
  // valid address); then step BK rows
  __device__ __forceinline__ void load(S* sm, int r0, int k1, const S* safe) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool v = cok && r0 + rr(u) < k1 && (unsigned)(t[u] - shift) < (unsigned)T;
      cp_async16(sm + rr(u) * Tile<S>::ROW_W + cc(), v ? p + (int64_t)u * RSTEP * ld : safe, v);
      t[u] += BK;
      while (t[u] >= T) t[u] -= T;
    }
    p += BK * ld;
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// D += A(16x16, row-major) * B(16x8, column-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- the pipelined product core --------------------------------------------
// C[m, n] = sum_k A[m, k] B[k, n], then op.epi(z, op.row(m), m, n, &C[m, n])
// for every valid m and every valid n that is a multiple of 8, on the 8
// values C[m, n .. n + 7] (every N is a multiple of 8). Two kinds of pass
// (Op::WGRAD):
// - a row pass: A's rows are data rows m, its columns the reduction index k,
//   walked segment by segment (each padded with zeros to a multiple of KD);
//   B is packed weights, rows n and columns k.
// - a weight-gradient pass: the reduction index is the data row r, over the
//   chunk [k0, k1) of blockIdx.z; A's columns are m (stored [k][m], read with
//   ldmatrix.trans) and B's columns n.
// bf16: 8 warps in a 2 x 4 grid, each a 64 x 32 tile of 4 x 4 m16n8
// fragments, on the tensor cores. f32: a 16 x 16 thread grid, 8 x 8 outputs
// each, FMAs on CUDA cores.
template <class Op>
__global__ void __launch_bounds__(NT, sizeof(typename Op::Store) == 2 ? 2 : 1) gemm_pipe(const Op op) {
  using S = typename Op::Store;
  using TL = typename Geo<Op>::T;
  constexpr int KD = Geo<Op>::KD, STAGES = TL::STAGES, OPER = TL::OPER;
  constexpr bool TC = std::is_same<S, __nv_bfloat16>::value, WG = Op::WGRAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sm = reinterpret_cast<S*>(smem_raw);
  // a row pass's column tiles are neighbours in launch order, so that they
  // find their A rows in L2
  const int m0 = (WG ? blockIdx.x : blockIdx.y) * BM, n0 = (WG ? blockIdx.y : blockIdx.x) * BN;

  // the loaders and the number of k-stages
  RowSide<S, KD> ra, rb;
  ColSide<S> ca, cb;
  int nk = 0, k0 = 0, k1 = 0;
  if constexpr (WG) {
    k0 = blockIdx.z * op.chunk;
    k1 = min(op.K, k0 + op.chunk);
    nk = (k1 - k0 + BK - 1) / BK;
    ca.init(op.A, m0, k0);
    cb.init(op.B, n0, k0);
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s >= op.first_seg(n0) && s < op.A.nseg) nk += (seg_of(op.A, s).width + KD - 1) / KD;
    rb.point(seg_of(op.B, 0), op.B.T, n0, op.N);
  }
  // the next stage to load: A's segment lj, its columns from loff
  int lj = WG ? 0 : op.first_seg(n0), loff = 0, lk = k0;
  SegView<S> lseg = seg_of(op.A, lj);
  auto load = [&](int it) {
    S* a = sm + (it % STAGES) * 2 * OPER;
    S* b = a + OPER;
    if constexpr (WG) {
      ca.load(a, lk, k1, op.A.p[0]);
      cb.load(b, lk, k1, op.B.p[0]);
      lk += BK;
    } else {
      if (loff == 0) ra.point(lseg, op.A.T, m0, op.M);
      ra.load(a, loff, lseg.width, op.A.p[0]);
      rb.load(b, lseg.start + loff, op.B.width, op.B.p[0]);
      loff += KD;
      if (loff >= lseg.width) lseg = seg_of(op.A, ++lj), loff = 0;
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;                 // tensor-core warp grid
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // CUDA-core thread grid

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage it has landed; every warp is done with stage it - 1
    if (it + STAGES - 1 < nk) load(it + STAGES - 1);
    cp_commit();
    const S* As = sm + (it % STAGES) * 2 * OPER;
    const S* Bs = As + OPER;
    if constexpr (TC) {
#pragma unroll
      for (int ks = 0; ks < KD; ks += 16) {
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mb = wm * 64 + i * 16;
          if (WG)
            ldsm_x4_t(af[i], As + (ks + (lane & 7) + ((lane >> 4) << 3)) * TL::ROW_W + mb + ((lane >> 3) & 1) * 8);
          else
            ldsm_x4(af[i], As + (mb + (lane & 15)) * TL::ROW_K + ks + (lane >> 4) * 8);
        }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int nb = wn * 32 + jp * 16;
          uint32_t r[4];
          if (WG)
            ldsm_x4_t(r, Bs + (ks + (lane & 7) + (((lane >> 3) & 1) << 3)) * TL::ROW_W + nb + (lane >> 4) * 8);
          else
            ldsm_x4(r, Bs + (nb + (lane & 7) + ((lane >> 4) << 3)) * TL::ROW_K + ks + ((lane >> 3) & 1) * 8);
          bf[2 * jp][0] = r[0], bf[2 * jp][1] = r[1], bf[2 * jp + 1][0] = r[2], bf[2 * jp + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc + (i * 4 + j) * 4, af[i], bf[j]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < KD; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int mm = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
          const int nn = (i < 4 ? 0 : 64) + tx * 4 + (i & 3);
          a[i] = ld(WG ? As + kk * TL::ROW_W + mm : As + mm * TL::ROW_K + kk);
          b[i] = ld(WG ? Bs + kk * TL::ROW_W + nn : Bs + nn * TL::ROW_K + kk);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(a[i], b[j], acc[i * 8 + j]);
      }
    }
  }

  // the accumulators go through shared memory, so that the epilogue walks
  // whole rows: 8 columns (16 or 32 bytes of each output) a thread, two rows
  // a warp
  cp_wait<0>();
  __syncthreads();
  float* cs = reinterpret_cast<float*>(smem_raw);
  constexpr int CS = BN + 4;
  if constexpr (TC) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* v = acc + (i * 4 + j) * 4 + 2 * h;
          *reinterpret_cast<float2*>(cs + (wm * 64 + i * 16 + gid + 8 * h) * CS + wn * 32 + j * 8 + tig * 2) =
              make_float2(v[0], v[1]);
        }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* row = cs + ((i < 4 ? 0 : 64) + ty * 4 + (i & 3)) * CS + tx * 4;
      st4(row, acc + i * 8);
      st4(row + 64, acc + i * 8 + 4);
    }
  }
  __syncthreads();
#pragma unroll 2
  for (int q = threadIdx.x; q < BM * BN / 8; q += NT) {
    const int ml = q / (BN / 8), nl = q % (BN / 8) * 8, m = m0 + ml, n = n0 + nl;
    if (m >= op.M || n >= op.N) continue;
    float v[8];
    ld8(cs + ml * CS + nl, v);
    op.epi(blockIdx.z, op.row(m), m, n, v);
  }
}

template <class Op>
static cudaError_t launch_gemm(const Op& op, int nz, cudaStream_t st) {
  constexpr int smem = Geo<Op>::T::SMEM > BM * (BN + 4) * 4 ? Geo<Op>::T::SMEM : BM * (BN + 4) * 4;
  cudaError_t e = cudaFuncSetAttribute(gemm_pipe<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const unsigned mt = (op.M + BM - 1) / BM, nt = (op.N + BN - 1) / BN;
  const dim3 grid = Op::WGRAD ? dim3(mt, nt, nz) : dim3(nt, mt, 1);
  gemm_pipe<Op><<<grid, NT, smem, st>>>(op);
  return cudaGetLastError();
}

// What every pass has: the product's shape and its operands. A
// weight-gradient pass (WGRAD) sums the reduction rows [z * chunk, min(K, (z
// + 1) * chunk)) in block z; a row pass takes all of K in one block.
template <typename S>
struct Pass {
  using Store = S;
  int M, N, K, chunk;
  Operand<S> A, B;
  __device__ __forceinline__ int64_t row(int) const { return 0; }
  // the first of A's segments that a column tile from n0 needs (row passes)
  __device__ __forceinline__ int first_seg(int) const { return 0; }
};

// Offset of row m = (b, t) of layer l in ab (B, L, T, G).
__device__ __forceinline__ int64_t ab_offset(int m, int T, int L, int l, int G) {
  const int b = m / T, t = m - b * T;
  return (((int64_t)b * L + l) * T + t) * G;
}

// ---- K2 ---------------------------------------------------------------------
// Columns 2i, 2i+1 of the product are the gate pair (i, G/2 + i): 8 columns
// give 4 gate pairs, stored at columns [i, i+4) and [G/2+i, G/2+i+4) of ab.
template <typename S>
struct GateOp : Pass<S> {
  static constexpr bool WGRAD = false;
  int T, L, l, G;
  const float* bconv;  // layer l's (G)
  const float* gadd;   // (B, L, G) or null
  S* ab;
  S* act;
  struct Row {
    int64_t ab, g;
  };
  __device__ __forceinline__ Row row(int m) const {
    const int b = m / T, t = m - b * T;
    const int64_t bl = (int64_t)b * L + l;
    return {(bl * T + t) * G, bl * G};
  }
  __device__ __forceinline__ void epi(int, Row r, int m, int n, const float* v) const {
    const int i = n >> 1, G2 = G >> 1;
    float va[4], vb[4], g[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      va[k] = v[2 * k] + bconv[i + k], vb[k] = v[2 * k + 1] + bconv[G2 + i + k];
      if (gadd) va[k] += gadd[r.g + i + k], vb[k] += gadd[r.g + G2 + i + k];
      g[k] = tanhf(rnd<S>(va[k])) * sigmoidf(rnd<S>(vb[k]));
    }
    st4(ab + r.ab + i, va);
    st4(ab + r.ab + G2 + i, vb);
    st4(act + (int64_t)m * G2 + i, g);
  }
};

// Columns [0, C): h = (act @ wout + bout + h) / sqrt 2, hb = S(h);
// columns [C, C+SK): the skip sum (stored in S after the last layer).
template <typename S>
struct OutOp : Pass<S> {
  static constexpr bool WGRAD = false;
  int C, SK, first, last;
  const float* bout;
  const float* bskip;
  float* h;
  S* hb;
  float* skip;
  S* skips;
  __device__ __forceinline__ void epi(int, int64_t, int m, int n, const float* v) const {
    float p[8];
    if (n < C) {
      const int64_t o = (int64_t)m * C + n;
      ld8(h + o, p);
#pragma unroll
      for (int k = 0; k < 8; ++k) p[k] = (v[k] + bout[n + k] + p[k]) * RS;
      st8(h + o, p);
      st8(hb + o, p);
    } else {
      const int s = n - C;
      const int64_t o = (int64_t)m * SK + s;
      if (first) {
#pragma unroll
        for (int k = 0; k < 8; ++k) p[k] = 0.0f;
      } else {
        ld8(skip + o, p);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) p[k] += v[k] + bskip[s + k];
      st8(skip + o, p);
      if (last) st8(skips + o, p);
    }
  }
};

template <typename S>
static cudaError_t forward_impl(const GluArgs& a) {
  cudaStream_t st = (cudaStream_t)a.stream;
  const int B = (int)a.B, T = (int)a.T, L = (int)a.L, C = (int)a.C, G = (int)a.G;
  const int G2 = G / 2, SK = (int)a.S, CIN = a.has_c ? (int)a.CIN : 0, M = B * T, K = 3 * C + CIN;
  for (int l = 0; l < L; ++l) {
    const int d = (int)a.dil[l];
    const void* hb = l == 0 ? a.x : a.hb;  // hb = S(x) before the first layer
    GateOp<S> g;
    g.M = M, g.N = G, g.K = K, g.chunk = 0;
    g.A = operand<S>(T);
    add_seg(g.A, hb, C, C, 2 * d);
    add_seg(g.A, hb, C, C, d);
    add_seg(g.A, hb, C, C, 0);
    if (CIN) add_seg(g.A, a.c, CIN, CIN, 0);
    g.B = operand<S>(T);
    add_seg(g.B, (const S*)a.wg + (int64_t)l * G * K, K, K, 0);
    g.T = T, g.L = L, g.l = l, g.G = G;
    g.bconv = a.bconv + (int64_t)l * G;
    g.gadd = a.has_g ? a.g_add : nullptr;
    g.ab = (S*)a.ab, g.act = (S*)a.act;
    cudaError_t e = launch_gemm(g, 1, st);
    if (e != cudaSuccess) return e;

    OutOp<S> o;
    o.M = M, o.N = C + SK, o.K = G2, o.chunk = 0;
    o.A = operand<S>(T);
    add_seg(o.A, a.act, G2, G2, 0);
    o.B = operand<S>(T);
    add_seg(o.B, (const S*)a.wo + (int64_t)l * (C + SK) * G2, G2, G2, 0);
    o.C = C, o.SK = SK, o.first = l == 0, o.last = l == L - 1;
    o.bout = a.bout + (int64_t)l * C, o.bskip = a.bskip + (int64_t)l * SK;
    o.h = a.h, o.hb = (S*)a.hb, o.skip = a.skip, o.skips = (S*)a.skips;
    e = launch_gemm(o, 1, st);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

// ---- K3 ---------------------------------------------------------------------
// act = S(tanh(ab_s[:G/2]) * sigmoid(ab_s[G/2:])) of layer l, 16 bytes a thread.
template <typename S>
__global__ void gate_act_kernel(const S* ab, S* act, int M, int T, int L, int l, int G) {
  constexpr int E = Tile<S>::E;
  const int G2 = G / 2, per_row = G2 / E;
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (int64_t)M * per_row) return;
  const int m = (int)(q / per_row), i = (int)(q - (int64_t)m * per_row) * E;
  const S* row = ab + ab_offset(m, T, L, l, G);
  alignas(16) S va[E], vb[E], vo[E];
  *reinterpret_cast<uint4*>(va) = *reinterpret_cast<const uint4*>(row + i);
  *reinterpret_cast<uint4*>(vb) = *reinterpret_cast<const uint4*>(row + G2 + i);
#pragma unroll
  for (int e = 0; e < E; ++e) st(vo + e, tanhf(ld(va + e)) * sigmoidf(ld(vb + e)));
  *reinterpret_cast<uint4*>(act + (int64_t)m * G2 + i) = *reinterpret_cast<const uint4*>(vo);
}

// rebuild: h = h * sqrt 2 - (act @ wout + bout), in place; hb = S(h).
template <typename S>
struct RebuildOp : Pass<S> {
  static constexpr bool WGRAD = false;
  int C;
  const float* bout;
  float* h;
  S* hb;
  __device__ __forceinline__ void epi(int, int64_t, int m, int n, const float* v) const {
    const int64_t o = (int64_t)m * C + n;
    float p[8];
    ld8(h + o, p);
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = p[k] * IRS - (v[k] + bout[n + k]);
    st8(h + o, p);
    st8(hb + o, p);
  }
};

// dact = [gy | S(dskip)] @ [wout | wskip]^T, then the gate backward into both
// halves of dab (f32) and dabs = S(dab): column n owns the gate pair
// (n, n + G/2).
template <typename S>
struct DactOp : Pass<S> {
  static constexpr bool WGRAD = false;
  int T, L, l, G;
  const S* ab;
  float* dab;
  S* dabs;
  __device__ __forceinline__ int64_t row(int m) const { return ab_offset(m, T, L, l, G); }
  __device__ __forceinline__ void epi(int, int64_t r, int m, int n, const float* v) const {
    const int G2 = G >> 1;
    float a[8], b[8];
    ld8(ab + r + n, a);
    ld8(ab + r + G2 + n, b);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float ta = tanhf(a[k]), sb = sigmoidf(b[k]);
      a[k] = v[k] * (sb * (1.0f - ta * ta));
      b[k] = v[k] * (ta * sb * (1.0f - sb));
    }
    const int64_t o = (int64_t)m * G + n;
    st8(dab + o, a);
    st8(dab + o + G2, b);
    st8(dabs + o, a);
    st8(dabs + o + G2, b);
  }
};

// A weight gradient's partial sum over one chunk of rows, into the chunk's
// slot of the workspace. W1: [dwout | dwskip] = act^T [gy | S(dskip)];
// W2: [dwconv | dwc] = [hb taps | S(c)]^T dabs.
template <typename S>
struct WorkPass : Pass<S> {
  static constexpr bool WGRAD = true;
  float* work;
  __device__ __forceinline__ void epi(int z, int64_t, int i, int n, const float* v) const {
    st8(work + ((int64_t)z * this->M + i) * this->N + n, v);
  }
};
template <typename S>
struct W1Op : WorkPass<S> {};
template <typename S>
struct W2Op : WorkPass<S> {};

// Columns [0, C): dx = dx/sqrt 2 + [dabs[t+2d] | dabs[t+d] | dabs[t]] @ wx,
// gy = S(dx/sqrt 2); columns [C, C+CIN): dc += dabs @ wc^T (wx holds wc^T in
// its unshifted third of k and zeros in the other two).
template <typename S>
struct DxOp : Pass<S> {
  static constexpr bool WGRAD = false;
  int C, CIN, first;
  float* dx;
  S* gy;
  float* dc;
  // a tile of dc columns only: wx is zero in the two shifted taps
  __device__ __forceinline__ int first_seg(int n0) const { return n0 >= C ? 2 : 0; }
  __device__ __forceinline__ void epi(int, int64_t, int m, int n, const float* v) const {
    float p[8];
    if (n < C) {
      const int64_t o = (int64_t)m * C + n;
      ld8(dx + o, p);
#pragma unroll
      for (int k = 0; k < 8; ++k) p[k] = p[k] * RS + v[k];
      st8(dx + o, p);
#pragma unroll
      for (int k = 0; k < 8; ++k) p[k] *= RS;
      st8(gy + o, p);
    } else {
      float* q = dc + (int64_t)m * CIN + (n - C);
      if (first) {
        st8(q, v);
      } else {
        ld8(q, p);
#pragma unroll
        for (int k = 0; k < 8; ++k) p[k] += v[k];
        st8(q, p);
      }
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

// pb[b, n] = sum_tc part[b, tc, n], also into per_b[b * stride + n] when set
__global__ void colsum_batch(const float* part, int n_tc, int N, float* pb, float* per_b, int64_t stride) {
  const int n = blockIdx.x * CT + threadIdx.x, b = blockIdx.y;
  if (n >= N) return;
  float s = 0.0f;
  for (int tc = 0; tc < n_tc; ++tc) s += part[((int64_t)b * n_tc + tc) * N + n];
  pb[(int64_t)b * N + n] = s;
  if (per_b) per_b[(int64_t)b * stride + n] = s;
}

// total[n] = sum_b pb[b, n]
__global__ void colsum_total(const float* pb, int B, int N, float* total) {
  const int n = blockIdx.x * CT + threadIdx.x;
  if (n >= N) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s += pb[(int64_t)b * N + n];
  total[n] = s;
}

template <class X>
static cudaError_t colsum(const X& x, const GluArgs& a, float* part, float* per_b, int64_t stride,
                          float* total, cudaStream_t st) {
  const int n_tc = (int)n_t_chunks(a);
  dim3 grid(n_tc, (unsigned)a.B, (x.N + CT - 1) / CT);
  colsum_partial<X><<<grid, CT, 0, st>>>(x, (int)a.T, T_CHUNK, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  float* pb = part + a.B * n_tc * col_width(a);
  const unsigned nb = (x.N + CT - 1) / CT;
  colsum_batch<<<dim3(nb, (unsigned)a.B), CT, 0, st>>>(part, n_tc, x.N, pb, per_b, stride);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  colsum_total<<<nb, CT, 0, st>>>(pb, (int)a.B, x.N, total);
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
    const S* wo = (const S*)a.wo + (int64_t)l * (C + SK) * G2;

    const int64_t n_act = (int64_t)M * (G2 / Tile<S>::E);
    gate_act_kernel<S><<<(unsigned)((n_act + 255) / 256), 256, 0, st>>>(ab, (S*)a.act, M, T, L, l, G);
    CHECK(cudaGetLastError());

    RebuildOp<S> rb;
    rb.M = M, rb.N = C, rb.K = G2, rb.chunk = 0;
    rb.A = operand<S>(T);
    add_seg(rb.A, a.act, G2, G2, 0);
    rb.B = operand<S>(T);
    add_seg(rb.B, wo, G2, G2, 0);  // the wout rows of [wout | wskip]^T
    rb.C = C, rb.bout = a.bout + (int64_t)l * C, rb.h = a.h, rb.hb = (S*)a.hb;
    CHECK(launch_gemm(rb, 1, st));

    DactOp<S> da;
    da.M = M, da.N = G2, da.K = C + SK, da.chunk = 0;
    da.A = operand<S>(T);
    add_seg(da.A, a.gy, C, C, 0);
    add_seg(da.A, dskips, SK, SK, 0);
    da.B = operand<S>(T);
    add_seg(da.B, (const S*)a.wd + (int64_t)l * G2 * (C + SK), C + SK, C + SK, 0);
    da.T = T, da.L = L, da.l = l, da.G = G, da.ab = ab, da.dab = a.dab, da.dabs = (S*)a.dabs;
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
    w1.M = G2, w1.N = C + SK, w1.K = M, w1.chunk = chunk;
    w1.A = operand<S>(T);
    add_seg(w1.A, a.act, G2, G2, 0);
    w1.B = operand<S>(T);
    add_seg(w1.B, a.gy, C, C, 0);
    add_seg(w1.B, dskips, SK, SK, 0);
    w1.work = a.work;
    CHECK(launch_gemm(w1, nz, st));
    W1Store s1;
    s1.M = G2, s1.N = C + SK, s1.C = C, s1.SK = SK;
    s1.dwout = a.dwout + (int64_t)l * G2 * C, s1.dwskip = a.dwskip + (int64_t)l * G2 * SK;
    CHECK(launch_reduce(s1, a.work, nz, st));

    W2Op<S> w2;
    w2.M = 3 * C + CIN, w2.N = G, w2.K = M, w2.chunk = chunk;
    w2.A = operand<S>(T);
    add_seg(w2.A, a.hb, C, C, 2 * d);
    add_seg(w2.A, a.hb, C, C, d);
    add_seg(w2.A, a.hb, C, C, 0);
    if (CIN) add_seg(w2.A, a.c, CIN, CIN, 0);
    w2.B = operand<S>(T);
    add_seg(w2.B, a.dabs, G, G, 0);
    w2.work = a.work;
    CHECK(launch_gemm(w2, nz, st));
    W2Store s2;
    s2.M = 3 * C + CIN, s2.N = G, s2.C = C, s2.G = G;
    s2.dwconv = a.dwconv + (int64_t)l * 3 * C * G;
    s2.dwc = CIN ? a.dwc + (int64_t)l * CIN * G : nullptr;
    CHECK(launch_reduce(s2, a.work, nz, st));

    DxOp<S> dxo;
    dxo.M = M, dxo.N = C + CIN, dxo.K = 3 * G, dxo.chunk = 0;
    dxo.A = operand<S>(T);
    add_seg(dxo.A, a.dabs, G, G, -2 * d);
    add_seg(dxo.A, a.dabs, G, G, -d);
    add_seg(dxo.A, a.dabs, G, G, 0);
    dxo.B = operand<S>(T);
    add_seg(dxo.B, (const S*)a.wx + (int64_t)l * (C + CIN) * 3 * G, 3 * G, 3 * G, 0);
    dxo.C = C, dxo.CIN = CIN, dxo.first = l == L - 1;
    dxo.dx = a.dx, dxo.gy = (S*)a.gy, dxo.dc = a.dc;
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
