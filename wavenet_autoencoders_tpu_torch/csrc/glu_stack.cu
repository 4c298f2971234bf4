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
// 6.95 TFLOP, 7.02 ms. Both are bound by operations. Every product but
// two, in bf16 storage K2's gate pass and K3's dx pass (below), runs on one
// pipelined core (gemm_pipe): 128 x 128 output tiles, a ring of k-stages in
// dynamic shared memory filled by 16-byte cp.async (zero-fill at the edges
// and past a batch row's edge), fragments by ldmatrix (.trans for operands
// whose reduction index is the row), mma.sync m16n8k16 bf16 -> f32 on the
// tensor cores. f32 storage (the accuracy check) runs the same loads and
// epilogues with f32 FMAs on CUDA cores. (wgmma m64n128k16 on the same
// cp.async ring, with the same 128-column tiles and per-thread address
// math, was measured slower for the row passes.)
//
// K2's gate pass in bf16 storage has a kernel of its own (gate_tma_wgmma,
// below; kernels/glu_stack.py:gate_route picks it). At svqwae's B=40 x
// T=5120 its products are 2 x 4.1 M rows x 832 x 368 = 2.51 TFLOP a step
// (2.54 ms at 989 TFLOP/s); its stores, bf16 ab and act (1.1 KB a row), 4.5
// GB a step (1.35 ms at 3.35 TB/s). On gemm_pipe (11.4 ms, 22 % of the
// FLOP bound) each 128 x 128 tile re-read the whole 832-deep A for each of
// the 3 column tiles of G = 368 (384 columns) and read 426 KB from L2 (41
// GB a step); its loads were per-thread cp.async with segment and shift
// arithmetic; its products 8 warps of mma.sync. The TMA kernel: one tile
// over all G columns, so A is read once; TMA boxes, so the taps' shifts and
// the zeros past a batch row's edge cost no thread any address arithmetic;
// the weight stage multicast to both blocks of a cluster, so a 128-row tile
// reads 213 KB of A and 306 KB of weights from L2 (26.4 GB a step without
// multicast, 16.6 GB with it); wgmma from shared memory in two consumer
// warpgroups. Its cost is the gate epilogue, which no longer hides behind a
// second block on the SM: tanh and sigmoid of 23.5 K gate pairs a tile
// next to 184 live accumulators a thread. So the consumers store only ab
// and three spare warps compute act from the stored ab while the
// consumers run the next tile's products (the consumers take a third of
// the pairs themselves, between k-steps; see below).
//
// K3's dx pass in bf16 storage has one too (dx_tma_wgmma, below;
// kernels/glu_stack.py:dx_route picks it). At svqwae's B=40 x T=5120 its
// products are 2 x 4.1 M rows x (256 x 1104 + 64 x 368) = 2.51 TFLOP a
// step, 2.54 ms at 989 TFLOP/s; its epilogue's bytes, the f32 read and
// write of dx, the bf16 gy and the f32 read and write of dc (3 KB a row),
// 12.6 GB a step, 3.76 ms at 3.35 TB/s; and dabs, read once, 3.0 GB, 0.9 ms.
// So its floor, ~4.7 ms, is set by bytes, not by products. On gemm_pipe
// (12.05 ms) each 128 x 128 tile re-read A, 1104 deep for the two dx
// column tiles and 368 for the dc tile, ~42 GB a step from L2, with
// mma.sync and per-thread tap arithmetic. The TMA kernel takes the gate
// kernel's answers for the products: one tile over all C + cin columns, so
// the three taps of dabs are read once a tile; TMA boxes for the taps
// (future rows here, zeros past a batch row's end and past G); the weight
// stage multicast over a cluster of two; wgmma in two consumer warpgroups.
// For the epilogue's bytes, the larger part of the floor, its tile is 64
// rows, one consumer warpgroup's, and the two consumers take tiles in
// turns: one's epilogue loads and stores dx, gy and dc while the other
// runs its products, so device memory is busy during the products and not
// after them. The price is weight bytes: a stage serves 64 rows, so a step
// reads ~30 GB from L2 (~20 with 128-row tiles) and its products alone take
// ~6.2 ms (4.5 with 128-row tiles); the whole pass ~7.7 ms (H100 SXM).
//
// Storage S is f32 or bf16 (template): x, c, weights, ab, skips, dskips and
// the operand buffers above. Biases, g_add, h, skip, dx, dab, dc and all
// gradients are f32. Every width (C, G/2, S, cin) is a multiple of 8 (16-byte
// loads of bf16 operands, 8-column epilogue chunks), which the wrapper checks.
#include <cuda.h>
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
  int64_t B, T, L, C, G, S, CIN, store_bf16, has_c, has_g, gate_wg, dx_wg;
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
  int C, CIN, d;       // the taps' widths and dilation (the TMA route's loads)
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
  // the products a, b of gate columns i and G/2 + i, and the pair's biases
  // bi = (bconv[i], bconv[G/2 + i], g_add[i], g_add[G/2 + i]) -> ab's two
  // values va, vb (f32, stored in S): both routes' arithmetic
  __device__ __forceinline__ void sum(float a, float b, float4 bi, float& va, float& vb) const {
    va = a + bi.x, vb = b + bi.y;
    if (gadd) va += bi.z, vb += bi.w;
  }
  __device__ __forceinline__ void epi(int, Row r, int m, int n, const float* v) const {
    const int i = n >> 1, G2 = G >> 1;
    float va[4], vb[4], g[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 bi = make_float4(bconv[i + k], bconv[G2 + i + k], gadd ? gadd[r.g + i + k] : 0.0f,
                                    gadd ? gadd[r.g + G2 + i + k] : 0.0f);
      sum(v[2 * k], v[2 * k + 1], bi, va[k], vb[k]);
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

// ---- K2's gate pass on TMA and wgmma (bf16 storage) ------------------------
// A persistent kernel over 128-row tiles of one batch row each (a ragged
// last tile where T is not a multiple of 128), every tile over all G gate
// columns, in three roles:
// - the producer, one thread of warp 0: TMA loads from 3-D tensor maps
//   (C, T, B) of hb (x at layer 0) and c, one 64-deep box a k-stage, the
//   taps at t0 - 2d, t0 - d and t0 (TMA's out-of-bounds fill gives the zeros
//   past a batch row's edge), and the layer's weight stage from a (K, G, L)
//   map, each half of the gate columns loaded by one block of a cluster of
//   GW_CLUSTER and multicast to both. mbarriers pace the ring of stages:
//   full (the producer's expected bytes) and empty (one arrival a consumer
//   warp of every block of the cluster). It loads the next tile's first
//   stages during the epilogue.
// - the consumers, warpgroups 1 and 2, 64 rows each: wgmma m64 x G/2 x 16
//   twice a k-step, 128-byte swizzled K-major operands in shared memory, the
//   accumulators in registers (G/2 a thread). Then ab = S(product + bconv +
//   g_add) (GateOp::sum; the biases from shared memory, the tile's g_add row
//   fetched during the products), staged a warp at a time for 8-byte
//   stores; and, during the next tile's products, act of the first GW_CACT
//   32-pair chunks, read back from the stored ab.
// - the act warps, warps 1-3: act of the other pairs from the stored ab of
//   a tile, read back through a cp.async ring, while the consumers run the
//   next tile's products; two mbarrier slots hand tiles over (ab stored,
//   act done).
// act = S(tanh(ab_a) sigmoid(ab_b)) from the stored bf16 ab is what
// gemm_pipe's GateOp computes and what K3's gate_act_kernel recomputes, bit for
// bit: sigmoidn is checked against sigmoidf on every bf16 input
// (wae_glu_sigmoid_mismatches).

#define GW_CLUSTER 2    // blocks of a cluster along the rows, sharing the weight stage
#define GW_BM 128       // rows of a tile
#define GW_BK 64        // depth of a k-stage: one 128-byte swizzle row of bf16
#define GW_THREADS 384  // the producer warpgroup, then two consumer warpgroups
#define GW_SROW 72      // bf16 row stride of a warp's staging buffer: 2 x 32 used, no bank conflicts
#define GW_AQ 5         // items an act thread has in flight
#define GW_CACT 2       // 32-pair chunks of the first half whose act the consumers compute (balances the roles)

// Shared memory of the kernel whose tile width (each half of the gate
// columns) is NH: STAGES k-stages of A (128 x 64) and the weights (2 NH x
// 64), the 8 consumer warps' staging buffers, the act warps' ring, the
// biases, then the barriers.
template <int NH>
struct GateGeo {
  static constexpr int A_BYTES = GW_BM * GW_BK * 2, H_BYTES = NH * GW_BK * 2;
  static constexpr int STAGE = A_BYTES + 2 * H_BYTES;
  static constexpr int STG = 8 * 16 * GW_SROW * 2;
  static constexpr int RING = 96 * GW_AQ * 32;  // the act warps' loads in flight: a and b of GW_AQ items a thread
  static constexpr int BIAS = 3 * 2 * NH * 4;     // bconv, then the g_add rows of two tiles (f32)
  static constexpr int STAGES = (232448 - 1024 - STG - RING - BIAS - 128) / STAGE;
  static constexpr int SMEM = 1024 + STAGES * STAGE + STG + RING + BIAS + 16 * STAGES + 32;  // 1024: alignment slack
  static_assert(H_BYTES % 1024 == 0, "each half of the weight stage starts on a swizzle atom");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// an arrival on the barrier at the same offset in block `rank` of the cluster
template <int CL>
__device__ __forceinline__ void mbar_arrive(uint32_t bar, uint32_t rank) {
  if constexpr (CL == 1) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
  } else {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
  }
}
// Spins until the phase of the given parity has completed. A wait past ~8 s
// of SM clock traps: a fault in the pipeline ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (!t0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// TMA: the box at (c0, c1, c2) of map m into shared memory at dst, its bytes
// counted on bar; the multicast form writes the same offsets (dst, bar) in
// every block of the cluster named by mask.
__device__ __forceinline__ void tma3(const CUtensorMap* m, uint32_t dst, uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma3_mc(const CUtensorMap* m, uint32_t dst, uint32_t bar, int c0, int c1, int c2,
                                        uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}
__device__ __forceinline__ void tma4_mc(const CUtensorMap* m, uint32_t dst, uint32_t bar, int c0, int c1, int c2,
                                        int c3, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "h"(mask)
      : "memory");
}

// The wgmma descriptor of a K-major bf16 operand stored as TMA's 128-byte
// swizzle writes it: rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO),
// LBO unused; the k-th 16-deep slice starts 32 k bytes further (+2 k).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32) += A (64 x 16) B (N x 16)^T, both bf16 K-major in shared
// memory; D = A B^T when acc is 0.
#define WG_R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_R16(i) WG_R4(i), WG_R4(i + 4), WG_R4(i + 8), WG_R4(i + 12)
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);
template <>
__device__ __forceinline__ void wgmma_bf16<184>(float (&d)[92], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %94, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n184k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91"
      "}, %92, %93, p, 1, 1, 0, 0;\n}\n"
      : WG_R16(0), WG_R16(16), WG_R16(32), WG_R16(48), WG_R16(64), WG_R4(80), WG_R4(84), WG_R4(88)
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_R16(0), WG_R16(16), WG_R16(32), WG_R16(48)
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : WG_R16(0), WG_R16(16), WG_R16(32), WG_R16(48), WG_R16(64), WG_R16(80), WG_R16(96), WG_R16(112)
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_bf16<80>(float (&d)[40], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : WG_R16(0), WG_R16(16), WG_R4(32), WG_R4(36)
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_R16(0), WG_R16(16)
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_bf16<40>(float (&d)[20], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, %20, %21, p, 1, 1, 0, 0;\n}\n"
      : WG_R16(0), WG_R4(16)
      : "l"(da), "l"(db), "r"(acc));
}
#undef WG_R16
#undef WG_R4

// sigmoidf of N values, bit for bit, without a branch a value: 1 / y, y = 1 +
// exp(-x), by two Newton steps from the hardware's approximate reciprocal,
// which is correctly rounded, as the IEEE division is, for every bf16 x with
// y < 2^126 (wae_glu_sigmoid_mismatches checks all 65,536); a group with a
// larger y takes the division.
template <int N>
__device__ __forceinline__ void sigmoidn(const float (&x)[N], float (&r)[N]) {
  float y[N];
  bool big = false;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    y[k] = 1.0f + expf(-x[k]);
    float q;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(q) : "f"(y[k]));
    q = __fmaf_rn(q, __fmaf_rn(-y[k], q, 1.0f), q);
    r[k] = __fmaf_rn(q, __fmaf_rn(-y[k], q, 1.0f), q);
    big |= !(y[k] < 0x1p126f);
  }
  if (big) {
#pragma unroll
    for (int k = 0; k < N; ++k) r[k] = 1.0f / y[k];
  }
}

// act = S(tanh(a) * sigmoid(b)) of N = 2 W gate pairs whose ab values a, b
// (in S) are W 32-bit words each: gate_act_kernel's arithmetic, bit for bit
template <int W>
__device__ __forceinline__ void gate_actw(const uint32_t (&wa)[W], const uint32_t (&wb)[W], uint32_t (&o)[W]) {
  float t[2 * W], vb[2 * W], sg[2 * W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wa[k]));
    const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wb[k]));
    t[2 * k] = tanhf(fa.x), t[2 * k + 1] = tanhf(fa.y), vb[2 * k] = fb.x, vb[2 * k + 1] = fb.y;
  }
  sigmoidn<2 * W>(vb, sg);
#pragma unroll
  for (int k = 0; k < W; ++k) o[k] = pack_bf2(t[2 * k] * sg[2 * k], t[2 * k + 1] * sg[2 * k + 1]);
}
__device__ __forceinline__ uint4 gate_act8(uint4 a, uint4 b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
  uint32_t o[4];
  gate_actw<4>(wa, wb, o);
  return make_uint4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ uint2 gate_act4(uint2 a, uint2 b) {
  const uint32_t wa[2] = {a.x, a.y}, wb[2] = {b.x, b.y};
  uint32_t o[2];
  gate_actw<2>(wa, wb, o);
  return make_uint2(o[0], o[1]);
}

// Counts the bf16 values x whose sigmoidn differs from sigmoidf in any bit,
// in groups of 8 and of 4 (gate_act8, gate_act4).
__global__ void sigmoid_check_kernel(unsigned* bad) {
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i0 >= 65536) return;
  float x[8], r[8], xl[4], xh[4], rl[4], rh[4];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = __uint_as_float((uint32_t)(i0 + k) << 16);
#pragma unroll
  for (int k = 0; k < 4; ++k) xl[k] = x[k], xh[k] = x[4 + k];
  sigmoidn<8>(x, r);
  sigmoidn<4>(xl, rl);
  sigmoidn<4>(xh, rh);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float want = sigmoidf(x[k]), r4 = k < 4 ? rl[k] : rh[k - 4];
    if (__float_as_uint(r[k]) != __float_as_uint(want) && !(r[k] != r[k] && want != want)) atomicAdd(bad, 1u);
    if (__float_as_uint(r4) != __float_as_uint(want) && !(r4 != r4 && want != want)) atomicAdd(bad, 1u);
  }
}

// The gate pass of layer op.l: ta is the map of hb (x at layer 0), tc of c,
// tw of the packed gate weights (K, G, L), boxes of 64 columns.
template <class Op, int NH, int CL>
__global__ void __launch_bounds__(GW_THREADS, 1)
    gate_tma_wgmma(const Op op, const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tc,
                   const __grid_constant__ CUtensorMap tw) {
  using S = typename Op::Store;
  using GG = GateGeo<NH>;
  constexpr int STAGES = GG::STAGES, NJ = NH / 8, G4 = NH / 2, G = 2 * NH;  // NJ 8-column groups, G4 gate pairs a half
  extern __shared__ unsigned char gw_raw[];
  const uint32_t raw = smem_addr(gw_raw), base = (raw + 1023) & ~1023u;
  S* stg = reinterpret_cast<S*>(gw_raw + (base - raw) + STAGES * GG::STAGE);
  S* ring = stg + GG::STG / 2;
  float* bias = reinterpret_cast<float*>(ring + GG::RING / 2);  // bconv (G), g_add rows (2 x G)
  // barriers: full and empty a stage; ab stored (consumers -> act warps) and
  // act done (act warps -> consumers) a slot of two
  const uint32_t full0 = base + STAGES * GG::STAGE + GG::STG + GG::RING + GG::BIAS, empty0 = full0 + 8 * STAGES;
  const uint32_t abready0 = empty0 + 8 * STAGES, actfree0 = abready0 + 16;
  auto a_at = [&](int s) { return base + s * GG::STAGE; };
  auto w_at = [&](int s) { return base + s * GG::STAGE + GG::A_BYTES; };

  const int kbc = (op.C + GW_BK - 1) / GW_BK, nkb = 3 * kbc + (op.CIN + GW_BK - 1) / GW_BK;
  const int ntt = (op.T + GW_BM - 1) / GW_BM, ntiles = op.M / op.T * ntt, npairs = (ntiles + CL - 1) / CL;
  uint32_t rank, cid, ncl;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  asm("mov.u32 %0, %%clusterid.x;\n" : "=r"(cid));
  asm("mov.u32 %0, %%nclusterid.x;\n" : "=r"(ncl));
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full0 + 8 * s, 1), mbar_init(empty0 + 8 * s, 8 * CL);
    for (int s = 0; s < 2; ++s) mbar_init(abready0 + 8 * s, 8), mbar_init(actfree0 + 8 * s, 3);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CL > 1)
    asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  else
    __syncthreads();

  if (threadIdx.x < 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
  if (threadIdx.x < 32) {  // the producer: one thread
    if (threadIdx.x != 0) return;
    int s = 0;
    uint32_t ph = 0;
    for (int p = cid; p < npairs; p += ncl) {
      const int q = min(p * CL + (int)rank, ntiles - 1);  // a tile past the end: any rows, never stored
      const int b = q / ntt, t0 = (q - b * ntt) * GW_BM;
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, GG::STAGE);
        int k0;
        if (kb < 3 * kbc) {  // tap j of hb, rows t - (2 - j) d
          const int j = kb / kbc, col = (kb - j * kbc) * GW_BK;
          tma3(&ta, a_at(s), full, col, t0 - (2 - j) * op.d, b);
          k0 = j * op.C + col;
        } else {
          const int col = (kb - 3 * kbc) * GW_BK;
          tma3(&tc, a_at(s), full, col, t0, b);
          k0 = 3 * op.C + col;
        }
        if constexpr (CL == 1) {
          tma3(&tw, w_at(s), full, k0, 0, op.l);
          tma3(&tw, w_at(s) + GG::H_BYTES, full, k0, NH, op.l);
        } else {
          tma3_mc(&tw, w_at(s) + rank * GG::H_BYTES, full, k0, rank * NH, op.l, (uint16_t)((1 << CL) - 1));
        }
        if (++s == STAGES) s = 0, ph ^= 1;
      }
    }
    // every stage released by the consumers of every block of the cluster
    // before this block exits: no remote arrival lands after it
    for (int i = 0; i < STAGES; ++i) {
      mbar_wait(empty0 + 8 * s, ph ^ 1);
      if (++s == STAGES) s = 0, ph ^= 1;
    }
    return;
  }

  if (threadIdx.x < 128) {  // the act warps: act from the ab a tile's consumers stored, during the next tile's products
    int k = 0;  // the block's stored tiles
    for (int p = cid; p < npairs; p += ncl, ++k) {
      const int q = p * CL + (int)rank;
      if (q >= ntiles) break;
      mbar_wait(abready0 + 8 * (k & 1), (k >> 1) & 1);
      constexpr int NI = NH / 8 - 4 * GW_CACT;  // items of a row: 8-pair groups past the consumers' chunks
      const int b = q / ntt, t0 = (q - b * ntt) * GW_BM, n = min(GW_BM, op.T - t0) * NI;
      const S* abt = op.ab + (((int64_t)b * op.L + op.l) * op.T + t0) * G;
      S* actt = op.act + ((int64_t)b * op.T + t0) * NH;
      // items of 8 gate pairs of a row, the thread's every 96th, read through
      // its own ring of GW_AQ slots in shared memory by cp.async (one group
      // an item, empty past the end), so that GW_AQ - 1 reads are in flight
      // while one is computed
      const int at = threadIdx.x - 32;
      S* mine = ring + at * GW_AQ * 16;
      auto fetch = [&](int j, int slot) {
        const int it = at + 96 * j;
        if (it < n) {
          const int r = it / NI, c = (it - r * NI + 4 * GW_CACT) * 8;
          cp_async16(mine + slot * 16, abt + (int64_t)r * G + c, true);
          cp_async16(mine + slot * 16 + 8, abt + (int64_t)r * G + NH + c, true);
        }
        cp_commit();
      };
#pragma unroll
      for (int j = 0; j < GW_AQ - 1; ++j) fetch(j, j);
      int slot = 0;
      for (int j = 0, it = at; it < n; ++j, it += 96) {
        fetch(j + GW_AQ - 1, slot == 0 ? GW_AQ - 1 : slot - 1);
        cp_wait<GW_AQ - 1>();
        const uint4 va = *reinterpret_cast<const uint4*>(mine + slot * 16);
        const uint4 vb = *reinterpret_cast<const uint4*>(mine + slot * 16 + 8);
        const int r = it / NI, c = (it - r * NI + 4 * GW_CACT) * 8;
        *reinterpret_cast<uint4*>(actt + (int64_t)r * NH + c) = gate_act8(va, vb);
        slot = slot == GW_AQ - 1 ? 0 : slot + 1;
      }
      cp_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive<1>(actfree0 + 8 * (k & 1), 0);
    }
    return;
  }

  // a consumer: rows 64 cw + 16 wi + [0, 16) of a tile, lane's rows r8 and r8 + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int cw = threadIdx.x / 128 - 1, wi = (threadIdx.x >> 5) & 3, q4 = lane & 3, r8 = lane >> 2;
  S* ws = stg + (cw * 4 + wi) * 16 * GW_SROW;
  float acc[2][NH / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) acc[h][i] = 0.0f;
  int s = 0, k = 0;
  uint32_t ph = 0;
  const int ct = threadIdx.x - 128;  // 0 .. 255
  for (int i = ct; i < G; i += 256) bias[i] = op.bconv[i];
  // act of the consumers' chunks (the first GW_CACT 32-pair chunks of half
  // 0) of the warp's rows of the previous tile (batch row pb, first row pt0;
  // none while pb < 0), done during this tile's products: the chunk's ab
  // read back into the idle staging buffer by cp.async (lane: half lane & 1
  // of row lane >> 1), then 4 pairs at a time between issuing a k-step's
  // products and waiting for them
  int pb = -1, pt0 = 0;
  const int ar = lane >> 1, ah = lane & 1;
  auto act_read = [&](int c) {
    if (pt0 + ar < op.T) {
      const S* src = op.ab + (((int64_t)pb * op.L + op.l) * op.T + pt0 + ar) * G + ah * NH + 32 * c;
#pragma unroll
      for (int u = 0; u < 4; ++u) cp_async16(ws + ar * GW_SROW + 32 * ah + 8 * u, src + 8 * u, true);
    }
    cp_commit();
  };
  // piece g (0 .. 3) of chunk c: 4 pairs of the lane's 16; the first piece
  // waits for the chunk's read, the last lets the staging buffer go
  auto act_piece = [&](int c, int g) {
    if (g == 0) cp_wait<0>(), __syncwarp();
    if (pt0 + ar < op.T) {
      const S* w = ws + ar * GW_SROW + 16 * ah + 4 * g;
      *reinterpret_cast<uint2*>(op.act + ((int64_t)pb * op.T + pt0 + ar) * NH + 32 * c + 16 * ah + 4 * g) =
          gate_act4(*reinterpret_cast<const uint2*>(w), *reinterpret_cast<const uint2*>(w + 32));
    }
    if (g == 3) __syncwarp();
  };
  for (int p = cid; p < npairs; p += ncl, ++k) {
    const int q = p * CL + (int)rank;
    // this tile's g_add row into its slot, read by the epilogue after the
    // products (the slot's previous tile, two back, is done with it)
    if (op.gadd && q < ntiles) {
      const int b = q / ntt;
      for (int c = ct * 4; c < G; c += 1024)
        cp_async16(bias + G * (1 + (k & 1)) + c, op.gadd + ((int64_t)b * op.L + op.l) * G + c, true);
    }
    cp_commit();
    // the previous tile's chunk c is read at k-step 5 c and computed at
    // 5 c + 1 .. 5 c + 4, a piece a k-step; what a short tile leaves after
    // its last k-step
    constexpr int PK = 5;
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(full0 + 8 * s, ph);
      const uint64_t da = sw128_desc(a_at(s) + cw * 64 * 128), db = sw128_desc(w_at(s));
      fence_acc(acc[0]), fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GW_BK / 16; ++kk) {
        wgmma_bf16<NH>(acc[0], da + 2 * kk, db + 2 * kk, kb | kk);
        wgmma_bf16<NH>(acc[1], da + 2 * kk, db + (GG::H_BYTES >> 4) + 2 * kk, kb | kk);
      }
      wgmma_commit();
      if (pb >= 0 && kb < GW_CACT * PK) {
        const int c = kb / PK, g = kb - c * PK - 1;
        if (g < 0) act_read(c);
        else act_piece(c, g);
      }
      wgmma_wait<0>();
      fence_acc(acc[0]), fence_acc(acc[1]);
      if (lane < CL) mbar_arrive<CL>(empty0 + 8 * s, lane);
      if (++s == STAGES) s = 0, ph ^= 1;
    }
    if (pb >= 0)
      for (int i = nkb; i < GW_CACT * PK; ++i) {
        const int c = i / PK, g = i - c * PK - 1;
        if (g < 0) act_read(c);
        else act_piece(c, g);
      }
    pb = -1;
    if (q >= ntiles) continue;

    // ab = S(product + bconv + g_add) at the original columns (GateOp::sum,
    // gemm_pipe's rounding), a chunk of 32 gate pairs of one half at a time: into the
    // warp's staging rows [ab_a | ab_b], then 8-byte stores of whole row
    // pieces, lane (pr, pc) columns pc .. pc + 3 of rows pr + 4 k, every
    // offset from its base pointer known at compile time. (The act of the
    // consumers' chunks follows during the next tile's products.)
    const int b = q / ntt, t0 = (q - b * ntt) * GW_BM + 64 * cw + 16 * wi;  // the warp's first row
    const int64_t bl = (int64_t)b * op.L + op.l;
    cp_wait<0>();
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // every consumer's part of the g_add row has landed
    const float* bc = bias + q4;
    const float* gr = op.gadd ? bias + G * (1 + (k & 1)) + q4 : nullptr;
    const int pr = lane >> 3, pc = (lane & 7) * 4, rows = op.T - t0 - pr;  // row pr + 4 k is stored while 4 k < rows
    S* abp = op.ab + (bl * op.T + t0 + pr) * G + pc;
    const S* wsp = ws + pr * GW_SROW + pc;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jc = 0; jc < (NJ + 7) / 8; ++jc) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = jc * 8 + jj, i = h * G4 + 4 * j;  // the lane's gate pair is i + q4
          if (j < NJ) {
            const float4 bi = make_float4(bc[i], bc[NH + i], gr ? gr[i] : 0.0f, gr ? gr[NH + i] : 0.0f);
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              float va, vb;
              op.sum(acc[h][4 * j + 2 * rr], acc[h][4 * j + 2 * rr + 1], bi, va, vb);
              S* o = ws + (r8 + 8 * rr) * GW_SROW + 4 * jj + q4;
              st(o, va), st(o + 32, vb);
            }
          }
        }
        __syncwarp();
        const int i0 = h * G4 + 32 * jc, nv = G4 - 32 * jc < 32 ? G4 - 32 * jc : 32;  // nv gate pairs from i0
        if (pc < nv) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (4 * r < rows) {
#pragma unroll
              for (int o = 0; o < 2; ++o)
                *reinterpret_cast<uint2*>(abp + 4 * r * G + o * NH + i0) =
                    *reinterpret_cast<const uint2*>(wsp + 4 * r * GW_SROW + 32 * o);
            }
        }
        __syncwarp();
      }
    pb = b, pt0 = t0;
    // hand the tile to the act warps once they are done with the slot's
    // previous tile
    mbar_wait(actfree0 + 8 * (k & 1), ((k >> 1) & 1) ^ 1);
    __syncwarp();
    if (lane == 0) mbar_arrive<1>(abready0 + 8 * (k & 1), 0);
  }
  if (pb >= 0)  // the last tile's
    for (int c = 0; c < GW_CACT; ++c) {
      act_read(c);
      for (int g = 0; g < 4; ++g) act_piece(c, g);
    }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// The map of a row-major bf16 array of rank n (dims[0] the contiguous
// dimension): boxes of box[0] x ... x box[n - 1], box[0] = 64 (one 128-byte
// swizzle row), stored with the 128-byte swizzle, zeros outside the array.
static cudaError_t tmap(CUtensorMap* m, const void* p, int n, const uint64_t* dims, const uint32_t* box) {
  const EncodeTiled f = encode_tiled();
  if (!f) return cudaErrorNotSupported;
  cuuint64_t d[4], strides[3];
  cuuint32_t bx[4], es[4];
  uint64_t s = 2;  // bytes of one element, then of one step along dimension i
  for (int i = 0; i < n; ++i) {
    if (i) strides[i - 1] = s;
    d[i] = dims[i], bx[i] = box[i], es[i] = 1, s *= dims[i];
  }
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, n, const_cast<void*>(p), d, strides, bx, es,
                       CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
// (d2, d1, d0) in boxes of 64 x rows x 1
static cudaError_t tmap3(CUtensorMap* m, const void* p, uint64_t d0, uint64_t d1, uint64_t d2, uint32_t rows) {
  const uint64_t dims[3] = {d0, d1, d2};
  const uint32_t box[3] = {GW_BK, rows, 1};
  return tmap(m, p, 3, dims, box);
}

// The maps of one forward call: x, hb, c and the gate weights.
struct GateMaps {
  CUtensorMap x, hb, c, w;
};

// Launches a persistent kernel of GW_THREADS threads a block, in clusters of
// CL along the rows, over ntiles row tiles: as many clusters as the card
// holds at once (resident, the kernel's own, found at its first launch), or
// fewer.
template <int CL, class Kern, class... A>
static cudaError_t launch_clusters(Kern kern, int smem, int ntiles, int& resident, cudaStream_t st, const A&... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(GW_THREADS), cfg.dynamicSmemBytes = smem, cfg.stream = st, cfg.attrs = attr, cfg.numAttrs = 1;
  if (!resident) {
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
    cfg.gridDim = dim3(sms / CL * CL);
    if ((e = cudaOccupancyMaxActiveClusters(&resident, kern, &cfg)) != cudaSuccess) return e;
    if (resident < 1) return cudaErrorInvalidConfiguration;
  }
  const int npairs = (ntiles + CL - 1) / CL;
  cfg.gridDim = dim3((npairs < resident ? npairs : resident) * CL);
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <int NH>
static cudaError_t launch_gate_tma(const GateOp<__nv_bfloat16>& op, const GateMaps& mp, cudaStream_t st) {
  static int resident = 0;
  const int ntiles = op.M / op.T * ((op.T + GW_BM - 1) / GW_BM);
  return launch_clusters<GW_CLUSTER>(gate_tma_wgmma<GateOp<__nv_bfloat16>, NH, GW_CLUSTER>, GateGeo<NH>::SMEM,
                                     ntiles, resident, st, op, op.l == 0 ? mp.x : mp.hb, mp.c, mp.w);
}

// The gate pass's route: the TMA kernel where GluArgs::gate_wg says so
// (kernels/glu_stack.py:gate_route), else gemm_pipe.
template <typename S>
static cudaError_t launch_gate(const GateOp<S>& g, const GateMaps* mp, cudaStream_t st) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value) {
    if (mp) {
      if (g.G == 368) return launch_gate_tma<184>(g, *mp, st);
      if (g.G == 256) return launch_gate_tma<128>(g, *mp, st);
      return cudaErrorInvalidValue;
    }
  }
  return launch_gemm(g, 1, st);
}

template <typename S>
static cudaError_t forward_impl(const GluArgs& a) {
  cudaStream_t st = (cudaStream_t)a.stream;
  const int B = (int)a.B, T = (int)a.T, L = (int)a.L, C = (int)a.C, G = (int)a.G;
  const int G2 = G / 2, SK = (int)a.S, CIN = a.has_c ? (int)a.CIN : 0, M = B * T, K = 3 * C + CIN;
  GateMaps maps;
  const GateMaps* mp = nullptr;
  if (std::is_same<S, __nv_bfloat16>::value && a.gate_wg) {
    cudaError_t e;
    if ((e = tmap3(&maps.x, a.x, C, T, B, GW_BM)) != cudaSuccess ||
        (e = tmap3(&maps.hb, a.hb, C, T, B, GW_BM)) != cudaSuccess ||
        (e = tmap3(&maps.c, CIN ? a.c : a.x, CIN ? CIN : C, T, B, GW_BM)) != cudaSuccess ||
        (e = tmap3(&maps.w, a.wg, K, G, L, G2)) != cudaSuccess)
      return e;
    mp = &maps;
  }
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
    g.T = T, g.L = L, g.l = l, g.G = G, g.C = C, g.CIN = CIN, g.d = d;
    g.bconv = a.bconv + (int64_t)l * G;
    g.gadd = a.has_g ? a.g_add : nullptr;
    g.ab = (S*)a.ab, g.act = (S*)a.act;
    cudaError_t e = launch_gate(g, mp, st);
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
  int T, G, l, d;  // the TMA route's loads: dabs (B, T, G), the layer and its dilation
  float* dx;
  S* gy;
  float* dc;
  // the new dx from the old one and the product v; gy = S(g): both routes'
  // arithmetic
  __device__ __forceinline__ static float next(float old, float v) { return old * RS + v; }
  __device__ __forceinline__ static float gy_of(float x) { return x * RS; }
  // a tile of dc columns only: wx is zero in the two shifted taps
  __device__ __forceinline__ int first_seg(int n0) const { return n0 >= C ? 2 : 0; }
  __device__ __forceinline__ void epi(int, int64_t, int m, int n, const float* v) const {
    float p[8];
    if (n < C) {
      const int64_t o = (int64_t)m * C + n;
      ld8(dx + o, p);
#pragma unroll
      for (int k = 0; k < 8; ++k) p[k] = next(p[k], v[k]);
      st8(dx + o, p);
#pragma unroll
      for (int k = 0; k < 8; ++k) p[k] = gy_of(p[k]);
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

// ---- K3's dx pass on TMA and wgmma (bf16 storage) ----------------------------
// A persistent kernel over DX_BM-row tiles of one batch row each (a ragged
// last tile where T is not a multiple of DX_BM), every tile over all NC = C
// dx columns and all NI = CIN dc columns, so that the three taps of dabs
// are read once a tile, in two roles:
// - the producer, one thread of warp 0: TMA loads from a 3-D map (G, T, B)
//   of dabs, one 64-deep box a k-stage, the taps at t0 + 2d, t0 + d and t0
//   (TMA's out-of-bounds fill gives the zeros past a batch row's end and
//   past G in a tap's last box), and the layer's weight stage from 4-D maps
//   (G, 3, C + CIN, L) of wx, whose tap is a dimension of its own, so that a
//   tap's last box reads zeros past G in the weights too: the dx rows, each
//   half loaded by one block of a cluster of DX_CLUSTER and multicast to
//   both, and on the unshifted tap's k-stages the dc rows, loaded by block 0
//   and multicast. It loads the block's tiles one after another through
//   one ring of stages.
// - the consumers, warpgroups 1 and 2, which take the block's tiles in
//   turns (ping-pong): wgmma m64 x NC x 16 on every k-step of a tile and
//   m64 x NI x 16 on its unshifted tap's (wx's dc rows are zero in the
//   shifted taps, which gemm_pipe's first_seg skips too), 128-byte swizzled
//   K-major operands in shared memory, NC/2 + NI/2 accumulators a thread,
//   one k-step's products in flight while the next is issued. Then the
//   epilogue from the registers, while the other warpgroup runs the next
//   tile's products: dx = dx/sqrt 2 + v, gy = S(dx/sqrt 2) (DxOp::next,
//   gy_of), and dc = v at the walk's first layer, else dc += v, 8-byte
//   loads and stores of the lane's column pairs. So the epilogue's traffic
//   to device memory runs beside the products, not after them.
// The k order a tap (taps t+2d, t+d, t; 64-deep boxes, 16 deep a product)
// and the roundings are gemm_pipe's, so the outputs are too, bit for bit.
// Warps 1-3 have no role. (Both consumers on one 128-row tile, as in the
// gate kernel, halve the weight bytes a row but leave each tile's epilogue
// after its products, when every SM stores at once: 10.1 against 7.7 ms
// at svqwae's B=40 x T=5120 on an H100 SXM.)

#define DX_BM 64      // rows of a tile: one consumer warpgroup's
#define DX_CLUSTER 2  // blocks of a cluster along the rows, sharing the weight stage
#define DX_EJ 16      // 8-column groups of a row whose old dx a consumer lane loads at once

// Shared memory of the kernel for NC dx and NI dc columns: STAGES k-stages
// of A (64 x 64), the dx rows (NC x 64) and the dc rows (NI x 64) of the
// weights, then the barriers.
template <int NC, int NI>
struct DxGeo {
  static constexpr int A_BYTES = DX_BM * GW_BK * 2, X_BYTES = NC * GW_BK * 2, I_BYTES = NI * GW_BK * 2;
  static constexpr int STAGE = A_BYTES + X_BYTES + I_BYTES;
  static constexpr int STAGES = (232448 - 1024 - 16) / (STAGE + 16);
  static constexpr int SMEM = 1024 + STAGES * (STAGE + 16) + 16;  // 1024: alignment slack
  static_assert(X_BYTES % (1024 * DX_CLUSTER) == 0 && I_BYTES % 1024 == 0,
                "each block's part of the weight stage starts on a swizzle atom");
};

// The dx pass of layer op.l: ta is the map of dabs (boxes of DX_BM rows), tx
// of wx's dx rows (boxes of NC / CL rows), ti of its dc rows (NI rows).
template <class Op, int NC, int NI, int CL>
__global__ void __launch_bounds__(GW_THREADS, 1)
    dx_tma_wgmma(const Op op, const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap ti) {
  static_assert(CL > 1, "the weight stage is multicast over the cluster");
  using DG = DxGeo<NC, NI>;
  constexpr int STAGES = DG::STAGES;
  extern __shared__ unsigned char gw_raw[];
  const uint32_t raw = smem_addr(gw_raw), base = (raw + 1023) & ~1023u;
  // barriers: full and empty a stage; turn, a tile's last stage landed
  // (its warpgroup -> the other one, whose tile's first stages follow)
  const uint32_t full0 = base + STAGES * DG::STAGE, empty0 = full0 + 8 * STAGES, turn = empty0 + 8 * STAGES;
  auto a_at = [&](int s) { return base + s * DG::STAGE; };
  auto w_at = [&](int s) { return base + s * DG::STAGE + DG::A_BYTES; };

  const int kbg = (op.G + GW_BK - 1) / GW_BK, nkb = 3 * kbg;  // k-stages a tap, a tile
  const int ntt = (op.T + DX_BM - 1) / DX_BM, ntiles = op.M / op.T * ntt, npairs = (ntiles + CL - 1) / CL;
  uint32_t rank, cid, ncl;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  asm("mov.u32 %0, %%clusterid.x;\n" : "=r"(cid));
  asm("mov.u32 %0, %%nclusterid.x;\n" : "=r"(ncl));
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full0 + 8 * s, 1), mbar_init(empty0 + 8 * s, 4 * CL);
    mbar_init(turn, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  if (threadIdx.x < 128) {  // the producer: one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    constexpr uint16_t mask = (uint16_t)((1 << CL) - 1);
    int s = 0;
    uint32_t ph = 0;
    for (int p = cid; p < npairs; p += ncl) {
      const int q = min(p * CL + (int)rank, ntiles - 1);  // a tile past the end: any rows, never stored
      const int b = q / ntt, t0 = (q - b * ntt) * DX_BM;
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        const uint32_t full = full0 + 8 * s;
        const int j = kb / kbg, col = (kb - j * kbg) * GW_BK;  // tap j: dabs rows t + (2 - j) d
        const bool dc = NI > 0 && j == 2;
        mbar_expect_tx(full, DG::A_BYTES + DG::X_BYTES + (dc ? DG::I_BYTES : 0));
        tma3(&ta, a_at(s), full, col, t0 + (2 - j) * op.d, b);
        tma4_mc(&tx, w_at(s) + rank * (DG::X_BYTES / CL), full, col, j, rank * (NC / CL), op.l, mask);
        if (dc && rank == 0) tma4_mc(&ti, w_at(s) + DG::X_BYTES, full, col, 2, NC, op.l, mask);
        if (++s == STAGES) s = 0, ph ^= 1;
      }
    }
    // every stage released by the consumers of every block of the cluster
    // before this block exits: no remote arrival lands after it
    for (int i = 0; i < STAGES; ++i) {
      mbar_wait(empty0 + 8 * s, ph ^ 1);
      if (++s == STAGES) s = 0, ph ^= 1;
    }
    return;
  }

  // a consumer warpgroup: the block's tiles cw, cw + 2, ...; rows 16 wi +
  // [0, 16) of a tile, lane's rows r8 and r8 + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1, wi = (threadIdx.x >> 5) & 3, q4 = lane & 3, r8 = lane >> 2;
  float ax[NC / 2], ai[NI > 0 ? NI / 2 : 1];
  for (int p = cid + cw * ncl, k = cw; p < npairs; p += 2 * ncl, k += 2) {
    const int q = p * CL + (int)rank;
    // the ring's place of the tile's first k-stage: the block's k-th tile.
    // A full barrier's parity names its phase only once the stage's previous
    // load (STAGES k-stages back) has landed: for the tile's first stages,
    // those of tile k - 1, which the turn barrier's phase k - 1 reports.
    int s = (int)(((int64_t)k * nkb) % STAGES), done = 0;  // done: the stage whose products are in flight
    uint32_t ph = (uint32_t)(((int64_t)k * nkb / STAGES) & 1);
    if (k > 0) mbar_wait(turn, (k - 1) & 1);
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(full0 + 8 * s, ph);
      if (kb == nkb - 1 && lane == 0) mbar_arrive<1>(turn, 0);
      const uint64_t da = sw128_desc(a_at(s)), dbx = sw128_desc(w_at(s));
      fence_acc(ax);
      if constexpr (NI > 0) fence_acc(ai);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GW_BK / 16; ++kk) wgmma_bf16<NC>(ax, da + 2 * kk, dbx + 2 * kk, kb | kk);
      if constexpr (NI > 0) {
        if (kb >= 2 * kbg) {
          const uint64_t dbi = sw128_desc(w_at(s) + DG::X_BYTES);
#pragma unroll
          for (int kk = 0; kk < GW_BK / 16; ++kk) wgmma_bf16<NI>(ai, da + 2 * kk, dbi + 2 * kk, (kb - 2 * kbg) | kk);
        }
      }
      wgmma_commit();
      // the previous k-step's products are done: its stage goes back
      wgmma_wait<1>();
      fence_acc(ax);
      if constexpr (NI > 0) fence_acc(ai);
      if (kb > 0 && lane < CL) mbar_arrive<CL>(empty0 + 8 * done, lane);
      done = s;
      if (++s == STAGES) s = 0, ph ^= 1;
    }
    wgmma_wait<0>();
    fence_acc(ax);
    if constexpr (NI > 0) fence_acc(ai);
    if (lane < CL) mbar_arrive<CL>(empty0 + 8 * done, lane);
    if (q >= ntiles) continue;

    const int b = q / ntt, tr = (q - b * ntt) * DX_BM + 16 * wi + r8;  // the lane's first row in batch row b
    const int64_t m = (int64_t)b * op.T + tr;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (tr + 8 * rr >= op.T) continue;
      float* xr = op.dx + (m + 8 * rr) * NC + 2 * q4;
      __nv_bfloat16* gr = op.gy + (m + 8 * rr) * NC + 2 * q4;
#pragma unroll
      for (int j0 = 0; j0 < NC / 8; j0 += DX_EJ) {
        float2 o[DX_EJ];
#pragma unroll
        for (int jj = 0; jj < DX_EJ; ++jj) o[jj] = *reinterpret_cast<const float2*>(xr + 8 * (j0 + jj));
#pragma unroll
        for (int jj = 0; jj < DX_EJ; ++jj) {
          const int j = j0 + jj;
          const float x0 = Op::next(o[jj].x, ax[4 * j + 2 * rr]), x1 = Op::next(o[jj].y, ax[4 * j + 2 * rr + 1]);
          *reinterpret_cast<float2*>(xr + 8 * j) = make_float2(x0, x1);
          *reinterpret_cast<uint32_t*>(gr + 8 * j) = pack_bf2(Op::gy_of(x0), Op::gy_of(x1));
        }
      }
      if constexpr (NI > 0) {
        float* cr = op.dc + (m + 8 * rr) * NI + 2 * q4;
        float2 o[NI / 8];
#pragma unroll
        for (int j = 0; j < NI / 8; ++j)
          o[j] = op.first ? make_float2(0.0f, 0.0f) : *reinterpret_cast<const float2*>(cr + 8 * j);
#pragma unroll
        for (int j = 0; j < NI / 8; ++j) {
          float2 v = make_float2(ai[4 * j + 2 * rr], ai[4 * j + 2 * rr + 1]);
          if (!op.first) v.x = o[j].x + v.x, v.y = o[j].y + v.y;
          *reinterpret_cast<float2*>(cr + 8 * j) = v;
        }
      }
    }
  }
}

// The maps of one backward call: dabs, wx's dx rows and its dc rows.
struct DxMaps {
  CUtensorMap a, x, i;
};

template <int NC, int NI>
static cudaError_t launch_dx_tma(const DxOp<__nv_bfloat16>& op, const DxMaps& mp, cudaStream_t st) {
  static int resident = 0;
  const int ntiles = op.M / op.T * ((op.T + DX_BM - 1) / DX_BM);
  return launch_clusters<DX_CLUSTER>(dx_tma_wgmma<DxOp<__nv_bfloat16>, NC, NI, DX_CLUSTER>, DxGeo<NC, NI>::SMEM,
                                     ntiles, resident, st, op, mp.a, mp.x, mp.i);
}

// The dx pass's route: the TMA kernel where GluArgs::dx_wg says so
// (kernels/glu_stack.py:dx_route, at the widths instantiated here), else
// gemm_pipe.
template <typename S>
static cudaError_t launch_dx(const DxOp<S>& o, const DxMaps* mp, cudaStream_t st) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value) {
    if (mp) {
      if (o.C == 256 && o.CIN == 64) return launch_dx_tma<256, 64>(o, *mp, st);
      if (o.C == 256 && o.CIN == 40) return launch_dx_tma<256, 40>(o, *mp, st);
      if (o.C == 256 && o.CIN == 128) return launch_dx_tma<256, 128>(o, *mp, st);
      if (o.C == 256 && o.CIN == 0) return launch_dx_tma<256, 0>(o, *mp, st);
      if (o.C == 128 && o.CIN == 80) return launch_dx_tma<128, 80>(o, *mp, st);
      return cudaErrorInvalidValue;
    }
  }
  return launch_gemm(o, 1, st);
}

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
  DxMaps dmaps;
  const DxMaps* dmp = nullptr;
  if (std::is_same<S, __nv_bfloat16>::value && a.dx_wg) {
    const uint64_t wdims[4] = {(uint64_t)G, 3, (uint64_t)(C + CIN), (uint64_t)L};  // wx (L, C+cin, 3, G)
    const uint32_t xbox[4] = {GW_BK, 1, (uint32_t)(C / DX_CLUSTER), 1}, ibox[4] = {GW_BK, 1, (uint32_t)(CIN ? CIN : 8), 1};
    CHECK(tmap3(&dmaps.a, a.dabs, G, T, B, DX_BM));
    CHECK(tmap(&dmaps.x, a.wx, 4, wdims, xbox));
    CHECK(tmap(&dmaps.i, a.wx, 4, wdims, ibox));
    dmp = &dmaps;
  }

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
    dxo.T = T, dxo.G = G, dxo.l = l, dxo.d = d;
    dxo.dx = a.dx, dxo.gy = (S*)a.gy, dxo.dc = a.dc;
    CHECK(launch_dx(dxo, dmp, st));
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


// The number of bf16 inputs on which the TMA gate kernel's sigmoid differs
// from sigmoidf (0 is what its act's equality with K3's gate_act_kernel
// rests on), or -1 on a CUDA error. Synchronous: a check, not a pass.
extern "C" int64_t wae_glu_sigmoid_mismatches() {
  unsigned* d = nullptr;
  unsigned h = 0;
  if (cudaMalloc(&d, sizeof(unsigned)) != cudaSuccess) return -1;
  const bool ok = cudaMemset(d, 0, sizeof(unsigned)) == cudaSuccess &&
                  (sigmoid_check_kernel<<<65536 / 8 / 128, 128>>>(d), cudaGetLastError() == cudaSuccess) &&
                  cudaMemcpy(&h, d, sizeof(unsigned), cudaMemcpyDeviceToHost) == cudaSuccess;
  cudaFree(d);
  return ok ? (int64_t)h : -1;
}

