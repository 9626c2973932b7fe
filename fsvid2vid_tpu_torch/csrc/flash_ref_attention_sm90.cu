// Multi-reference flash attention for Hopper (sm_90a), forward only: the
// tensor-core routes of kernel B1, in bf16 and in f32, for every channel
// count 1 <= c <= 512 that the JAX generator sends to its Pallas kernel.
//
// Replaces the Pallas TPU kernel fsvid2vid_tpu/ops/pallas/attention_kernel.py
// (flash_ref_attention, body _kernel).  For each batch element b and query
// q, with N = K * hw_key keys:
//
//   s[n]         = query[b,q,:] . key[b,n,:]
//   out_x[b,q,:] = sum_n softmax_n(s)[n] * xf[b,n,:]
//   out_l[b,q,:] = sum_n softmax_n(s)[n] * lf[b,n,:]          (optional)
//   vis[b,q,r]   = sum_{n : n / hw_key == r} softmax_n(s)[n]  (f32)
//
// As in the TPU kernel: the softmax runs in the exp2 domain, the running max,
// sum and accumulators are f32, p is rounded to the input dtype before the
// value products (so f32 inputs keep p at f32 accuracy), and l and vis use
// the unrounded p.
//
// Split-bf16 products (f32 inputs).  The tensor cores multiply bf16 exactly
// and add in f32, so an f32 operand is carried as a sum of bf16 parts:
// x = hi + mid + lo with hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid) (24 bits), or x = hi + lo (16 bits).  An energy's
// absolute error becomes the weight's relative error through the
// exponential, so q and k take 3 parts and QK^T the 6 products whose order is
// at least 2^-16: hh, hm, mh, hl, lh, mm.  The values' errors are not
// amplified: xf, lf and p take 2 parts and PV the 3 products hh, hl, lh.  A
// pre-pass kernel writes the parts of q, k, xf and lf into scratch memory
// that the caller allocates.  bf16 inputs are their own single part.
//
// Channel counts.  TMA rows need 16-byte strides, so the tensor maps see c
// rounded up to cp, a multiple of 8.  Where c % 8 != 0 ("ragged"), the same
// pre-pass writes the inputs with their channels zero-padded to cp (in bf16
// one more pass, ~2x the inputs' bytes; in f32 the split's own pass): zero
// channels add nothing to q.k nor to the outputs, whose stores stop at c.
// The other way in, cp.async of the unpadded rows into the swizzled tiles,
// would save that pass but give up TMA's one-thread copies and its zero-fill
// of the ragged edges.  Two walks share the softmax, the mass table and the
// value products:
//  - c <= 128, the narrow walk (flash_ref_attention_sm90_kernel): the
//    128-query tile stays in shared memory with up to 2 channel boxes, and a
//    consumer's accumulators hold every value channel [xf | lf], up to
//    2 x 128;
//  - 128 < c <= 512, the wide walk (flash_ref_attention_wide_kernel):
//    neither fits.  At c = 256 with lf the query tile and three key stages
//    would take ~353 KB of the 227 KB, and O would take 256 registers a
//    thread.  So the value channels [xf | lf], in 64-channel boxes, are cut
//    into slices of WIDE_VB = 4 boxes (256 channels, 128 accumulators a
//    thread, as the narrow walk at c = 128 with lf), one slice per block
//    along the grid's z; and QK^T streams through shared memory in
//    64-channel chunks, each chunk bringing its query box with its key box,
//    so no tile ever holds all c channels.  The price: every slice
//    recomputes S = QK^T (at c = 256 with lf, 2 slices: QK^T twice, 4/3 of
//    the useful products; at c = 512 with lf, 4 slices, 2x), and the query
//    box is fetched again with every key tile (from L2: a block's 128 rows
//    stay there), twice a key box's bytes in bf16.
//
// Bounds on an H100 SXM at the serving shape (face 512 px, K = 8: B = 1,
// hw = 16384, N = 131072, c = 128, with lf): the products are 1.65e12 FLOP,
// 1.7 ms at the 989 TFLOP/s bf16 tensor-core peak, against ~34 us for the
// ~113 MB of bf16 inputs and outputs.  In f32 the split products are 12 bf16
// products of the 5.5e11 FLOP unit (6 for QK^T, 3 for each of xf and lf),
// 6.67 ms at that peak; the pre-pass moves ~0.45 GB (~0.14 ms at 3.35 TB/s).
// Both are bound by operations.  At c = 256 (the --ngf 64 model) the useful
// products are 3.3e12 FLOP, 3.34 ms bf16, and 13.3 ms as f32's split
// products; the wide walk does 4/3 of them (QK^T once per value slice).
//
// Design (the narrow walk; the wide walk's differences are at
// flash_ref_attention_wide_kernel).  A block owns BQ = 128 queries of one
// batch element and is three
// warpgroups: a producer and two consumers of 64 query rows each.
//  - The producer's one thread loads the query tile (its parts) once and then
//    streams key tiles of BK keys (the parts of K, then the parts of
//    [xf | lf]; 64 channels per TMA box, 128-byte swizzle) into a ring of
//    STAGES shared-memory stages, each guarded by a "full" mbarrier (TMA
//    transaction count) and an "empty" one (released by all 256 consumer
//    threads).  bf16: 64-key tiles, 3 stages.  f32: the 3-part query tile is
//    96 KB at c = 128 with lf and a 64-key stage would be 112 KB, so tiles
//    are 32 keys (56 KB) to keep two stages in flight.
//  - A consumer computes S = Q K^T with wgmma m64nBKk16 (both operands
//    K-major in shared memory, the small products first), the streaming
//    softmax on the accumulator registers (a row lives in a quad of
//    threads), then O += P V with the register-sourced wgmma: P packed to
//    bf16 straight from the S accumulators (in f32 as p_hi = bf16(p) and
//    p_lo = bf16(p - p_hi), against the high and low parts of the values);
//    xf and lf together as one MN-major B operand of width
//    64 * NB * (1 + has_lf), so one instruction feeds both outputs.
//  - The two consumers take turns on the tensor cores ("ping-pong" over two
//    named barriers): each issues PV of its previous tile and QK^T of its
//    next one together, then hands over and runs its exponentials while the
//    other's products run.
//  - Keys are walked reference by reference: ceil(hw_key / BK) tiles from
//    r * hw_key, the columns of a reference's last tile past hw_key masked to
//    -inf (TMA zero-fills past N).  So no tile straddles two references, and
//    the per-reference mass needs no per-key work: a running sum s_r of the
//    current reference's p, rescaled like l, is recorded with the running
//    max at the reference's end, and vis[r] = s_r * 2^(m_r - m_final) / l.
//  - f32 only: the accumulators are flushed every FLUSH_TILES key tiles into
//    a per-thread f32 sum in scratch memory (rescaled by the running max,
//    like O), so no accumulator register sums more than FLUSH_TILES tiles:
//    the tensor cores' own f32 accumulation over a whole key walk (24,576
//    accumulating instructions at the serving shape) was measured to drift
//    past the f32 tolerance of the slice (scripts/torch_kernel_variants.py,
//    b1_f32 "no_flush").
//  - Ragged shapes: TMA zero-fills query rows past hw (never stored) and
//    channels past cp (stores are masked to c).

#include <math.h>
#include <stddef.h>

#include "sm90_common.cuh"

namespace {

constexpr int BQ = 128;                 // queries per block
constexpr int THREADS = 384;            // two consumer warpgroups, one producer
constexpr int CONSUMERS = 256;
constexpr int NARROW_MAX_C = 128;      // the narrow walk's channels
constexpr int MAX_C = 512;             // the wide walk's
constexpr int Q_BOX_BYTES = BQ * 128;   // 128 query rows x 64 bf16 channels
constexpr float LOG2E = 1.4426950408889634f;

// What the two input dtypes' designs differ in.
template <typename T> struct Design;
template <> struct Design<__nv_bfloat16> {
  static constexpr int QP = 1;            // bf16 parts of q and k
  static constexpr int VP = 1;            // bf16 parts of xf, lf and p
  static constexpr int BK = 64;           // keys per tile
  static constexpr int STAGES = 3;        // key tiles in flight
  static constexpr int FLUSH_TILES = 0;   // key tiles between accumulator flushes; 0: none
};
template <> struct Design<float> {
  static constexpr int QP = 3;
  static constexpr int VP = 2;
  static constexpr int BK = 32;
  static constexpr int STAGES = 2;
  static constexpr int FLUSH_TILES = 64;
};

// Shared memory, from a 1024-byte aligned base (128-byte swizzle atoms): the
// query tile [q parts x NB boxes], STAGES key stages [K parts x NB | V parts
// x NV] with V = [xf | lf] in NV = NB * (1 + has_lf) boxes of BK keys, the
// mbarriers, and a (BQ, n_refs) table of (s_r, m_r).
template <typename T> __host__ __device__ constexpr int k_box_bytes() {
  return Design<T>::BK * 128;   // BK keys x 64 bf16 channels
}
__host__ __device__ constexpr int v_boxes(int nb, bool has_lf) { return nb * (has_lf ? 2 : 1); }
template <typename T> __host__ __device__ constexpr int q_bytes(int nb) {
  return Design<T>::QP * nb * Q_BOX_BYTES;
}
template <typename T> __host__ __device__ constexpr int stage_bytes(int nb, bool has_lf) {
  return (Design<T>::QP * nb + Design<T>::VP * v_boxes(nb, has_lf)) * k_box_bytes<T>();
}
template <typename T> __host__ __device__ constexpr int tiles_bytes(int nb, bool has_lf) {
  return q_bytes<T>(nb) + Design<T>::STAGES * stage_bytes<T>(nb, has_lf);
}
template <typename T> __host__ __device__ constexpr int barrier_bytes() {
  return 8 * (2 * Design<T>::STAGES + 1);
}
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int nb, bool has_lf, int n_refs) {
  return 1024 + tiles_bytes<T>(nb, has_lf) + barrier_bytes<T>() +
         (size_t)BQ * n_refs * sizeof(float2);
}

// The wide walk: value slices of WIDE_VB 64-channel boxes; a ring of
// QK_STAGES chunks [query box parts | key box parts] and one of V_STAGES
// value tiles [V parts x WIDE_VB boxes of BK keys].
constexpr int WIDE_VB = 4;
template <typename T> struct Wide;
template <> struct Wide<__nv_bfloat16> {
  static constexpr int QK_STAGES = 4;
  static constexpr int V_STAGES = 2;
};
template <> struct Wide<float> {
  static constexpr int QK_STAGES = 3;
  static constexpr int V_STAGES = 1;
};
template <typename T> __host__ __device__ constexpr int wide_qk_bytes() {
  return Design<T>::QP * (Q_BOX_BYTES + k_box_bytes<T>());
}
template <typename T> __host__ __device__ constexpr int wide_v_bytes() {
  return Design<T>::VP * WIDE_VB * k_box_bytes<T>();
}
template <typename T> __host__ __device__ constexpr int wide_tiles_bytes() {
  return Wide<T>::QK_STAGES * wide_qk_bytes<T>() + Wide<T>::V_STAGES * wide_v_bytes<T>();
}
template <typename T> __host__ __device__ constexpr int wide_barrier_bytes() {
  return 8 * 2 * (Wide<T>::QK_STAGES + Wide<T>::V_STAGES);
}
template <typename T> __host__ __device__ constexpr size_t wide_smem_bytes(int n_refs) {
  return 1024 + wide_tiles_bytes<T>() + wide_barrier_bytes<T>() +
         (size_t)BQ * n_refs * sizeof(float2);
}

__host__ __device__ constexpr int padded(int c) { return (c + 7) / 8 * 8; }
__host__ __device__ constexpr int boxes(int cp) { return (cp + 63) / 64; }
// value boxes [xf | lf] and the wide walk's slices of them
__host__ __device__ constexpr int value_boxes(int cp, bool has_lf) {
  return boxes(cp) * (has_lf ? 2 : 1);
}
__host__ __device__ constexpr int wide_slices(int cp, bool has_lf) {
  return (value_boxes(cp, has_lf) + WIDE_VB - 1) / WIDE_VB;
}

// Scratch memory: the bf16 parts of q (QP x b x hw x cp), k (QP x b x n x
// cp), xf and lf (VP x b x n x cp each), written by the pre-pass, then the
// f32 flush sums, one per output accumulator of every consumer thread of
// every block (f32 only).  A route whose inputs TMA reads in place needs
// none.
struct Scratch {
  size_t q, k, x, l, acc, total;   // byte offsets and size
};
Scratch scratch_layout(int qp, int vp, int b, int hw, int n, int cp, bool has_lf,
                       size_t acc_floats) {
  const size_t qe = (size_t)b * hw * cp, ke = (size_t)b * n * cp;
  Scratch s;
  s.q = 0;
  s.k = s.q + 2 * qp * qe;
  s.x = s.k + 2 * qp * ke;
  s.l = s.x + 2 * vp * ke;
  s.acc = (s.l + (has_lf ? 2 * vp * ke : 0) + 255) / 256 * 256;
  s.total = s.acc + acc_floats * sizeof(float);
  return s;
}
// the f32 routes' flush sums: the narrow walk's 32 per box of [xf | lf],
// the wide walk's 32 * WIDE_VB, per consumer thread and block
size_t narrow_acc_floats(int b, int hw, int cp, bool has_lf) {
  return (size_t)((hw + BQ - 1) / BQ) * b * CONSUMERS * 32 * value_boxes(cp, has_lf);
}
size_t wide_acc_floats(int b, int hw, int cp, bool has_lf) {
  return (size_t)((hw + BQ - 1) / BQ) * b * wide_slices(cp, has_lf) * CONSUMERS * 32 * WIDE_VB;
}

// --- the consumers' turns: named barriers 1 and 2, 256 threads each --------
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// x - bf16(x), exact in f32
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

// The split pre-pass: x (n4 float4) -> PARTS bf16 arrays of the same shape,
// part_stride elements apart, each the bf16 rounding of what the earlier
// parts leave.
template <int PARTS>
__global__ void __launch_bounds__(256)
split_kernel(const float4* __restrict__ x, __nv_bfloat16* __restrict__ out, size_t n4,
             size_t part_stride) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    float r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      uint2 packed;
      packed.x = pack_bf16(r[0], r[1]);
      packed.y = pack_bf16(r[2], r[3]);
      *reinterpret_cast<uint2*>(out + p * part_stride + 4 * i) = packed;
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = bf16_rest(r[e]);
    }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The pre-pass where c != cp: x (rows x c) -> PARTS bf16 arrays of rows x
// cp, part_stride elements apart, channels c..cp-1 zero; one thread per 4
// output channels (8-byte stores, cp % 8 == 0), scalar loads since the
// input rows are not aligned.  bf16 inputs: one part, their zero-padded copy.
template <typename TIn, int PARTS>
__global__ void __launch_bounds__(256)
split_pad_kernel(const TIn* __restrict__ x, __nv_bfloat16* __restrict__ out, size_t rows, int c,
                 int cp, size_t part_stride) {
  const int groups = cp / 4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < rows * groups;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / groups;
    const int ch = (int)(i % groups) * 4;
    const TIn* src = x + row * c + ch;
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = ch + e < c ? to_f32(src[e]) : 0.f;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      uint2 packed;
      packed.x = pack_bf16(r[0], r[1]);
      packed.y = pack_bf16(r[2], r[3]);
      *reinterpret_cast<uint2*>(out + p * part_stride + row * cp + ch) = packed;
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = bf16_rest(r[e]);
    }
  }
}

// The products (q part, k part) of QK^T, the smallest first: with 3 parts
// (0 = hi, 1 = mid, 2 = lo) the 6 of order >= 2^-16, mm, lh, hl, mh, hm, hh;
// with one part only the last, hh.
__host__ __device__ constexpr int q_part(int pr) { return pr == 0 ? 1 : pr == 1 ? 2 : pr == 3 ? 1 : 0; }
__host__ __device__ constexpr int k_part(int pr) { return pr == 0 ? 1 : pr == 2 ? 2 : pr == 4 ? 1 : 0; }
template <typename T> __host__ __device__ constexpr int first_product() {
  return Design<T>::QP == 1 ? 5 : 0;
}

// S (64 x BK, f32) = this warpgroup's 64 query rows . the stage's BK keys.
template <typename T, int NB>
__device__ __forceinline__ void issue_qk(float (&s)[Design<T>::BK / 2], uint32_t q_rows,
                                         uint32_t k_tile) {
  constexpr int FIRST = first_product<T>();
#pragma unroll
  for (int pr = FIRST; pr < 6; ++pr)
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // 16 channels = 32 bytes per step
        wgmma_ss(s, smem_desc(q_rows + (q_part(pr) * NB + cb) * Q_BOX_BYTES + kk * 32, 16, 1024),
                 smem_desc(k_tile + (k_part(pr) * NB + cb) * k_box_bytes<T>() + kk * 32, 16, 1024),
                 (pr != FIRST || cb != 0 || kk != 0));
}

// O += P (bf16 registers, 64 x BK) . V, V = [xf | lf] (BK keys x
// 64 * NB * (1 + lf) channels, MN-major: 64-channel boxes k_box_bytes apart,
// 8-key groups 1024 bytes apart).  f32: P = p_hi + p_lo and V = V_hi + V_lo,
// as p_lo V_hi + p_hi V_lo + p_hi V_hi.
template <typename T, int NO>
__device__ __forceinline__ void issue_pv(float (&o)[NO], const uint32_t (&p_hi)[Design<T>::BK / 4],
                                         const uint32_t (&p_lo)[Design<T>::BK / 4],
                                         uint32_t v_hi, uint32_t v_lo) {
  constexpr int KB = k_box_bytes<T>();
#pragma unroll
  for (int kk = 0; kk < Design<T>::BK / 16; ++kk) {   // 16 keys = 2048 bytes per step
    if constexpr (Design<T>::VP == 2) {
      wgmma_rs<NO>(o, &p_lo[4 * kk], smem_desc(v_hi + kk * 2048, KB, 1024));
      wgmma_rs<NO>(o, &p_hi[4 * kk], smem_desc(v_lo + kk * 2048, KB, 1024));
    }
    wgmma_rs<NO>(o, &p_hi[4 * kk], smem_desc(v_hi + kk * 2048, KB, 1024));
  }
}

// Streaming softmax of one scored tile s (this thread's BK / 2 values of two
// rows; keys from `valid` on are masked): new running max m, p = 2^(s log2e
// - m) in s, row sums into l and the reference's sum sr, O rescaled, p packed
// to bf16 (f32: split into p_hi + p_lo) for the PV products.
template <typename T, int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[Design<T>::BK / 2], float (&o)[NO],
                                             uint32_t (&p_hi)[Design<T>::BK / 4],
                                             uint32_t (&p_lo)[Design<T>::BK / 4], float (&m)[2],
                                             float (&l)[2], float (&sr)[2], int valid, int quad) {
  constexpr int NS = Design<T>::BK / 2;
  if (valid < Design<T>::BK) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (8 * (i / 4) + 2 * quad + i % 2 >= valid) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]) * LOG2E);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int h = (i / 2) % 2;
    s[i] = ex2(fmaf(s[i], LOG2E, -m[h]));
    rs[h] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = alpha[h] * l[h] + rs[h];
    sr[h] = alpha[h] * sr[h] + rs[h];
  }
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];
#pragma unroll
  for (int k = 0; k < NS / 2; ++k) {
    p_hi[k] = pack_bf16(s[2 * k], s[2 * k + 1]);
    if constexpr (Design<T>::VP == 2)
      p_lo[k] = pack_bf16(bf16_rest(s[2 * k]), bf16_rest(s[2 * k + 1]));
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
// Channels ch and ch + 1 (ch even, ch < c) of an output row of c channels:
// one paired store where c is even (aligned), else one or two single ones.
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int ch, int c, float a, float b) {
  if (c % 2 == 0) {
    store2(row + ch, a, b);
  } else {
    store1(row + ch, a);
    if (ch + 1 < c) store1(row + ch + 1, b);
  }
}

// Accumulator layout of wgmma m64nN (per warpgroup thread, warp w, lane l):
// register i holds row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2.  So a row lives in the quad of lanes with
// equal l / 4, and registers 8k .. 8k+7 of S packed pairwise are exactly the
// A fragment of keys 16k .. 16k+15 for the register-sourced PV product.
//
// tm_q / tm_k / tm_x / tm_l map the bf16 parts of the inputs as planes
// p * batch + b; acc holds the flush sums (f32 only).
template <typename T, int NB, bool HAS_LF>
__global__ void __launch_bounds__(THREADS, 1)
flash_ref_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_x,
                                const __grid_constant__ CUtensorMap tm_l,
                                T* __restrict__ out_x, T* __restrict__ out_l,
                                float* __restrict__ vis, float* __restrict__ acc, int batch,
                                int hw, int c, int n_refs, int hw_key) {
  using D = Design<T>;
  constexpr int BK = D::BK;
  constexpr int KB = k_box_bytes<T>();
  constexpr int NO = 32 * NB * (HAS_LF ? 2 : 1);   // output accumulators per thread
  constexpr int VB = 64 * NB;                      // value channels per output
  constexpr int NV = v_boxes(NB, HAS_LF);
  constexpr int SB = stage_bytes<T>(NB, HAS_LF);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t stages = base + q_bytes<T>(NB);
  const uint32_t bars = base + tiles_bytes<T>(NB, HAS_LF);   // full[], empty[], q_full
  const uint32_t q_full = bars + 16 * D::STAGES;
  float2* table = reinterpret_cast<float2*>(smem_raw + (bars - raw) + barrier_bytes<T>());

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tiles_per_ref = (hw_key + BK - 1) / BK;
  const int n_tiles = n_refs * tiles_per_ref;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < D::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (D::STAGES + s), CONSUMERS);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, q_bytes<T>(NB));
      for (int p = 0; p < D::QP; ++p)
        for (int cb = 0; cb < NB; ++cb)
          tma_load(q_tile + (p * NB + cb) * Q_BOX_BYTES, &tm_q, q_full, 64 * cb, q0,
                   p * batch + b);
      int stage = 0, ref = 0, j = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const uint32_t full = bars + 8 * stage;
        const uint32_t dst = stages + stage * SB;
        const int row = ref * hw_key + j * BK;
        mbar_wait(bars + 8 * (D::STAGES + stage), phase ^ 1);
        mbar_expect_tx(full, SB);
        for (int cb = 0; cb < NB; ++cb) {
          for (int p = 0; p < D::QP; ++p)
            tma_load(dst + (p * NB + cb) * KB, &tm_k, full, 64 * cb, row, p * batch + b);
          for (int p = 0; p < D::VP; ++p) {
            const uint32_t v = dst + (D::QP * NB + p * NV) * KB;
            tma_load(v + cb * KB, &tm_x, full, 64 * cb, row, p * batch + b);
            if (HAS_LF) tma_load(v + (NB + cb) * KB, &tm_l, full, 64 * cb, row, p * batch + b);
          }
        }
        if (++j == tiles_per_ref) { j = 0; ++ref; }
        if (++stage == D::STAGES) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int row0 = 64 * wg + 16 * ((threadIdx.x % 128) / 32) + lane / 4;   // and row0 + 8
    const uint32_t q_rows = q_tile + wg * (64 * 128);
    const int mine = 1 + wg, other = 2 - wg;

    float o[NO], s[BK / 2];
    uint32_t p_hi[BK / 4], p_lo[BK / 4];   // p_lo: f32 only
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, sr[2] = {0.f, 0.f};
    int ref = 0, j = 0;   // reference of the tile being scored, and its tile there
    // f32: this thread's flush sums (element i at my_acc[i * CONSUMERS]) and
    // the running max they are scaled to
    float* my_acc = acc + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * NO * CONSUMERS +
                    threadIdx.x;
    float m_flushed[2] = {-INFINITY, -INFINITY};
    bool flushed = false;

    // Softmax of the scored tile; at a reference's end record (s_r, m_r).
    auto score = [&]() {
      softmax_tile<T, NO>(s, o, p_hi, p_lo, m, l, sr, hw_key - j * BK, quad);
      if (j == tiles_per_ref - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float total = quad_sum(sr[h]);
          if (quad == 0) table[(row0 + 8 * h) * n_refs + ref] = make_float2(total, m[h]);
          sr[h] = 0.f;
        }
        j = 0;
        ++ref;
      } else {
        ++j;
      }
    };
    // The flushed sum, rescaled to the running max m, plus O; O restarts.
    auto flush = [&]() {
      float scale[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        scale[h] = ex2(m_flushed[h] - m[h]);
        m_flushed[h] = m[h];
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        float v = o[i];
        if (flushed) v = fmaf(my_acc[i * CONSUMERS], scale[(i / 2) % 2], v);
        my_acc[i * CONSUMERS] = v;
        o[i] = 0.f;
      }
      flushed = true;
    };
    auto fence_p = [&]() {
      fence_regs(p_hi);
      if constexpr (D::VP == 2) fence_regs(p_lo);
    };
    const auto values = [&](int st) { return stages + st * SB + D::QP * NB * KB; };

    if (wg == 1) turn_pass(1);   // warpgroup 0 takes the first turn
    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(bars, 0);
    turn_wait(mine);
    wgmma_fence();
    issue_qk<T, NB>(s, q_rows, stages);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    turn_pass(other);
    score();
    for (int t = 1; t < n_tiles; ++t) {
      const int prev = stage;
      if (++stage == D::STAGES) { stage = 0; phase ^= 1; }
      mbar_wait(bars + 8 * stage, phase);
      turn_wait(mine);
      wgmma_fence();
      issue_pv<T, NO>(o, p_hi, p_lo, values(prev), values(prev) + NV * KB);
      issue_qk<T, NB>(s, q_rows, stages + stage * SB);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(s);
      fence_p();
      turn_pass(other);
      mbar_arrive(bars + 8 * (D::STAGES + prev));
      if constexpr (D::FLUSH_TILES > 0)
        if (t % D::FLUSH_TILES == 0) flush();   // O holds tiles < t, at max m
      score();
    }
    turn_wait(mine);
    wgmma_fence();
    issue_pv<T, NO>(o, p_hi, p_lo, values(stage), values(stage) + NV * KB);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_p();
    if (wg == 0) turn_pass(other);   // warpgroup 1's last turn has no successor

    // ---------------- epilogue ----------------
    if constexpr (D::FLUSH_TILES > 0) {
      if (flushed) {
        float scale[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) scale[h] = ex2(m_flushed[h] - m[h]);
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] = fmaf(my_acc[i * CONSUMERS], scale[(i / 2) % 2], o[i]);
      }
    }
    float inv_l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = quad_sum(l[h]);
      inv_l[h] = 1.f / l[h];
    }
#pragma unroll
    for (int i = 0; i < NO; i += 2) {
      const int h = (i / 2) % 2;
      const int q = q0 + row0 + 8 * h;
      const int col = 8 * (i / 4) + 2 * quad;
      const int ch = col % VB;
      if (q < hw && ch < c) {
        T* out = (HAS_LF && col >= VB) ? out_l : out_x;
        store_pair(out + ((size_t)b * hw + q) * c, ch, c, o[i] * inv_l[h], o[i + 1] * inv_l[h]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const int q = q0 + row;
      if (q >= hw) continue;
      for (int r = quad; r < n_refs; r += 4) {
        const float2 e = table[row * n_refs + r];
        vis[((size_t)b * hw + q) * n_refs + r] = e.x * ex2(e.y - m[h]) * inv_l[h];
      }
    }
  }
}

// S (64 x BK, f32) (+)= this warpgroup's 64 query rows . the BK keys, over
// one 64-channel chunk: the query box's and the key box's parts, as
// issue_qk's products; FIRST_CHUNK starts the sum.
template <typename T, bool FIRST_CHUNK>
__device__ __forceinline__ void issue_qk_chunk(float (&s)[Design<T>::BK / 2], uint32_t q_rows,
                                               uint32_t k_box) {
  constexpr int FIRST = first_product<T>();
#pragma unroll
  for (int pr = FIRST; pr < 6; ++pr)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, smem_desc(q_rows + q_part(pr) * Q_BOX_BYTES + kk * 32, 16, 1024),
               smem_desc(k_box + k_part(pr) * k_box_bytes<T>() + kk * 32, 16, 1024),
               !(FIRST_CHUNK && pr == FIRST && kk == 0));
}

// The wide walk (128 < c <= 512).  Block (x, y, z): queries 128x..128x+127
// of batch element y, value boxes WIDE_VB z .. WIDE_VB z + WIDE_VB - 1 of
// [xf boxes 0..nq-1 | lf boxes 0..nq-1] (n_values of them in all).  The
// producer streams, per key tile, nq chunks [query box | key box] (their
// parts) into the QK ring and then the slice's value boxes into the V ring.
// Each consumer warpgroup (64 query rows; no turns) issues the previous
// tile's O += P V, then sums S over the chunks, keeping one chunk's
// products in flight while the next arrives and releasing a chunk (and the
// previous value tile) once its products are done; every product is done
// before the softmax, as the narrow walk's.  Every slice computes the same
// S, m, l and masses; slice 0 writes vis.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_ref_attention_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_x,
                                const __grid_constant__ CUtensorMap tm_l,
                                T* __restrict__ out_x, T* __restrict__ out_l,
                                float* __restrict__ vis, float* __restrict__ acc, int batch,
                                int hw, int c, int nq, int n_values, int n_refs, int hw_key) {
  using D = Design<T>;
  using W = Wide<T>;
  constexpr int BK = D::BK;
  constexpr int KB = k_box_bytes<T>();
  constexpr int NO = 32 * WIDE_VB;                 // output accumulators per thread
  constexpr int QKB = wide_qk_bytes<T>();
  constexpr int VBY = wide_v_bytes<T>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t qk_ring = base;
  const uint32_t v_ring = base + W::QK_STAGES * QKB;
  const uint32_t qk_full = base + wide_tiles_bytes<T>();
  const uint32_t qk_empty = qk_full + 8 * W::QK_STAGES;
  const uint32_t v_full = qk_empty + 8 * W::QK_STAGES;
  const uint32_t v_empty = v_full + 8 * W::V_STAGES;
  float2* table =
      reinterpret_cast<float2*>(smem_raw + (qk_full - raw) + wide_barrier_bytes<T>());

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int v0 = WIDE_VB * blockIdx.z;             // the slice's first value box
  const int nv = min(WIDE_VB, n_values - v0);      // its boxes that exist
  const int tiles_per_ref = (hw_key + BK - 1) / BK;
  const int n_tiles = n_refs * tiles_per_ref;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W::QK_STAGES; ++s) {
      mbar_init(qk_full + 8 * s, 1);
      mbar_init(qk_empty + 8 * s, CONSUMERS);
    }
    for (int s = 0; s < W::V_STAGES; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int qs = 0, vs = 0, ref = 0, j = 0;
      uint32_t q_phase = 0, v_phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int row = ref * hw_key + j * BK;
        for (int cb = 0; cb < nq; ++cb) {
          const uint32_t full = qk_full + 8 * qs;
          const uint32_t dst = qk_ring + qs * QKB;
          mbar_wait(qk_empty + 8 * qs, q_phase ^ 1);
          mbar_expect_tx(full, QKB);
          for (int p = 0; p < D::QP; ++p) {
            tma_load(dst + p * Q_BOX_BYTES, &tm_q, full, 64 * cb, q0, p * batch + b);
            tma_load(dst + D::QP * Q_BOX_BYTES + p * KB, &tm_k, full, 64 * cb, row,
                     p * batch + b);
          }
          if (++qs == W::QK_STAGES) { qs = 0; q_phase ^= 1; }
        }
        const uint32_t full = v_full + 8 * vs;
        const uint32_t dst = v_ring + vs * VBY;
        mbar_wait(v_empty + 8 * vs, v_phase ^ 1);
        mbar_expect_tx(full, D::VP * nv * KB);
        for (int p = 0; p < D::VP; ++p)
          for (int v = 0; v < nv; ++v) {
            const int g = v0 + v;
            tma_load(dst + (p * WIDE_VB + v) * KB, g < nq ? &tm_x : &tm_l, full, 64 * (g % nq),
                     row, p * batch + b);
          }
        if (++vs == W::V_STAGES) { vs = 0; v_phase ^= 1; }
        if (++j == tiles_per_ref) { j = 0; ++ref; }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int row0 = 64 * wg + 16 * ((threadIdx.x % 128) / 32) + lane / 4;   // and row0 + 8
    const uint32_t rows = wg * (64 * 128);   // this warpgroup's rows in a query box

    float o[NO], s[BK / 2];
    uint32_t p_hi[BK / 4], p_lo[BK / 4];   // p_lo: f32 only
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, sr[2] = {0.f, 0.f};
    int ref = 0, j = 0;
    float* my_acc = acc +
                    (size_t)((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
                        NO * CONSUMERS +
                    threadIdx.x;
    float m_flushed[2] = {-INFINITY, -INFINITY};
    bool flushed = false;

    auto score = [&]() {
      softmax_tile<T, NO>(s, o, p_hi, p_lo, m, l, sr, hw_key - j * BK, quad);
      if (j == tiles_per_ref - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float total = quad_sum(sr[h]);
          if (quad == 0) table[(row0 + 8 * h) * n_refs + ref] = make_float2(total, m[h]);
          sr[h] = 0.f;
        }
        j = 0;
        ++ref;
      } else {
        ++j;
      }
    };
    auto flush = [&]() {
      float scale[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        scale[h] = ex2(m_flushed[h] - m[h]);
        m_flushed[h] = m[h];
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        float v = o[i];
        if (flushed) v = fmaf(my_acc[i * CONSUMERS], scale[(i / 2) % 2], v);
        my_acc[i * CONSUMERS] = v;
        o[i] = 0.f;
      }
      flushed = true;
    };
    auto fence_p = [&]() {
      fence_regs(p_hi);
      if constexpr (D::VP == 2) fence_regs(p_lo);
    };

    int qs = 0, vs = 0;
    uint32_t q_phase = 0, v_phase = 0;
    // O += P V of the tile scored last, from V ring slot vs
    auto issue_values = [&]() {
      mbar_wait(v_full + 8 * vs, v_phase);
      const uint32_t v = v_ring + vs * VBY;
      wgmma_fence();
      issue_pv<T, NO>(o, p_hi, p_lo, v, v + WIDE_VB * KB);
      wgmma_commit();
    };
    for (int t = 0; t < n_tiles; ++t) {
      if (t > 0) issue_values();
      int prev = -1;    // the QK ring slot of the chunk before
      for (int cb = 0; cb < nq; ++cb) {
        mbar_wait(qk_full + 8 * qs, q_phase);
        const uint32_t chunk = qk_ring + qs * QKB;
        wgmma_fence();
        if (cb == 0)
          issue_qk_chunk<T, true>(s, chunk + rows, chunk + D::QP * Q_BOX_BYTES);
        else
          issue_qk_chunk<T, false>(s, chunk + rows, chunk + D::QP * Q_BOX_BYTES);
        wgmma_commit();
        wgmma_wait<1>();   // all but this chunk's products are done
        if (prev >= 0) {
          mbar_arrive(qk_empty + 8 * prev);
        } else if (t > 0) {   // the previous tile's values
          mbar_arrive(v_empty + 8 * vs);
          if (++vs == W::V_STAGES) { vs = 0; v_phase ^= 1; }
        }
        prev = qs;
        if (++qs == W::QK_STAGES) { qs = 0; q_phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s);
      fence_p();
      mbar_arrive(qk_empty + 8 * prev);
      if constexpr (D::FLUSH_TILES > 0)
        if (t > 0 && t % D::FLUSH_TILES == 0) flush();   // O holds tiles < t, at max m
      score();
    }
    issue_values();
    wgmma_wait<0>();
    fence_regs(o);
    fence_p();

    // ---------------- epilogue ----------------
    if constexpr (D::FLUSH_TILES > 0) {
      if (flushed) {
        float scale[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) scale[h] = ex2(m_flushed[h] - m[h]);
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] = fmaf(my_acc[i * CONSUMERS], scale[(i / 2) % 2], o[i]);
      }
    }
    float inv_l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = quad_sum(l[h]);
      inv_l[h] = 1.f / l[h];
    }
#pragma unroll
    for (int i = 0; i < NO; i += 2) {
      const int h = (i / 2) % 2;
      const int q = q0 + row0 + 8 * h;
      const int col = 8 * (i / 4) + 2 * quad;
      const int g = v0 + col / 64;
      const int ch = 64 * (g % nq) + col % 64;
      if (q < hw && g < n_values && ch < c) {
        T* out = g < nq ? out_x : out_l;
        store_pair(out + ((size_t)b * hw + q) * c, ch, c, o[i] * inv_l[h], o[i + 1] * inv_l[h]);
      }
    }
    if (blockIdx.z == 0) {
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const int q = q0 + row;
        if (q >= hw) continue;
        for (int r = quad; r < n_refs; r += 4) {
          const float2 e = table[row * n_refs + r];
          vis[((size_t)b * hw + q) * n_refs + r] = e.x * ex2(e.y - m[h]) * inv_l[h];
        }
      }
    }
  }
}

template <typename T, int NB, bool HAS_LF>
int launch(const CUtensorMap* maps, void* ox, void* ol, void* vis, void* acc, int b, int hw,
           int n, int c, int n_refs, cudaStream_t stream) {
  auto kern = flash_ref_attention_sm90_kernel<T, NB, HAS_LF>;
  const size_t smem = smem_bytes<T>(NB, HAS_LF, n_refs);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hw + BQ - 1) / BQ, b);
  kern<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], static_cast<T*>(ox),
                                        static_cast<T*>(ol), static_cast<float*>(vis),
                                        static_cast<float*>(acc), b, hw, c, n_refs, n / n_refs);
  return (int)cudaGetLastError();
}

// The narrow walk on tensor maps of cp channels (cp <= 128), stores of c.
template <typename T>
int launch_for(const CUtensorMap* maps, bool has_lf, void* ox, void* ol, void* vis, void* acc,
               int b, int hw, int n, int c, int cp, int n_refs, cudaStream_t s) {
  if (cp <= 64)
    return has_lf ? launch<T, 1, true>(maps, ox, ol, vis, acc, b, hw, n, c, n_refs, s)
                  : launch<T, 1, false>(maps, ox, ol, vis, acc, b, hw, n, c, n_refs, s);
  return has_lf ? launch<T, 2, true>(maps, ox, ol, vis, acc, b, hw, n, c, n_refs, s)
                : launch<T, 2, false>(maps, ox, ol, vis, acc, b, hw, n, c, n_refs, s);
}

// The wide walk on tensor maps of cp channels (128 < cp <= 512), stores of c.
template <typename T>
int launch_wide(const CUtensorMap* maps, bool has_lf, void* ox, void* ol, void* vis, void* acc,
                int b, int hw, int n, int c, int cp, int n_refs, cudaStream_t stream) {
  auto kern = flash_ref_attention_wide_kernel<T>;
  const size_t smem = wide_smem_bytes<T>(n_refs);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hw + BQ - 1) / BQ, b, wide_slices(cp, has_lf));
  kern<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], static_cast<T*>(ox),
                                        static_cast<T*>(ol), static_cast<float*>(vis),
                                        static_cast<float*>(acc), b, hw, c, boxes(cp),
                                        value_boxes(cp, has_lf), n_refs, n / n_refs);
  return (int)cudaGetLastError();
}

template <int PARTS>
cudaError_t split(const void* x, void* out, size_t n, cudaStream_t stream) {
  const size_t n4 = n / 4;
  const int blocks = (int)((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
  split_kernel<PARTS><<<blocks, 256, 0, stream>>>(static_cast<const float4*>(x),
                                                  static_cast<__nv_bfloat16*>(out), n4, n);
  return cudaGetLastError();
}

// x (rows x c of TIn) as PARTS bf16 arrays of rows x cp: split_kernel where
// nothing is padded, else split_pad_kernel.
template <typename TIn, int PARTS>
cudaError_t to_parts(const void* x, void* out, size_t rows, int c, int cp, cudaStream_t stream) {
  if constexpr (sizeof(TIn) == 4) {
    if (c == cp) return split<PARTS>(x, out, rows * c, stream);
  }
  const size_t groups = rows * (cp / 4);
  const int blocks = (int)((groups + 255) / 256 < 132 * 16 ? (groups + 255) / 256 : 132 * 16);
  split_pad_kernel<TIn, PARTS><<<blocks, 256, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<__nv_bfloat16*>(out), rows, c, cp, rows * cp);
  return cudaGetLastError();
}

// The pre-pass into scratch laid out by sc, then the four tensor maps on it.
template <typename TIn, int QP, int VP>
int prepare(EncodeTiled fn, CUtensorMap* maps, const void* query, const void* key,
            const void* xf, const void* lf, uint8_t* base, const Scratch& sc, int b, int hw,
            int n, int c, int cp, int key_box, cudaStream_t s) {
  void *qp = base + sc.q, *kp = base + sc.k, *xp = base + sc.x, *lp = base + sc.l;
  if (!encode(fn, &maps[0], qp, QP * b, hw, cp, BQ) ||
      !encode(fn, &maps[1], kp, QP * b, n, cp, key_box) ||
      !encode(fn, &maps[2], xp, VP * b, n, cp, key_box) ||
      !encode(fn, &maps[3], lf ? lp : xp, VP * b, n, cp, key_box))
    return -2;
  cudaError_t err = to_parts<TIn, QP>(query, qp, (size_t)b * hw, c, cp, s);
  if (err == cudaSuccess) err = to_parts<TIn, QP>(key, kp, (size_t)b * n, c, cp, s);
  if (err == cudaSuccess) err = to_parts<TIn, VP>(xf, xp, (size_t)b * n, c, cp, s);
  if (err == cudaSuccess && lf) err = to_parts<TIn, VP>(lf, lp, (size_t)b * n, c, cp, s);
  return (int)err;
}

// The four tensor maps on the bf16 inputs themselves (c % 8 == 0).
int encode_inputs(EncodeTiled fn, CUtensorMap* maps, const void* query, const void* key,
                  const void* xf, const void* lf, int b, int hw, int n, int c, int key_box) {
  return encode(fn, &maps[0], query, b, hw, c, BQ) && encode(fn, &maps[1], key, b, n, c, key_box) &&
                 encode(fn, &maps[2], xf, b, n, c, key_box) &&
                 encode(fn, &maps[3], lf ? lf : xf, b, n, c, key_box)
             ? 0
             : -2;
}

bool valid_shape(int b, int hw, int n, int c, int n_refs, int min_c, int max_c) {
  return b >= 1 && hw >= 1 && n_refs >= 1 && n >= n_refs && n % n_refs == 0 && c >= min_c &&
         c <= max_c;
}
bool narrow_shape(int b, int hw, int n, int c, int n_refs) {
  return valid_shape(b, hw, n, c, n_refs, 1, NARROW_MAX_C);
}
bool wide_shape(int b, int hw, int n, int c, int n_refs) {
  return valid_shape(b, hw, n, c, n_refs, NARROW_MAX_C + 1, MAX_C);
}

// The bf16 routes' scratch: the zero-padded inputs where c % 8 != 0, else none.
Scratch bf16_scratch(int b, int hw, int n, int c, bool has_lf) {
  return scratch_layout(1, 1, b, hw, n, c % 8 ? padded(c) : 0, has_lf, 0);
}

}  // namespace

extern "C" {

// Every entry point: query (b, hw, c); key / xf / lf (b, n, c), lf may be
// null; contiguous, 16-byte aligned.  out_x / out_l: (b, hw, c) of the
// inputs' dtype; vis: (b, hw, n_refs) f32.  Scratch, where an entry takes
// it: the bytes its *_scratch_bytes function gives, 256-byte aligned.  Each
// launches on `stream` without synchronising and returns 0, a CUDA error
// code, -1 when the CUDA driver has no cuTensorMapEncodeTiled, or -2 when a
// tensor map cannot be encoded.

// bf16, c % 8 == 0, c <= 128: the narrow walk on the inputs.
int fsv_flash_ref_attention_sm90(const void* query, const void* key, const void* xf,
                                 const void* lf, void* out_x, void* out_l, void* vis, int b,
                                 int hw, int n, int c, int n_refs, void* stream) {
  if (!narrow_shape(b, hw, n, c, n_refs) || c % 8) return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  CUtensorMap maps[4];
  if (encode_inputs(fn, maps, query, key, xf, lf, b, hw, n, c, Design<__nv_bfloat16>::BK))
    return -2;
  return launch_for<__nv_bfloat16>(maps, lf != nullptr, out_x, out_l, vis, nullptr, b, hw, n, c,
                                   c, n_refs, static_cast<cudaStream_t>(stream));
}

// Bytes of scratch one bf16 call of the ragged (c <= 128, c % 8 != 0) or
// wide (128 < c <= 512) route needs: the inputs zero-padded to a multiple
// of 8 channels, or 0 where c % 8 == 0; 0 for a shape neither takes.
size_t fsv_flash_ref_attention_sm90_padded_scratch_bytes(int b, int hw, int n, int c, int n_refs,
                                                         int has_lf) {
  if (!valid_shape(b, hw, n, c, n_refs, 1, MAX_C)) return 0;
  return bf16_scratch(b, hw, n, c, has_lf != 0).total;
}

// bf16, c <= 128, c % 8 != 0: the zero-padding pass, then the narrow walk.
int fsv_flash_ref_attention_sm90_ragged(const void* query, const void* key, const void* xf,
                                        const void* lf, void* scratch, void* out_x, void* out_l,
                                        void* vis, int b, int hw, int n, int c, int n_refs,
                                        void* stream) {
  if (!narrow_shape(b, hw, n, c, n_refs) || c % 8 == 0) return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = padded(c);
  CUtensorMap maps[4];
  const int err = prepare<__nv_bfloat16, 1, 1>(fn, maps, query, key, xf, lf,
                                               static_cast<uint8_t*>(scratch),
                                               bf16_scratch(b, hw, n, c, lf != nullptr), b, hw,
                                               n, c, cp, Design<__nv_bfloat16>::BK, s);
  if (err) return err;
  return launch_for<__nv_bfloat16>(maps, lf != nullptr, out_x, out_l, vis, nullptr, b, hw, n, c,
                                   cp, n_refs, s);
}

// bf16, 128 < c <= 512: the wide walk, on the inputs where c % 8 == 0, else
// after the zero-padding pass.
int fsv_flash_ref_attention_sm90_wide(const void* query, const void* key, const void* xf,
                                      const void* lf, void* scratch, void* out_x, void* out_l,
                                      void* vis, int b, int hw, int n, int c, int n_refs,
                                      void* stream) {
  if (!wide_shape(b, hw, n, c, n_refs)) return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int BK = Design<__nv_bfloat16>::BK;
  const int cp = padded(c);
  CUtensorMap maps[4];
  const int err = c % 8 ? prepare<__nv_bfloat16, 1, 1>(fn, maps, query, key, xf, lf,
                                                       static_cast<uint8_t*>(scratch),
                                                       bf16_scratch(b, hw, n, c, lf != nullptr),
                                                       b, hw, n, c, cp, BK, s)
                        : encode_inputs(fn, maps, query, key, xf, lf, b, hw, n, c, BK);
  if (err) return err;
  return launch_wide<__nv_bfloat16>(maps, lf != nullptr, out_x, out_l, vis, nullptr, b, hw, n, c,
                                    cp, n_refs, s);
}

// Bytes of scratch one f32 call with c <= 128 needs; 0 for a shape it does
// not take.
size_t fsv_flash_ref_attention_sm90_f32_scratch_bytes(int b, int hw, int n, int c, int n_refs,
                                                      int has_lf) {
  using D = Design<float>;
  if (!narrow_shape(b, hw, n, c, n_refs)) return 0;
  const int cp = padded(c);
  return scratch_layout(D::QP, D::VP, b, hw, n, cp, has_lf != 0,
                        narrow_acc_floats(b, hw, cp, has_lf != 0))
      .total;
}

// f32, c <= 128: the split pre-pass (zero-padding c to a multiple of 8),
// then the narrow walk.
int fsv_flash_ref_attention_sm90_f32(const void* query, const void* key, const void* xf,
                                     const void* lf, void* scratch, void* out_x, void* out_l,
                                     void* vis, int b, int hw, int n, int c, int n_refs,
                                     void* stream) {
  using D = Design<float>;
  if (!narrow_shape(b, hw, n, c, n_refs)) return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = padded(c);
  const Scratch sc = scratch_layout(D::QP, D::VP, b, hw, n, cp, lf != nullptr,
                                    narrow_acc_floats(b, hw, cp, lf != nullptr));
  uint8_t* base = static_cast<uint8_t*>(scratch);
  CUtensorMap maps[4];
  const int err = prepare<float, D::QP, D::VP>(fn, maps, query, key, xf, lf, base, sc, b, hw, n,
                                               c, cp, D::BK, s);
  if (err) return err;
  return launch_for<float>(maps, lf != nullptr, out_x, out_l, vis, base + sc.acc, b, hw, n, c, cp,
                           n_refs, s);
}

// Bytes of scratch one f32 call with 128 < c <= 512 needs; 0 for a shape
// it does not take.
size_t fsv_flash_ref_attention_sm90_wide_f32_scratch_bytes(int b, int hw, int n, int c,
                                                           int n_refs, int has_lf) {
  using D = Design<float>;
  if (!wide_shape(b, hw, n, c, n_refs)) return 0;
  const int cp = padded(c);
  return scratch_layout(D::QP, D::VP, b, hw, n, cp, has_lf != 0,
                        wide_acc_floats(b, hw, cp, has_lf != 0))
      .total;
}

// f32, 128 < c <= 512: the split pre-pass, then the wide walk.
int fsv_flash_ref_attention_sm90_wide_f32(const void* query, const void* key, const void* xf,
                                          const void* lf, void* scratch, void* out_x,
                                          void* out_l, void* vis, int b, int hw, int n, int c,
                                          int n_refs, void* stream) {
  using D = Design<float>;
  if (!wide_shape(b, hw, n, c, n_refs)) return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = padded(c);
  const Scratch sc = scratch_layout(D::QP, D::VP, b, hw, n, cp, lf != nullptr,
                                    wide_acc_floats(b, hw, cp, lf != nullptr));
  uint8_t* base = static_cast<uint8_t*>(scratch);
  CUtensorMap maps[4];
  const int err = prepare<float, D::QP, D::VP>(fn, maps, query, key, xf, lf, base, sc, b, hw, n,
                                               c, cp, D::BK, s);
  if (err) return err;
  return launch_wide<float>(maps, lf != nullptr, out_x, out_l, vis, base + sc.acc, b, hw, n, c, cp,
                            n_refs, s);
}

}  // extern "C"
