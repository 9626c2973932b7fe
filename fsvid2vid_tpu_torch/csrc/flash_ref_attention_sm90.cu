// Multi-reference flash attention for Hopper (sm_90a) in bf16, forward only:
// the tensor-core route of kernel B1.
//
// Replaces the Pallas TPU kernel fsvid2vid_tpu/ops/pallas/attention_kernel.py
// (flash_ref_attention, body _kernel) for bf16 inputs with c % 8 == 0 and
// c <= 128; csrc/flash_ref_attention.cu keeps f32 and the other channel
// counts.  For each batch element b and query q, with N = K * hw_key keys:
//
//   s[n]         = query[b,q,:] . key[b,n,:]
//   out_x[b,q,:] = sum_n softmax_n(s)[n] * xf[b,n,:]
//   out_l[b,q,:] = sum_n softmax_n(s)[n] * lf[b,n,:]          (optional)
//   vis[b,q,r]   = sum_{n : n / hw_key == r} softmax_n(s)[n]  (f32)
//
// As in the TPU kernel: the softmax runs in the exp2 domain, the running max,
// sum and accumulators are f32, p is rounded to bf16 before the value
// products, and l and vis use the unrounded p.
//
// Bound on an H100 SXM at the serving shape (face 512 px, K = 8: B = 1,
// hw = 16384, N = 131072, c = 128, with lf): 1.65e12 FLOP of products, 1.7 ms
// at the 989 TFLOP/s bf16 tensor-core peak, against ~34 us for the ~113 MB
// of inputs and outputs; the 2.1e9 exponentials take ~0.55 ms of the
// special-function units besides.  The call is bound by operations.
//
// Design.  A block owns BQ = 128 queries of one batch element and is three
// warpgroups: a producer and two consumers of 64 query rows each.
//  - The producer's one thread loads the query tile once and then streams
//    key tiles of BK = 64 keys (K, xf and lf, 64 channels per TMA box, 128-byte
//    swizzle) into a ring of STAGES shared-memory stages, each guarded by a
//    "full" mbarrier (TMA transaction count) and an "empty" one (released by
//    all 256 consumer threads).
//  - A consumer computes S = Q K^T with wgmma m64n64k16 (both operands
//    K-major in shared memory), the streaming softmax on the accumulator
//    registers (a row lives in a quad of threads), then O += P V with the
//    register-sourced wgmma (P packed to bf16 straight from the S
//    accumulators; xf and lf together as one MN-major B operand of width
//    64 * NB * (1 + has_lf), so one instruction feeds both outputs).
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
//  - Ragged shapes: TMA zero-fills query rows past hw (never stored) and
//    channels past c (stores are masked to c).  Rows need 16-byte strides,
//    hence c % 8 == 0.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                 // queries per block
constexpr int BK = 64;                  // keys per tile
constexpr int STAGES = 3;               // key tiles in flight
constexpr int THREADS = 384;            // two consumer warpgroups, one producer
constexpr int CONSUMERS = 256;
constexpr int MAX_C = 128;
constexpr int Q_BOX_BYTES = BQ * 128;   // 128 query rows x 64 bf16 channels
constexpr int K_BOX_BYTES = BK * 128;   // 64 keys x 64 bf16 channels
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base (128-byte swizzle atoms):
// the query tile, STAGES key stages [K | xf | lf] of NB boxes each, the
// mbarriers, and a (BQ, n_refs) table of (s_r, m_r).
__host__ __device__ constexpr int q_bytes(int nb) { return nb * Q_BOX_BYTES; }
__host__ __device__ constexpr int stage_bytes(int nb, bool has_lf) {
  return nb * K_BOX_BYTES * (has_lf ? 3 : 2);
}
__host__ __device__ constexpr int tiles_bytes(int nb, bool has_lf) {
  return q_bytes(nb) + STAGES * stage_bytes(nb, has_lf);
}
constexpr int BARRIER_BYTES = 8 * (2 * STAGES + 1);
__host__ __device__ constexpr size_t smem_bytes(int nb, bool has_lf, int n_refs) {
  return 1024 + tiles_bytes(nb, has_lf) + BARRIER_BYTES + (size_t)BQ * n_refs * sizeof(float2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA -----------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the barrier's phase with the given parity has completed.  A
// wait of more than 2^35 cycles (~20 s) means a fault in the pipeline: trap,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 35)) __trap();
  }
}
// One box of a 3-D tensor map (channel, row, batch) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int ch, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(ch), "r"(row), "r"(batch)
      : "memory");
}

// --- the consumers' turns: named barriers 1 and 2, 256 threads each --------
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// --- wgmma -------------------------------------------------------------------
// Shared-memory matrix descriptor for a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Registers an async wgmma reads or writes: pinned at this point for the
// compiler, so it neither reuses nor reads them before the wait.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[0:32] (+)= A (64x16, K-major, shared) * B (16x64, K-major, shared)
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:32] += A (64x16, registers) * B (16x64, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:64] += A (64x16, registers) * B (16x128, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:128] += A (64x16, registers) * B (16x256, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128], const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int NO> __device__ __forceinline__ void wgmma_rs(float (&d)[NO], const uint32_t* a,
                                                          uint64_t db);
template <> __device__ __forceinline__ void wgmma_rs<32>(float (&d)[32], const uint32_t* a,
                                                         uint64_t db) {
  wgmma_rs_m64n64k16(d, a, db);
}
template <> __device__ __forceinline__ void wgmma_rs<64>(float (&d)[64], const uint32_t* a,
                                                         uint64_t db) {
  wgmma_rs_m64n128k16(d, a, db);
}
template <> __device__ __forceinline__ void wgmma_rs<128>(float (&d)[128], const uint32_t* a,
                                                          uint64_t db) {
  wgmma_rs_m64n256k16(d, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 64, f32) = this warpgroup's 64 query rows . the stage's 64 keys.
template <int NB>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // 16 channels = 32 bytes per step
      wgmma_ss_m64n64k16(s, smem_desc(q_tile + cb * Q_BOX_BYTES + kk * 32, 16, 1024),
                         smem_desc(k_tile + cb * K_BOX_BYTES + kk * 32, 16, 1024),
                         (cb | kk) != 0);
}

// O += P (bf16 registers, 64 x 64) . [xf | lf] (64 keys x 64 * NB * (1 + lf)
// channels, MN-major: 64-channel boxes K_BOX_BYTES apart, 8-key groups
// 1024 bytes apart).
template <int NO>
__device__ __forceinline__ void issue_pv(float (&o)[NO], const uint32_t (&p)[16], uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)   // 16 keys = 2048 bytes per step
    wgmma_rs<NO>(o, &p[4 * kk], smem_desc(v_tile + kk * 2048, K_BOX_BYTES, 1024));
}

// Streaming softmax of one scored tile s (this thread's 32 values of two
// rows; keys from `valid` on are masked): new running max m, p = 2^(s log2e
// - m) in s, row sums into l and the reference's sum sr, O rescaled, p packed
// to bf16 for the PV product.
template <int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&o)[NO], uint32_t (&p)[16],
                                             float (&m)[2], float (&l)[2], float (&sr)[2],
                                             int valid, int quad) {
  if (valid < BK) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (8 * (i / 4) + 2 * quad + i % 2 >= valid) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]) * LOG2E);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
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
  for (int k = 0; k < 16; ++k) p[k] = pack_bf16(s[2 * k], s[2 * k + 1]);
}

// Accumulator layout of wgmma m64nN (per warpgroup thread, warp w, lane l):
// register i holds row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2.  So a row lives in the quad of lanes with
// equal l / 4, and registers 8k .. 8k+7 of S packed pairwise are exactly the
// A fragment of keys 16k .. 16k+15 for the register-sourced PV product.
template <int NB, bool HAS_LF>
__global__ void __launch_bounds__(THREADS, 1)
flash_ref_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_x,
                                const __grid_constant__ CUtensorMap tm_l,
                                __nv_bfloat16* __restrict__ out_x,
                                __nv_bfloat16* __restrict__ out_l, float* __restrict__ vis,
                                int hw, int c, int n_refs, int hw_key) {
  constexpr int NO = 32 * NB * (HAS_LF ? 2 : 1);   // output accumulators per thread
  constexpr int VB = 64 * NB;                      // value channels per output
  constexpr int SB = stage_bytes(NB, HAS_LF);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t stages = base + q_bytes(NB);
  const uint32_t bars = base + tiles_bytes(NB, HAS_LF);   // full[STAGES], empty[STAGES], q_full
  const uint32_t q_full = bars + 16 * STAGES;
  float2* table = reinterpret_cast<float2*>(smem_raw + (bars - raw) + BARRIER_BYTES);

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tiles_per_ref = (hw_key + BK - 1) / BK;
  const int n_tiles = n_refs * tiles_per_ref;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), CONSUMERS);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, q_bytes(NB));
      for (int cb = 0; cb < NB; ++cb)
        tma_load(q_tile + cb * Q_BOX_BYTES, &tm_q, q_full, 64 * cb, q0, b);
      int stage = 0, ref = 0, j = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const uint32_t full = bars + 8 * stage;
        const uint32_t dst = stages + stage * SB;
        const int row = ref * hw_key + j * BK;
        mbar_wait(bars + 8 * (STAGES + stage), phase ^ 1);
        mbar_expect_tx(full, SB);
        for (int cb = 0; cb < NB; ++cb) {
          tma_load(dst + cb * K_BOX_BYTES, &tm_k, full, 64 * cb, row, b);
          tma_load(dst + (NB + cb) * K_BOX_BYTES, &tm_x, full, 64 * cb, row, b);
          if (HAS_LF) tma_load(dst + (2 * NB + cb) * K_BOX_BYTES, &tm_l, full, 64 * cb, row, b);
        }
        if (++j == tiles_per_ref) { j = 0; ++ref; }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
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

    float o[NO], s[32];
    uint32_t p[16];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, sr[2] = {0.f, 0.f};
    int ref = 0, j = 0;   // reference of the tile being scored, and its tile there

    // Softmax of the scored tile; at a reference's end record (s_r, m_r).
    auto score = [&]() {
      softmax_tile<NO>(s, o, p, m, l, sr, hw_key - j * BK, quad);
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

    if (wg == 1) turn_pass(1);   // warpgroup 0 takes the first turn
    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(bars, 0);
    turn_wait(mine);
    wgmma_fence();
    issue_qk<NB>(s, q_rows, stages);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    turn_pass(other);
    score();
    for (int t = 1; t < n_tiles; ++t) {
      const int prev = stage;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
      mbar_wait(bars + 8 * stage, phase);
      turn_wait(mine);
      wgmma_fence();
      issue_pv<NO>(o, p, stages + prev * SB + NB * K_BOX_BYTES);
      issue_qk<NB>(s, q_rows, stages + stage * SB);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(s);
      fence_regs(p);
      turn_pass(other);
      mbar_arrive(bars + 8 * (STAGES + prev));
      score();
    }
    turn_wait(mine);
    wgmma_fence();
    issue_pv<NO>(o, p, stages + stage * SB + NB * K_BOX_BYTES);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p);
    if (wg == 0) turn_pass(other);   // warpgroup 1's last turn has no successor

    // ---------------- epilogue ----------------
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
        __nv_bfloat16* out = (HAS_LF && col >= VB) ? out_l : out_x;
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * hw + q) * c + ch) =
            __floats2bfloat162_rn(o[i] * inv_l[h], o[i + 1] * inv_l[h]);
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

// cuTensorMapEncodeTiled, fetched from the CUDA driver through the runtime, so
// the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (batch, rows, c) bf16, contiguous, as a 3-D map of 64-channel x box_rows
// boxes with 128-byte swizzle; reads outside the tensor return zeros.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch, int rows, int c,
            int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)c * 2, (cuuint64_t)rows * c * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB, bool HAS_LF>
int launch(const CUtensorMap* maps, void* ox, void* ol, void* vis, int b, int hw, int n, int c,
           int n_refs, cudaStream_t stream) {
  auto kern = flash_ref_attention_sm90_kernel<NB, HAS_LF>;
  const size_t smem = smem_bytes(NB, HAS_LF, n_refs);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hw + BQ - 1) / BQ, b);
  kern<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                        static_cast<__nv_bfloat16*>(ox),
                                        static_cast<__nv_bfloat16*>(ol), static_cast<float*>(vis),
                                        hw, c, n_refs, n / n_refs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// query: (b, hw, c); key / xf / lf: (b, n, c), lf may be null; all bf16,
// contiguous, 16-byte aligned, c % 8 == 0, c <= 128.  out_x / out_l:
// (b, hw, c) bf16; vis: (b, hw, n_refs) f32.  Launches on `stream` without
// synchronising and returns 0, a CUDA error code, -1 when the CUDA driver has no
// cuTensorMapEncodeTiled, or -2 when a tensor map cannot be encoded.
int fsv_flash_ref_attention_sm90(const void* query, const void* key, const void* xf,
                                 const void* lf, void* out_x, void* out_l, void* vis, int b,
                                 int hw, int n, int c, int n_refs, void* stream) {
  if (b < 1 || hw < 1 || n_refs < 1 || n < n_refs || n % n_refs || c < 8 || c > MAX_C ||
      c % 8)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  CUtensorMap maps[4];
  if (!encode(fn, &maps[0], query, b, hw, c, BQ) || !encode(fn, &maps[1], key, b, n, c, BK) ||
      !encode(fn, &maps[2], xf, b, n, c, BK) ||
      !encode(fn, &maps[3], lf ? lf : xf, b, n, c, BK))
    return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 64)
    return lf ? launch<1, true>(maps, out_x, out_l, vis, b, hw, n, c, n_refs, s)
              : launch<1, false>(maps, out_x, out_l, vis, b, hw, n, c, n_refs, s);
  return lf ? launch<2, true>(maps, out_x, out_l, vis, b, hw, n, c, n_refs, s)
            : launch<2, false>(maps, out_x, out_l, vis, b, hw, n, c, n_refs, s);
}

}  // extern "C"
