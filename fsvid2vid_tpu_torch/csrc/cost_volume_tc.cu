// FlowNetC correlation cost volume for Hopper (sm_90a) on the tensor cores,
// forward only: kernel B2, for every displacement grid.
//
// Replaces the Pallas TPU kernel fsvid2vid_tpu/ops/pallas/cost_volume_kernel.py
// (cost_volume_pallas, body _kernel) for any max_displacement md >= 0 and
// stride s >= 1.  With D = 2 * (md / s) + 1, R = s * (md / s) and dy, dx in
// {-R, -R + s, ..., R}:
//
//   out[b, dyi * D + dxi, y, x] = (1/C) * sum_c f1[b,c,y,x] * f2[b,c,y+dy,x+dx]
//
// with f2 read as zero outside the map.  f1, f2: (B, C, H, W) and out:
// (B, D*D, H, W), contiguous, float32 or bfloat16; accumulation is f32 and
// the sum is multiplied by 1/C before it is rounded to the output type.
// B and H are at most 65,535 (grid dimensions); nothing else is limited.
//
// Bound on an H100 SXM.  The useful products are those of the (pixel,
// shift) pairs whose shifted pixel lies in the map; the bytes are f1 and f2
// read once and the output written once.  At the face teacher's shape
// (face 256 px, batch 4 x 3 frames: B = 12, C = 256, H = W = 32, md 20,
// s 2, D = 21) that is 1.26 GFLOP (7.6 us as 3xTF32 at the 495 TFLOP/s tf32
// peak) against 46.8 MB (14.0 us at 3.35 TB/s): bound by bytes.  At s = 1
// (D = 41) the output alone is 82.6 MB: 107.8 MB, 32.2 us, against 4.89
// GFLOP (29.6 us as 3xTF32).  This design's own products (below) are ~1.9x
// the band's in tf32, 3 times over for f32 inputs.
//
// Design.  The contraction over C is a matrix product: for one output row
// (b, y) and one vertical shift dy, M[x, x'] = sum_c f1[c, y, x] f2[c, y+dy,
// x'], and the outputs are the band x' = x + dx.  Every dx is a multiple of
// s, so a pixel x meets only the f2 columns x' = x (mod s).  A class is 16
// pixels x = first + s i (i < 16) of one residue; it meets the 15 + Dw
// columns first - R + s (w0 + j) of a window of Dw horizontal shifts
// starting at dxi = w0, a 16 x (15 + Dw) product: one m16 tile of pixels by
// NT = ceil((15 + Dw) / 8) n8 tiles of f2 columns.  The classes of a row are
// its 16-pixel progressions P = 0, 1, ...: span P / s, residue P % s, first
// pixel 16 s (P / s) + P % s.  At s = 2 a block's two classes are the two
// parities of 32 neighbouring pixels, at s = 1 its two halves, at s >= 3
// two residues of a span of 16 s pixels (or of two spans, for odd s).
// Products run as mma.sync m16n8k8 tf32: f32 inputs as 3xTF32 (x = big +
// small, big = x truncated to tf32, small = x - big, of which the tensor
// cores read the tf32 bits; the products small.big + big.small + big.big,
// relative error below 3 * 2^-20 per product), bf16 inputs as one product
// (a bf16 value is exact in tf32).
//  - Windows.  The horizontal shifts are cut into W_n = ceil(D / 25)
//    windows of Dw = ceil(D / W_n) <= 25 shifts (NT <= 5), one per block
//    along the grid's x with the block's two classes, so registers and
//    shared memory stay bounded whatever md is; D <= 25 is one window.
//  - A block is 8 warps: one per (vertical shift slot, class), 4 slots.  It
//    walks the shifts whose row lies in the map, 4 at a time, and for each
//    group the channels in chunks of 32: a step stages the f1 chunk of its
//    32 pixels and the chunks of the window's columns of the 4 rows y + dy,
//    and the accumulators of a shift live in registers across its chunks.
//    The shifts whose row leaves the map are written as zeros.  A class
//    wholly past W does no products.
//  - The contraction needs channels next to each other, and f1, f2 have W
//    contiguous: a pre-pass kernel writes both as (B, H, W, Cp) f32 into
//    scratch memory the caller allocates (Cp = C rounded up to 32, zeros
//    past C; bf16 widened).  Staging then copies whole 128-byte rows of 32
//    channels of one pixel with 16-byte cp.async (zero-filled outside the
//    map), so gathering a class's pixels at any stride costs what a
//    contiguous segment does.  In shared memory the two classes interleave,
//    row 2 i + c for pixel (or column) i of class c, with a channel stride =
//    4 (mod 32) floats, so the copies and the fragment loads (channels 2t and
//    2t + 1 of a lane as one 8-byte load: A's and B's K index k <-> channel
//    2k for k < 4 and 2(k - 4) + 1 else) are free of bank conflicts.  At
//    s = 2 the rows are the 32 pixels and the 16 NT columns in order, as in
//    the parity design this generalises.  (Copying single floats straight
//    from (B, C, H, W) into that layout left the kernel no faster than the
//    CUDA-core design this kernel replaced.)
//  - Staging is double-buffered: the copies of the next step are issued
//    before this step's products, so a step waits only on copies issued a
//    step earlier.  Two blocks share an SM.
//  - A shift's outputs go through shared memory, so the (B, D*D, H, W) rows
//    are written 128 bytes per warp where the block's pixels are neighbours
//    (s <= 2); at s >= 3 a warp's 32 pixels lie s apart.
//  - Templates: the stride is a compile-time constant for s = 2 (every
//    flow-teacher call) and a runtime value otherwise, by NT in 2..5.
//  - Ragged shapes: pixels past W and channels past C are staged as zeros,
//    f2 columns outside the map likewise; stores are masked to W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;                // pixels per block: two classes of 16
constexpr int CLASS_PX = 16;          // pixels of one class: the m16 tile
constexpr int SLOTS = 4;              // vertical shifts per step
constexpr int WARPS = 2 * SLOTS;      // one warp per (shift slot, class)
constexpr int THREADS = 32 * WARPS;
constexpr int CC = 32;                // channels per step
constexpr int CS = CC + 4;            // staged channel stride (floats), = 4 (mod 32)
constexpr int MAX_NT = 5;             // n8 tiles of f2 columns per class
constexpr int MAX_DW = 8 * MAX_NT - 15;   // horizontal shifts per window

__host__ __device__ constexpr int n_tiles(int dw) { return (15 + dw + 7) / 8; }
// one staging buffer: the f1 chunk [TX][CS] and the f2 chunks [SLOTS][16 NT][CS]
__host__ __device__ constexpr int buffer_floats(int nt) { return (TX + SLOTS * 16 * nt) * CS; }

// two staging buffers and the outputs of SLOTS shifts [SLOTS][Dw][TX]
inline size_t smem_bytes(int dw) {
  return sizeof(float) * (2 * (size_t)buffer_floats(n_tiles(dw)) + (size_t)SLOTS * dw * TX);
}

// The tiling of one displacement grid: D shifts per axis, radius R, the
// horizontal shifts in `windows` windows of at most `window_d`, NT n8 tiles.
struct Plan {
  int d, radius, windows, window_d, n_tiles;
};

inline Plan plan_for(int max_displacement, int stride) {
  Plan p;
  p.d = 2 * (max_displacement / stride) + 1;
  p.radius = max_displacement / stride * stride;
  p.windows = (p.d + MAX_DW - 1) / MAX_DW;
  p.window_d = (p.d + p.windows - 1) / p.windows;
  p.n_tiles = n_tiles(p.window_d);
  return p;
}

// Blocks along a row of W pixels: its s * ceil(W / 16 s) classes, two a block.
inline int x_blocks(int W, int stride) {
  const int spans = (W + CLASS_PX * stride - 1) / (CLASS_PX * stride);
  return (stride * spans + 1) / 2;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// big (+ small) = x: 3xTF32 for f32 inputs, by truncation (a mask and a
// subtraction run at the full rate, where two cvt.rna.tf32 would not); a
// bf16 input is its own big part.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if (SPLIT) {
    big = __float_as_uint(x) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
  } else {
    big = __float_as_uint(x);
  }
}

// 16 bytes from global to shared memory, or zeros when !ok (src must be a
// valid address even then).
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Returns once this thread's copies of all but the newest group have landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// d (16x8, f32) += a (16x8, tf32, row) * b (8x8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The pre-pass: src (B, C, HW) -> dst (B, HW, Cp) f32, zeros for c >= C,
// through a 32 x 32 tile in shared memory; blocks of 32 x 8 threads.
template <typename T>
__global__ void __launch_bounds__(256)
to_channels_last_kernel(const T* __restrict__ src, float* __restrict__ dst, int C, int HW,
                        int Cp) {
  __shared__ float tile[32][33];
  const int p0 = blockIdx.x * 32, c0 = blockIdx.y * 32, b = blockIdx.z;
  const T* s = src + (size_t)b * C * HW;
  float* d = dst + (size_t)b * HW * Cp;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r, p = p0 + threadIdx.x;
    tile[r][threadIdx.x] = (c < C && p < HW) ? to_f32(s[(size_t)c * HW + p]) : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int p = p0 + r;
    if (p < HW) d[(size_t)p * Cp + c0 + threadIdx.x] = tile[threadIdx.x][r];
  }
}

// NT n8 tiles of f2 columns per class; S the stride, or 0 for `stride`.
// Fragment layout of m16n8k8 (lane = 4 g + t): A rows g, g + 8 and K columns
// t, t + 4; B K rows t, t + 4 and column g; C rows g, g + 8, columns 2t, 2t + 1.
template <typename T, int NT, int S>
__global__ void __launch_bounds__(THREADS, 2)
cost_volume_tc_kernel(const float* __restrict__ f1t, const float* __restrict__ f2t,
                      T* __restrict__ out, int Cp, int H, int W, int D, int stride,
                      int windows, int window_d, float inv_c) {
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int XP = 16 * NT;
  extern __shared__ float smem[];
  float* outs = smem + 2 * buffer_floats(NT);   // [SLOTS][Dw][TX]

  const int s = S > 0 ? S : stride;
  const int R = (D - 1) / 2 * s;
  const int xb = blockIdx.x / windows, w0 = blockIdx.x % windows * window_d;
  const int dw = min(window_d, D - w0);   // this window's shifts: dxi in [w0, w0 + dw)
  const int y = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t plane = (size_t)H * W;
  const float* f1r = f1t + ((size_t)b * H + y) * W * Cp;   // the row (b, y): [W][Cp]
  const float* f2b = f2t + (size_t)b * H * W * Cp;
  T* outb = out + (size_t)b * D * D * plane + (size_t)y * W;

  // the block's classes P = 2 xb + c; staged row p = 2 i + c is the class's
  // pixel i, and in the f2 chunks its column i: f2 at pixel(p) - R + s w0.
  // At s = 2 the rows are the block's 32 neighbouring pixels in order.
  const int first0 = S == 2 ? TX * xb : CLASS_PX * s * (2 * xb / s) + 2 * xb % s;
  const int first1 = S == 2 ? first0 + 1 : CLASS_PX * s * ((2 * xb + 1) / s) + (2 * xb + 1) % s;
  auto pixel = [&](int p) {
    return S == 2 ? first0 + p : ((p & 1) ? first1 : first0) + s * (p >> 1);
  };
  const int col0 = s * w0 - R;

  // the shifts whose row y - R + s dyi lies in the map: dyi in [lo, hi]
  const int lo = max(0, (R - y + s - 1) / s);
  const int hi = min(D - 1, (H - 1 - y + R) / s);
  const int n_valid = hi - lo + 1;
  for (int e = tid; e < (D - n_valid) * dw * TX; e += THREADS) {
    const int x = pixel(e % TX), zr = e / TX;
    int dyi = zr / dw;
    if (dyi >= lo) dyi += n_valid;
    if (x < W) outb[((size_t)dyi * D + w0 + zr % dw) * plane + x] = from_f32<T>(0.f);
  }

  const int n_chunks = Cp / CC;
  const int steps = (n_valid + SLOTS - 1) / SLOTS * n_chunks;
  // step -> buffer: 32 channels of the block's f1 pixels and of the window's
  // f2 columns in the group's rows, 16 bytes a copy (a lane's 4 channels of
  // one pixel: 8 lanes a 128-byte row); zeros outside the map and for
  // shifts past hi
  auto stage = [&](int step) {
    float* f1c = smem + (step & 1) * buffer_floats(NT);
    float* f2c = f1c + TX * CS;
    const int dyi0 = lo + step / n_chunks * SLOTS, c0 = step % n_chunks * CC + 4 * (tid % 8);
    {
      const int row = tid / 8;   // TX * CC / 4 == THREADS copies
      const int x = pixel(row);
      const bool ok = x < W;
      copy16(f1c + row * CS + 4 * (tid % 8), ok ? f1r + (size_t)x * Cp + c0 : f1t, ok);
    }
#pragma unroll
    for (int e = tid; e < SLOTS * XP * CC / 4; e += THREADS) {
      const int row = e / 8 % XP, sl = e / (8 * XP);
      const int dyi = dyi0 + sl, xg = pixel(row) + col0;
      const bool ok = dyi <= hi && xg >= 0 && xg < W;
      copy16(f2c + (sl * XP + row) * CS + 4 * (e % 8),
             ok ? f2b + ((size_t)(y - R + s * dyi) * W + xg) * Cp + c0 : f2t, ok);
    }
  };

  const int slot = warp / 2, cls = warp % 2;
  const bool live = (cls ? first1 : first0) < W;   // the class has a pixel in the map
  float acc[NT][4];
  stage(0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    const int grp = step / n_chunks, chunk = step % n_chunks;
    if (step + 1 < steps) stage(step + 1);   // into the other buffer
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();   // this step's buffer has landed, from every thread
    if (chunk == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
    const int dyi = lo + grp * SLOTS + slot;
    if (dyi <= hi && live) {   // the same for the whole warp
      const float* f1c = smem + (step & 1) * buffer_floats(NT);
      const float* a_row = f1c + (2 * g + cls) * CS + 2 * t;
      const float* b_row = f1c + TX * CS + (slot * XP + 2 * g + cls) * CS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < CC / 8; ++kk) {
        const float2 a_lo = *reinterpret_cast<const float2*>(a_row + kk * 8);
        const float2 a_hi = *reinterpret_cast<const float2*>(a_row + 16 * CS + kk * 8);
        uint32_t ab[4], as[4];
        split<SPLIT>(a_lo.x, ab[0], as[0]);
        split<SPLIT>(a_hi.x, ab[1], as[1]);
        split<SPLIT>(a_lo.y, ab[2], as[2]);
        split<SPLIT>(a_hi.y, ab[3], as[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 bv = *reinterpret_cast<const float2*>(b_row + 16 * n * CS + kk * 8);
          uint32_t bb[2], bs[2];
          split<SPLIT>(bv.x, bb[0], bs[0]);
          split<SPLIT>(bv.y, bb[1], bs[1]);
          if (SPLIT) {   // the small products first
            mma_tf32(acc[n], as, bb);
            mma_tf32(acc[n], ab, bs);
          }
          mma_tf32(acc[n], ab, bb);
        }
      }
    }
    if (chunk == n_chunks - 1) {   // the group's shifts are complete
      if (dyi <= hi && live) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = g + 8 * (e / 2);              // the class's pixel i
            const int k = 8 * n + 2 * t + e % 2 - i;    // its column i + k: dxi = w0 + k
            if (k >= 0 && k < dw) outs[(slot * dw + k) * TX + 2 * i + cls] = acc[n][e] * inv_c;
          }
      }
      __syncthreads();
      const int rows = min(SLOTS, n_valid - grp * SLOTS) * dw;
      for (int e = tid; e < rows * TX; e += THREADS) {
        const int x = pixel(e % TX), r = e / TX;
        const int row_dyi = lo + grp * SLOTS + r / dw;
        if (x < W)
          outb[((size_t)row_dyi * D + w0 + r % dw) * plane + x] = from_f32<T>(outs[e]);
      }
    }
    __syncthreads();   // this step's buffer is free for step + 2
  }
}

inline int c_pad(int c) { return (c + CC - 1) / CC * CC; }

template <typename T, int NT, int S>
cudaError_t launch(const float* f1t, const float* f2t, void* out, int B, int C, int H, int W,
                   const Plan& p, int stride, cudaStream_t stream) {
  auto kern = cost_volume_tc_kernel<T, NT, S>;
  const size_t smem = smem_bytes(p.window_d);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(x_blocks(W, stride) * p.windows, H, B);
  kern<<<grid, THREADS, smem, stream>>>(f1t, f2t, static_cast<T*>(out), c_pad(C), H, W, p.d,
                                        stride, p.windows, p.window_d, 1.0f / (float)C);
  return cudaGetLastError();
}

template <typename T, int S>
cudaError_t launch_nt(const float* f1t, const float* f2t, void* out, int B, int C, int H,
                      int W, const Plan& p, int stride, cudaStream_t stream) {
  switch (p.n_tiles) {
    case 2: return launch<T, 2, S>(f1t, f2t, out, B, C, H, W, p, stride, stream);
    case 3: return launch<T, 3, S>(f1t, f2t, out, B, C, H, W, p, stride, stream);
    case 4: return launch<T, 4, S>(f1t, f2t, out, B, C, H, W, p, stride, stream);
    case 5: return launch<T, 5, S>(f1t, f2t, out, B, C, H, W, p, stride, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* f1, const void* f2, void* scratch, void* out, int B, int C,
                     int H, int W, const Plan& p, int stride, cudaStream_t stream) {
  float* f1t = static_cast<float*>(scratch);
  float* f2t = f1t + (size_t)B * H * W * c_pad(C);
  const dim3 grid((H * W + 31) / 32, c_pad(C) / 32, B), block(32, 8);
  to_channels_last_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(f1), f1t, C,
                                                         H * W, c_pad(C));
  to_channels_last_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(f2), f2t, C,
                                                         H * W, c_pad(C));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return stride == 2 ? launch_nt<T, 2>(f1t, f2t, out, B, C, H, W, p, stride, stream)
                     : launch_nt<T, 0>(f1t, f2t, out, B, C, H, W, p, stride, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (under half an SM's at
// every grid), or 0 for an invalid grid (stride < 1 or max_displacement < 0).
size_t fsv_cost_volume_tc_smem_bytes(int max_displacement, int stride) {
  if (stride < 1 || max_displacement < 0) return 0;
  return smem_bytes(plan_for(max_displacement, stride).window_d);
}

// The tiling of a grid on rows of `width` pixels, into plan[0..8]: D, R,
// classes per block, pixels per class, windows, shifts per window, n8 tiles,
// blocks along a row (windows included), shared-memory bytes.  Returns 0,
// or -1 for an invalid grid.
int fsv_cost_volume_tc_plan(int max_displacement, int stride, int width, int* plan) {
  if (stride < 1 || max_displacement < 0 || width < 1) return -1;
  const Plan p = plan_for(max_displacement, stride);
  const int values[9] = {p.d, p.radius, 2, CLASS_PX, p.windows, p.window_d, p.n_tiles,
                         x_blocks(width, stride) * p.windows,
                         (int)smem_bytes(p.window_d)};
  for (int i = 0; i < 9; ++i) plan[i] = values[i];
  return 0;
}

// Bytes of scratch memory one call needs: f1 and f2 as (B, H, W, Cp) f32.
size_t fsv_cost_volume_tc_scratch_bytes(int B, int C, int H, int W) {
  return 2 * sizeof(float) * (size_t)B * H * W * c_pad(C);
}

// f1, f2: (B, C, H, W); out: (B, D*D, H, W); all contiguous, float32
// (is_bf16 == 0) or bfloat16.  scratch: fsv_cost_volume_tc_scratch_bytes,
// 16-byte aligned.  Launches the pre-pass and the kernel on `stream` and
// returns cudaGetLastError() (0 on success) without synchronising.
int fsv_cost_volume_tc(const void* f1, const void* f2, void* scratch, void* out, int B, int C,
                       int H, int W, int max_displacement, int stride, int is_bf16,
                       void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || H > 65535 || B > 65535 || stride < 1 ||
      max_displacement < 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(max_displacement, stride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(f1, f2, scratch, out, B, C, H, W, p, stride, s)
                       : dispatch<float>(f1, f2, scratch, out, B, C, H, W, p, stride, s));
}

}  // extern "C"
