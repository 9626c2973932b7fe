// FlowNetC correlation cost volume for Hopper (sm_90a) on the tensor cores,
// forward only: the banded-product route of kernel B2.
//
// Replaces the Pallas TPU kernel fsvid2vid_tpu/ops/pallas/cost_volume_kernel.py
// (cost_volume_pallas, body _kernel) for stride 2 and D <= 25; the CUDA-core
// kernel csrc/cost_volume.cu keeps the other shapes.  With R = D - 1 =
// 2 * (max_displacement / 2) and dy, dx in {-R, -R + 2, ..., R}:
//
//   out[b, dyi * D + dxi, y, x] = (1/C) * sum_c f1[b,c,y,x] * f2[b,c,y+dy,x+dx]
//
// with f2 read as zero outside the map.  f1, f2: (B, C, H, W) and out:
// (B, D*D, H, W), contiguous, float32 or bfloat16; accumulation is f32 and
// the sum is multiplied by 1/C before it is rounded to the output type.
//
// Bound on an H100 SXM at the training shape (face 256 px, batch 4 x 3
// frames: B = 12, C = 256, H = W = 32, D = 21): the useful f32 work is
// 2 * B*H*W * 441 * C = 2.77 GFLOP (41 us at the 67 TFLOP/s CUDA-core peak)
// against ~47 MB moved once (14 us at 3.35 TB/s).  This design's own
// products (below) are ~4x the useful work in tf32, 3 times over for f32
// inputs; at the 495 TFLOP/s tf32 peak they bound it at ~20 us.
//
// Design.  The contraction over C is a matrix product: for one output row
// (b, y) and one vertical shift dy, M[x, x'] = sum_c f1[c, y, x] f2[c, y+dy,
// x'] over the 32 pixels x of a block and the f2 row segment x' in
// [x0 - R, x0 + 32 + R), and the outputs are the band x' = x + dx.  With
// stride 2 an even x meets only f2 columns of one parity and an odd x the
// other, so each parity is a 16 x (16 + R) product (one m16 tile of pixels
// by ceil((15 + D) / 8) n8 tiles of f2 columns), ~1.7x the band's work
// instead of ~3.4x.  Products run as mma.sync m16n8k8 tf32: f32 inputs as
// 3xTF32 (x = big + small, big = x truncated to tf32, small = x - big, of
// which the tensor cores read the tf32 bits; the products small.big +
// big.small + big.big, relative error below 3 * 2^-20 per product), bf16
// inputs as one product (a bf16 value is exact in tf32).
//  - A block owns 32 pixels of one output row and is 8 warps: one per
//    (vertical shift slot, pixel parity), 4 slots.  It walks the shifts
//    whose row lies in the map, 4 at a time, and for each group the channels
//    in chunks of 32: a step stages the f1 row's chunk and the chunks of the
//    4 rows y + dy, and the accumulators of a shift live in registers across
//    its chunks.  The shifts whose row leaves the map are written as zeros.
//  - The contraction needs channels next to each other, and f1, f2 have W
//    contiguous: a pre-pass kernel writes both as (B, H, W, Cp) f32 into
//    scratch memory the caller allocates (Cp = C rounded up to 32, zeros
//    past C; bf16 widened).  Staging then copies whole 128-byte rows of 32
//    channels with 16-byte cp.async (zero-filled outside the map), into
//    shared memory as [pixel][channel] with a channel stride = 4 (mod 32)
//    floats, so the copies and the fragment loads (channels 2t and 2t + 1 of
//    a lane as one 8-byte load: A's and B's K index k <-> channel 2k for
//    k < 4 and 2(k - 4) + 1 else) are free of bank conflicts.  (Copying
//    single floats straight from (B, C, H, W) into that layout left the
//    kernel no faster than the CUDA-core one.)
//  - Staging is double-buffered: the copies of the next step are issued
//    before this step's products, so a step waits only on copies issued a
//    step earlier.  Two blocks share an SM.
//  - A shift's outputs go through shared memory, so the (B, D*D, H, W) rows
//    are written 128 bytes per warp.
//  - Ragged shapes: pixels past W and channels past C are staged as zeros,
//    f2 columns outside the map likewise; stores are masked to W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;                // pixels of one output row per block, 16 per parity
constexpr int SLOTS = 4;              // vertical shifts per step
constexpr int WARPS = 2 * SLOTS;      // one warp per (shift slot, parity)
constexpr int THREADS = 32 * WARPS;
constexpr int CC = 32;                // channels per step
constexpr int CS = CC + 4;            // staged channel stride (floats), = 4 (mod 32)
constexpr int MAX_NT = 5;             // n8 tiles of f2 columns per parity
constexpr int MAX_D = 8 * MAX_NT - 15;

__host__ __device__ constexpr int n_tiles(int d) { return (15 + d + 7) / 8; }
// one staging buffer: the f1 chunk [TX][CS] and the f2 chunks [SLOTS][16 NT][CS]
__host__ __device__ constexpr int buffer_floats(int nt) { return (TX + SLOTS * 16 * nt) * CS; }

// two staging buffers and the outputs of SLOTS shifts [SLOTS][D][TX]
inline size_t smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)buffer_floats(n_tiles(d)) + (size_t)SLOTS * d * TX);
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

// NT n8 tiles of f2 columns per parity: 16 * NT staged columns from x0 - R.
// Fragment layout of m16n8k8 (lane = 4 g + t): A rows g, g + 8 and K columns
// t, t + 4; B K rows t, t + 4 and column g; C rows g, g + 8, columns 2t, 2t + 1.
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, 2)
cost_volume_tc_kernel(const float* __restrict__ f1t, const float* __restrict__ f2t,
                      T* __restrict__ out, int Cp, int H, int W, int D, float inv_c) {
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int XP = 16 * NT;
  extern __shared__ float smem[];
  float* outs = smem + 2 * buffer_floats(NT);   // [SLOTS][D][TX]

  const int R = D - 1;
  const int x0 = blockIdx.x * TX, y = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t plane = (size_t)H * W;
  const float* f1r = f1t + ((size_t)b * H + y) * W * Cp;   // the row (b, y): [W][Cp]
  const float* f2b = f2t + (size_t)b * H * W * Cp;
  T* outb = out + (size_t)b * D * D * plane + (size_t)y * W + x0;

  // the shifts whose row y - R + 2 dyi lies in the map: dyi in [lo, hi]
  const int lo = max(0, (R - y + 1) / 2);
  const int hi = min(D - 1, (H - 1 - y + R) / 2);
  const int n_valid = hi - lo + 1;
  for (int e = tid; e < (D - n_valid) * D * TX; e += THREADS) {
    const int x = e % TX, zr = e / TX;
    int dyi = zr / D;
    if (dyi >= lo) dyi += n_valid;
    if (x0 + x < W) outb[(size_t)(dyi * D + zr % D) * plane + x] = from_f32<T>(0.f);
  }

  const int n_chunks = Cp / CC;
  const int steps = (n_valid + SLOTS - 1) / SLOTS * n_chunks;
  // step -> buffer: 32 channels of the f1 row and of the group's f2 rows,
  // 16 bytes a copy (a lane's 4 channels of one pixel: 8 lanes a 128-byte
  // row); zeros outside the map and for shifts past hi
  auto stage = [&](int step) {
    float* f1c = smem + (step & 1) * buffer_floats(NT);
    float* f2c = f1c + TX * CS;
    const int dyi0 = lo + step / n_chunks * SLOTS, c0 = step % n_chunks * CC + 4 * (tid % 8);
    {
      const int col = tid / 8;   // TX * CC / 4 == THREADS copies
      const bool ok = x0 + col < W;
      copy16(f1c + col * CS + 4 * (tid % 8), ok ? f1r + (size_t)(x0 + col) * Cp + c0 : f1t, ok);
    }
#pragma unroll
    for (int e = tid; e < SLOTS * XP * CC / 4; e += THREADS) {
      const int col = e / 8 % XP, s = e / (8 * XP);
      const int dyi = dyi0 + s, xg = x0 - R + col;
      const bool ok = dyi <= hi && xg >= 0 && xg < W;
      copy16(f2c + (s * XP + col) * CS + 4 * (e % 8),
             ok ? f2b + ((size_t)(y - R + 2 * dyi) * W + xg) * Cp + c0 : f2t, ok);
    }
  };

  const int slot = warp / 2, par = warp % 2;
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
    if (dyi <= hi) {   // the same for the whole warp
      const float* f1c = smem + (step & 1) * buffer_floats(NT);
      const float* a_row = f1c + (2 * g + par) * CS + 2 * t;
      const float* b_row = f1c + TX * CS + (slot * XP + 2 * g + par) * CS + 2 * t;
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
      if (dyi <= hi) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = g + 8 * (e / 2);              // pixel 2 i + par
            const int k = 8 * n + 2 * t + e % 2 - i;    // f2 column i + k: dx = -R + 2 k
            if (k >= 0 && k < D) outs[(slot * D + k) * TX + 2 * i + par] = acc[n][e] * inv_c;
          }
      }
      __syncthreads();
      const int rows = min(SLOTS, n_valid - grp * SLOTS) * D;
      for (int e = tid; e < rows * TX; e += THREADS) {
        const int x = e % TX, r = e / TX;
        const int row_dyi = lo + grp * SLOTS + r / D;
        if (x0 + x < W) outb[(size_t)(row_dyi * D + r % D) * plane + x] = from_f32<T>(outs[e]);
      }
    }
    __syncthreads();   // this step's buffer is free for step + 2
  }
}

inline int c_pad(int c) { return (c + CC - 1) / CC * CC; }

template <typename T, int NT>
cudaError_t launch(const float* f1t, const float* f2t, void* out, int B, int C, int H, int W,
                   int D, cudaStream_t stream) {
  auto kern = cost_volume_tc_kernel<T, NT>;
  const size_t smem = smem_bytes(D);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TX - 1) / TX, H, B);
  kern<<<grid, THREADS, smem, stream>>>(f1t, f2t, static_cast<T*>(out), c_pad(C), H, W, D,
                                        1.0f / (float)C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* f1, const void* f2, void* scratch, void* out, int B, int C,
                     int H, int W, int D, cudaStream_t stream) {
  float* f1t = static_cast<float*>(scratch);
  float* f2t = f1t + (size_t)B * H * W * c_pad(C);
  const dim3 grid((H * W + 31) / 32, c_pad(C) / 32, B), block(32, 8);
  to_channels_last_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(f1), f1t, C,
                                                         H * W, c_pad(C));
  to_channels_last_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(f2), f2t, C,
                                                         H * W, c_pad(C));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (n_tiles(D)) {
    case 2: return launch<T, 2>(f1t, f2t, out, B, C, H, W, D, stream);
    case 3: return launch<T, 3>(f1t, f2t, out, B, C, H, W, D, stream);
    case 4: return launch<T, 4>(f1t, f2t, out, B, C, H, W, D, stream);
    case 5: return launch<T, 5>(f1t, f2t, out, B, C, H, W, D, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (under half an SM's at
// every D it takes), or 0 when the kernel does not take the displacement
// grid (stride 2 and D <= 25 only).
size_t fsv_cost_volume_tc_smem_bytes(int max_displacement, int stride) {
  if (stride != 2 || max_displacement < 0) return 0;
  const int D = 2 * (max_displacement / 2) + 1;
  return D > MAX_D ? 0 : smem_bytes(D);
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
  if (B < 1 || C < 1 || H < 1 || W < 1 || H > 65535 || B > 65535 ||
      fsv_cost_volume_tc_smem_bytes(max_displacement, stride) == 0)
    return (int)cudaErrorInvalidValue;
  const int D = 2 * (max_displacement / 2) + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(f1, f2, scratch, out, B, C, H, W, D, s)
                       : dispatch<float>(f1, f2, scratch, out, B, C, H, W, D, s));
}

}  // extern "C"
