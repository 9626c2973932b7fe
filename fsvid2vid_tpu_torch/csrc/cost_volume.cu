// FlowNetC correlation cost volume for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel fsvid2vid_tpu/ops/pallas/cost_volume_kernel.py
// (cost_volume_pallas, body _kernel).  With R = (max_displacement / stride)
// * stride, D = 2 * (max_displacement / stride) + 1 and dy, dx in
// {-R, -R + stride, ..., R}:
//
//   out[b, dyi * D + dxi, y, x] = (1/C) * sum_c f1[b,c,y,x] * f2[b,c,y+dy,x+dx]
//
// with f2 read as zero outside the map.  f1, f2: (B, C, H, W) and out:
// (B, D*D, H, W), contiguous, float32 or bfloat16 (converted on load);
// accumulation is f32 and the sum is multiplied by 1/C before it is rounded
// to the output type.
//
// Bound on an H100 SXM at the training shape (face 256 px, batch 4 x 3
// frames: B = 12, C = 256, H = W = 32, D = 21): 2 * B*H*W * 441 * C = 2.77
// GFLOP of f32 multiply-adds (~41 us at the 67 TFLOP/s CUDA-core peak)
// against ~47 MB moved once (~14 us at 3.35 TB/s): bound by operations.
//
// Design.  One thread block owns TX = 32 neighbouring pixels of one output
// row (b, y).  For every vertical shift dy it walks the channels in chunks
// of CC: the f1 tile and the f2 row segment [x0 - R, x0 + TX + R) of row
// y + dy are staged in shared memory as f32, with zeros where the segment
// leaves the map, so no padded copy of f2 is ever made.  A warp is one group
// of 32 pixels at one dx; a thread keeps its f1 value in a register and
// reuses it for its dx, dx + 8, dx + 16, ... (f32 accumulators in
// registers), so shared-memory reads are conflict-free rows.  Rows y + dy
// outside the map are written as zeros without touching f1 or f2.  Outputs
// are written in the port's (B, D*D, H, W) layout, 128 bytes per warp.  Any
// H, W, C, max_displacement and stride are taken as long as D <= 64 and the
// staged segment fits in shared memory.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W at that shape: 0.54 ms in
// f32, 13 times the bound.  What this simple design leaves on the table:
// every multiply-add still reads one f32 from shared memory, the f1 tile is
// staged again for every dy, and the contraction over C could run on the
// tensor cores as a banded matrix product (wgmma on bf16 tiles) fed by TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TX = 32;                    // pixels of one row per block (one warp wide)
constexpr int GROUPS = 8;                 // warps per block, each on its own dx
constexpr int THREADS = TX * GROUPS;
constexpr int CC = 32;                    // channels staged per chunk
constexpr int MAX_ITEMS = 8;              // most dx per thread: D <= GROUPS * MAX_ITEMS
constexpr size_t SMEM_LIMIT = 232448;     // dynamic shared memory of one block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ inline int segment_width(int radius) { return TX + 2 * radius; }

inline size_t smem_bytes(int radius) {
  return (size_t)CC * (TX + segment_width(radius)) * sizeof(float);
}

// NI = ceil(D / GROUPS): the dx indices a thread owns (g, g + GROUPS, ...).
template <typename T, int NI>
__global__ void __launch_bounds__(THREADS)
cost_volume_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
                   int C, int H, int W, int radius, int stride, int D, float inv_c) {
  extern __shared__ float smem[];
  const int segw = segment_width(radius);
  float* f1s = smem;             // [CC][TX]
  float* f2s = smem + CC * TX;   // [CC][segw]

  const int x0 = blockIdx.x * TX;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int x = tid % TX;        // the thread's pixel
  const int g = tid / TX;        // the thread's first dx index (its warp)
  const bool x_ok = x0 + x < W;
  const size_t plane = (size_t)H * W;
  const T* f1b = f1 + (size_t)b * C * plane + (size_t)y * W;
  const T* f2b = f2 + (size_t)b * C * plane;
  T* outb = out + (size_t)b * D * D * plane + (size_t)y * W + x0 + x;

  for (int dyi = 0; dyi < D; ++dyi) {
    const int y2 = y - radius + dyi * stride;
    float acc[NI];
#pragma unroll
    for (int it = 0; it < NI; ++it) acc[it] = 0.f;

    if (y2 >= 0 && y2 < H) {   // the same for every thread of the block
      for (int c0 = 0; c0 < C; c0 += CC) {
        __syncthreads();       // the previous chunk has been consumed
        for (int i = tid; i < CC * TX; i += THREADS) {
          const int cc = i / TX, j = i % TX;
          const int c = c0 + cc, xg = x0 + j;
          f1s[i] = (c < C && xg < W) ? to_f32(f1b[(size_t)c * plane + xg]) : 0.f;
        }
        for (int i = tid; i < CC * segw; i += THREADS) {
          const int cc = i / segw, j = i % segw;
          const int c = c0 + cc, xg = x0 - radius + j;
          f2s[i] = (c < C && xg >= 0 && xg < W)
                       ? to_f32(f2b[(size_t)c * plane + (size_t)y2 * W + xg])
                       : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int cc = 0; cc < CC; ++cc) {
          const float a = f1s[cc * TX + x];
          const float* row = f2s + cc * segw + x;
#pragma unroll
          for (int it = 0; it < NI; ++it) {
            const int dxi = g + it * GROUPS;
            if (dxi < D) acc[it] += a * row[dxi * stride];   // same for the whole warp
          }
        }
      }
    }
    if (x_ok) {
#pragma unroll
      for (int it = 0; it < NI; ++it) {
        const int dxi = g + it * GROUPS;
        if (dxi < D) outb[(size_t)(dyi * D + dxi) * plane] = from_f32<T>(acc[it] * inv_c);
      }
    }
  }
}

template <typename T, int NI>
cudaError_t launch(const void* f1, const void* f2, void* out, int B, int C, int H, int W,
                   int radius, int stride, int D, cudaStream_t stream) {
  auto kern = cost_volume_kernel<T, NI>;
  const size_t smem = smem_bytes(radius);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TX - 1) / TX, H, B);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(f1), static_cast<const T*>(f2),
                                        static_cast<T*>(out), C, H, W, radius, stride, D,
                                        1.0f / (float)C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* f1, const void* f2, void* out, int B, int C, int H, int W,
                     int radius, int stride, int D, cudaStream_t stream) {
  switch ((D + GROUPS - 1) / GROUPS) {
    case 1: return launch<T, 1>(f1, f2, out, B, C, H, W, radius, stride, D, stream);
    case 2: return launch<T, 2>(f1, f2, out, B, C, H, W, radius, stride, D, stream);
    case 3: return launch<T, 3>(f1, f2, out, B, C, H, W, radius, stride, D, stream);
    case 4: return launch<T, 4>(f1, f2, out, B, C, H, W, radius, stride, D, stream);
    case 5: return launch<T, 5>(f1, f2, out, B, C, H, W, radius, stride, D, stream);
    case 6: return launch<T, 6>(f1, f2, out, B, C, H, W, radius, stride, D, stream);
    case 7: return launch<T, 7>(f1, f2, out, B, C, H, W, radius, stride, D, stream);
    case 8: return launch<T, 8>(f1, f2, out, B, C, H, W, radius, stride, D, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; the caller checks it
// against the card's per-block limit before launching.
size_t fsv_cost_volume_smem_bytes(int max_displacement, int stride) {
  if (stride < 1 || max_displacement < 0) return 0;
  return smem_bytes(max_displacement / stride * stride);
}

// The largest displacement-grid width D the kernel takes.
int fsv_cost_volume_max_d() { return GROUPS * MAX_ITEMS; }

// f1, f2: (B, C, H, W); out: (B, D*D, H, W); all contiguous, float32
// (is_bf16 == 0) or bfloat16.  Launches on `stream` and returns
// cudaGetLastError() (0 on success) without synchronising.
int fsv_cost_volume(const void* f1, const void* f2, void* out, int B, int C, int H, int W,
                    int max_displacement, int stride, int is_bf16, void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || stride < 1 || max_displacement < 0)
    return (int)cudaErrorInvalidValue;
  const int d = max_displacement / stride;
  const int D = 2 * d + 1;
  const int radius = d * stride;
  if (D > GROUPS * MAX_ITEMS || smem_bytes(radius) > SMEM_LIMIT || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(f1, f2, out, B, C, H, W, radius, stride, D, s)
              : dispatch<float>(f1, f2, out, B, C, H, W, radius, stride, D, s);
  return (int)err;
}

}  // extern "C"
