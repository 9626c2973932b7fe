// The served forward's eval-mode norm as one pass: normalise with fixed
// per-channel statistics, apply up to three SPADE modulations and an
// optional leaky ReLU, and write once.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it on the TPU.  In eager PyTorch it ran as a chain of full-size
// passes (the cast to f32, addcmul, the cast back, for each map `1 + gamma`,
// a multiply and an add over channel slices that are strided in a
// channels-last tensor, then leaky_relu and autocast's cast to bf16), and
// so it was added: ops/norm_modulate.py holds the wrapper and the plain
// version.  With c channels, per pixel p and channel k:
//
//   y = x[p, k] * scale[k] + shift[k]
//   y = y * (1 + map_m[p, k]) + map_m[p, c + k]      for each map m
//   y = y > 0 ? y : y * slope                         (slope 1: none)
//   out[p, k] = y rounded to the output type
//
// x and out: (B, H, W, c) in memory (a channels-last (B, c, H, W) tensor),
// float32 or bfloat16 each; each map: (B, H, W, 2c) in out's type, gamma
// in its first c channels and beta in the next c (every served map is a
// convolution's output in the type the norm hands on); scale and shift:
// float32 (c).  The arithmetic is f32 in registers and rounds once, at the
// store (round to nearest even for bf16, as a cast in PyTorch rounds).
// c % 8 == 0 and every pointer 16-byte aligned.
//
// Bound on an H100 SXM: bytes.  A few flops an element against 6-22 bytes
// an element (x f32 or bf16 read once, 4 bytes of each bf16 map, the output
// written once); at 3.35 TB/s the street cell's up_0 norm with one map
// (32 x 64 x 256 x 512 elements, x f32, map and output bf16) moves 2.68 GB:
// 0.80 ms.
//
// Design.  The only aim is to move each byte once.  A thread owns 8
// channels of one pixel at a time: x as one 16-byte load (bf16) or two
// (f32), the gamma and beta halves of a map as two loads of the same width
// at the pixel's stride of 2c, and the output as one or two 16-byte
// stores; neighbouring threads take neighbouring 8-channel groups, so a
// warp reads and writes contiguous rows.  The grid is at most 8 blocks of
// 256 threads an SM, each thread walking pixels at a stride that keeps its
// channel group fixed, so its 8 scales and shifts are loaded once into
// registers for every pixel it takes.  No intermediate reaches device
// memory and no thread waits for another.  Templates: x's and out's types
// and the number of maps (0-3), so each instance's loads are known at
// compile time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;           // channels a thread handles at a time
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 2048 threads: an SM's full occupancy
constexpr int MAX_MAPS = 3;

struct Maps {
  const void* p[MAX_MAPS];
};

__device__ __forceinline__ void load8(const float* p, float v[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[VEC]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[VEC]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// `lanes` threads work: a multiple of `groups` (c / 8), so thread t keeps
// channel group t % groups and walks pixels t / groups + i * lanes / groups.
template <typename TX, typename TO, int NMAPS>
__global__ void __launch_bounds__(THREADS)
norm_modulate_kernel(const TX* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ shift, Maps maps, TO* __restrict__ out,
                     long long pixels, int c, long long lanes, float slope) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= lanes) return;
  const int groups = c / VEC;
  const int k0 = (int)(t % groups) * VEC;
  const long long pixel_step = lanes / groups;
  float sc[VEC], sh[VEC];
  load8(scale + k0, sc);
  load8(shift + k0, sh);
  for (long long p = t / groups; p < pixels; p += pixel_step) {
    const long long i = p * c + k0;
    float v[VEC];
    load8(x + i, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = fmaf(v[k], sc[k], sh[k]);
#pragma unroll
    for (int m = 0; m < NMAPS; ++m) {
      const TO* gamma = static_cast<const TO*>(maps.p[m]) + 2 * p * c + k0;
      float g[VEC], b[VEC];
      load8(gamma, g);
      load8(gamma + c, b);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = fmaf(v[k], 1.0f + g[k], b[k]);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = v[k] > 0.0f ? v[k] : v[k] * slope;
    store8(out + i, v);
  }
}

template <typename TX, typename TO>
cudaError_t launch_typed(const void* x, const float* scale, const float* shift, Maps maps,
                         int n_maps, void* out, long long pixels, int c, float slope,
                         cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long groups = c / VEC;
  const long long units = pixels * groups;
  long long blocks = (units + THREADS - 1) / THREADS;
  if (blocks > (long long)sms * BLOCKS_PER_SM) blocks = (long long)sms * BLOCKS_PER_SM;
  if (blocks * THREADS < groups) blocks = (groups + THREADS - 1) / THREADS;  // c > 2048
  long long lanes = blocks * THREADS / groups * groups;
  if (lanes > units) lanes = units;
  const TX* xp = static_cast<const TX*>(x);
  TO* op = static_cast<TO*>(out);
  switch (n_maps) {
    case 0:
      norm_modulate_kernel<TX, TO, 0><<<(unsigned)blocks, THREADS, 0, stream>>>(
          xp, scale, shift, maps, op, pixels, c, lanes, slope);
      break;
    case 1:
      norm_modulate_kernel<TX, TO, 1><<<(unsigned)blocks, THREADS, 0, stream>>>(
          xp, scale, shift, maps, op, pixels, c, lanes, slope);
      break;
    case 2:
      norm_modulate_kernel<TX, TO, 2><<<(unsigned)blocks, THREADS, 0, stream>>>(
          xp, scale, shift, maps, op, pixels, c, lanes, slope);
      break;
    default:
      norm_modulate_kernel<TX, TO, 3><<<(unsigned)blocks, THREADS, 0, stream>>>(
          xp, scale, shift, maps, op, pixels, c, lanes, slope);
      break;
  }
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_out(int out_bf16, const void* x, const float* scale, const float* shift,
                       Maps maps, int n_maps, void* out, long long pixels, int c, float slope,
                       cudaStream_t s) {
  return out_bf16 ? launch_typed<TX, __nv_bfloat16>(x, scale, shift, maps, n_maps, out, pixels,
                                                    c, slope, s)
                  : launch_typed<TX, float>(x, scale, shift, maps, n_maps, out, pixels, c,
                                            slope, s);
}

}  // namespace

extern "C" {

// x: `pixels` rows of c channels (B * H * W pixels of a channels-last map);
// map0..map2: the first n_maps (0-3) are used, rows of 2c channels in
// out's type; out: like x.  *_bf16 != 0: that tensor is bfloat16, else
// float32.  slope: the leaky ReLU's (1 for none).  Launches on `stream` and
// returns cudaGetLastError() (0 on success) without synchronising.
int fsv_norm_modulate(const void* x, const void* scale, const void* shift, const void* map0,
                      const void* map1, const void* map2, int n_maps, void* out,
                      long long pixels, int c, float slope, int x_bf16, int out_bf16,
                      void* stream) {
  if (pixels < 1 || c < VEC || c % VEC || n_maps < 0 || n_maps > MAX_MAPS)
    return (int)cudaErrorInvalidValue;
  const Maps maps = {{map0, map1, map2}};
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_bf16 ? launch_out<__nv_bfloat16>(out_bf16, x, sc, sh, maps, n_maps, out, pixels,
                                                  c, slope, s)
                      : launch_out<float>(out_bf16, x, sc, sh, maps, n_maps, out, pixels, c,
                                          slope, s));
}

}  // extern "C"
