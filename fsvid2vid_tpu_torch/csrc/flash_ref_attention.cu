// Multi-reference flash attention for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel fsvid2vid_tpu/ops/pallas/attention_kernel.py
// (flash_ref_attention, body _kernel).  For each batch element b and query q:
//
//   s[n]        = query[b,q,:] . key[b,n,:]                 n < N = K * hw_key
//   out_x[b,q,:] = sum_n softmax_n(s)[n] * xf[b,n,:]
//   out_l[b,q,:] = sum_n softmax_n(s)[n] * lf[b,n,:]          (optional)
//   vis[b,q,r]   = sum_{n : n / hw_key == r} softmax_n(s)[n]  (f32)
//
// The softmax runs in the exp2 domain with f32 running max / sum and f32
// accumulators.  For bf16 inputs p is rounded to bf16 before the value
// products, as the TPU kernel does; l and vis use the unrounded p.
//
// Bound on an H100 SXM at the serving shape (face 512 px, K = 8,
// n_downsample_A = 2: B = 1, hw = 16384, N = 131072, c = 128, with lf):
//   operations: QK^T 5.5e11 FLOP + two PV products 1.1e12 FLOP = 1.65e12
//               FLOP, plus 2.1e9 exponentials;
//   bytes:      ~113 MB of bf16 inputs and outputs moved once.
// So the call is compute-bound: ~1.7 ms at the 989 TFLOP/s bf16 dense
// tensor-core peak (~25 ms at the 67 TFLOP/s f32 CUDA-core peak) against
// ~34 us for the bytes.
//
// Design.  One thread block owns a tile of BQ queries of one batch element
// and walks every key tile of all K references in a loop (the TPU kernel's
// sequential "arbitrary" grid axis); nothing is carried between blocks.  Per
// key tile it stages K^T, xf and lf in shared memory as f32, forms the
// BQ x BK energy tile with CUDA-core FMAs (4x4 per thread), updates the
// running max / sum, rescales the register accumulators and adds P.V.
// The per-reference mass is accumulated in shared memory: each key's
// reference is n / hw_key, so key tiles need not align to reference
// boundaries (the TPU kernel needed kb | hw_key).  Ragged query and key tiles
// are masked; channels are zero-padded to a multiple of 64 (c <= 128).
//
// What this simple design leaves on the table: it runs on the CUDA cores
// (at best the f32 rate, ~15x below the bf16 tensor-core peak) and loads its
// tiles synchronously.  wgmma with TMA-fed, multi-stage shared-memory rings
// and warp specialisation is the path to the tensor-core bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads, each owning 4 query rows
constexpr int LDT = BQ + 4;   // row length of the channel-major tiles
constexpr int MAX_C = 128;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as the value product sees it: rounded to the input dtype.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Shared-memory floats for one block; vis partials are 4 per query row.
__host__ __device__ constexpr size_t smem_floats(int cp, bool has_lf, int n_refs) {
  return 2 * (size_t)cp * LDT + (has_lf ? 2 : 1) * (size_t)BK * cp
         + (size_t)BK * LDT + 2 * BQ + 4 * (size_t)BQ * n_refs;
}

template <typename T, int NC, bool HAS_LF>
__global__ void __launch_bounds__(THREADS)
flash_ref_attention_kernel(const T* __restrict__ query, const T* __restrict__ key,
                           const T* __restrict__ xf, const T* __restrict__ lf,
                           T* __restrict__ out_x, T* __restrict__ out_l,
                           float* __restrict__ vis, int hw, int n, int c, int n_refs,
                           int hw_key) {
  constexpr int CP = 64 * NC;  // padded channels; each thread owns 4 per 64
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [CP][LDT] query tile, transposed
  float* ks = qs + CP * LDT;                    // [CP][LDT] key tile, transposed
  float* xs = ks + CP * LDT;                    // [BK][CP]
  float* ls = xs + BK * CP;                     // [BK][CP] (HAS_LF only)
  float* ps = ls + (HAS_LF ? BK * CP : 0);      // [BK][LDT] probabilities
  float* alpha_s = ps + BK * LDT;               // [BQ] per-row rescale of this tile
  float* l_s = alpha_s + BQ;                    // [BQ] final row sums
  float* vs = l_s + BQ;                         // [4][BQ][n_refs] mass partials

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qb = query + (size_t)b * hw * c;
  const T* kb = key + (size_t)b * n * c;
  const T* xb = xf + (size_t)b * n * c;
  const T* lb = HAS_LF ? lf + (size_t)b * n * c : nullptr;

  for (int i = tid; i < BQ * CP; i += THREADS) {
    const int row = i / CP, ch = i % CP;
    const int q = q0 + row;
    qs[ch * LDT + row] = (q < hw && ch < c) ? to_f32(qb[(size_t)q * c + ch]) : 0.f;
  }
  for (int i = tid; i < 4 * BQ * n_refs; i += THREADS) vs[i] = 0.f;

  float m_i[4], l_i[4];
  float acc_x[4][4 * NC];
  float acc_l[4][HAS_LF ? 4 * NC : 1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) {
      acc_x[i][j] = 0.f;
      if constexpr (HAS_LF) acc_l[i][j] = 0.f;
    }
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // previous tile's ks / xs / ls / ps are consumed
    for (int i = tid; i < BK * CP; i += THREADS) {
      const int row = i / CP, ch = i % CP;
      const int kk = k0 + row;
      const bool ok = kk < n && ch < c;
      const size_t off = (size_t)kk * c + ch;
      ks[ch * LDT + row] = ok ? to_f32(kb[off]) : 0.f;
      xs[row * CP + ch] = ok ? to_f32(xb[off]) : 0.f;
      if constexpr (HAS_LF) ls[row * CP + ch] = ok ? to_f32(lb[off]) : 0.f;
    }
    __syncthreads();

    // energy tile: rows ty*4 + i, keys tx*4 + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < c; ++ch) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[ch * LDT + ty * 4]);
      const float4 k4 = *reinterpret_cast<const float4*>(&ks[ch * LDT + tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(get(a, i), get(k4, j), s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx * 4 + j < n) ? s[i][j] * LOG2E : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads sharing ty are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = exp2f(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = alpha * l_i[i] + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NC; ++j) {
        acc_x[i][j] *= alpha;
        if constexpr (HAS_LF) acc_l[i][j] *= alpha;
      }
      if (tx == 0) alpha_s[ty * 4 + i] = alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&ps[(tx * 4 + j) * LDT + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // P.V: rows ty*4 + i, channels cc*64 + tx*4 + j
    const int k_end = min(BK, n - k0);
#pragma unroll 2
    for (int kk = 0; kk < k_end; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&ps[kk * LDT + ty * 4]);
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = round_to<T>(get(p4, i));
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float4 x4 = *reinterpret_cast<const float4*>(&xs[kk * CP + cc * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc_x[i][cc * 4 + j] = fmaf(p[i], get(x4, j), acc_x[i][cc * 4 + j]);
        if constexpr (HAS_LF) {
          const float4 l4 = *reinterpret_cast<const float4*>(&ls[kk * CP + cc * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc_l[i][cc * 4 + j] = fmaf(p[i], get(l4, j), acc_l[i][cc * 4 + j]);
        }
      }
    }

    // per-reference mass: thread owns (row, part) and keys part*16 .. +15
    {
      const int row = tid / 4, part = tid % 4;
      float* vrow = vs + ((size_t)part * BQ + row) * n_refs;
      const float a = alpha_s[row];
      for (int r = 0; r < n_refs; ++r) vrow[r] *= a;
      for (int j = 0; j < 16; ++j) {
        const int col = part * 16 + j;
        if (col < k_end) vrow[(k0 + col) / hw_key] += ps[col * LDT + row];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    if (tx == 0) l_s[ty * 4 + i] = l_i[i];
    if (q >= hw) continue;
    const float inv_l = 1.f / l_i[i];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = cc * 64 + tx * 4 + j;
        if (ch < c) {
          out_x[((size_t)b * hw + q) * c + ch] = from_f32<T>(acc_x[i][cc * 4 + j] * inv_l);
          if constexpr (HAS_LF) out_l[((size_t)b * hw + q) * c + ch] = from_f32<T>(acc_l[i][cc * 4 + j] * inv_l);
        }
      }
  }
  __syncthreads();
  for (int i = tid; i < BQ * n_refs; i += THREADS) {
    const int row = i / n_refs, r = i % n_refs;
    const int q = q0 + row;
    if (q >= hw) continue;
    float m = 0.f;
#pragma unroll
    for (int part = 0; part < 4; ++part) m += vs[((size_t)part * BQ + row) * n_refs + r];
    vis[((size_t)b * hw + q) * n_refs + r] = m / l_s[row];
  }
}

template <typename T, int NC, bool HAS_LF>
cudaError_t launch(const void* q, const void* k, const void* xf, const void* lf, void* ox,
                   void* ol, void* vis, int b, int hw, int n, int c, int n_refs,
                   cudaStream_t stream) {
  auto kern = flash_ref_attention_kernel<T, NC, HAS_LF>;
  const size_t smem = smem_floats(64 * NC, HAS_LF, n_refs) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((hw + BQ - 1) / BQ, b);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(xf),
      static_cast<const T*>(lf), static_cast<T*>(ox), static_cast<T*>(ol),
      static_cast<float*>(vis), hw, n, c, n_refs, n / n_refs);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t dispatch_lf(const void* q, const void* k, const void* xf, const void* lf, void* ox,
                        void* ol, void* vis, int b, int hw, int n, int c, int n_refs,
                        cudaStream_t stream) {
  return lf ? launch<T, NC, true>(q, k, xf, lf, ox, ol, vis, b, hw, n, c, n_refs, stream)
            : launch<T, NC, false>(q, k, xf, lf, ox, ol, vis, b, hw, n, c, n_refs, stream);
}

template <typename T>
cudaError_t dispatch_c(const void* q, const void* k, const void* xf, const void* lf, void* ox,
                       void* ol, void* vis, int b, int hw, int n, int c, int n_refs,
                       cudaStream_t stream) {
  return c <= 64 ? dispatch_lf<T, 1>(q, k, xf, lf, ox, ol, vis, b, hw, n, c, n_refs, stream)
                 : dispatch_lf<T, 2>(q, k, xf, lf, ox, ol, vis, b, hw, n, c, n_refs, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; the caller checks it
// against the card's per-block limit before launching.
size_t fsv_flash_ref_attention_smem_bytes(int c, int n_refs, int has_lf) {
  return smem_floats(c <= 64 ? 64 : 128, has_lf != 0, n_refs) * sizeof(float);
}

// query: (b, hw, c); key / xf / lf: (b, n, c), lf may be null; all contiguous,
// float32 (is_bf16 == 0) or bfloat16.  out_x / out_l: (b, hw, c) in the input
// type; vis: (b, hw, n_refs) float32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success) without synchronising.
int fsv_flash_ref_attention(const void* query, const void* key, const void* xf, const void* lf,
                            void* out_x, void* out_l, void* vis, int b, int hw, int n, int c,
                            int n_refs, int is_bf16, void* stream) {
  if (b < 1 || hw < 1 || n_refs < 1 || n < n_refs || n % n_refs || c < 1 || c > MAX_C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_c<__nv_bfloat16>(query, key, xf, lf, out_x, out_l, vis, b, hw, n, c,
                                          n_refs, s)
              : dispatch_c<float>(query, key, xf, lf, out_x, out_l, vis, b, hw, n, c, n_refs, s);
  return (int)err;
}

}  // extern "C"
