// Causal (or full) GQA flash attention for Hopper (sm_90a): the hand-written
// CUDA counterpart of the reference's Pallas kernel
//   repro/kernels/flash_attention.py::flash_attention / _kernel  (kernel 4)
// reached from repro/models/model.py::_attention_block(use_pallas=True), on
// the prefill and full-sequence forward of the dense decoders.
//
// What it computes, for q (B, Hq, S, D) and k, v (B, Hkv, S, D), all
// contiguous, Hq % Hkv == 0, f32 or bf16:
//   o[b, h] = softmax(mask((q[b, h] * (1/sqrt(D))) k[b, h / G]^T)) v[b, h / G]
// with G = Hq / Hkv, the math in f32 and o in q's dtype. As in _kernel:
//   * q is cast to f32 and multiplied by the scale before the dot; k and v
//     are cast to f32;
//   * the logits are f32 dot products, the causal mask sets -1e30 (not
//     -inf) where the key lies after the query;
//   * a running (m, l, acc) per query row is updated tile by tile: m_new =
//     max(m, max(logits)), p = exp(logits - m_new), alpha = exp(m - m_new),
//     l = l * alpha + sum(p), acc = acc * alpha + p v;
//   * key tiles past the diagonal are skipped, and the row is flushed at the
//     last key tile that holds a key at or before its last query:
//     o = acc / max(l, 1e-30).
// The kv head is the q head / G, taken by indexing: no copy of K or V.
//
// Bound: operations. 2 B Hq S^2 D flops for causal attention (4 B Hq S^2 D
// full) against 4 B Hq S D (q, k, v read once at Hq = Hkv, o written) bytes:
// at D = 64, S = 2048 the product needs ~800 flops per byte, over the card's
// ~295 bf16 flops per byte. This first kernel keeps the arithmetic in f32 on
// the CUDA cores, not the tensor cores: TF32 misses the f32 tolerance by
// 50-100x, and bf16 MMA with wgmma and TMA is later work. So its own
// ceiling is the f32 rate (67 TFLOP/s on the H100 SXM), ~14x under the
// bf16 bound.
//
// Design: one thread block of 256 threads per (batch * q head, 64-row q
// tile), the longest causal rows launched first. The block stages its q
// tile (scaled) in shared memory once, then streams 64-key tiles of K and V
// through shared memory. Thread (ty, tx) of a 16 x 16 grid owns query rows
// ty + 16 i (i < 4): it computes the logits of keys tx + 16 j (j < 4), so a
// row's max and sum are reductions over the 16 lanes of a half warp
// (shuffles), and accumulates the output columns 64 h + 4 tx + u (u < 4,
// h < D / 64) of its rows from the tile's probabilities, staged in shared
// memory. Rows of the q and k tiles are padded to D + 4 floats, so the
// float4 reads of a quarter warp fall in distinct banks. Shared memory:
// 68,608 B at D = 64 and 117,760 B at D = 128 (one block per SM), above
// the 48 KB default: the launch raises the block's limit first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 64  // query rows per thread block
#define BK 64  // keys per K/V tile
#define THREADS 256
#define NEG_INF (-1e30f)

namespace {

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x.x, x.y);
  p2[1] = __floats2bfloat162_rn(x.z, x.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int smem_bytes() {
  // q and k tiles (padded rows), v tile, p tile (padded rows)
  return (BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 4)) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int hq, int hkv, int s,
          int causal, float scale) {
  constexpr int QS = D + 4;   // row stride of the q and k tiles
  constexpr int PS = BK + 4;  // row stride of the p tile
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;
  float* ks = qs + BQ * QS;
  float* vs = ks + BK * QS;
  float* ps = vs + BK * D;

  const int nq = s / BQ;
  const int qi = nq - 1 - (int)blockIdx.y;  // longest causal rows first
  const int bh = blockIdx.x;
  const int batch = bh / hq, head = bh % hq;
  const long long kv_head = (long long)batch * hkv + head / (hq / hkv);
  const long long q_base = ((long long)bh * s + (long long)qi * BQ) * D;
  const long long kv_base = kv_head * s * D;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int idx = tid; idx < BQ * D / 4; idx += THREADS) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 x = load4(q + q_base + (long long)r * D + c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    store4(qs + r * QS + c, x);
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int last = causal ? (qi * BQ + BQ - 1) / BK : s / BK - 1;
  for (int ki = 0; ki <= last; ++ki) {
    __syncthreads();  // the previous tile's readers are done
    const long long kv_off = kv_base + (long long)ki * BK * D;
    for (int idx = tid; idx < BK * D / 4; idx += THREADS) {
      const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
      store4(ks + r * QS + c, load4(k + kv_off + (long long)r * D + c));
      store4(vs + r * D + c, load4(v + kv_off + (long long)r * D + c));
    }
    __syncthreads();

    // logits of rows ty + 16 i against keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * QS + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * QS + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dot4(qa[i], kb[j], sc[i][j]);
    }

    // the online softmax update of each row, the row's 16 threads together
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qi * BQ + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (causal && ki * BK + tx + 16 * j > row) sc[i][j] = NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rs += sc[i][j];
        ps[(ty + 16 * i) * PS + tx + 16 * j] = sc[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p v over the tile's keys
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float pa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * PS + c);
        pa[i][0] = x.x;
        pa[i][1] = x.y;
        pa[i][2] = x.z;
        pa[i][3] = x.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (c + u) * D + h * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][h * 4 + 0] = fmaf(pa[i][u], vv.x, acc[i][h * 4 + 0]);
            acc[i][h * 4 + 1] = fmaf(pa[i][u], vv.y, acc[i][h * 4 + 1]);
            acc[i][h * 4 + 2] = fmaf(pa[i][u], vv.z, acc[i][h * 4 + 2]);
            acc[i][h * 4 + 3] = fmaf(pa[i][u], vv.w, acc[i][h * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float den = fmaxf(l[i], 1e-30f);
    T* out = o + q_base + (long long)(ty + 16 * i) * D;
#pragma unroll
    for (int h = 0; h < D / 64; ++h)
      store4(out + h * 64 + tx * 4,
             make_float4(acc[i][h * 4 + 0] / den, acc[i][h * 4 + 1] / den,
                         acc[i][h * 4 + 2] / den, acc[i][h * 4 + 3] / den));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s, int causal, float scale,
           cudaStream_t st) {
  auto kern = flash_fwd<T, D>;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * hq, s / BQ);
  kern<<<grid, THREADS, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, hq, hkv, s, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Returns a cudaError_t code (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int s, int d, int causal,
                                      int dtype, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s <= 0 || s % BQ != 0 ||
      s % BK != 0 || s / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, o, b, hq, hkv, s, causal, scale, st);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, o, b, hq, hkv, s, causal, scale, st);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, b, hq, hkv, s, causal,
                                     scale, st);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, b, hq, hkv, s, causal,
                                      scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
