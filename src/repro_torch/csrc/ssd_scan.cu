// The Mamba2 SSD intra-chunk term for Hopper (sm_90a): the hand-written CUDA
// counterpart of the reference's Pallas kernel
//   repro/kernels/ssd_scan.py::ssd_intra_chunk / _kernel  (kernel 5).
// The reference's models compute this term by einsum (repro/models/ssm.py::
// ssd_chunked); the port routes its own ssd_chunked through this kernel
// under use_kernel (repro_torch/models/ssm.py), on the prefill and the
// full-sequence forward of the ssm and hybrid families.
//
// What it computes, per cell (one chunk of one sequence) and head h:
//   y[q, :] = sum_{s <= q} (c_q . b_s) * exp(l_q - l_s) * u[s, :]
// for c, b (Q, N), u (Q, P), l (Q) the inclusive cumulative log-decay, the
// math in f32 and y in u's dtype. As in _kernel, the decay above the
// diagonal is selected to 0 BEFORE the exp is used: there l_q - l_s > 0,
// and at Mamba2's decay rates its exp overflows to inf, which a 0/1 mask
// multiplied in would turn into NaN. Key tiles wholly above the diagonal
// contribute exactly 0 and are skipped.
//
// Layout: every operand is addressed as (cell, head, row, column) with
// element strides for the first three and the column contiguous, so the
// model passes its own (B * chunks, Q, H, P) u and (B * chunks, Q, H) l as
// they lie, and c and b (B * chunks, Q, N) once for all heads (head stride
// 0): no copy of b and c per head. The public (G, Q, N) form is one head.
//
// Bound: the causal term needs Q (Q + 1) N flops per cell for the Gram
// c_q . b_s (c and b are shared by the heads) and Q (Q + 1) P per (cell,
// head) for the decayed tile times u; it moves 2 N Q values per cell plus
// (2 P + 1) Q per (cell, head) (u, l, y). At mamba2's prefill shape (Q =
// 256, N = 128, P = 64, H = 80, f32) that is ~32 flops per byte, under the
// card's ~148 TF32 flops per byte (495 TFLOP/s over 3.35 TB/s): the least
// time is the bytes'. This first kernel keeps the arithmetic in f32 on the
// CUDA cores: TF32 keeps ~3 digits and the reference holds the kernel at
// rtol 1e-5. It also forms the Gram once per (cell, head), not once per
// cell: N / (N + P) of its arithmetic (2/3 at mamba2's shape) repeats
// across the heads, so it executes ~3.6x the function's flops (whole
// diagonal tiles included). Sharing the Gram across the heads of a block,
// then mma.sync or wgmma with a 3xTF32 split, are later work.
//
// Design: flash attention's shape with a decay in place of the softmax. A
// Q x Q f32 Gram tile (256 KiB at Q = 256) does not fit in shared memory,
// so one thread block of 256 threads takes one (cell * head, 64-row query
// tile), the longest causal rows launched first. It stages C_q (64 x N) and
// l_q once, then walks the key tiles at or below the diagonal: B_s (64 x N),
// U_s (64 x P) and l_s into shared memory; the 64 x 64 Gram sub-tile in
// registers (thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and keys
// tx + 16 j, i, j < 4); the masked decay; the scaled tile to shared memory;
// then acc (4 rows x P / 16 columns per thread) += tile U_s. Rows of the c
// and b tiles are padded to N + 4 floats so a quarter warp's float4 reads
// fall in distinct banks. A ragged last tile (Q not a multiple of 64) is
// zero-filled and its rows past Q are not stored. Shared memory: 101,888 B
// at N = 128, P = 64 (two blocks per SM), over the 48 KB default: the
// launch raises the block's limit first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 64  // query rows per thread block
#define BS 64  // keys per B/U tile
#define THREADS 256
#define MAX_N 256
#define PS (BS + 4)  // row stride of the scaled Gram tile

namespace {

// element strides of (cell, head, row) for c, b, u, l and o
struct Layout {
  long long c[3], b[3], u[3], l[3], o[3];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The output column of a thread's c-th accumulator: four consecutive
// columns per 64 (a half warp's float4 reads of a U row are one contiguous
// 256 B span) where P >= 64, else P / 16 consecutive columns.
template <int PC>
__device__ __forceinline__ int column(int c, int tx) {
  if constexpr (PC >= 4) return (c / 4) * 64 + tx * 4 + c % 4;
  return tx * PC + c;
}

template <int PC>
__device__ __forceinline__ void load_row(const float* row, int tx,
                                         float (&v)[PC]) {
  if constexpr (PC >= 4) {
#pragma unroll
    for (int h = 0; h < PC / 4; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(row + h * 64 + tx * 4);
      v[4 * h + 0] = x.x;
      v[4 * h + 1] = x.y;
      v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    }
  } else if constexpr (PC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(row + tx * 2);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = row[tx];
  }
}

__host__ __device__ constexpr int smem_floats(int n, int p) {
  // c and b tiles (padded rows), u tile, scaled Gram tile, l_q and l_s
  return BQ * (n + 4) + BS * (n + 4) + BS * p + BQ * PS + BQ + BS;
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS, 2)
ssd_intra(const T* __restrict__ c, const T* __restrict__ b,
          const T* __restrict__ u, const float* __restrict__ ld,
          T* __restrict__ o, Layout L, int heads, int q_len, int n) {
  constexpr int PC = P / 16;  // output columns per thread
  const int NS = n + 4;       // row stride of the c and b tiles
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* cs = smem;
  float* bs = cs + BQ * NS;
  float* us = bs + BS * NS;
  float* ps = us + BS * P;
  float* lq = ps + BQ * PS;
  float* ls = lq + BQ;

  const int nq = (q_len + BQ - 1) / BQ;
  const int qi = nq - 1 - (int)blockIdx.y;  // longest causal rows first
  const long long cell = blockIdx.x / heads;
  const long long head = blockIdx.x % heads;
  const T* cg = c + cell * L.c[0] + head * L.c[1];
  const T* bg = b + cell * L.b[0] + head * L.b[1];
  const T* ug = u + cell * L.u[0] + head * L.u[1];
  const float* lg = ld + cell * L.l[0] + head * L.l[1];
  T* og = o + cell * L.o[0] + head * L.o[1];
  const int q0 = qi * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int idx = tid; idx < BQ * n; idx += THREADS) {
    const int r = idx / n, k = idx - r * n, q = q0 + r;
    cs[r * NS + k] = q < q_len ? to_f32(cg[q * L.c[2] + k]) : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS)
    lq[r] = q0 + r < q_len ? lg[(q0 + r) * L.l[2]] : 0.f;

  float acc[4][PC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int cc = 0; cc < PC; ++cc) acc[i][cc] = 0.f;

  for (int ki = 0; ki <= qi; ++ki) {
    __syncthreads();  // the previous tile's readers are done
    const int s0 = ki * BS;
    for (int idx = tid; idx < BS * n; idx += THREADS) {
      const int r = idx / n, k = idx - r * n, s = s0 + r;
      bs[r * NS + k] = s < q_len ? to_f32(bg[s * L.b[2] + k]) : 0.f;
    }
    for (int idx = tid; idx < BS * P; idx += THREADS) {
      const int r = idx / P, k = idx % P, s = s0 + r;
      us[r * P + k] = s < q_len ? to_f32(ug[s * L.u[2] + k]) : 0.f;
    }
    for (int r = tid; r < BS; r += THREADS)
      ls[r] = s0 + r < q_len ? lg[(s0 + r) * L.l[2]] : 0.f;
    __syncthreads();

    // Gram sub-tile: rows ty + 16 i against keys tx + 16 j
    float g[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < n; k += 4) {
      float4 ca[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ca[i] = *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * NS + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bb[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * NS + k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = dot4(ca[i], bb[j], g[i][j]);
    }

    // the decay, selected to 0 above the diagonal before its exp is used
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        ps[r * PS + col] =
            s0 + col <= q0 + r ? g[i][j] * expf(lq[r] - ls[col]) : 0.f;
      }
    }
    __syncthreads();

    // acc += (scaled tile) U_s over the tile's keys
#pragma unroll 2
    for (int s = 0; s < BS; s += 4) {
      float pa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * PS + s);
        pa[i][0] = x.x;
        pa[i][1] = x.y;
        pa[i][2] = x.z;
        pa[i][3] = x.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float uv[PC];
        load_row<PC>(us + (s + e) * P, tx, uv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int cc = 0; cc < PC; ++cc)
            acc[i][cc] = fmaf(pa[i][e], uv[cc], acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q < q_len) {
      T* row = og + q * L.o[2];
#pragma unroll
      for (int cc = 0; cc < PC; ++cc)
        from_f32(row + column<PC>(cc, tx), acc[i][cc]);
    }
  }
}

template <typename T, int P>
int launch(const void* c, const void* b, const void* u, const float* ld,
           void* o, const Layout& L, int cells, int heads, int q_len, int n,
           cudaStream_t st) {
  auto kern = ssd_intra<T, P>;
  const int bytes = smem_floats(n, P) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cells * heads, (q_len + BQ - 1) / BQ);
  kern<<<grid, THREADS, bytes, st>>>((const T*)c, (const T*)b, (const T*)u,
                                     ld, (T*)o, L, heads, q_len, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* c, const void* b, const void* u, const float* ld,
             void* o, const Layout& L, int cells, int heads, int q_len,
             int n, int p, cudaStream_t st) {
  switch (p) {
    case 16:
      return launch<T, 16>(c, b, u, ld, o, L, cells, heads, q_len, n, st);
    case 32:
      return launch<T, 32>(c, b, u, ld, o, L, cells, heads, q_len, n, st);
    case 64:
      return launch<T, 64>(c, b, u, ld, o, L, cells, heads, q_len, n, st);
    case 128:
      return launch<T, 128>(c, b, u, ld, o, L, cells, heads, q_len, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 15 element strides, (cell, head, row) for c, b, u, ld and o in
// that order; the column stride of c, b, u and o is 1. dtype: 0 = f32 (c,
// b, u and o), 1 = bf16; ld is f32. Returns a cudaError_t code (0 on
// success).
extern "C" int ssd_intra_chunk_launch(const void* c, const void* b,
                                      const void* u, const void* ld, void* o,
                                      int cells, int heads, int q_len, int n,
                                      int p, const long long* strides,
                                      int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cells <= 0 || heads <= 0 || q_len <= 0 || n < 4 || n > MAX_N ||
      n % 4 != 0 || (long long)cells * heads > 0x7fffffffLL ||
      (q_len + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  Layout L;
  for (int i = 0; i < 3; ++i) {
    L.c[i] = strides[i];
    L.b[i] = strides[3 + i];
    L.u[i] = strides[6 + i];
    L.l[i] = strides[9 + i];
    L.o[i] = strides[12 + i];
  }
  const float* l = (const float*)ld;
  if (dtype == 0)
    return dispatch<float>(c, b, u, l, o, L, cells, heads, q_len, n, p, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(c, b, u, l, o, L, cells, heads, q_len, n,
                                   p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_intra_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
