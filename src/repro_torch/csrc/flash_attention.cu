// Causal (or full) GQA flash attention for Hopper (sm_90a): the hand-written
// CUDA counterpart of the reference's Pallas kernel
//   repro/kernels/flash_attention.py::flash_attention / _kernel  (kernel 4)
// reached from repro/models/model.py::_attention_block(use_pallas=True), on
// the prefill and full-sequence forward of the dense and hybrid decoders.
//
// What it computes, for q (B, Hq, S, D) and k, v (B, Hkv, S, D), Hq % Hkv ==
// 0, S % 128 == 0, D in (64, 96, 128), f32 or bf16:
//   o[b, h] = softmax(mask(scale * q[b, h] k[b, h / G]^T)) v[b, h / G]
// with G = Hq / Hkv, scale = 1 / sqrt(D), o contiguous (B, Hq, S, D) in q's
// dtype. As in _kernel: the causal mask sets -1e30 (not -inf) where the key
// lies after the query; a running (m, l, acc) per query row is updated tile
// by tile: m_new = max(m, max(logits)), p = exp(logits - m_new), alpha =
// exp(m - m_new), l = l * alpha + sum(p), acc = acc * alpha + p v; key tiles
// past the diagonal are skipped; o = acc / max(l, 1e-30). The kv head is the
// q head / G, taken by indexing: no copy of K or V.
//
// Bound: operations. 2 B Hq S^2 D flops for causal attention (4 B Hq S^2 D
// full) against 4 B Hq S D bytes (q, k, v read once at Hq = Hkv, o written):
// at D = 64, S = 2048 the product needs ~800 flops per byte, over the card's
// ~295 bf16 flops per byte. So the bf16 route is built for the tensor cores.
//
// bf16 route (flash_fwd_wgmma<D>): Hopper's warpgroup MMA fed by TMA.
//   * Work items are (128-row q tile, batch * q head) pairs. One persistent
//     block per SM (384 threads: two consumer warpgroups of 64 q rows each
//     and a producer warpgroup) walks its share of them, the longest causal
//     rows first, dealt to the blocks in snake order.
//   * The producer's one thread loads each item's q tile, then its 128-key
//     K and V tiles into rings of 2 stages in shared memory, with
//     cp.async.bulk.tensor (TMA) on 4-d tensor maps of (B, H, S, D) built
//     from the tensors' strides: the model's transposed views are read in
//     place. Each tile arrives on a "full" mbarrier; the consumers free K
//     and V stages and the q tile on "empty" mbarriers (one arrival per
//     warpgroup), so the next tiles, and the next item's q tile, load while
//     this tile's products run. The producer warpgroup hands its registers
//     to the consumers (setmaxnreg 24 / 240).
//   * Tiles are stored as 128-byte-swizzled [128 rows x 64 columns] atoms
//     (TMA's CU_TENSOR_MAP_SWIZZLE_128B; D = 128 is two atoms side by side),
//     which wgmma reads through shared-memory descriptors of the same
//     swizzle: q and k K-major, v MN-major through the transpose bit.
//   * D = 96 (phi-3's heads): a 96-column bf16 row is 192 B, which no
//     128-byte swizzle atom holds whole, so a row is loaded as D = 128's two
//     64-column boxes. The second box reaches past the tensor map's last
//     column (D = 96), and TMA fills columns 96-127 with zeros; the shared
//     layout, the barriers' byte counts and the descriptors are D = 128's.
//     S = q k^T takes 6 k-steps of 16 (the zero columns are not read), so
//     it does D = 96's flops; O += P v runs at N = 128 over V's zero
//     columns (a third more flops for that product, 1/6 of the total) and
//     the flush stores the 96 real columns. The scale is 1/sqrt(96).
//   * S = q k^T: wgmma m64n128k16, bf16 in, f32 accumulators in registers.
//     The scale is applied to the f32 logits after the product (at D = 128
//     1/sqrt(D) is not exact in bf16), folded with log2(e) into the exp2 of
//     the MUFU unit. The row max and row sum are f32 across the quad of
//     threads that hold a row's fragment; l sums the f32 p. Only the
//     diagonal tile is masked, by select.
//   * O += P v: wgmma m64nDk16 with P, rounded to bf16, as the register A
//     operand: the S accumulator fragment re-packed in place (the two
//     layouts coincide), never through shared memory. O stays f32 in
//     registers; the flush divides by max(l, 1e-30), rounds once to bf16,
//     and stores through shared memory in 16-byte coalesced writes.
//   * At D = 64 the exponentials take as long on the MUFU unit as the
//     products on the tensor cores, so the two overlap, as in
//     FlashAttention-3: each warpgroup issues tile t's S and tile t - 1's
//     P v together and runs tile t's softmax while P v is in flight (P in
//     two register sets that take turns), and the two warpgroups take turns
//     at issuing (named barriers), so that one's softmax runs while the
//     other's products hold the tensor cores.
//   Numerics: the bf16 q.k products summed in f32 (the reference casts to
//   f32 first: the products of bf16 values are exact in f32 either way; the
//   sum order differs); P rounded to bf16 for P v (4.5-5.7e-3 against f64 at
//   the reference test's shapes, inside the bf16 bar of 2e-2).
//
// f32 route (flash_fwd<float, D>): f32 FMAs on the CUDA cores, because
// TF32 on the tensor cores misses the f32 bar of 2e-5 by 50-100x (a 3xTF32
// split is later work). One thread block of 256 threads per (batch * q head,
// 64-row q tile), the longest causal rows launched first. The block stages
// its q tile (scaled, as the reference does before the dot) in shared
// memory once, then streams 64-key tiles of K and V through shared memory.
// Thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16 i (i < 4): it
// computes the logits of keys tx + 16 j (j < 4), so a row's max and sum are
// reductions over the 16 lanes of a half warp (shuffles), and accumulates
// the output columns 64 h + 4 tx + u (u < 4, h < D / 64) of its rows, and at
// D = 96 also 64 + 2 tx + u (u < 2), from the tile's probabilities, staged
// in shared memory. Rows of the q and k tiles are padded to D + 4 floats, so
// the float4 reads of a quarter warp fall in distinct banks. It reads
// contiguous inputs only. Shared memory: 68,608 B at D = 64, 93,184 B at
// D = 96 and 117,760 B at D = 128.
//
// Both routes need more than the 48 KB default of shared memory: each launch
// raises the kernel's limit first.
#include <cuda.h>  // CUtensorMap and its encoder's types: the encoder itself
                   // comes through cudaGetDriverEntryPoint, so the library
                   // needs no link to libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 64  // f32 route: query rows per thread block
#define BK 64  // f32 route: keys per K/V tile
#define THREADS 256
#define NEG_INF (-1e30f)

namespace {

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
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
  static_assert(D % 32 == 0 && D <= 128, "D in (64, 96, 128)");
  constexpr int QS = D + 4;   // row stride of the q and k tiles
  constexpr int PS = BK + 4;  // row stride of the p tile
  constexpr int DC = D / 16;  // output columns per thread
  constexpr int NH = D / 64;  // 64-column chunks: 4 columns a thread each
  constexpr int R2 = D % 64 ? 1 : 0;  // a 32-column rest: 2 a thread
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
        for (int h = 0; h < NH; ++h) {
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
        if (R2) {
          const float2 vv = *reinterpret_cast<const float2*>(
              vs + (c + u) * D + NH * 64 + tx * 2);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][NH * 4 + 0] = fmaf(pa[i][u], vv.x, acc[i][NH * 4 + 0]);
            acc[i][NH * 4 + 1] = fmaf(pa[i][u], vv.y, acc[i][NH * 4 + 1]);
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
    for (int h = 0; h < NH; ++h)
      store4(out + h * 64 + tx * 4,
             make_float4(acc[i][h * 4 + 0] / den, acc[i][h * 4 + 1] / den,
                         acc[i][h * 4 + 2] / den, acc[i][h * 4 + 3] / den));
    if (R2)
      *reinterpret_cast<float2*>(out + NH * 64 + tx * 2) =
          make_float2(acc[i][NH * 4 + 0] / den, acc[i][NH * 4 + 1] / den);
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

// ---------------------------------------------------------------------------
// bf16 route: wgmma + TMA
namespace tc {

constexpr int ROWS = 128;      // q rows per work item
constexpr int KEYS = 128;      // keys per K/V tile
constexpr int CONSUMERS = 2;   // warpgroups of 64 q rows
constexpr int THREADS_TC = 128 * (CONSUMERS + 1);  // + the producer
constexpr int ATOM = 128 * 128;  // bytes of a [128 rows x 64 bf16] atom
static_assert(ROWS == KEYS, "the causal tile count assumes square tiles");
static_assert(ROWS == 64 * CONSUMERS, "a warpgroup holds 64 q rows");

constexpr int STAGES = 2;      // K and V ring depth

// 64-column atoms of a row of head dim D (D = 96 takes D = 128's two)
template <int D>
__host__ __device__ constexpr int atoms() {
  return (D + 63) / 64;
}

template <int D>
constexpr int smem_bytes() {
  // 1024 B of alignment slack, the q tile, the K and V rings, the output
  // tile, the barriers
  return 1024 + (2 + 2 * STAGES) * atoms<D>() * ATOM + 8 * (2 + 4 * STAGES);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity. A wait
// that outlasts 2^24 polls (far beyond any tile's copy or products) traps,
// so a broken pipeline fails its launch instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// One [128 rows x 64 columns] box of a (B, H, S, D) tensor map into shared
// memory, 128-byte swizzled; completion counted on the barrier in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int head,
                                         int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(batch), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), swizzle mode 1
// (128 B) in bits 62-63. The atoms are 1024-byte aligned, so the base offset
// is 0; a K step inside an atom moves the start address by 32 B.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// D (64 x 128, f32) (+)= A (64 x 16, bf16, shared memory) B^T (128 x 16, bf16,
// shared memory), both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16, registers) B (16 x 64, bf16, shared
// memory, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16, registers) B (16 x 128, bf16, shared
// memory, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n64(d, a, db);
}

__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

// 2^x on the MUFU unit, subnormal results flushed to zero (a p under 2^-126
// adds nothing to a row sum that holds a 1).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A barrier of one consumer warpgroup's 128 threads.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// The two consumer warpgroups take turns at issuing their products, so that
// one's softmax (the MUFU and f32 units) runs while the other's products
// hold the tensor cores: warpgroup w waits at barrier 3 + w for the other's
// hand-over, and hands over at the other's barrier once it has issued.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(3 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(4 - wg) : "memory");
}

template <int D>
__global__ void __launch_bounds__(THREADS_TC, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int bhq, int hq, int hkv,
                int s, int causal, float scale_log2) {
  static_assert(D == 64 || D == 96 || D == 128, "D in (64, 96, 128)");
  constexpr int NA = atoms<D>();  // 64-column atoms per row
  constexpr int DP = 64 * NA;     // O's columns in the products (D padded)
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;                        // NA atoms
  const uint32_t k_s = q_s + NA * ATOM;             // STAGES x NA atoms
  const uint32_t v_s = k_s + STAGES * NA * ATOM;    // STAGES x NA atoms
  const uint32_t o_s = v_s + STAGES * NA * ATOM;    // NA atoms
  const uint32_t bars = o_s + NA * ATOM;            // 8-byte mbarriers:
  const uint32_t q_full = bars;                     // the q tile landed
  const uint32_t q_empty = bars + 8;                // q read: may refill
  const uint32_t k_full = bars + 16;                // + 8 st: K tile landed
  const uint32_t v_full = k_full + 8 * STAGES;      // + 8 st: V tile landed
  const uint32_t k_empty = v_full + 8 * STAGES;     // + 8 st: K tile read
  const uint32_t v_empty = k_empty + 8 * STAGES;    // + 8 st: V tile read

  // the blocks walk the (q tile, batch * q head) items, the longest causal
  // rows first: item i is q tile nq - 1 - i / bhq of row bh = i % bhq. Round
  // r gives items r G .. r G + G - 1 (G blocks) to the blocks in snake
  // order, so that a block's short and long items even out
  const int nq = s / ROWS, items = nq * bhq;
  const int G = gridDim.x;
  auto item = [&](int r) {
    return r * G + ((r & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    bar_init(q_empty, CONSUMERS);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      bar_init(k_full + 8 * st, 1);
      bar_init(v_full + 8 * st, 1);
      bar_init(k_empty + 8 * st, CONSUMERS);
      bar_init(v_empty + 8 * st, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {
    // the producer warpgroup gives its registers to the consumers; one
    // thread keeps the rings' TMA copies in flight, across items: the next
    // item's q tile and first K/V tiles load while the consumers finish
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 4 * CONSUMERS * 32) {
      int ring = 0;
      for (int it = 0, i = item(0); i < items; i = item(++it)) {
        const int qi = nq - 1 - i / bhq, bh = i % bhq;
        const int batch = bh / hq, head = bh % hq;
        const int kv_head = head / (hq / hkv);
        const int ntiles = causal ? qi + 1 : s / KEYS;
        if (it > 0) bar_wait(q_empty, (it - 1) & 1);
        bar_expect(q_full, NA * ATOM);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load(q_s + a * ATOM, &tq, 64 * a, qi * ROWS, head, batch,
                   q_full);
        for (int t = 0; t < ntiles; ++t, ++ring) {
          const int st = ring % STAGES;
          const uint32_t ph = ((ring / STAGES) - 1) & 1;
          if (ring >= STAGES) bar_wait(k_empty + 8 * st, ph);
          bar_expect(k_full + 8 * st, NA * ATOM);
#pragma unroll
          for (int a = 0; a < NA; ++a)
            tma_load(k_s + (st * NA + a) * ATOM, &tk, 64 * a, t * KEYS,
                     kv_head, batch, k_full + 8 * st);
          if (ring >= STAGES) bar_wait(v_empty + 8 * st, ph);
          bar_expect(v_full + 8 * st, NA * ATOM);
#pragma unroll
          for (int a = 0; a < NA; ++a)
            tma_load(v_s + (st * NA + a) * ATOM, &tv, 64 * a, t * KEYS,
                     kv_head, batch, v_full + 8 * st);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    // a consumer warpgroup: 64 q rows of each item. Thread (warp w, lane)
    // of the warpgroup holds rows r0 = 16 w + lane / 4 and r0 + 8 of every
    // accumulator, at columns 8 j + 2 (lane % 4) + {0, 1} (register
    // 4 j + {0, 1} for r0, 4 j + {2, 3} for r0 + 8).
    const int wg = warp / 4;
    const int tid = threadIdx.x % 128;
    const int lane = threadIdx.x % 32;
    const int r0 = (tid / 32) * 16 + lane / 4;
    const int qd = lane % 4;
    const int lim0 = wg * 64 + r0;  // r0's row in the q tile
    const uint32_t q_wg = q_s + wg * 64 * 128;  // the warpgroup's q rows
    uint8_t* stage = smem + (o_s - base) + wg * 64 * 128;  // its out rows
    float sc[KEYS / 2];          // S = q k^T of the newest tile
    uint32_t pa[KEYS / 16][4];   // P of a tile, as wgmma's A operand,
    uint32_t pb[KEYS / 16][4];   // in two sets that take turns
    float acc[DP / 2];           // O (at D = 96 its last 32 columns are 0)
    float m0, m1, l0, l1;

    // S = q k^T for the K tile of ring slot r: 64 x 128 logits, unscaled,
    // f32
    auto issue_qk = [&](int r) {
      const uint32_t k_st = k_s + (r % STAGES) * NA * ATOM;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * ATOM + (kk % 4) * 32;
        wgmma_ss_n128(sc, desc_sw128(q_wg + off, 16, 1024),
                      desc_sw128(k_st + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P v for the V tile of ring slot r
    auto issue_pv = [&](const uint32_t (&p)[KEYS / 16][4], int r) {
      const uint32_t v_st = v_s + (r % STAGES) * NA * ATOM;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
        wgmma_pv(acc, p[kk], desc_sw128(v_st + kk * 16 * 128, ATOM, 1024));
      wgmma_commit();
    };
    // The online softmax of sc into p: the diagonal tile's keys after the
    // query set to -1e30 (by select), the row max over the quad, p =
    // exp(scale (s - m_new)) in f32, this thread's share of the row sums
    // from the f32 p (the quad adds its four at the flush), P in bf16 as
    // wgmma's register A operand (keys 16 kk .. 16 kk + 15 are accumulator
    // registers 8 kk .. 8 kk + 7, already in A's fragment order). Returns
    // alpha = exp(scale (m - m_new)) of both rows, for O.
    auto softmax = [&](uint32_t (&p)[KEYS / 16][4], bool masked,
                       float& alpha0, float& alpha1) {
      if (masked) {
        const int lim1 = lim0 + 8;
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
          const int c = 8 * j + 2 * qd;
          sc[4 * j + 0] = c > lim0 ? NEG_INF : sc[4 * j + 0];
          sc[4 * j + 1] = c + 1 > lim0 ? NEG_INF : sc[4 * j + 1];
          sc[4 * j + 2] = c > lim1 ? NEG_INF : sc[4 * j + 2];
          sc[4 * j + 3] = c + 1 > lim1 ? NEG_INF : sc[4 * j + 3];
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      alpha0 = exp2_ftz((m0 - mx0) * scale_log2);
      alpha1 = exp2_ftz((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      const float b0 = mx0 * scale_log2, b1 = mx1 * scale_log2;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk) {
        float e[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          e[u] = exp2_ftz(
              fmaf(sc[8 * kk + u], scale_log2, (u & 2) ? -b1 : -b0));
        rs0 += (e[0] + e[1]) + (e[4] + e[5]);
        rs1 += (e[2] + e[3]) + (e[6] + e[7]);
        p[kk][0] = pack_bf16(e[0], e[1]);
        p[kk][1] = pack_bf16(e[2], e[3]);
        p[kk][2] = pack_bf16(e[4], e[5]);
        p[kk][3] = pack_bf16(e[6], e[7]);
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
    };

    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    int ring = 0;
    for (int it = 0, i = item(0); i < items; i = item(++it)) {
      const int qi = nq - 1 - i / bhq, bh = i % bhq;
      const int ntiles = causal ? qi + 1 : s / KEYS;
      const bool last_item = item(it + 1) >= items;
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
      m0 = m1 = NEG_INF;
      l0 = l1 = 0.f;
      float alpha0, alpha1;

      // tile 0: S alone, then its softmax
      bar_wait(q_full, it & 1);
      bar_wait(k_full + 8 * (ring % STAGES), (ring / STAGES) & 1);
      turn_wait(wg);
      issue_qk(ring);
      turn_pass(wg);
      wgmma_wait_all();
      fence_regs(sc);
      if (tid == 0) bar_arrive(k_empty + 8 * (ring % STAGES));
      if (ntiles == 1 && tid == 0) bar_arrive(q_empty);
      softmax(pa, causal && ntiles == 1, alpha0, alpha1);

      // tile t: its S and tile t - 1's O += P v issued in one turn; its
      // softmax while P v runs (the other warpgroup's turn holds the tensor
      // cores meanwhile); O rescaled once P v has landed
      auto step = [&](int t, const uint32_t (&p_prev)[KEYS / 16][4],
                      uint32_t (&p_next)[KEYS / 16][4]) {
        const int r = ring + t;
        bar_wait(k_full + 8 * (r % STAGES), (r / STAGES) & 1);
        bar_wait(v_full + 8 * ((r - 1) % STAGES), ((r - 1) / STAGES) & 1);
        turn_wait(wg);
        issue_qk(r);
        issue_pv(p_prev, r - 1);
        turn_pass(wg);
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_regs(sc);
        if (tid == 0) bar_arrive(k_empty + 8 * (r % STAGES));
        if (t == ntiles - 1 && tid == 0) bar_arrive(q_empty);
        softmax(p_next, causal && t == ntiles - 1, alpha0, alpha1);
        wgmma_wait_all();
        fence_regs(acc);
        if (tid == 0) bar_arrive(v_empty + 8 * ((r - 1) % STAGES));
        // every accumulator, D = 96's zero columns too: their registers
        // then live as D = 128's
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          acc[4 * j + 0] *= alpha0;
          acc[4 * j + 1] *= alpha0;
          acc[4 * j + 2] *= alpha1;
          acc[4 * j + 3] *= alpha1;
        }
      };
      // the last tile's O += P v; every turn is handed over but warpgroup
      // 1's last (nobody waits for it)
      auto last_pv = [&](const uint32_t (&p)[KEYS / 16][4]) {
        const int r = ring + ntiles - 1;
        bar_wait(v_full + 8 * (r % STAGES), (r / STAGES) & 1);
        turn_wait(wg);
        issue_pv(p, r);
        if (wg == 0 || !last_item) turn_pass(wg);
        wgmma_wait_all();
        fence_regs(acc);
        if (tid == 0) bar_arrive(v_empty + 8 * (r % STAGES));
      };
      int t = 1;
      for (; t + 1 < ntiles; t += 2) {
        step(t, pa, pb);
        step(t + 1, pb, pa);
      }
      if (t < ntiles) {
        step(t, pa, pb);
        last_pv(pb);
      } else {
        last_pv(pa);
      }
      ring += ntiles;

      // flush: o = acc / max(l, 1e-30), rounded once to bf16, staged in the
      // warpgroup's output rows (swizzled like the tiles) and written out in
      // 16-byte chunks; the warpgroup's 64 output rows are contiguous in o
      const float d0 = fmaxf(quad_sum(l0), 1e-30f);
      const float d1 = fmaxf(quad_sum(l1), 1e-30f);
      named_sync(1 + wg);  // the last item's copy-out has read the rows
      // every accumulator is staged, D = 96's zero columns too (into the
      // atoms' unused half): all of O's registers are then read as at
      // D = 128, and the copy-out stores D columns
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int a = j / 8, ch = j % 8;
        const int ra = r0, rb = r0 + 8;
        *reinterpret_cast<uint32_t*>(stage + a * ATOM + ra * 128 +
                                     ((ch ^ (ra % 8)) * 16) + qd * 4) =
            pack_bf16(acc[4 * j + 0] / d0, acc[4 * j + 1] / d0);
        *reinterpret_cast<uint32_t*>(stage + a * ATOM + rb * 128 +
                                     ((ch ^ (rb % 8)) * 16) + qd * 4) =
            pack_bf16(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
      }
      named_sync(1 + wg);
      constexpr int CH = D / 8;  // 16-byte chunks per row
      __nv_bfloat16* out =
          o + ((long long)bh * s + (long long)qi * ROWS + wg * 64) * D;
#pragma unroll
      for (int j = tid; j < 64 * CH; j += 128) {
        const int r = j / CH, c = j % CH, a = c / 8, ch = c % 8;
        const uint4 x = *reinterpret_cast<const uint4*>(
            stage + a * ATOM + r * 128 + ((ch ^ (r % 8)) * 16));
        *reinterpret_cast<uint4*>(out + (long long)r * D + c * 8) = x;
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int ERR_NO_ENCODER = -1;  // this file's own error codes
constexpr int ERR_MAP = -2;

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a (B, H, S, D) bf16 tensor with element strides (sb,
// sh, ss) and a unit last stride, read in [128 rows x 64 columns] boxes,
// 128-byte swizzled; a box that reaches past column d is filled with zeros.
int make_map(CUtensorMap* map, const void* ptr, int b, int h, int s, int d,
             long long sb, long long sh, long long ss) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 128, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_MAP;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s, const long long* st, int causal,
           float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, b, hq, s, D, st[0], st[1], st[2]);
  if (err == 0) err = make_map(&mk, k, b, hkv, s, D, st[3], st[4], st[5]);
  if (err == 0) err = make_map(&mv, v, b, hkv, s, D, st[6], st[7], st[8]);
  if (err != 0) return err;
  auto kern = flash_fwd_wgmma<D>;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // one persistent block per SM (one fits), each walking its items
  const long long items = (long long)b * hq * (s / ROWS);
  const int grid = (int)(items < sms ? items : sms);
  kern<<<grid, THREADS_TC, bytes, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, b * hq, hq, hkv, s, causal,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

// dtype: 0 = f32 (the CUDA-core route: contiguous tensors only), 1 = bf16
// (the tensor-core route: any element strides (b, h, s) of q, k, v that are
// multiples of 8, with a unit last stride). o is contiguous (B, Hq, S, D).
// Returns 0 on success, a cudaError_t code, or one of this file's negative
// codes (flash_attention_error_string names each).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int b, int hq,
    int hkv, int s, int d, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, int causal, int dtype, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s <= 0 || s % tc::ROWS != 0 ||
      s / tc::ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    const long long sd = (long long)s * d;
    if (qsb != hq * sd || qsh != sd || qss != d || ksb != hkv * sd ||
        ksh != sd || kss != d || vsb != hkv * sd || vsh != sd || vss != d)
      return (int)cudaErrorInvalidValue;
    if (s / BQ > 65535) return (int)cudaErrorInvalidValue;
    if (d == 64)
      return launch<float, 64>(q, k, v, o, b, hq, hkv, s, causal, scale, st);
    if (d == 96)
      return launch<float, 96>(q, k, v, o, b, hq, hkv, s, causal, scale, st);
    if (d == 128)
      return launch<float, 128>(q, k, v, o, b, hq, hkv, s, causal, scale,
                                st);
    return (int)cudaErrorInvalidValue;
  }
  const long long strides[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  for (long long x : strides)
    if (x <= 0 || x % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && d == 64)
    return tc::launch<64>(q, k, v, o, b, hq, hkv, s, strides, causal, scale,
                          st);
  if (dtype == 1 && d == 96)
    return tc::launch<96>(q, k, v, o, b, hq, hkv, s, strides, causal, scale,
                          st);
  if (dtype == 1 && d == 128)
    return tc::launch<128>(q, k, v, o, b, hq, hkv, s, strides, causal, scale,
                           st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code == tc::ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found through "
           "cudaGetDriverEntryPoint";
  if (code == tc::ERR_MAP)
    return "cuTensorMapEncodeTiled refused a tensor map of q, k or v";
  return cudaGetErrorString((cudaError_t)code);
}
