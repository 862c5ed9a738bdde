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
// for c, b (Q, N) shared by the heads, u (Q, P), l (Q) the inclusive
// cumulative log-decay, all in f32. As in _kernel, the decay above the
// diagonal is selected to 0 BEFORE its exp is used: there l_q - l_s > 0,
// and at Mamba2's decay rates its exp overflows to inf, which a 0/1 mask
// multiplied in would turn into NaN. The exponent is never factored as
// exp(l_q) exp(-l_s), which overflows too. Key tiles wholly above the
// diagonal are skipped.
//
// Layout: c and b are (cell, row) with the column contiguous, read once per
// head group; u, l and the output are (cell, head, row) with element
// strides, so the model's own (B * chunks, Q, H, P) u and (B * chunks, Q,
// H) l are read as they lie. Rows of c, b and u are 16-byte aligned (the
// wrapper copies a view that is not). The kernel reads and writes f32: the
// wrapper widens bf16 inputs (exactly) and rounds the result to u's dtype.
//
// Bound. The function needs Q (Q + 1) N flops per cell for the Gram c_q .
// b_s and Q (Q + 1) P per (cell, head) for the decayed tile times u, and
// moves 2 N Q values per cell plus (2 P + 1) Q per (cell, head). At
// mamba2_2p7b's prefill shape ((cells, Q, N, H, P) = (32, 256, 128, 80, 64))
// that is 11.05 GFLOP and 346.6 MB: 0.103 ms of bytes at 3.35 TB/s against
// 0.022 ms of flops at the 495 TFLOP/s TF32 rate, so the bytes bound it. At
// hymba_1p5b's (32, 256, 16, 25, 64): 3.40 GFLOP, 106.7 MB, 0.032 ms of
// bytes. What this kernel executes: three TF32 products per f32 product;
// the Gram of every 64 x 64 tile pair up to the diagonal once per head
// group, N zero-padded to whole 32-column chunks; the decayed tile times u
// per head, whole off the diagonal and on it the k-steps up to each warp's
// last row (20 of 32): 34.2 + 5.0 = 39.3 GFLOP of TF32 at mamba2's shape
// (head group 16), 10.7 + 1.8 = 12.5 at hymba's (head group 4), 0.079 and
// 0.025 ms at the TF32 peak (chip_smoke.py's ssd_run_flops).
//
// Design.
// 1. One Gram per (cell, 64-row query tile) for a group of heads. A block of
//    four warps takes one cell, one query tile and a group of hg heads (the
//    wrapper's head_group: the Gram then costs at most ~1/8 of the products
//    it feeds). It forms the panel G = C_q B_s^T for every key tile s <= q
//    (64 x up to 256 f32 in shared memory), c and b streamed through a
//    double buffer of cp.async copies in chunks of 32 columns, then walks
//    its heads: W_h = where(q >= s, exp(l_h[q] - l_h[s]), 0) * G, formed in
//    registers straight into the A fragments, and acc_h += W_h U_h[s], the
//    accumulators in registers (warp w owns query rows 16 w .. 16 w + 15,
//    all P columns). The kernel this one replaced formed the Gram once per
//    head: at mamba2's shape 2/3 of its 40.3 GFLOP were that repeat.
//    Blocks are numbered cell-major, then head group, then query tile with
//    the longest causal rows first. A chunk longer than 256 keys forms
//    each 256-key panel again per head (correct, not fast: the models'
//    chunk is 256).
// 2. 3xTF32 on the tensor cores, mma.sync.m16n8k8 .tf32. Each operand x is
//    split as hi = tf32(x), lo = tf32(x - hi), rounded as cvt.rna.tf32.f32
//    rounds (in two integer instructions: the cvt compiles to more), and
//    each product is a_lo b_hi + a_hi b_lo + a_hi b_hi accumulated in f32
//    (the dropped a_lo b_lo is ~2^-22 relative); the replaced kernel's f32
//    FMAs on the CUDA cores put its executed flops alone at ~0.6 ms. Both
//    products are split so: the Gram, and W_h U_h with W_h split after it is
//    formed in f32. A tile's W (8 k-steps, 32 values a thread) is formed
//    before its products, and the tiles off the diagonal run without the
//    select or the k-step skip: straight-line code the compiler can
//    interleave. wgmma was tried as well (U split once per block into hi
//    and lo planes, transposed to the K-major 128-byte-swizzled layout tf32
//    requires, with one, two and four warpgroups a block): no faster, since
//    the tensor cores are not what bounds this kernel (below), and
//    mma.sync keeps the per-warp skip on the diagonal tile.
// 3. The next (head, key tile)'s U tile and its l values are copied by
//    cp.async into the other half of a double buffer while the current one
//    is multiplied; l is staged once per head and tile (the key tile's 64
//    values and the query tile's 64).
// What holds it back (variants that each skip one part, timed in turns): no
// one part. The three mma.sync a product, the splits (U's redone by each of
// the four warps), the exp and the Gram each take a share, at two blocks of
// four warps an SM (set by the shared memory). It runs at ~5.5x its bound
// at mamba2's shape (PERF.md).
// Shared memory: the Gram panel 64 x (K + 4) floats (K = min(Q, 256) keys
// rounded up to 64), then a staging region used first for the c/b chunks
// (2 buffers x 2 x 64 x 36 floats) and then for the u tiles (2 x 64 x (P +
// 8) floats), then 2 x 128 floats of l: 104,448 B at Q = 256, P <= 64, so
// two blocks per SM; 136,704 B at P = 128 (one). The row strides (K + 4, 36
// and P + 8 floats) make every fragment read of a warp hit 32 distinct
// banks. ptxas (-Xptxas -v, sm_90a): 229 registers at P = 64 and 128, 156
// and 158 at P = 32 and 16, no spills, no stack.
#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 64       // query rows per block; keys per key tile
#define PANEL 4     // key tiles per Gram panel (256 keys)
#define KC 32       // columns of c and b per staged chunk
#define CS (KC + 4)  // row stride of a staged c or b chunk
#define WARPS 4
#define THREADS (WARPS * 32)
#define MAX_N 256

namespace {

// element strides: (cell, row) for c and b; (cell, head, row) for u, l and
// the output. The column stride of c, b, u and the output is 1.
struct Layout {
  long long c[2], b[2], u[3], l[3], o[3];
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero: half an ulp added to the magnitude, the low 13 bits cleared),
// in two integer instructions, where the cvt compiles to more on sm_90a
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~22 bits, each a TF32 value (round to nearest, away on a
// tie)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// not volatile: the compiler may interleave independent products
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[n0 + j] += a b_j in 3xTF32 for NB n-tiles: a_lo b_hi + a_hi b_lo +
// a_hi b_hi, the small terms first, each pass over all NB n-tiles so that
// neighbouring products are independent. b[j] holds the B fragment's two
// f32 values of n-tile j.
template <int NB, int ND>
__device__ __forceinline__ void mma3(float (&d)[ND][4], int n0,
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const float (&b)[NB][2]) {
  uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    split(b[j][0], bh[j][0], bl[j][0]);
    split(b[j][1], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) mma(d[n0 + j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < NB; ++j) mma(d[n0 + j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < NB; ++j) mma(d[n0 + j], ah, bh[j][0], bh[j][1]);
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void zero4(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
}

__host__ __device__ constexpr int stage_floats(int p) {
  return 2 * 2 * BQ * CS > 2 * BQ * (p + 8) ? 2 * 2 * BQ * CS
                                            : 2 * BQ * (p + 8);
}

__host__ __device__ constexpr int smem_floats(int key_tiles, int p) {
  // the Gram panel, the staging region, l (key tile and query tile) x 2
  return BQ * (key_tiles * BQ + 4) + stage_floats(p) + 2 * 2 * BQ;
}

struct Block {
  const float *c, *b, *u, *l;
  float* o;
  Layout L;
  int q_len, n, q0, qi, h0, h1;
  float *gp, *stage, *lbuf;
  int gs;  // row stride of the Gram panel
};

// Gram panel pn: gp[r][(s % PANEL) * BQ + k] = c[q0 + r] . b[s * BQ + k] for
// the key tiles s of the panel up to qi, c and b staged in 32-column chunks
// through a double buffer.
__device__ __forceinline__ void gram_panel(const Block& B, int pn) {
  const int tid = threadIdx.x, w = tid >> 5, g = (tid >> 2) & 7,
            t = tid & 3;
  const int t0 = pn * PANEL, t1 = min(B.qi + 1, t0 + PANEL);
  const int nkc = (B.n + KC - 1) / KC;
  const int steps = (t1 - t0) * nkc;

  auto stage = [&](int i) {
    const int st = t0 + i / nkc, col0 = (i % nkc) * KC;
    constexpr int w4 = KC / 4;  // quads per row
    float* cb = B.stage + (i & 1) * 2 * BQ * CS;
    for (int idx = tid; idx < 2 * BQ * w4; idx += THREADS) {
      const int which = idx >= BQ * w4;
      const int rem = idx - which * BQ * w4, r = rem / w4, qd = rem % w4;
      const int row = (which ? st * BQ : B.q0) + r, col = col0 + qd * 4;
      float* dst = cb + which * BQ * CS + r * CS + qd * 4;
      if (row < B.q_len && col < B.n)
        cp16(dst, which ? B.b + row * B.L.b[1] + col
                        : B.c + row * B.L.c[1] + col);
      else
        zero4(dst);  // a ragged row, or the pad of N to whole chunks
    }
  };

  float acc[8][4];
  stage(0);
  cp_commit();
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) stage(i + 1);
    cp_commit();
    cp_wait_prev();
    __syncthreads();
    const int kc = i % nkc, st = t0 + i / nkc;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    const float* cs = B.stage + (i & 1) * 2 * BQ * CS + (16 * w + g) * CS;
    const float* bs = B.stage + (i & 1) * 2 * BQ * CS + BQ * CS + g * CS;
#pragma unroll
    for (int k8 = 0; k8 < KC / 8; ++k8) {
      const int k = 8 * k8 + t;
      uint32_t ah[4], al[4];
      split(cs[k], ah[0], al[0]);
      split(cs[8 * CS + k], ah[1], al[1]);
      split(cs[k + 4], ah[2], al[2]);
      split(cs[8 * CS + k + 4], ah[3], al[3]);
      float bv[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bv[j][0] = bs[j * 8 * CS + k];
        bv[j][1] = bs[j * 8 * CS + k + 4];
      }
      mma3(acc, 0, ah, al, bv);
    }
    if (kc == nkc - 1) {
      float* row = B.gp + (16 * w + g) * B.gs + (st % PANEL) * BQ + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(row + 8 * B.gs + 8 * j) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();  // the buffer is free for step i + 2, the panel done
  }
}

// acc += W U_s over one 64-key tile for this warp's 16 query rows: W =
// G * exp(l_q - l_s) formed for all 8 k-steps first (32 independent exp
// chains a thread) and split into A fragments, then the products. g0 and g1
// are the warp's two Gram rows of a thread at the tile's first key, ls the
// tile's l, lq0 and lq1 the two rows' l, ub the U tile at (t, g). DIAG: the
// diagonal tile, where the decay is selected to 0 above the diagonal before
// it is used (its exp may be inf there) and the k-steps past the warp's
// last row (16 w + 15) are skipped; off it every key precedes every row.
template <int P, bool DIAG>
__device__ __forceinline__ void tile_product(float (&acc)[P / 8][4],
                                             const float* g0,
                                             const float* g1,
                                             const float* ls, float lq0,
                                             float lq1, const float* ub) {
  constexpr int NT = P / 8, NG = NT < 8 ? NT : 8, US = P + 8;
  const int w = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3, r0 = 16 * w + g;
  uint32_t ah[8][4], al[8][4];
#pragma unroll
  for (int k8 = 0; k8 < 8; ++k8) {
    const int k = 8 * k8 + t;
    const float la = ls[k], lb = ls[k + 4];
    float wv[4] = {g0[k] * expf(lq0 - la), g1[k] * expf(lq1 - la),
                   g0[k + 4] * expf(lq0 - lb), g1[k + 4] * expf(lq1 - lb)};
    if (DIAG) {
      wv[0] = k <= r0 ? wv[0] : 0.f;
      wv[1] = k <= r0 + 8 ? wv[1] : 0.f;
      wv[2] = k + 4 <= r0 ? wv[2] : 0.f;
      wv[3] = k + 4 <= r0 + 8 ? wv[3] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) split(wv[e], ah[k8][e], al[k8][e]);
  }
#pragma unroll
  for (int k8 = 0; k8 < 8; ++k8) {
    if (DIAG && k8 > 2 * w + 1) break;
    const float* uk = ub + 8 * k8 * US;
    // n-tiles in groups of at most 8 (P = 128: two), to bound the
    // registers the split fragments take
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NG) {
      float bv[NG][2];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        bv[j][0] = uk[8 * (n0 + j)];
        bv[j][1] = uk[4 * US + 8 * (n0 + j)];
      }
      mma3(acc, n0, ah[k8], al[k8], bv);
    }
  }
}

// acc_h += W_h U_h over the steps (head h, key tile s) for h in [j0, j1) and
// s in [s0, s1): the accumulators start at 0 on key tile 0 and are stored on
// key tile qi. U tiles and l are staged through a double buffer, the next
// step's copies in flight during the current step's products.
template <int P>
__device__ __forceinline__ void head_steps(const Block& B, int j0, int j1,
                                           int s0, int s1,
                                           float (&acc)[P / 8][4]) {
  constexpr int NT = P / 8, US = P + 8, UT = BQ * US, Q4 = P / 4;
  const int tid = threadIdx.x, w = tid >> 5, g = (tid >> 2) & 7,
            t = tid & 3;
  const int ns = s1 - s0, steps = (j1 - j0) * ns;

  auto stage = [&](int i) {
    const int j = j0 + i / ns, s = s0 + i % ns;
    float* ub = B.stage + (i & 1) * UT;
    float* lb = B.lbuf + (i & 1) * 2 * BQ;
    const float* ug = B.u + j * B.L.u[1];
    const float* lg = B.l + j * B.L.l[1];
    for (int idx = tid; idx < BQ * Q4; idx += THREADS) {
      const int r = idx / Q4, qd = idx % Q4, row = s * BQ + r;
      float* dst = ub + r * US + qd * 4;
      if (row < B.q_len)
        cp16(dst, ug + row * B.L.u[2] + qd * 4);
      else
        zero4(dst);
    }
    // l of the key tile, then of the query tile
    for (int idx = tid; idx < 2 * BQ; idx += THREADS) {
      const int row = idx < BQ ? s * BQ + idx : B.q0 + idx - BQ;
      if (row < B.q_len)
        cp4(lb + idx, lg + row * B.L.l[2]);
      else
        lb[idx] = 0.f;
    }
  };

  const int r0 = 16 * w + g, qa = B.q0 + r0, qb = qa + 8;
  const float* g0 = B.gp + r0 * B.gs;
  const float* g1 = g0 + 8 * B.gs;
  stage(0);
  cp_commit();
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) stage(i + 1);
    cp_commit();
    cp_wait_prev();
    __syncthreads();
    const int j = j0 + i / ns, s = s0 + i % ns;
    if (s == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    }
    const float* ub = B.stage + (i & 1) * UT + t * US + g;
    const float* ls = B.lbuf + (i & 1) * 2 * BQ;
    const float lq0 = ls[BQ + r0], lq1 = ls[BQ + r0 + 8];
    const int gc = (s % PANEL) * BQ;
    if (s == B.qi)
      tile_product<P, true>(acc, g0 + gc, g1 + gc, ls, lq0, lq1, ub);
    else
      tile_product<P, false>(acc, g0 + gc, g1 + gc, ls, lq0, lq1, ub);
    if (s == B.qi) {
      float* o = B.o + j * B.L.o[1] + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (qa < B.q_len)
          *reinterpret_cast<float2*>(o + qa * B.L.o[2] + 8 * nt) =
              make_float2(acc[nt][0], acc[nt][1]);
        if (qb < B.q_len)
          *reinterpret_cast<float2*>(o + qb * B.L.o[2] + 8 * nt) =
              make_float2(acc[nt][2], acc[nt][3]);
      }
    }
    __syncthreads();  // the buffer is free for step i + 2
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS)
    ssd_intra(const float* __restrict__ c, const float* __restrict__ b,
              const float* __restrict__ u, const float* __restrict__ ld,
              float* __restrict__ o, Layout L, int heads, int hg, int groups,
              int q_len, int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nq = (q_len + BQ - 1) / BQ;
  const int blk = blockIdx.x;
  const long long cell = blk / nq / groups;
  const int grp = (blk / nq) % groups;
  Block B;
  B.qi = nq - 1 - blk % nq;  // the longest causal rows first
  B.q0 = B.qi * BQ;
  B.c = c + cell * L.c[0];
  B.b = b + cell * L.b[0];
  B.u = u + cell * L.u[0];
  B.l = ld + cell * L.l[0];
  B.o = o + cell * L.o[0];
  B.L = L;
  B.q_len = q_len;
  B.n = n;
  B.h0 = grp * hg;
  B.h1 = min(heads, B.h0 + hg);
  B.gs = min(nq, PANEL) * BQ + 4;
  B.gp = smem;
  B.stage = smem + BQ * B.gs;
  B.lbuf = B.stage + stage_floats(P);

  float acc[P / 8][4];
  const int npanels = B.qi / PANEL + 1;
  if (npanels == 1) {  // the Gram once for the whole head group
    gram_panel(B, 0);
    head_steps<P>(B, B.h0, B.h1, 0, B.qi + 1, acc);
  } else {  // a chunk past 256 keys: each panel again per head
    for (int j = B.h0; j < B.h1; ++j)
      for (int pn = 0; pn < npanels; ++pn) {
        gram_panel(B, pn);
        head_steps<P>(B, j, j + 1, pn * PANEL,
                      min(B.qi + 1, (pn + 1) * PANEL), acc);
      }
  }
}

template <int P>
int launch(const float* c, const float* b, const float* u, const float* ld,
           float* o, const Layout& L, int cells, int heads, int hg,
           int q_len, int n, cudaStream_t st) {
  auto kern = ssd_intra<P>;
  const int nq = (q_len + BQ - 1) / BQ, groups = (heads + hg - 1) / hg;
  const long long blocks = (long long)cells * groups * nq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int bytes = smem_floats(nq < PANEL ? nq : PANEL, P) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)blocks, THREADS, bytes, st>>>(c, b, u, ld, o, L, heads, hg,
                                                 groups, q_len, n);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 13 element strides: (cell, row) for c and b, (cell, head, row)
// for u, ld and o, in that order; the column stride of c, b, u and o is 1
// and the rows of c, b and u are 16-byte aligned. All f32. hg: heads per
// block (one Gram each). Returns a cudaError_t code (0 on success).
extern "C" int ssd_intra_chunk_launch(const void* c, const void* b,
                                      const void* u, const void* ld, void* o,
                                      int cells, int heads, int hg,
                                      int q_len, int n, int p,
                                      const long long* strides,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cells <= 0 || heads <= 0 || hg <= 0 || q_len <= 0 || n < 4 ||
      n > MAX_N || n % 4 != 0)
    return (int)cudaErrorInvalidValue;
  Layout L;
  for (int i = 0; i < 2; ++i) {
    L.c[i] = strides[i];
    L.b[i] = strides[2 + i];
  }
  for (int i = 0; i < 3; ++i) {
    L.u[i] = strides[4 + i];
    L.l[i] = strides[7 + i];
    L.o[i] = strides[10 + i];
  }
  const float *fc = (const float*)c, *fb = (const float*)b,
              *fu = (const float*)u, *fl = (const float*)ld;
  float* fo = (float*)o;
  switch (p) {
    case 16:
      return launch<16>(fc, fb, fu, fl, fo, L, cells, heads, hg, q_len, n,
                        st);
    case 32:
      return launch<32>(fc, fb, fu, fl, fo, L, cells, heads, hg, q_len, n,
                        st);
    case 64:
      return launch<64>(fc, fb, fu, fl, fo, L, cells, heads, hg, q_len, n,
                        st);
    case 128:
      return launch<128>(fc, fb, fu, fl, fo, L, cells, heads, hg, q_len, n,
                         st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_intra_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
