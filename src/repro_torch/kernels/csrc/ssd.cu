// Hopper (sm_90a) chunked SSD (Mamba-2 state-space duality) forward scan,
// with a plain C interface for ctypes (built by
// repro_torch/kernels/build.py).
//
// ssd_scan — replaces repro/kernels/ssd_scan/kernel.py::ssd_scan
//   (_ssd_kernel), which ops.py::ssd_scan_model_layout reaches after
//   transposing to (B, H, S, P).  Per (b, h), over the chunks of Q steps
//   in order, with an fp32 (P, N) state that starts at 0:
//     cum   = cumsum(a) over the chunk, total = cum[Q-1]
//     y     = (C B^T o decay) x + exp(cum) (C state^T),
//             decay[i][j] = exp(cum_i - cum_j) for j <= i, else 0
//     state = exp(total) state + x^T (B o exp(total - cum))
//   The reference's forms exp(total - cum) and exp(cum_i - cum_j) are
//   kept (a quotient of exps under- or overflows), and the mask is applied
//   before the exp: for j > i the exponent is positive and unbounded.
//
// What bounds it.  At the main path's shape (B 2, H 64, S 2048, P 64,
// N 128, Q 256) the scan needs 12.0 GFLOP (kernel.py::needed_flops)
// against 139.5 MB moved: about 86 FLOPs a byte in fp32, far past the
// ridge of the CUDA cores (67 TFLOP/s, 20 FLOPs a byte), so on FMAs it is
// bound by operations.  Three things in the design answer that:
//
// 1. C B^T once per (b, chunk).  B and C are shared by every head (one
//    group), so C B^T does not depend on h: the first blocks of
//    ssd_chunk_kernel write the causal 64 x 64 tiles of each chunk's
//    C B^T, undecayed (the decay depends on h), into a scratch of
//    B x chunks x Qp x Qp fp32 (Qp = Q rounded up to 64; 4 MiB at the main
//    shape, so it stays in L2), and the output kernel reads its rows
//    there.  Per head it then does only the decay and M x.
// 2. Chunk-parallel.  Blocks run in no order, so a block that walks its
//    chunks in order (one per (b, h)) leaves most of the card idle and
//    waits at every barrier.  Instead the scan is three launches:
//      ssd_chunk_kernel: after the C B^T blocks, one block per (b, h,
//        chunk but the last, 64 columns of P) forms the chunk's own
//        increment x^T (B o exp(total - cum)), transposed, and its total,
//        into a (B, H, chunks, P, N) fp32 scratch;
//      ssd_pass_kernel: state_{c+1} = exp(total_c) state_c + inc_c over
//        the chunks in order, elementwise, in place: slot c then holds
//        the state entering chunk c;
//      ssd_out_kernel, one block of 8 warps per (b, h, chunk, 128 query
//        rows, 64 columns of P): y = (C B^T o decay) x +
//        exp(cum) C state_c^T, the blocks with the most key tiles first;
//        each x tile and state slab is split and stored once for the 128
//        rows (with 64-row blocks of 4 warps the kernel took 0.39 ms, not
//        0.35; tools/ssd_check.py).
//    1,056 chunk blocks and 2,048 output blocks at the main shape.
// 3. Tensor cores at fp32 accuracy.  Every product (C B^T, M x,
//    C state^T, x^T (B o w)) runs on mma.sync.m16n8k8 with TF32 operands
//    and fp32 accumulators, each operand split as x = hi + lo (hi = x
//    rounded to TF32, lo = x - hi rounded, both to nearest with ties away
//    as cvt.rna.tf32.f32 rounds, by two integer operations each: the
//    conversion instruction runs at a fraction of their rate) and the
//    product taken as lo*hi + hi*lo + hi*hi (3xTF32).  One TF32 product
//    alone keeps 10 bits of each operand and misses ref.REL_TOL (1e-4 of
//    each block's max) by about 5x at (1, 4, 1024, 64, 128, 256); the
//    split keeps about 21 and passes with room (ref.ssd_split emulates
//    both; tests/test_torch_ssd_split.py).  Its bound is then 3x the
//    needed work over the dense TF32 peak (494.7 TFLOP/s): 0.0728 ms,
//    beside the FMA bound of 0.1791 ms.  mma.sync is not the card's
//    fastest path: alone, from registers, it reaches 329 TFLOP/s on an
//    H100 80GB HBM3 at 700 W (tools/ssd_check.py --mma-rate), and wgmma,
//    the fast one, takes TF32 only K-major while M x reads x along its
//    rows.  What holds the kernel further below that is the work around
//    each mma (building and splitting A, reading B, the tile stores): no
//    mma sits behind a branch (a branch around one makes the compiler
//    fence it with a warp synchronisation), so every n-tile of a block is
//    multiplied, the columns past P holding zeros.
//
// Operands.  A fragments are built in registers: M from the C B^T rows
// (8-byte loads from L2) times exp2(cum2_i - cum2_j) (ex2.approx on the
// log2-scaled cumsum; masked before the exp), exp(cum_i) C from global,
// B o w from shared memory; each A value is used by one warp, so it is
// split once.  The B operands (x, the states, B for C B^T) are shared by
// a block's warps (4 or 8), so they are split once as they are stored, hi
// and lo interleaved, and read with 8- or 16-byte loads.  Within a
// k-step of 8 the fragment's columns t and t+4 stand for keys 2t and
// 2t+1 (the same permutation in A and B), so a thread's two A values of
// a row are neighbours.  Row strides are padded so that every fragment
// load is free of bank conflicts.  The next x tile is loaded into
// registers while the current one is multiplied; the B slab of the
// increment arrives by cp.async while x is split.
//
// Layout.  x and y are (B, H, S, P) (layout 0, the reference's kernel
// layout) or (B, S, H, P) (layout 1, the model's: no transposes around
// the call); a likewise (B, H, S) or (B, S, H); B and C are (B, S, N),
// shared by every head.  Everything is fp32 and contiguous.
//
// Scratch, allocated by the caller (the kernels allocate nothing): cb,
// B * chunks * Qp * Qp floats; states, B * H * chunks * P * N; totals,
// B * H * chunks; cb and states 16-byte aligned.
//
// Limits: N a multiple of 4 up to 128, Q up to 256 with S % Q == 0, any
// P (64 columns a block, the last slice masked; 16-byte x loads when P is
// a multiple of 4 and x is 16-byte aligned), any Q row count (the last
// tile is zero-padded).  exp2f for the scalings, ex2.approx for the decay
// (2 ulp; both far inside REL_TOL), no fast-math flag.
//
// Not here: a backward kernel (the backward recomputes the plain math,
// as the reference's custom_vjp does), and wgmma (it takes TF32 only
// K-major, and M x reads x along its rows).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // rows of a query or key tile
constexpr int kBP = 64;          // columns of P per block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQMax = 256;       // longest chunk
constexpr int kNMax = 128;       // widest state
// row strides (32-bit words) of the shared tiles, each chosen so that the
// fragment loads that read it hit 32 banks (see each tile)
constexpr int kLDC = kBQ + 8;    // 72: C tiles of C B^T (pairs read)
constexpr int kLDW = kNMax + 4;  // 132: B slabs (rows 2t, 2t+1 read)
// tiles stored split and interleaved, (hi, lo) a word pair an element
constexpr int kLDX2 = 2 * kBP + 4;   // 132 words: x tiles [key][p]
constexpr int kLDS2 = 2 * kBQ + 16;  // 144 words: state tiles [p][n]
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// products: mma.sync m16n8k8, TF32 operands, fp32 accumulators, 3xTF32

// x rounded to TF32, to nearest with ties away from zero: the result of
// cvt.rna.tf32.f32, by two integer operations (the conversion instruction
// runs at a fraction of their rate, and the kernels split every operand)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: hi keeps x's top 11 significant bits, lo the
// next 11 of the remainder (x - hi is exact)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// One k-step of 8 for a warp: acc[m][nt] += A_m (16 x 8) B (8 x 8 NT).  A_m
// comes as its fragment values a[m] (rows g, g+8 by the step's columns for
// t and t+4, in mma's order a0..a3) and is split here.  B comes split from
// shared memory, hi and lo interleaved: element B(k, n) at o = k BR + n BC
// has its halves at words 2o and 2o + 1; the fragment's rows t and t+4 are
// the step's rows k0 and k1, one 8-byte load each (kMode 1) or, with
// k1 = k0 + 1 and BR = 1, both in one 16-byte load (kMode 2).  Every n-tile
// is multiplied (columns past P hold zeros): a branch around an mma makes
// the compiler fence it with a warp synchronisation.
template <int MT, int NT, int BR, int BC, int kMode>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4],
                                         const float (&a)[MT][4],
                                         const uint32_t* B, int k0, int k1) {
  const int g = (threadIdx.x & 31) >> 2;
  uint32_t ah[MT][4], al[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) split(a[m][e], ah[m][e], al[m][e]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int o0 = k0 * BR + (8 * nt + g) * BC;
    const int o1 = k1 * BR + (8 * nt + g) * BC;
    uint32_t bh0, bh1, bl0, bl1;
    if (kMode == 2) {                // k1 = k0 + 1: both rows in 16 bytes
      const uint4 v = *reinterpret_cast<const uint4*>(B + 2 * o0);
      bh0 = v.x, bl0 = v.y, bh1 = v.z, bl1 = v.w;
    } else {
      const uint2 v0 = *reinterpret_cast<const uint2*>(B + 2 * o0);
      const uint2 v1 = *reinterpret_cast<const uint2*>(B + 2 * o1);
      bh0 = v0.x, bl0 = v0.y, bh1 = v1.x, bl1 = v1.y;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
      mma3(acc[m][nt], ah[m], al[m], bh0, bh1, bl0, bl1);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;
}

// 2^x, approximate (ex2.approx.ftz: about 2 ulp; under 2^-126 it is 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// ---------------------------------------------------------------------------
// loads

// cum2[r] = (a[s0] + ... + a[s0 + r]) log2(e) for r < Q, by the calling
// warp: lane l sums rows 8l .. 8l+7, then the lanes' totals are scanned
// with shuffles.  Returns the chunk's total (natural units) to every lane.
__device__ __forceinline__ float chunk_cumsum(float* cum2, const float* ab,
                                              int64_t as_s, int s0, int Q) {
  const int lane = threadIdx.x & 31;
  constexpr int kPer = kQMax / 32;
  float v[kPer];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int r = lane * kPer + k;
    run += r < Q ? ab[(int64_t)(s0 + r) * as_s] : 0.f;
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  const float base = incl - run;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int r = lane * kPer + k;
    if (r < Q) cum2[r] = (base + v[k]) * kLog2e;
  }
  return __shfl_sync(0xffffffffu, base + v[kPer - 1], (Q - 1) / kPer);
}

// A 64 x 64 fp32 tile into registers: element (r, q) at src[r ld + q],
// zero at or past `rows` rows or `cols` columns; thread f of kT holds, with
// kVec, the float4s f + kT u (row f / 16, columns 4 (f % 16); ld, cols
// and src then multiples of 4 floats), else the scalars f + kT u (row
// f / 64, column f % 64)
template <bool kVec, int kT>
__device__ __forceinline__ void load_tile64(float (&v)[4096 / kT],
                                            const float* src, int64_t ld,
                                            int rows, int cols) {
#pragma unroll
  for (int u = 0; u < (kVec ? 1024 : 4096) / kT; ++u) {
    const int f = threadIdx.x + kT * u;
    if (kVec) {
      const int r = f >> 4, q = 4 * (f & 15);
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && q < cols)
        w = *reinterpret_cast<const float4*>(src + r * ld + q);
      v[4 * u] = w.x;
      v[4 * u + 1] = w.y;
      v[4 * u + 2] = w.z;
      v[4 * u + 3] = w.w;
    } else {
      const int r = f >> 6, q = f & 63;
      v[u] = (r < rows && q < cols) ? src[r * ld + q] : 0.f;
    }
  }
}

// the registers of load_tile64, split, into an interleaved tile of row
// stride kStride words: (hi, lo) of element (r, q) at words r kStride + 2q
template <bool kVec, int kT, int kStride>
__device__ __forceinline__ void store_tile64(const float (&v)[4096 / kT],
                                             uint32_t* dst) {
#pragma unroll
  for (int u = 0; u < (kVec ? 1024 : 4096) / kT; ++u) {
    const int f = threadIdx.x + kT * u;
    if (kVec) {
      const int r = f >> 4, q = 4 * (f & 15);
      uint4 v0, v1;
      split(v[4 * u], v0.x, v0.y);
      split(v[4 * u + 1], v0.z, v0.w);
      split(v[4 * u + 2], v1.x, v1.y);
      split(v[4 * u + 3], v1.z, v1.w);
      uint4* d = reinterpret_cast<uint4*>(dst + r * kStride + 2 * q);
      d[0] = v0;
      d[1] = v1;
    } else {
      uint2 w;
      split(v[u], w.x, w.y);
      *reinterpret_cast<uint2*>(dst + (f >> 6) * kStride + 2 * (f & 63)) = w;
    }
  }
}

// a 16-byte cp.async (through L2, not L1); with full false it writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// ---------------------------------------------------------------------------
// 1. per chunk: C B^T of the causal tile pairs (shared by the heads) and,
// for every chunk but the last, each head's increment
// inc = x^T (B o exp(total - cum)) and total.  One launch, a 1-D grid: the
// C B^T blocks first, (pair, chunk, b); then the increment blocks,
// (P slice, chunk, h, b)

struct CbSmem {
  float c[kBQ * kLDC];           // query rows of C, 64 columns of N
  uint32_t b[kBQ * kLDS2];       // key rows of B, 64 columns of N, split
};

struct IncSmem {
  float b[kBQ * kLDW];           // key rows of B, every column of N
  uint32_t x[kBQ * kLDX2];       // key rows of x, 64 columns of P, split
  float cum2[kQMax];
  float w[kQMax];                // exp(total - cum), 0 past Q
};

union ChunkSmem {
  CbSmem cb;
  IncSmem inc;
};

// C B^T, undecayed, of the causal tile pair (it, jt) of chunk c: rows i of
// C against rows j of B, a warp's 16 rows of i by all 64 of j
__device__ __forceinline__ void cb_tile(CbSmem& sm, const float* Bm,
                                        const float* Cm, float* cb, int b,
                                        int c, int nc, int it, int jt, int S,
                                        int N, int Q, int Qp) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = c * Q, i0 = it * kBQ, j0 = jt * kBQ;
  const float* Cb = Cm + ((int64_t)b * S + s0) * N;
  const float* Bb = Bm + ((int64_t)b * S + s0) * N;
  float acc[1][8][4];
  zero(acc);
  for (int n0 = 0; n0 < N; n0 += kBQ) {
    float cr[4096 / kThreads], br[4096 / kThreads];
    load_tile64<true, kThreads>(cr, Cb + (int64_t)i0 * N + n0, N, Q - i0,
                                N - n0);
    load_tile64<true, kThreads>(br, Bb + (int64_t)j0 * N + n0, N, Q - j0,
                                N - n0);
    __syncthreads();                 // the last slab is read
#pragma unroll
    for (int u = 0; u < 1024 / kThreads; ++u) {
      const int f = tid + kThreads * u;
      *reinterpret_cast<float4*>(&sm.c[(f >> 4) * kLDC + 4 * (f & 15)]) =
          make_float4(cr[4 * u], cr[4 * u + 1], cr[4 * u + 2], cr[4 * u + 3]);
    }
    store_tile64<true, kThreads, kLDS2>(br, sm.b);
    __syncthreads();
    const int ks_n = (min(kBQ, N - n0) + 7) / 8;
    for (int ks = 0; ks < ks_n; ++ks) {
      // A(i, n) = C[i][n], columns 2t and 2t + 1 of the step: 8-byte
      // loads, banks 8g + 2t in each half-warp
      const float* ca = sm.c + (16 * warp + g) * kLDC + 8 * ks + 2 * t;
      const float2 v0 = *reinterpret_cast<const float2*>(ca);
      const float2 v1 = *reinterpret_cast<const float2*>(ca + 8 * kLDC);
      const float a[1][4] = {{v0.x, v1.x, v0.y, v1.y}};
      // B(n, j) = B[j][n], rows 2t, 2t + 1 of the step, interleaved and
      // adjacent: one 16-byte load
      mma_step<1, 8, 1, kLDS2 / 2, 2>(acc, a, sm.b + 16 * ks, 2 * t,
                                      2 * t + 1);
    }
  }
  float* out = cb + ((int64_t)(b * nc + c) * Qp + i0 + 16 * warp + g) * Qp + j0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(out + col) =
        make_float2(acc[0][nt][0], acc[0][nt][1]);
    *reinterpret_cast<float2*>(out + 8 * Qp + col) =
        make_float2(acc[0][nt][2], acc[0][nt][3]);
  }
}

// the increment of chunk c of (b, h), transposed: inc^T (n, p) =
// sum_j (B o w)[j][n] x[j][p]; a warp's 32 rows of n by 64 columns of p
template <bool kVec>
__device__ __forceinline__ void inc_tile(IncSmem& sm, const float* x,
                                         const float* a, const float* Bm,
                                         float* states, float* totals, int b,
                                         int h, int c, int ps, int S, int H,
                                         int P, int N, int Q, int64_t xs_b,
                                         int64_t xs_h, int64_t xs_s,
                                         int64_t as_b, int64_t as_h,
                                         int64_t as_s) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nc = S / Q, s0 = c * Q, p0 = ps * kBP;
  const float* xb = x + b * xs_b + h * xs_h;
  const float* Bb = Bm + ((int64_t)b * S + s0) * N;
  float total = 0.f;
  if (warp == 0)
    total = chunk_cumsum(sm.cum2, a + b * as_b + h * as_h, as_s, s0, Q);
  __syncthreads();
  const float total2 = sm.cum2[Q - 1];
  for (int r = tid; r < kBQ * ((Q + kBQ - 1) / kBQ); r += kThreads)
    sm.w[r] = r < Q ? exp2f(total2 - sm.cum2[r]) : 0.f;
  float acc[2][8][4];
  zero(acc);
  const bool active = 32 * warp < N;
  for (int j0 = 0; j0 < Q; j0 += kBQ) {
    float xr[4096 / kThreads];
    load_tile64<kVec, kThreads>(xr, xb + (int64_t)(s0 + j0) * xs_s + p0, xs_s,
                                Q - j0, P - p0);
    __syncthreads();                 // the last slab is read; w is written
    // B rows, zero past Q and past N, while x is split and stored
    for (int f = tid; f < kBQ * (kNMax / 4); f += kThreads) {
      const int r = f >> 5, q = 4 * (f & 31);
      const bool full = j0 + r < Q && q < N;
      cp_async16(&sm.b[r * kLDW + q],
                 full ? Bb + (int64_t)(j0 + r) * N + q : Bb, full);
    }
    store_tile64<kVec, kThreads, kLDX2>(xr, sm.x);
    cp_async_wait_all();
    __syncthreads();
    if (active) {
      const int ks_n = (min(kBQ, Q - j0) + 7) / 8;
      for (int ks = 0; ks < ks_n; ++ks) {
        // keys 8ks + 2t and + 1 stand for the fragment's columns t, t + 4
        // A(n, j) = B[j][n] w_j: banks 8t + g (2 x 132 = 8 mod 32)
        const float* br = sm.b + (8 * ks + 2 * t) * kLDW + 32 * warp + g;
        const float2 w = *reinterpret_cast<const float2*>(
            &sm.w[j0 + 8 * ks + 2 * t]);
        float av[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          av[m][0] = br[16 * m] * w.x;
          av[m][1] = br[16 * m + 8] * w.x;
          av[m][2] = br[kLDW + 16 * m] * w.y;
          av[m][3] = br[kLDW + 16 * m + 8] * w.y;
        }
        // B(j, p) = x[j][p], interleaved: 8-byte loads, banks 8t + 2g
        mma_step<2, 8, kLDX2 / 2, 1, 1>(acc, av, sm.x,
                                        8 * ks + 2 * t, 8 * ks + 2 * t + 1);
      }
    }
  }
  float* out = states + ((int64_t)(b * H + h) * nc + c) * P * N;
  if (active) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int n = 32 * warp + 16 * m + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = p0 + 8 * nt + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ne = n + 8 * (e >> 1), pe = p + (e & 1);
          if (ne < N && pe < P) out[(int64_t)pe * N + ne] = acc[m][nt][e];
        }
      }
    }
  }
  if (ps == 0 && tid == 0) totals[(b * H + h) * nc + c] = total;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ cb, float* __restrict__ states,
                 float* __restrict__ totals, int B, int S, int H, int P,
                 int N, int Q, int Qp, int nps, int64_t xs_b, int64_t xs_h,
                 int64_t xs_s, int64_t as_b, int64_t as_h, int64_t as_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int nc = S / Q, n_qt = Qp / kBQ;
  const int pairs = n_qt * (n_qt + 1) / 2;
  int bid = blockIdx.x;
  if (bid < pairs * nc * B) {
    int pair = bid % pairs, it = 0;
    while (pair > it) pair -= ++it;
    cb_tile(sm.cb, Bm, Cm, cb, bid / (pairs * nc), (bid / pairs) % nc, nc, it,
            pair, S, N, Q, Qp);
    return;
  }
  bid -= pairs * nc * B;
  const int ps = bid % nps;
  bid /= nps;
  const int c = bid % (nc - 1);
  bid /= nc - 1;
  inc_tile<kVec>(sm.inc, x, a, Bm, states, totals, bid / H, bid % H, c, ps,
                 S, H, P, N, Q, xs_b, xs_h, xs_s, as_b, as_h, as_s);
}

// ---------------------------------------------------------------------------
// 2. the pass over the chunks, in place: slot c of `states` holds chunk c's
// increment and leaves holding the state entering chunk c (slot 0 zero);
// grid (float4s of a (P, N) state / threads, H, B).  The increments of 8
// chunks are loaded before any is overwritten.

__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ totals,
                int H, int PN, int nc) {
  constexpr int kGroup = 8;
  const int64_t e = 4 * ((int64_t)blockIdx.x * kThreads + threadIdx.x);
  if (e >= PN) return;
  const int bh = blockIdx.z * H + blockIdx.y;
  float* slot = states + (int64_t)bh * nc * PN + e;
  const float* tot = totals + (int64_t)bh * nc;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kGroup) {
    float4 inc[kGroup];
    float et[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int c = c0 + u;
      inc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      et[u] = 0.f;
      if (c < nc - 1) {
        inc[u] = *reinterpret_cast<const float4*>(slot + (int64_t)c * PN);
        et[u] = expf(tot[c]);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int c = c0 + u;
      if (c < nc) *reinterpret_cast<float4*>(slot + (int64_t)c * PN) = st;
      st.x = fmaf(et[u], st.x, inc[u].x);
      st.y = fmaf(et[u], st.y, inc[u].y);
      st.z = fmaf(et[u], st.z, inc[u].z);
      st.w = fmaf(et[u], st.w, inc[u].w);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the output of two 64-row query tiles of a chunk, 64 columns of P:
// y = (C B^T o decay) x + exp(cum) C state_c^T; grid (chunks x P slices, H,
// query-tile pairs x B), the pairs with the most key tiles first.  Each
// of the 8 warps owns 16 rows; each key tile of x and each slab of the
// state is split and stored once for the 128 rows.  The next key tile of
// x is loaded into registers while the current one is multiplied; a
// tile's C B^T values come into registers before its x tile is stored.
//
// Within each k-step of 8 the fragment's columns t and t+4 stand for keys
// (or state columns) 2t and 2t+1, in A and B alike (the sum runs over all
// 8 either way): a thread's two A values of a row are then neighbours, one
// 8-byte load.

constexpr int kOutWarps = 8;
constexpr int kOutThreads = 32 * kOutWarps;
constexpr int kOutRows = 16 * kOutWarps;     // 128 query rows a block

struct OutSmem {
  union {
    uint32_t x[kBQ * kLDX2];     // key rows of x, 64 columns of P, split
    uint32_t st[kBP * kLDS2];    // state rows p, 64 columns of N, split
  };
  float cum2[kQMax];
};

template <bool kVec>
__global__ void __launch_bounds__(kOutThreads, 2)
ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ Cm, const float* __restrict__ cb,
               const float* __restrict__ states, float* __restrict__ y,
               int S, int H, int P, int N, int Q, int Qp, int nps, int nb,
               int64_t xs_b, int64_t xs_h, int64_t xs_s, int64_t as_b,
               int64_t as_h, int64_t as_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ps = blockIdx.x % nps, c = blockIdx.x / nps, h = blockIdx.y;
  const int n_pairs = gridDim.z / nb;
  const int pr = n_pairs - 1 - (int)blockIdx.z / nb, b = blockIdx.z % nb;
  const int nc = S / Q, s0 = c * Q, i0 = pr * kOutRows, p0 = ps * kBP;
  const float* xb = x + b * xs_b + h * xs_h + (int64_t)s0 * xs_s + p0;
  const int r0 = i0 + 16 * warp;             // the warp's first row
  const int i = r0 + g;                      // the thread's rows i and i + 8
  const bool active = r0 < Q;
  // key tiles up to the block's last row
  const int n_kt = (min(Q, i0 + kOutRows) + kBQ - 1) / kBQ;

  if (warp == 0) chunk_cumsum(sm.cum2, a + b * as_b + h * as_h, as_s, s0, Q);
  float xr[4096 / kOutThreads];
  load_tile64<kVec, kOutThreads>(xr, xb, xs_s, Q, P - p0);
  __syncthreads();
  const float ci0 = i < Q ? sm.cum2[i] : 0.f;
  const float ci1 = i + 8 < Q ? sm.cum2[i + 8] : 0.f;

  float acc[1][8][4];
  zero(acc);
  // this warp's rows of the chunk's C B^T, keys from 2t
  const float* cbr = cb + ((int64_t)(b * nc + c) * Qp + i) * Qp + 2 * t;
  for (int jt = 0; jt < n_kt; ++jt) {
    const int j0 = jt * kBQ;
    // k-steps of this warp: keys up to its last row, and below Q
    const int ks_n = active ? max(0, min((min(kBQ, Q - j0) + 7) / 8,
                                         (r0 + 16 - j0) / 8))
                            : 0;
    // the A values of this tile: rows i, i + 8, keys j0 + 8ks + 2t, + 1
    float2 cv[8][2];
    if (ks_n > 0) {
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        cv[ks][0] = *reinterpret_cast<const float2*>(cbr + j0 + 8 * ks);
        cv[ks][1] =
            *reinterpret_cast<const float2*>(cbr + 8 * Qp + j0 + 8 * ks);
      }
    }
    if (jt > 0) __syncthreads();     // the last tile is read
    store_tile64<kVec, kOutThreads, kLDX2>(xr, sm.x);
    if (jt + 1 < n_kt)
      load_tile64<kVec, kOutThreads>(xr, xb + (int64_t)(j0 + kBQ) * xs_s,
                                     xs_s, Q - j0 - kBQ, P - p0);
    __syncthreads();
    auto step = [&](int ks) {
      const int j = j0 + 8 * ks + 2 * t;
      const float2 cj = *reinterpret_cast<const float2*>(&sm.cum2[j]);
      // M = C B^T o exp(cum_i - cum_j), masked before the exp
      const bool row0 = i < Q, row1 = i + 8 < Q;
      float av[1][4];
      av[0][0] = row0 && j <= i ? cv[ks][0].x * exp2_fast(ci0 - cj.x) : 0.f;
      av[0][2] = row0 && j < i ? cv[ks][0].y * exp2_fast(ci0 - cj.y) : 0.f;
      av[0][1] = row1 && j <= i + 8 ? cv[ks][1].x * exp2_fast(ci1 - cj.x) : 0.f;
      av[0][3] = row1 && j < i + 8 ? cv[ks][1].y * exp2_fast(ci1 - cj.y) : 0.f;
      // B(j, p) = x[j][p], rows 2t and 2t + 1 of the step,
      // interleaved: 8-byte loads, banks 8t + 2g
      mma_step<1, 8, kLDX2 / 2, 1, 1>(acc, av, sm.x + 8 * ks * kLDX2, 2 * t,
                                      2 * t + 1);
    };
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      if (ks < ks_n) step(ks);
  }

  if (c > 0) {                       // the state entering chunk 0 is zero
    const float* st = states + ((int64_t)(b * H + h) * nc + c) * P * N +
                      (int64_t)p0 * N;
    const float* cr = Cm + ((int64_t)b * S + s0 + i) * N + 2 * t;
    const float e0 = i < Q ? exp2f(ci0) : 0.f;
    const float e1 = i + 8 < Q ? exp2f(ci1) : 0.f;
    for (int n0 = 0; n0 < N; n0 += kBQ) {
      const int ks_n = (min(kBQ, N - n0) + 7) / 8;
      // the A values of this slab: C rows i, i + 8, columns n0 + 8ks + 2t
      float2 cv[8][2];
      if (active) {
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int n = n0 + 8 * ks;
          cv[ks][0] = cv[ks][1] = make_float2(0.f, 0.f);
          if (ks < ks_n && n + 2 * t < N) {
            if (i < Q) cv[ks][0] = *reinterpret_cast<const float2*>(cr + n);
            if (i + 8 < Q)
              cv[ks][1] = *reinterpret_cast<const float2*>(cr + 8 * N + n);
          }
        }
      }
      __syncthreads();               // the last tile or slab is read
      for (int f = tid; f < kBP * (kBQ / 4); f += kOutThreads) {
        const int r = f >> 4, q = 4 * (f & 15);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p0 + r < P && n0 + q < N)
          v = *reinterpret_cast<const float4*>(st + (int64_t)r * N + n0 + q);
        uint4 v0, v1;
        split(v.x, v0.x, v0.y);
        split(v.y, v0.z, v0.w);
        split(v.z, v1.x, v1.y);
        split(v.w, v1.z, v1.w);
        uint4* d = reinterpret_cast<uint4*>(&sm.st[r * kLDS2 + 2 * q]);
        d[0] = v0;
        d[1] = v1;
      }
      __syncthreads();
      if (active) {
        auto step = [&](int ks) {
          // A(i, n) = exp(cum_i) C[i][n], columns 2t and 2t + 1 of the step
          const float av[1][4] = {{e0 * cv[ks][0].x, e1 * cv[ks][1].x,
                                   e0 * cv[ks][0].y, e1 * cv[ks][1].y}};
          // B(n, p) = state[p][n], rows 2t, 2t + 1 of the step,
          // interleaved and adjacent: one 16-byte load, banks 16g + 4t
          // (+ 0..3) in each quarter-warp
          mma_step<1, 8, 1, kLDS2 / 2, 2>(acc, av, sm.st + 16 * ks,
                                          2 * t, 2 * t + 1);
        };
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          if (ks < ks_n) step(ks);
      }
    }
  }

  if (active) {
    float* yb = y + b * xs_b + h * xs_h + (int64_t)s0 * xs_s;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int p = p0 + 8 * nt + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ih = i + 8 * half;
        if (ih < Q) {
          float* yr = yb + (int64_t)ih * xs_s + p;
          if (kVec && p + 1 < P) {
            *reinterpret_cast<float2*>(yr) =
                make_float2(acc[0][nt][2 * half], acc[0][nt][2 * half + 1]);
          } else {
            if (p < P) yr[0] = acc[0][nt][2 * half];
            if (p + 1 < P) yr[1] = acc[0][nt][2 * half + 1];
          }
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0;
}

}  // namespace


extern "C" {

// x, y: (B, H, S, P) for layout 0, (B, S, H, P) for layout 1; a: (B, H, S)
// or (B, S, H); Bm, Cm: (B, S, N) 16-byte aligned; all fp32, contiguous.
// Q the chunk: S % Q == 0, Q <= 256; N a multiple of 4 up to 128.
// Scratch (see the header): cb, states (16-byte aligned) and totals.
// Launches ssd_chunk_kernel, then, with more than one chunk,
// ssd_pass_kernel, then ssd_out_kernel, in order on `stream`.
int ssd_scan_fwd(const void* x, const void* a, const void* Bm, const void* Cm,
                 void* y, void* cb, void* states, void* totals, int B, int S,
                 int H, int P, int N, int Q, int layout, void* stream) {
  const int n_qt = (Q + kBQ - 1) / kBQ, nps = (P + kBP - 1) / kBP;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      Q > kQMax || S % Q || N > kNMax || N % 4 || H > 65535 ||
      (int64_t)B * n_qt > 65535 || (int64_t)P * N > (1 << 30) ||
      (layout != 0 && layout != 1) || !aligned16(Bm) || !aligned16(Cm) ||
      !aligned16(cb) || !aligned16(states)) {
    return cudaErrorInvalidValue;
  }
  const int nc = S / Q, Qp = n_qt * kBQ;
  const int64_t xs_b = (int64_t)H * S * P;
  const int64_t xs_h = layout == 0 ? (int64_t)S * P : P;
  const int64_t xs_s = layout == 0 ? P : (int64_t)H * P;
  const int64_t as_b = (int64_t)H * S;
  const int64_t as_h = layout == 0 ? S : 1;
  const int64_t as_s = layout == 0 ? 1 : H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  float* cbf = static_cast<float*>(cb);
  float* sf = static_cast<float*>(states);
  float* tf = static_cast<float*>(totals);
  cudaError_t err;
  const bool vec = P % 4 == 0 && aligned16(x);
  const int pairs = n_qt * (n_qt + 1) / 2;
  const int64_t blocks = (int64_t)pairs * nc * B +
                         (int64_t)(nc - 1) * nps * H * B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto chunk = vec ? ssd_chunk_kernel<true> : ssd_chunk_kernel<false>;
  auto out = vec ? ssd_out_kernel<true> : ssd_out_kernel<false>;
  if ((err = cudaFuncSetAttribute(chunk,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sizeof(ChunkSmem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(out,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sizeof(OutSmem))) != cudaSuccess) {
    return err;
  }
  chunk<<<(unsigned)blocks, kThreads, sizeof(ChunkSmem), st>>>(
      xf, af, Bf, Cf, cbf, sf, tf, B, S, H, P, N, Q, Qp, nps, xs_b, xs_h,
      xs_s, as_b, as_h, as_s);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nc > 1) {
    const int pn = P * N;
    ssd_pass_kernel<<<dim3((pn / 4 + kThreads - 1) / kThreads, H, B),
                      kThreads, 0, st>>>(sf, tf, H, pn, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int n_pairs = (Q + kOutRows - 1) / kOutRows;
  out<<<dim3(nc * nps, H, B * n_pairs), kOutThreads, sizeof(OutSmem), st>>>(
      xf, af, Cf, cbf, sf, static_cast<float*>(y), S, H, P, N, Q, Qp, nps, B,
      xs_b, xs_h, xs_s, as_b, as_h, as_s);
  return cudaGetLastError();
}

// compiled tiles: 0 -> rows per query / key tile, 1 -> columns of P per
// block, 2 -> threads per output block (the chunk kernel's have half),
// 3 -> longest chunk, 4 -> widest state
int ssd_tile(int which) {
  switch (which) {
    case 0: return kBQ;
    case 1: return kBP;
    case 2: return kOutThreads;
    case 3: return kQMax;
    case 4: return kNMax;
    default: return -1;
  }
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
