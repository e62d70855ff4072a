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
//   Bound: operations.  At the main path's shape (B 2, H 64, S 2048,
//   P 64, N 128, Q 256) the reference's model counts 34.4 GFLOP against
//   139 MB moved — about 250 FLOPs per byte in fp32, whose peak (67
//   TFLOP/s, no tensor cores: no TF32, for the fp32 parity the model's
//   casts ask for) is reached at 20 FLOPs per byte.
//
// Layout.  x and y are (B, H, S, P) (layout 0, the reference's kernel
// layout) or (B, S, H, P) (layout 1, the model's: no transposes around
// the call); a likewise (B, H, S) or (B, S, H); B and C are (B, S, N),
// shared by every head (one group), so 64 heads read them from L2 rather
// than 64 times from device memory.  Everything is fp32 and contiguous.
//
// Grid.  One block of 8 warps per (32 columns of P, h, b): 2 x 64 x 2 =
// 256 blocks at the main shape, two to an SM.  Column p of y and row p of
// the state depend only on column p of x, so splitting P across blocks
// costs only a recomputation of C B^T per 32-column slice, and gives
// twice the blocks of one per (b, h) (128 < 132 SMs).  A block walks its
// chunks in order (blocks run in no order, so the state cannot cross
// blocks) with its (32, N) slice of the state in shared memory.  The
// chunk does not fit shared memory (a Q x Q fp32 score tile at Q 256 is
// 256 KiB), so a chunk is cut into 64-row tiles: for each query tile i,
// for each key tile j <= i (the causal half only), the 64 x 64 tile of
// C B^T is computed from shared-memory C and B tiles (4 x 4 outputs per
// thread, float4 loads along N), masked and decayed into M in shared
// memory, and M x is accumulated in registers (8 rows x 1 column per
// thread); then the query tile adds exp(cum) C state^T and writes y.  The
// last query tile visits every key tile of the chunk, and there the
// state's increment x^T (B o w) is accumulated in registers (4 x 4 per
// thread); it is applied after every query tile has read the old state.
// The chunk's cumsum is one warp's scan (8 rows per lane, then shuffles).
// Shared memory: C, B (64 x 132), state (32 x 132), M (64 x 80), x
// (64 x 32), cum and exp(total - cum) (256 each) — 115,200 bytes.
//
// Limits: N a multiple of 4 up to 128, Q up to 256 with S % Q == 0, any
// P (a ragged last slice is masked), any Q row count (the last tile is
// zero-padded).  Plain FMAs and expf throughout (no fast math).
//
// Not here: tensor cores (TF32 or bf16 would break the fp32 parity),
// sharing C B^T across heads (it does not depend on h), and a backward
// kernel (the backward recomputes the plain math, as the reference's
// custom_vjp does).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // rows of a query or key tile
constexpr int kTP = 32;          // columns of x, y and the state per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQMax = 256;       // longest chunk
constexpr int kNMax = 128;       // widest state
constexpr int kLD = kNMax + 4;   // row stride (floats) of C, B and the state
constexpr int kLDM = kBQ + 16;   // row stride of M: conflict-free stores
constexpr int kLDX = kTP;        // row stride of the x tile

struct Smem {
  float C[kBQ * kLD];            // query tile of C, rows past Q zero
  float B[kBQ * kLD];            // key tile of B, rows past Q zero
  float st[kTP * kLD];           // the block's (32, N) state slice
  float M[kBQ * kLDM];           // masked, decayed C B^T of a tile pair
  float x[kBQ * kLDX];           // key tile of x, 32 columns
  float cum[kQMax];              // cumsum of a over the chunk
  float w[kQMax];                // exp(total - cum)
};

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [row0, row0 + kBQ) of a (S, N) matrix into a (kBQ, kLD) tile;
// rows at or past `rows` are zero
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int N) {
  const int n4 = N >> 2;
  for (int f = threadIdx.x; f < kBQ * n4; f += kThreads) {
    const int r = f / n4, q = f - r * n4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      v = *reinterpret_cast<const float4*>(src + (int64_t)(row0 + r) * N +
                                           4 * q);
    *reinterpret_cast<float4*>(dst + r * kLD + 4 * q) = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               float* __restrict__ y, int S, int P, int N, int Q,
               int64_t xs_b, int64_t xs_h, int64_t xs_s, int64_t as_b,
               int64_t as_h, int64_t as_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * kTP, h = blockIdx.y, b = blockIdx.z;
  const float* xb = x + b * xs_b + h * xs_h;
  float* yb = y + b * xs_b + h * xs_h;
  const float* ab = a + b * as_b + h * as_h;
  const float* Bb = Bm + (int64_t)b * S * N;
  const float* Cb = Cm + (int64_t)b * S * N;
  const int nc = S / Q, n_tiles = (Q + kBQ - 1) / kBQ;
  const int n4 = N >> 2;
  const int ty = tid >> 4, tx = tid & 15;   // C B^T: rows ty + 16r, cols tx + 16q
  const int p = p0 + lane;                  // M x, inter: rows warp + 8r

  for (int i = tid; i < kTP * kLD; i += kThreads) sm.st[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();                 // the last chunk is done with cum and st
    if (warp == 0) {                 // cumsum: lane l holds rows 8l .. 8l+7
      float v[kQMax / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < kQMax / 32; ++k) {
        const int r = lane * (kQMax / 32) + k;
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
      for (int k = 0; k < kQMax / 32; ++k) {
        const int r = lane * (kQMax / 32) + k;
        if (r < Q) sm.cum[r] = base + v[k];
      }
    }
    __syncthreads();
    const float total = sm.cum[Q - 1];
    for (int r = tid; r < Q; r += kThreads) sm.w[r] = expf(total - sm.cum[r]);

    float ds[4][4];                  // state increment: p 4*warp + k, n 4*lane + m
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int m = 0; m < 4; ++m) ds[k][m] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kBQ;
      const bool last = it == n_tiles - 1;
      __syncthreads();               // the last tile is done with C
      load_rows(sm.C, Cb, s0 + i0, Q - i0, N);
      float acc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kBQ;
        __syncthreads();             // the last pair is done with B, x and M
        load_rows(sm.B, Bb, s0 + j0, Q - j0, N);
        for (int f = tid; f < kBQ * kTP; f += kThreads) {
          const int r = f >> 5, col = f & 31;
          sm.x[r * kLDX + col] =
              (r < Q - j0 && p0 + col < P)
                  ? xb[(int64_t)(s0 + j0 + r) * xs_s + p0 + col]
                  : 0.f;
        }
        __syncthreads();

        // C B^T for the pair, then masked (before the exp) and decayed
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) sc[r][q] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(
                &sm.C[(ty + 16 * r) * kLD + n]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bv[q] = *reinterpret_cast<const float4*>(
                &sm.B[(tx + 16 * q) * kLD + n]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) sc[r][q] = dot4(cv[r], bv[q], sc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * q;
            float m = 0.f;
            if (j <= i && i < Q) m = sc[r][q] * expf(sm.cum[i] - sm.cum[j]);
            sm.M[(ty + 16 * r) * kLDM + tx + 16 * q] = m;
          }

        // the last query tile sees every key tile: the state increment
        if (last && lane < n4) {
          const int jn = min(kBQ, Q - j0);
          for (int j = 0; j < jn; ++j) {
            const float wj = sm.w[j0 + j];
            const float4 xv =
                *reinterpret_cast<const float4*>(&sm.x[j * kLDX + 4 * warp]);
            float4 bw =
                *reinterpret_cast<const float4*>(&sm.B[j * kLD + 4 * lane]);
            bw.x *= wj;
            bw.y *= wj;
            bw.z *= wj;
            bw.w *= wj;
            const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              ds[k][0] = fmaf(xk[k], bw.x, ds[k][0]);
              ds[k][1] = fmaf(xk[k], bw.y, ds[k][1]);
              ds[k][2] = fmaf(xk[k], bw.z, ds[k][2]);
              ds[k][3] = fmaf(xk[k], bw.w, ds[k][3]);
            }
          }
        }
        __syncthreads();             // M is complete

        // y += M x for rows warp + 8r, column p
        for (int j = 0; j < kBQ; j += 4) {
          const float4 xv = make_float4(
              sm.x[j * kLDX + lane], sm.x[(j + 1) * kLDX + lane],
              sm.x[(j + 2) * kLDX + lane], sm.x[(j + 3) * kLDX + lane]);
#pragma unroll
          for (int r = 0; r < 8; ++r)
            acc[r] = dot4(*reinterpret_cast<const float4*>(
                              &sm.M[(warp + 8 * r) * kLDM + j]),
                          xv, acc[r]);
        }
      }

      // y += exp(cum_i) (C_i . state_p), with the state before this chunk
      float in[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) in[r] = 0.f;
      for (int n = 0; n < N; n += 4) {
        const float4 sv =
            *reinterpret_cast<const float4*>(&sm.st[lane * kLD + n]);
#pragma unroll
        for (int r = 0; r < 8; ++r)
          in[r] = dot4(*reinterpret_cast<const float4*>(
                           &sm.C[(warp + 8 * r) * kLD + n]),
                       sv, in[r]);
      }
      if (p < P) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + warp + 8 * r;
          if (i < Q)
            yb[(int64_t)(s0 + i) * xs_s + p] =
                fmaf(expf(sm.cum[i]), in[r], acc[r]);
        }
      }
    }

    __syncthreads();                 // every tile has read the old state
    if (lane < n4) {
      const float et = expf(total);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float4* sp = reinterpret_cast<float4*>(
            &sm.st[(4 * warp + k) * kLD + 4 * lane]);
        float4 s = *sp;
        s.x = fmaf(et, s.x, ds[k][0]);
        s.y = fmaf(et, s.y, ds[k][1]);
        s.z = fmaf(et, s.z, ds[k][2]);
        s.w = fmaf(et, s.w, ds[k][3]);
        *sp = s;
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
int ssd_scan_fwd(const void* x, const void* a, const void* Bm, const void* Cm,
                 void* y, int B, int S, int H, int P, int N, int Q,
                 int layout, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      Q > kQMax || S % Q || N > kNMax || N % 4 || B > 65535 || H > 65535 ||
      (layout != 0 && layout != 1) || !aligned16(Bm) || !aligned16(Cm)) {
    return cudaErrorInvalidValue;
  }
  const int64_t hsp = (int64_t)H * S * P;
  const int64_t xs_h = layout == 0 ? (int64_t)S * P : P;
  const int64_t xs_s = layout == 0 ? P : (int64_t)H * P;
  const int64_t as_h = layout == 0 ? S : 1;
  const int64_t as_s = layout == 0 ? 1 : H;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_fwd_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kTP - 1) / kTP, H, B);
  ssd_fwd_kernel<<<grid, kThreads, sizeof(Smem),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(y), S, P, N, Q, hsp, xs_h, xs_s, (int64_t)H * S,
      as_h, as_s);
  return cudaGetLastError();
}

// compiled tiles: 0 -> rows per query / key tile, 1 -> columns of P per
// block, 2 -> threads per block, 3 -> longest chunk, 4 -> widest state
int ssd_tile(int which) {
  switch (which) {
    case 0: return kBQ;
    case 1: return kTP;
    case 2: return kThreads;
    case 3: return kQMax;
    case 4: return kNMax;
    default: return -1;
  }
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
