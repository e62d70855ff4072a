// Hopper (sm_90a) versions of the three ERT micro-kernels, with a plain C
// interface for ctypes (built by repro_torch/kernels/build.py).
//
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() right after the
// launch (or cudaErrorInvalidValue for an argument it does not take), so a
// refused launch is reported to the Python wrapper, which raises.
//
// ---------------------------------------------------------------------------
// triad — replaces repro/kernels/ert/bandwidth.py::triad (_triad_kernel,
//   _triad_kernel_db): o = a*s + b.
//   Bound: bytes (3*N*itemsize per pass, 2*N FLOPs; AI 1/6 in fp32).
//   Design: a grid-stride loop over 16-byte vectors (4 x f32 or 8 x bf16)
//   so each warp moves 512 contiguous bytes per load, and a scalar tail
//   loop, so any N runs in the kernel.  The TPU kernel pads the last block
//   instead; padding here would move bytes triad_bytes() does not count.
//   `reps` repeats the pass inside one launch: an L2-resident array is
//   streamed many times so the launch lasts long enough to time.  The
//   product and sum round separately (mul, then add) exactly as the plain
//   PyTorch version does; the kernel is memory-bound, so this costs nothing.
//
// fma_chain — replaces repro/kernels/ert/flops.py::fma_chain
//   (_fma_chain_kernel): ILP independent chains of n_iters dependent
//   acc = acc*a + b per element, then summed; (2*n_iters*ILP + ILP)*N FLOPs.
//   Bound: operations (fp32 CUDA cores; bf16 as packed __nv_bfloat162).
//   Design: ILP is a template parameter, so the chains live in registers
//   and hide the FMA latency; a and b are runtime arguments and the result
//   is stored, so the compiler can neither fold nor drop the chain (do not
//   build with --use_fast_math).  bf16 packs two elements per register and
//   issues __hfma2: twice the elements per instruction, as ERT's half2 rung.
//
// matmul (ert_gemm) — replaces repro/kernels/ert/gemm.py::matmul
//   (_matmul_kernel): C = A @ B with an fp32 accumulator, cast to out_dtype
//   at the store; 2*M*N*K FLOPs.
//   Bound: operations (tensor cores for bf16/fp16) at large sizes.
//   Design: the TPU kernel carries its accumulator in VMEM scratch across a
//   sequential K grid axis; Hopper blocks run in parallel with no order, so
//   each block owns one 128x128 output tile and loops over K itself, its
//   fp32 accumulators held in registers (wmma 16x16x16 fragments) while
//   128x32 / 32x128 operand tiles stream through a two-stage cp.async ring
//   in shared memory.  fp32 inputs run on the CUDA cores in full fp32
//   (fmaf, no TF32), matching preferred_element_type=f32.  A simple kernel
//   first: wgmma, TMA and persistent scheduling are later work.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// ----------------------------------------------------------------- triad --

__device__ __forceinline__ float triad1(float a, float s, float b) {
  return __fadd_rn(__fmul_rn(a, s), b);
}
__device__ __forceinline__ __nv_bfloat16 triad1(__nv_bfloat16 a, __nv_bfloat16 s,
                                                __nv_bfloat16 b) {
  return __hadd(__hmul(a, s), b);
}
__device__ __forceinline__ __half triad1(__half a, __half s, __half b) {
  return __hadd(__hmul(a, s), b);
}

template <typename T>
__global__ void triad_kernel(const T* a, const T* b, T* o, int64_t n,
                             float scale, int reps) {
  constexpr int kVec = 16 / sizeof(T);
  const T s = from_float<T>(scale);
  const int64_t nvec = n / kVec;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* av = reinterpret_cast<const uint4*>(a);
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  uint4* ov = reinterpret_cast<uint4*>(o);
  // .cg loads and stores keep the data out of L1: a thread revisits the
  // same elements on every pass, and an SM's share of an L2-sized array
  // would otherwise be served from its L1
  for (int r = 0; r < reps; ++r) {
    for (int64_t i = tid; i < nvec; i += stride) {
      uint4 va = __ldcg(av + i), vb = __ldcg(bv + i), vo;
      const T* ea = reinterpret_cast<const T*>(&va);
      const T* eb = reinterpret_cast<const T*>(&vb);
      T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
      for (int j = 0; j < kVec; ++j) eo[j] = triad1(ea[j], s, eb[j]);
      __stcg(ov + i, vo);
    }
    for (int64_t i = nvec * kVec + tid; i < n; i += stride) {
      o[i] = triad1(__ldcg(a + i), s, __ldcg(b + i));
    }
  }
}

// ------------------------------------------------------------- fma_chain --

template <int ILP>
__global__ void fma_chain_f32_kernel(const float* x, float* o, int64_t n,
                                     int n_iters, float a, float b) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = x[i];
    float acc[ILP];
#pragma unroll
    for (int j = 0; j < ILP; ++j) acc[j] = v + (float)j;
#pragma unroll 16
    for (int it = 0; it < n_iters; ++it) {
#pragma unroll
      for (int j = 0; j < ILP; ++j) acc[j] = fmaf(acc[j], a, b);
    }
    float out = acc[0];
#pragma unroll
    for (int j = 1; j < ILP; ++j) out += acc[j];
    o[i] = out;
  }
}

template <int ILP>
__device__ __forceinline__ __nv_bfloat162 bf16_chain(__nv_bfloat162 v,
                                                     int n_iters,
                                                     __nv_bfloat162 a2,
                                                     __nv_bfloat162 b2) {
  __nv_bfloat162 acc[ILP];
#pragma unroll
  for (int j = 0; j < ILP; ++j) acc[j] = __hadd2(v, __float2bfloat162_rn((float)j));
#pragma unroll 16
  for (int it = 0; it < n_iters; ++it) {
#pragma unroll
    for (int j = 0; j < ILP; ++j) acc[j] = __hfma2(acc[j], a2, b2);
  }
  __nv_bfloat162 out = acc[0];
#pragma unroll
  for (int j = 1; j < ILP; ++j) out = __hadd2(out, acc[j]);
  return out;
}

template <int ILP>
__global__ void fma_chain_bf16_kernel(const __nv_bfloat16* x, __nv_bfloat16* o,
                                      int64_t n, int n_iters, float a, float b) {
  const __nv_bfloat162 a2 = __float2bfloat162_rn(a);
  const __nv_bfloat162 b2 = __float2bfloat162_rn(b);
  const int64_t npair = n / 2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(x);
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(o);
  for (int64_t i = tid; i < npair; i += stride) {
    o2[i] = bf16_chain<ILP>(x2[i], n_iters, a2, b2);
  }
  if ((n & 1) && tid == 0) {  // odd N: the last element rides in a pair
    const __nv_bfloat162 r =
        bf16_chain<ILP>(__bfloat162bfloat162(x[n - 1]), n_iters, a2, b2);
    o[n - 1] = __low2bfloat16(r);
  }
}

// ------------------------------------------------------------------ gemm --

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename OutT> __device__ __forceinline__ OutT to_out(float x);
template <> __device__ __forceinline__ float to_out<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half to_out<__half>(float x) {
  return __float2half_rn(x);
}

// Tensor-core GEMM: 8 warps as 2 (M) x 4 (N), each warp a 64x32 sub-tile
// of 4x2 wmma fragments.  Rows of the shared tiles are padded by 8
// elements (16 bytes) against bank conflicts; every fragment pointer stays
// 32-byte aligned as wmma requires.
template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
gemm_wmma_kernel(const T* A, const T* B, OutT* C, int M, int N, int K) {
  constexpr int kAP = kBK + 8, kBP = kBN + 8;
  __shared__ __align__(128) T As[2][kBM * kAP];
  __shared__ __align__(128) T Bs[2][kBK * kBP];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  auto load_tiles = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;              // 0..511
      const int ar = v / 4, ac = (v % 4) * 8;        // A: 128 rows x 4 chunks
      cp_async16(&As[stage][ar * kAP + ac], A + (size_t)(bm + ar) * K + k0 + ac);
      const int br = v / 16, bc = (v % 16) * 8;      // B: 32 rows x 16 chunks
      cp_async16(&Bs[stage][br * kBP + bc], B + (size_t)(k0 + br) * N + bn + bc);
    }
    cp_async_commit();
  };

  const int nk = K / kBK;
  load_tiles(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tiles(cur ^ 1, (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], &As[cur][(wm * 64 + i * 16) * kAP + kk], kAP);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[cur][kk * kBP + wn * 32 + j * 16], kBP);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fp32 fragment at a time in the
  // (now idle) A tiles, then writes it cast to OutT, 8 elements a lane
  float* stage = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c0 = (lane % 2) * 8;
      OutT* dst = C + (size_t)(bm + wm * 64 + i * 16 + r) * N + bn + wn * 32 + j * 16 + c0;
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = to_out<OutT>(stage[r * 16 + c0 + e]);
      __syncwarp();
    }
  }
}

// CUDA-core fp32 GEMM: each thread owns an 8x8 register tile (two 4-wide
// row groups x two 4-wide column groups, 64 apart, so the float4 reads of
// the shared tiles are conflict-free).  A is stored transposed in shared
// memory so a thread's 8 A values along M are contiguous.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* A, const float* B, OutT* C, int M, int N, int K) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / kBK, c = v % kBK;
      As[c][r] = A[(size_t)(bm + r) * K + k0 + c];
    }
#pragma unroll
    for (int i = 0; i < (kBK * kBN) / kThreads; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / kBN, c = v % kBN;
      Bs[r][c] = B[(size_t)(k0 + r) * N + bn + c];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = bm + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = bn + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      C[(size_t)row * N + col] = to_out<OutT>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_wmma(const void* A, const void* B, void* C, int M, int N,
                        int K, int out_dtype, dim3 grid, cudaStream_t st) {
  switch (out_dtype) {
    case kF32:
      gemm_wmma_kernel<T, float><<<grid, kThreads, 0, st>>>(
          (const T*)A, (const T*)B, (float*)C, M, N, K);
      break;
    case kBF16:
      gemm_wmma_kernel<T, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
          (const T*)A, (const T*)B, (__nv_bfloat16*)C, M, N, K);
      break;
    case kF16:
      gemm_wmma_kernel<T, __half><<<grid, kThreads, 0, st>>>(
          (const T*)A, (const T*)B, (__half*)C, M, N, K);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ert_triad(const void* a, const void* b, void* o, long long n, float scale,
              int reps, int dtype, int blocks, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      triad_kernel<float><<<blocks, threads, 0, st>>>(
          (const float*)a, (const float*)b, (float*)o, n, scale, reps);
      break;
    case kBF16:
      triad_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
          (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (__nv_bfloat16*)o,
          n, scale, reps);
      break;
    case kF16:
      triad_kernel<__half><<<blocks, threads, 0, st>>>(
          (const __half*)a, (const __half*)b, (__half*)o, n, scale, reps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int ert_fma_chain(const void* x, void* o, long long n, int n_iters, int ilp,
                  float a, float b, int dtype, int blocks, int threads,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ERT_CHAIN(ILP)                                                          \
  case ILP:                                                                     \
    if (dtype == kF32)                                                          \
      fma_chain_f32_kernel<ILP><<<blocks, threads, 0, st>>>(                    \
          (const float*)x, (float*)o, n, n_iters, a, b);                        \
    else                                                                        \
      fma_chain_bf16_kernel<ILP><<<blocks, threads, 0, st>>>(                   \
          (const __nv_bfloat16*)x, (__nv_bfloat16*)o, n, n_iters, a, b);        \
    break;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  switch (ilp) {
    ERT_CHAIN(1)
    ERT_CHAIN(2)
    ERT_CHAIN(4)
    ERT_CHAIN(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef ERT_CHAIN
  return cudaGetLastError();
}

int ert_gemm(const void* A, const void* B, void* C, int M, int N, int K,
             int in_dtype, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M % kBM || N % kBN || K % kBK) return cudaErrorInvalidValue;
  const dim3 grid(N / kBN, M / kBM);
  switch (in_dtype) {
    case kBF16:
      return launch_wmma<__nv_bfloat16>(A, B, C, M, N, K, out_dtype, grid, st);
    case kF16:
      return launch_wmma<__half>(A, B, C, M, N, K, out_dtype, grid, st);
    case kF32:
      switch (out_dtype) {
        case kF32:
          gemm_f32_kernel<float><<<grid, kThreads, 0, st>>>(
              (const float*)A, (const float*)B, (float*)C, M, N, K);
          break;
        case kBF16:
          gemm_f32_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
              (const float*)A, (const float*)B, (__nv_bfloat16*)C, M, N, K);
          break;
        case kF16:
          gemm_f32_kernel<__half><<<grid, kThreads, 0, st>>>(
              (const float*)A, (const float*)B, (__half*)C, M, N, K);
          break;
        default:
          return cudaErrorInvalidValue;
      }
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}

// compiled GEMM tile: 0 -> block_m, 1 -> block_n, 2 -> block_k
int ert_gemm_tile(int which) {
  return which == 0 ? kBM : which == 1 ? kBN : kBK;
}

const char* ert_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
