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
//   Bound: bytes (3*N*itemsize per pass, 2*N FLOPs; AI 1/6 in fp32).  The
//   kernel sets characterize's HBM and L2 ceilings, the denominators of
//   every memory-bound verdict, so it has to reach what the card can
//   stream, not a fraction of it.
//   Design: a streaming kernel for Hopper.  A persistent grid (at most the
//   blocks the SMs hold at once, so an L2-sized triad with `reps` passes
//   stays an L2 measurement and an HBM-sized one an HBM one) whose blocks
//   claim 16 KiB chunks of a and b one at a time from a counter over
//   reps x chunks (zeroed by the caller, one for each launch, so launches
//   on different streams share nothing): the grid walks the arrays in
//   order, pass after pass,
//   and a block on a slow share of the memory system takes fewer chunks
//   (with fixed contiguous shares the slowest block set the time, about
//   3% behind torch.add; tools/ssd_check.py --triad).  One thread per
//   block moves the data with 1-D bulk copies (cp.async.bulk, through L2
//   and not L1): each chunk of a and b into a ring of 3 stages in shared
//   memory, completing the stage's mbarrier; every thread computes its
//   16-byte vectors in place of a; the stage goes back out with one bulk
//   store (bulk_group), and is refilled once that store has read it, so
//   two stages of loads stay in flight while the block computes.  The
//   ring depth (3) and the stage (16 KiB an operand) are compiled in, and
//   with them 96 KiB of shared memory a block, so two blocks fit an SM;
//   threads per block and the grid (SMs x blocks_per_sm) are the run-time
//   parameters tuning searches, and a grid larger than what the SMs hold
//   at once is refused, not cut.  The elements past
//   the last whole chunk take a scalar grid-stride loop, so any N runs.
//   The TPU kernel pads the last block instead; padding here would move
//   bytes triad_bytes() does not count.  The product and sum round
//   separately (mul, then add) exactly as the plain PyTorch version does;
//   the kernel is memory-bound, so this costs nothing.
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
//   each block owns one 128x256 output tile and loops over K itself.  Only
//   wgmma reaches Hopper's full tensor-core rate, and it must be fed without
//   spending the consumers' issue slots on copies, so the block is
//   warp-specialised: three warpgroups, one block per SM.  Warpgroup 0 is
//   the producer: one of its threads keeps TMA loads of 128x64 A and 64x256
//   B tiles (128-byte swizzle) in flight through a 4-stage ring in dynamic
//   shared memory, each stage guarded by a "full" mbarrier (completed by the
//   TMA's byte count) and an "empty" one (released by the consumers); it
//   gives registers up with setmaxnreg.  Warpgroups 1 and 2 are consumers:
//   each owns 64 rows of the tile in one m64n256k16 fp32 accumulator (128
//   registers a thread), issues wgmma straight from the shared tiles (A
//   K-major, B as given: row-major, N contiguous, read with the transpose
//   bit, so no copy of B is made) and keeps one K step in flight, freeing a
//   stage only after the wgmma that read it has finished.  TMA fills the
//   ragged edge with zeros and the epilogue, straight from the accumulator
//   registers, masks its stores, so any M, N, K with 16-byte rows runs.
//   The grid walks the tiles in groups of 8 tile rows, column by column in
//   a group, so the blocks in flight share A and B panels in the L2 (bf16
//   8192^3 on an H100 80GB HBM3 at 700 W: 2.10 ms row by row, 1.42 ms so;
//   tools/ert_gemm_check.py --group-m 1 8).
//   fp32 inputs run on the CUDA cores in full fp32 (fmaf, no TF32),
//   matching preferred_element_type=f32, with their own 128x128x32 tile.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

// The ring: kTriadStages stages of one kTriadChunk chunk of a and one of
// b each; 3 x 2 x 16 KiB, so two blocks fit an SM.  Work is claimed a
// chunk at a time from *next, the launch's own counter over reps x chunks
// (zero at the launch), so the grid walks the arrays in order (pass after
// pass) and no block waits on a slow share.
constexpr int kTriadStages = 3;
constexpr int kTriadChunk = 16384;         // bytes of each operand a stage
constexpr int kTriadSmem = kTriadStages * 2 * kTriadChunk + 64;

template <typename T>
__global__ void triad_kernel(const T* a, const T* b, T* o, int64_t n,
                             float scale, int reps,
                             unsigned long long* next) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int64_t item_of[kTriadStages];   // a stage's item, -1 past the end
  constexpr int kElems = kTriadChunk / sizeof(T);
  constexpr int kVec = 16 / sizeof(T);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem_raw + kTriadStages * 2 * kTriadChunk);
  const T s = from_float<T>(scale);
  const int64_t nchunks = n / kElems;
  const int64_t total = nchunks * reps;
  const bool issuer = threadIdx.x == 0;
  if (issuer) {
    for (int st = 0; st < kTriadStages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto stage = [&](int64_t k) {
    return reinterpret_cast<T*>(smem_raw + (k % kTriadStages) * 2 *
                                               kTriadChunk);
  };
  // the issuer claims the next item into stage k % S: two bulk loads that
  // complete the stage's mbarrier, or, past the end, a bare arrival
  auto load = [&](int64_t k) {
    const int64_t g = (int64_t)atomicAdd(next, 1ull);
    uint64_t* bar = &full[k % kTriadStages];
    item_of[k % kTriadStages] = g < total ? g : -1;
    if (g >= total) {
      mbar_arrive(bar);
      return;
    }
    const int64_t ch = g % nchunks;
    mbar_expect_tx(bar, 2 * kTriadChunk);
    bulk_load(stage(k), a + ch * kElems, kTriadChunk, bar);
    bulk_load(stage(k) + kElems, b + ch * kElems, kTriadChunk, bar);
  };
  if (issuer)
    for (int64_t k = 0; k < kTriadStages; ++k) load(k);
  for (int64_t k = 0;; ++k) {
    mbar_wait(&full[k % kTriadStages], (uint32_t)(k / kTriadStages) & 1);
    const int64_t g = item_of[k % kTriadStages];
    if (g < 0) break;                // every later claim is past the end too
    uint4* sa = reinterpret_cast<uint4*>(stage(k));
    const uint4* sb = sa + kTriadChunk / 16;
    for (int v = threadIdx.x; v < kTriadChunk / 16; v += blockDim.x) {
      uint4 va = sa[v], vb = sb[v], vo;
      const T* ea = reinterpret_cast<const T*>(&va);
      const T* eb = reinterpret_cast<const T*>(&vb);
      T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
      for (int j = 0; j < kVec; ++j) eo[j] = triad1(ea[j], s, eb[j]);
      sa[v] = vo;                    // o in place of a
    }
    fence_async_shared();
    __syncthreads();
    if (issuer) {
      bulk_store(o + (g % nchunks) * kElems, stage(k), kTriadChunk);
      bulk_commit();
      // the stage of item k - 1 is free once its store has read it
      if (k >= 1) {
        bulk_wait_read<1>();
        load(k - 1 + kTriadStages);
      }
    }
  }
  __syncthreads();
  if (issuer) bulk_wait<0>();
  // the elements past the last whole chunk, every pass
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int r = 0; r < reps; ++r)
    for (int64_t e = nchunks * kElems + tid; e < n; e += stride)
      o[e] = triad1(__ldcg(a + e), s, __ldcg(b + e));
}

// a grid larger than the blocks the SMs take at once is refused: with
// reps > 1 a later wave would find its share of the passes in L2
template <typename T>
cudaError_t launch_triad(const T* a, const T* b, T* o, int64_t n, float scale,
                         int reps, int blocks, int threads,
                         unsigned long long* next, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      triad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTriadSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, triad_kernel<T>, threads, kTriadSmem)) != cudaSuccess) {
    return err;
  }
  if (blocks < 1 || blocks > sms * per_sm)
    return cudaErrorInvalidConfiguration;
  triad_kernel<T><<<blocks, threads, kTriadSmem, st>>>(a, b, o, n, scale,
                                                       reps, next);
  return cudaGetLastError();
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

// two neighbouring outputs of one row, cast and stored as one vector
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

// Tensor-core tile (bf16/fp16 inputs): 128x256 outputs per block, K steps
// of 64, a ring of 4 stages of 48 KiB.
constexpr int kTcBM = 128, kTcBN = 256, kTcBK = 64, kTcStages = 4;
constexpr int kTcThreads = 384;                    // producer + 2 consumers
// tile rows per group of the grid's walk: at 8192^3 the 132 blocks in
// flight read 8 A panels and about 17 B panels instead of 4 and all 32.
// Walking row by row (1) took 2.1018 ms at bf16 8192^3 against 1.4181 ms
// for 8 (NVIDIA H100 80GB HBM3, 700 W).
constexpr int kTcGroupM = 8;
constexpr int kTcConsumerWarps = 8;
constexpr int kTcABytes = kTcBM * kTcBK * 2;       // 16 KiB
constexpr int kTcBBox = 64 * kTcBK * 2;            // one 64-wide B box, 8 KiB
constexpr int kTcStageBytes = kTcABytes + kTcBN / 64 * kTcBBox;  // 48 KiB
// the ring, 1 KiB to align it to the swizzle's 1024-byte period, and the
// full and empty barriers
constexpr int kTcSmemBytes = kTcStages * kTcStageBytes + 1024 + 2 * kTcStages * 8;

#define ERT_ACC8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ERT_ACC32(i) ERT_ACC8(i), ERT_ACC8(i + 8), ERT_ACC8(i + 16), ERT_ACC8(i + 24)
#define ERT_ACC_REGS                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "  \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "  \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "  \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "    \
  "%123, %124, %125, %126, %127}"
// d += A(64x16, K-major) @ B(16x256, N-major): scale-d 1, no negation,
// A not transposed, B transposed (its N is contiguous)
#define ERT_WGMMA(TY)                                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "    \
               ERT_ACC_REGS ", %128, %129, p, 1, 1, 0, 1;\n}\n"                \
               : ERT_ACC32(0), ERT_ACC32(32), ERT_ACC32(64), ERT_ACC32(96)    \
               : "l"(da), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    ERT_WGMMA("f16");
  } else {
    ERT_WGMMA("bf16");
  }
}

// The tensor-core GEMM.  Shared memory of one stage: A as 128 rows of 64
// K-values (128 bytes a row, K-major), then B as 4 boxes of 64 K-rows of 64
// N-values (N-major); each 8-row, 1024-byte group is swizzled by TMA.
//   A descriptor: 8-row groups 1024 B apart (stride offset); the K step of
//   16 values moves the start 32 B inside the swizzled row.
//   B descriptor: 8-K-row groups 1024 B apart (stride offset), the 64-wide
//   N boxes 8 KiB apart (leading offset); a K step of 16 rows moves the
//   start 2 KiB.
template <typename T, typename OutT>
__global__ void __launch_bounds__(kTcThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, OutT* C, int M,
                  int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kTcStages * kTcStageBytes);
  uint64_t* empty = full + kTcStages;
  const int wg = threadIdx.x / 128;
  const int nk = (K + kTcBK - 1) / kTcBK;
  // the grid walks the tiles in groups of kTcGroupM tile rows, column by
  // column inside a group, so the blocks in flight share A and B panels
  const int tiles_m = (M + kTcBM - 1) / kTcBM, tiles_n = (N + kTcBN - 1) / kTcBN;
  const int per_group = kTcGroupM * tiles_n;
  const int first_m = blockIdx.x / per_group * kTcGroupM;
  const int gm = min(tiles_m - first_m, kTcGroupM);
  const int m0 = (first_m + blockIdx.x % per_group % gm) * kTcBM;
  const int n0 = (blockIdx.x % per_group / gm) * kTcBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // B boxes wholly past N are not loaded: they feed masked columns only
      const int nbox = min(kTcBN / 64, (N - n0 + 63) / 64);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kTcStages;
        // round r of a stage waits for the consumers' r-th release
        if (kt >= kTcStages) mbar_wait(&empty[s], ((kt / kTcStages) + 1) & 1);
        uint8_t* sa = ring + s * kTcStageBytes;
        mbar_expect_tx(&full[s], kTcABytes + nbox * kTcBBox);
        tma_load_2d(sa, &map_a, &full[s], kt * kTcBK, m0);
        for (int q = 0; q < nbox; ++q)
          tma_load_2d(sa + kTcABytes + q * kTcBBox, &map_b, &full[s], n0 + 64 * q,
                      kt * kTcBK);
      }
    }
  } else {
    // consumer c owns rows [64c, 64c + 64) of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    fence_acc(d);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kTcStages;
      mbar_wait(&full[s], (kt / kTcStages) & 1);
      const uint32_t sa = smem_u32(ring + s * kTcStageBytes) + c * 64 * 128;
      const uint64_t da = sw128_desc(sa, 16, 1024);
      const uint64_t db = sw128_desc(sa - c * 64 * 128 + kTcABytes, kTcBBox, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk)
        wgmma_m64n256k16<T>(d, da + 2 * kk, db + 128 * kk);
      wgmma_commit();
      // the previous step's wgmma has finished: its stage may be refilled
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kTcStages]);
    }
    wgmma_wait<0>();
    fence_acc(d);

    // epilogue: accumulator register 4j + e holds (row + 8 for e >= 2,
    // col0 + 8j + 1 for odd e)
    const int row = m0 + 64 * c + 16 * warp + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
      if (col < N) {  // N is even, so col + 1 < N too
        if (row < M) store2(C + (size_t)row * N + col, d[4 * j], d[4 * j + 1]);
        if (row + 8 < M)
          store2(C + (size_t)(row + 8) * N + col, d[4 * j + 2], d[4 * j + 3]);
      }
    }
  }
}

#undef ERT_WGMMA
#undef ERT_ACC_REGS
#undef ERT_ACC32
#undef ERT_ACC8

// fp32 tile (CUDA cores): 128x128 outputs per block, K steps of 32.
constexpr int kF32BM = 128, kF32BN = 128, kF32BK = 32, kF32Threads = 256;

// CUDA-core fp32 GEMM: each thread owns an 8x8 register tile (two 4-wide
// row groups x two 4-wide column groups, 64 apart, so the float4 reads of
// the shared tiles are conflict-free).  A is stored transposed in shared
// memory so a thread's 8 A values along M are contiguous.
template <typename OutT>
__global__ void __launch_bounds__(kF32Threads)
gemm_f32_kernel(const float* A, const float* B, OutT* C, int M, int N, int K) {
  constexpr int kBM = kF32BM, kBN = kF32BN, kBK = kF32BK, kThreads = kF32Threads;
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
      C[(size_t)row * N + col] = from_float<OutT>(acc[i][j]);
    }
  }
}

template <typename T, typename OutT>
cudaError_t launch_wgmma_out(const CUtensorMap& ma, const CUtensorMap& mb,
                             void* C, int M, int N, int K, cudaStream_t st) {
  // above 48 KiB of dynamic shared memory a kernel must opt in, once per
  // instantiation (a refused launch shows in cudaGetLastError below)
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_wgmma_kernel<T, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTcSmemBytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid(((N + kTcBN - 1) / kTcBN) * ((M + kTcBM - 1) / kTcBM));
  gemm_wgmma_kernel<T, OutT><<<grid, kTcThreads, kTcSmemBytes, st>>>(
      ma, mb, static_cast<OutT*>(C), M, N, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma(const void* A, const void* B, void* C, int M, int N,
                         int K, int out_dtype, cudaStream_t st) {
  // TMA's rules: 16-byte aligned bases and rows (K and N multiples of 8)
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 ||
      reinterpret_cast<uintptr_t>(A) % 16 || reinterpret_cast<uintptr_t>(B) % 16)
    return cudaErrorInvalidValue;
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap ma, mb;
  if (!encode_2d(&ma, dt, A, K, M, kTcBK, kTcBM) ||
      !encode_2d(&mb, dt, B, N, K, 64, kTcBK))
    return cudaErrorNotSupported;
  switch (out_dtype) {
    case kF32:
      return launch_wgmma_out<T, float>(ma, mb, C, M, N, K, st);
    case kBF16:
      return launch_wgmma_out<T, __nv_bfloat16>(ma, mb, C, M, N, K, st);
    case kF16:
      return launch_wgmma_out<T, __half>(ma, mb, C, M, N, K, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// `next`: one zeroed unsigned 64-bit counter in device memory, the
// launch's own
int ert_triad(const void* a, const void* b, void* o, long long n, float scale,
              int reps, int dtype, int blocks, int threads, void* next,
              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* ctr = static_cast<unsigned long long*>(next);
  switch (dtype) {
    case kF32:
      return launch_triad((const float*)a, (const float*)b, (float*)o, n,
                          scale, reps, blocks, threads, ctr, st);
    case kBF16:
      return launch_triad((const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
                          (__nv_bfloat16*)o, n, scale, reps, blocks, threads,
                          ctr, st);
    case kF16:
      return launch_triad((const __half*)a, (const __half*)b, (__half*)o, n,
                          scale, reps, blocks, threads, ctr, st);
    default:
      return cudaErrorInvalidValue;
  }
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
  switch (in_dtype) {
    case kBF16:
      return launch_wgmma<__nv_bfloat16>(A, B, C, M, N, K, out_dtype, st);
    case kF16:
      return launch_wgmma<__half>(A, B, C, M, N, K, out_dtype, st);
    case kF32: {
      if (M <= 0 || M % kF32BM || N % kF32BN || K % kF32BK)
        return cudaErrorInvalidValue;
      const dim3 grid(N / kF32BN, M / kF32BM);
      switch (out_dtype) {
        case kF32:
          gemm_f32_kernel<float><<<grid, kF32Threads, 0, st>>>(
              (const float*)A, (const float*)B, (float*)C, M, N, K);
          break;
        case kBF16:
          gemm_f32_kernel<__nv_bfloat16><<<grid, kF32Threads, 0, st>>>(
              (const float*)A, (const float*)B, (__nv_bfloat16*)C, M, N, K);
          break;
        case kF16:
          gemm_f32_kernel<__half><<<grid, kF32Threads, 0, st>>>(
              (const float*)A, (const float*)B, (__half*)C, M, N, K);
          break;
        default:
          return cudaErrorInvalidValue;
      }
      return cudaGetLastError();
    }
    default:
      return cudaErrorInvalidValue;
  }
}

// compiled GEMM tiles: 0, 1, 2 -> block_m, block_n, block_k of the
// tensor-core kernel (bf16/fp16 inputs); 3, 4, 5 -> those of the fp32 one
int ert_gemm_tile(int which) {
  const int tiles[6] = {kTcBM, kTcBN, kTcBK, kF32BM, kF32BN, kF32BK};
  return which >= 0 && which < 6 ? tiles[which] : 0;
}

const char* ert_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
