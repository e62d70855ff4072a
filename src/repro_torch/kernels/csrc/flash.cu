// Hopper (sm_90a) causal GQA flash-attention forward, with a plain C
// interface for ctypes (built by repro_torch/kernels/build.py).
//
// flash_attention — replaces repro/kernels/flash_attention/kernel.py::
//   flash_attention (_flash_kernel), which ops.py::flash_attention_gqa
//   reaches after repeating K/V once per query head.  Per query row:
//   s = (q . k) * hd^-0.5 over the keys, masked entries -1e30, online
//   softmax with the running max m, sum l and accumulator acc in fp32,
//   out = acc / l rounded once to q's dtype.
//   Bound: operations at the main path's shape (bf16 (2, 2048, 32, 128),
//   2 KV heads): 4 * S^2 / 2 * hd FLOPs per head against q, k, v and o
//   moved once — about 512 FLOPs per byte, above the card's ~295.
//
// Layout.  q and o are read and written in the model layout (B, Sq, H, hd)
// and k, v in (B, Sk, KV, hd), all contiguous: query head h reads KV head
// h / G (G = H / KV) directly, so nothing is repeated G times in device
// memory.  The reference's (BH, S, hd) layout is the case H = KV = 1.
//
// Routes, chosen by dtype alone (flash_route; never by a failure):
//   bf16/fp16, any hd (a multiple of 8 up to 256): flash_fwd_wgmma_kernel;
//   fp32 (the O0 parity path): flash_fwd_f32_kernel, plain FMAs (no TF32)
//   with S, P and O staged in shared memory, 4 warps of 16 query rows.
//
// flash_fwd_wgmma_kernel.  Only wgmma reaches Hopper's full tensor-core
// rate, and it must be fed without spending the consumers' issue slots on
// copies, so the block is warp-specialised: 128 query rows, three
// warpgroups (384 threads), one block an SM.
//   Warpgroup 0 is the producer: one of its threads loads the block's Q
//   tile once and then K and V tiles of BK keys through a ring of stages
//   in dynamic shared memory, with TMA (cp.async.bulk.tensor) over 4-D
//   tensor maps of the model layout (hd, heads, S, B), 64 columns a box
//   with 128-byte swizzle.  TMA fills zeros past Sq, Sk and hd, so any S
//   runs and hd < 64 is padded to 64.  Each K and V stage has a "full"
//   mbarrier (completed by the TMA's byte count) and an "empty" one
//   (released by the 8 consumer warps).  It gives registers up with
//   setmaxnreg.
//   Warpgroups 1 and 2 are consumers, each owning 64 query rows.  Per key
//   tile: S = Q K^T with wgmma m64nBKk16, both operands in shared memory
//   and K-major (hd contiguous), on the unscaled q (a scaled q rounded
//   back to bf16 would add error the reference does not have); the fp32
//   S stays in registers, where each row is held by a quad of 4 threads,
//   so the online softmax's row max takes two __shfl_xor_sync, and
//   exp2 of s * scale * log2(e) - m is one FMA and one ex2.  P is rounded
//   to the input dtype in place: the m64nN accumulator layout is the
//   k16 A-register layout, so P never goes through shared memory, and
//   O += P V is wgmma with A from registers and V as B, MN-major (hd
//   contiguous) read with the transpose bit; l sums the fp32 p.  A stage
//   is released only after the wgmma that read it has finished.
//   Keeping the tensor cores busy through the softmax: tile kt's QK^T and
//   tile kt-1's PV are issued together and tile kt's softmax runs while
//   the PV product does (S, O and P are all live then: 160 registers at
//   hd 128, no spill); the two consumers take turns to issue (named
//   barriers 1 and 2), so one's products run while the other computes
//   its softmax.  The epilogue stages O through the consumer's own Q rows
//   of shared memory, so each row is stored as 16-byte vectors.
//   Tiles: BK = 128 keys up to hd 128 (S and O 64 registers a thread
//   each), 32 keys above it (O takes 128, S 16); 2 stages at hd 128 (160
//   KiB of shared memory), 4 at hd 64 and 256 (144 and 192 KiB).
//
// Causal work.  Key tiles past the diagonal of the q tile's last row are
// skipped, as the reference's `nb` bound does; only tiles that reach
// past a consumer's first row (or past Sk) are masked.  Blocks run in no
// order, so nothing carries between them; the q tiles with the most key
// tiles are launched first, those of every head before any shorter one.
//
// Masking.  A masked entry (a key past the diagonal, or past Sk) takes no
// part in the row max and gets p = 0, instead of exp(-1e30 - m): the same
// numbers whenever the row has seen an unmasked key, and no exp(0) = 1 for
// masked keys when it has not (which the -1e30 sentinel alone would give).
// Key 0 is visible to every row, so l > 0 for every written row.
//
// Not here yet: a persistent grid (a block's start-up and epilogue are not
// hidden behind another block's work), and a backward kernel (the
// backward recomputes the plain math, as the reference's custom_vjp does).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum Route { kRouteWgmma = 0, kRouteF32 = 1 };

constexpr int kBQ = 64;                 // fp32 kernel: query rows per block
constexpr int kWarps = 4;               // 16 query rows per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr float kNegInf = -1e30f;       // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// causal q tiles with the most key tiles first
__device__ __forceinline__ int q_tile(int Sq, int causal) {
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  return causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
}

// key tiles of width bk from 0 up to the diagonal of the q tile's last row
template <int BQ = kBQ>
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int bk,
                                         int causal) {
  const int n = (Sk + bk - 1) / bk;
  return causal ? min(n, (min(q0 + BQ, Sq) - 1) / bk + 1) : n;
}

// ============================================ 16-bit: wgmma + TMA kernel ==

constexpr int kWgBQ = 128;              // query rows per block
constexpr int kWgThreads = 384;         // producer + 2 consumer warpgroups
constexpr int kWgConsumerWarps = 8;

// keys per tile: 128, or 32 above hd 128 (the O accumulator doubles)
constexpr int wg_bk(int hdp) { return hdp > 128 ? 32 : 128; }

template <int HDP>
struct WgLayout {
  static constexpr int kBK = wg_bk(HDP);
  static constexpr int kStages = HDP == 128 ? 2 : 4;
  static constexpr int kBoxes = HDP / 64;           // 64-column TMA boxes
  static constexpr int kQBox = kWgBQ * 128;         // bytes of one Q box
  static constexpr int kKVBox = kBK * 128;          // bytes of one K/V box
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;  // one K or V tile
  static constexpr int kK = kQBytes;                // Q at 0, then the rings
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  // Q full, then K full, K empty, V full, V empty per stage; 1 KiB to
  // align the tiles to the swizzle's 1024-byte period
  static constexpr int kBytes = kBars + (1 + 4 * kStages) * 8 + 1024;
};

template <typename T> struct Half16;
template <> struct Half16<__nv_bfloat16> {
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};
template <> struct Half16<__half> {
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// 2^x on the special-function unit, results below 2^-126 flushed to 0
// (exp2f adds a denormal path; p that small is 0 in bf16 and in l);
// exp2(-inf) = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define FA_D8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_D16(i) FA_D8(i), FA_D8(i + 8)
#define FA_D32(i) FA_D16(i), FA_D16(i + 16)
#define FA_REGS16                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define FA_REGS32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31}"
#define FA_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63}"
#define FA_REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, " \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, " \
  "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, " \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
// d (+)= A(64x16, K-major) @ B(16xN): both from shared memory, neither
// transposed (K is contiguous in both); scale_d 0 overwrites d
#define FA_SS(N, REGS, A, B, P, TY, ...)                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY    \
               " " REGS ", %" A ", %" B ", p, 1, 1, 0, 0;\n}\n"              \
               : __VA_ARGS__                                                \
               : "l"(da), "l"(db), "r"(scale_d))
// d += A(64x16, registers) @ B(16xN, N contiguous: the transpose bit)
#define FA_RS(N, REGS, A0, B, P, TY, ...)                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY    \
               " " REGS ", {%" A0 "}, %" B ", p, 1, 1, 1;\n}\n"              \
               : __VA_ARGS__                                                \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T> constexpr bool kF16In = std::is_same<T, __half>::value;

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (kF16In<T>) FA_SS("32", FA_REGS16, "16", "17", "18", "f16", FA_D16(0));
  else FA_SS("32", FA_REGS16, "16", "17", "18", "bf16", FA_D16(0));
}
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (kF16In<T>) FA_SS("64", FA_REGS32, "32", "33", "34", "f16", FA_D32(0));
  else FA_SS("64", FA_REGS32, "32", "33", "34", "bf16", FA_D32(0));
}
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (kF16In<T>)
    FA_SS("128", FA_REGS64, "64", "65", "66", "f16", FA_D32(0), FA_D32(32));
  else FA_SS("128", FA_REGS64, "64", "65", "66", "bf16", FA_D32(0), FA_D32(32));
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kF16In<T>)
    FA_RS("64", FA_REGS32, "32, %33, %34, %35", "36", "37", "f16", FA_D32(0));
  else FA_RS("64", FA_REGS32, "32, %33, %34, %35", "36", "37", "bf16", FA_D32(0));
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kF16In<T>)
    FA_RS("128", FA_REGS64, "64, %65, %66, %67", "68", "69", "f16", FA_D32(0),
          FA_D32(32));
  else FA_RS("128", FA_REGS64, "64, %65, %66, %67", "68", "69", "bf16", FA_D32(0),
             FA_D32(32));
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kF16In<T>)
    FA_RS("256", FA_REGS128, "128, %129, %130, %131", "132", "133", "f16",
          FA_D32(0), FA_D32(32), FA_D32(64), FA_D32(96));
  else FA_RS("256", FA_REGS128, "128, %129, %130, %131", "132", "133", "bf16",
             FA_D32(0), FA_D32(32), FA_D32(64), FA_D32(96));
}

#undef FA_RS
#undef FA_SS
#undef FA_REGS128
#undef FA_REGS64
#undef FA_REGS32
#undef FA_REGS16
#undef FA_D32
#undef FA_D16
#undef FA_D8

// S = Q K^T of one consumer's 64 rows and a tile of BK keys: k steps of
// 16 columns, the fifth in the next 64-column box; the first overwrites S
template <typename T, int HDP>
__device__ __forceinline__ void issue_qk(float (&sc)[WgLayout<HDP>::kBK / 2],
                                         uint64_t dq, uint32_t ks) {
  using L = WgLayout<HDP>;
  const uint64_t dk = sw128_desc(ks, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int qoff = ((kk / 4) * L::kQBox + (kk % 4) * 32) >> 4;
    const int koff = ((kk / 4) * L::kKVBox + (kk % 4) * 32) >> 4;
    wgmma_ss<T>(sc, dq + qoff, dk + koff, kk > 0);
  }
}

// O += P V: k steps of 16 keys, 2 KiB apart
template <typename T, int HDP>
__device__ __forceinline__ void issue_pv(float (&acc)[HDP / 2],
                                         uint32_t (&pa)[WgLayout<HDP>::kBK / 16][4],
                                         uint32_t vs) {
  using L = WgLayout<HDP>;
  const uint64_t dv = sw128_desc(vs, L::kKVBox, 1024);
#pragma unroll
  for (int kk = 0; kk < L::kBK / 16; ++kk) wgmma_rs<T>(acc, pa[kk], dv + 128 * kk);
}

// The online softmax of one S tile in place: masks an edge tile (a masked
// entry takes no part in the max and gets p = 0), takes each row's max
// over the quad that holds it, turns s into p = exp2(s * scale_log2 - m),
// adds p into the lane's partial row sums l, and returns each row's
// rescale factor in alpha.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool edge, int k0, const int (&row)[2],
                                             int col, int Sk, int causal,
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (edge) {
        const int key = k0 + 8 * j + col + (e & 1);
        if (key >= Sk || (causal && key > row[e >> 1])) sc[4 * j + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    }
  }
  float mneg[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    mneg[r] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = fast_exp2(fmaf(sc[i], scale_log2, mneg[(i >> 1) & 1]));  // masked: 0
    rs[(i >> 1) & 1] += sc[i];
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// P in the input dtype: n-tiles 2kk and 2kk + 1 of S are the A fragment
// of k step kk (the m64nN accumulator layout is the k16 A-register one)
template <typename T, int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = Half16<T>::pack(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// named barriers 1 and 2 (0 is __syncthreads; 3 and 4 each consumer's
// own) between the two consumer warpgroups: a sync waits for the other
// warpgroup's arrival
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// One block: query head blockIdx.x, batch blockIdx.y, q tile blockIdx.z,
// so the blocks of every head's longest causal q tiles launch first (the
// grid's tail is then the shortest tiles).  Shared memory: Q as kBoxes boxes of 128
// rows x 64 columns (128 bytes a row, each 8-row group of 1024 bytes
// swizzled by TMA), then kStages K tiles and kStages V tiles as kBoxes
// boxes of BK rows x 64 columns.
//   Q (A) and K (B) descriptors, K-major: 8-row groups 1024 B apart
//   (stride offset); a k step of 16 columns moves the start 32 B inside
//   the swizzled row, the fifth the next box.
//   V (B) descriptor, MN-major: 8-key groups 1024 B apart (stride offset),
//   the 64-column boxes kKVBox apart (leading offset); a k step of 16
//   keys moves the start 2 KiB.
template <typename T, int HDP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       T* __restrict__ o, int Sq, int Sk, int H, int KV, int hd,
                       int causal, float scale) {
  using L = WgLayout<HDP>;
  constexpr int BK = L::kBK, kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(tiles + L::kBars);
  uint64_t* full_k = full_q + 1;
  uint64_t* empty_k = full_k + kStages;
  uint64_t* full_v = empty_k + kStages;
  uint64_t* empty_v = full_v + kStages;

  const int n_qt = (Sq + kWgBQ - 1) / kWgBQ;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z) * kWgBQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int n_kt = key_tiles<kWgBQ>(q0, Sq, Sk, BK, causal);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], kWgConsumerWarps);
      mbar_init(&empty_v[s], kWgConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, L::kQBytes);
      for (int x = 0; x < L::kBoxes; ++x)
        tma_load_4d(tiles + x * L::kQBox, &map_q, full_q, 64 * x, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        // round r of a stage waits for the consumers' r-th release
        const uint32_t released = ((kt / kStages) + 1) & 1;
        uint8_t* ks = tiles + L::kK + s * L::kKVBytes;
        uint8_t* vs = tiles + L::kV + s * L::kKVBytes;
        if (kt >= kStages) mbar_wait(&empty_k[s], released);
        mbar_expect_tx(&full_k[s], L::kKVBytes);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(ks + x * L::kKVBox, &map_k, &full_k[s], 64 * x, kvh, kt * BK, b);
        if (kt >= kStages) mbar_wait(&empty_v[s], released);
        mbar_expect_tx(&full_v[s], L::kKVBytes);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(vs + x * L::kKVBox, &map_v, &full_v[s], 64 * x, kvh, kt * BK, b);
      }
    }
  } else {
    // consumer c owns query rows [q0 + 64c, q0 + 64c + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int first = q0 + 64 * c;
    // this thread's rows (accumulator registers 4j + e, e >= 2 the second)
    // and the first of its two columns in each 8-column group
    const int row[2] = {first + 16 * warp + lane / 4, first + 16 * warp + lane / 4 + 8};
    const int col = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;      // exp(x) = exp2(x log2 e)

    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.0f;
    uint32_t pa[BK / 16][4];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};   // m: exp2 domain
    float alpha[2];
    auto ks = [&](int kt) { return smem_u32(tiles + L::kK + kt % kStages * L::kKVBytes); };
    auto vs = [&](int kt) { return smem_u32(tiles + L::kV + kt % kStages * L::kKVBytes); };
    auto parity = [&](int kt) { return (uint32_t)(kt / kStages) & 1; };
    // only a tile that reaches past this consumer's first row, or past Sk,
    // is masked
    auto edge = [&](int kt) {
      return kt * BK + BK > Sk || (causal && kt * BK + BK - 1 > first);
    };

    const uint64_t dq = sw128_desc(smem_u32(tiles) + c * 64 * 128, 16, 1024);
    mbar_wait(full_q, 0);
    if (c == 1) named_arrive(1);      // consumer 0 takes the first turn
    // tile 0's S and P
    {
      float sc[BK / 2];
      mbar_wait(&full_k[0], 0);
      named_sync(1 + c);
      wgmma_fence();
      issue_qk<T, HDP>(sc, dq, ks(0));
      wgmma_commit();
      named_arrive(2 - c);
      wgmma_wait<0>();
      fence_acc(sc);
      if (lane == 0) mbar_arrive(&empty_k[0]);
      softmax_tile<BK>(sc, m, l, alpha, edge(0), 0, row, col, Sk, causal, scale_log2);
      pack_p<T, BK>(pa, sc);
    }
    // tile kt's S = Q K^T and the previous tile's O += P V are issued
    // together; tile kt's softmax runs while the PV product does
    for (int kt = 1; kt < n_kt; ++kt) {
      float sc[BK / 2];
      mbar_wait(&full_k[kt % kStages], parity(kt));
      named_sync(1 + c);
      fence_acc(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_qk<T, HDP>(sc, dq, ks(kt));
      wgmma_commit();
      mbar_wait(&full_v[(kt - 1) % kStages], parity(kt - 1));
      issue_pv<T, HDP>(acc, pa, vs(kt - 1));
      wgmma_commit();
      named_arrive(2 - c);
      wgmma_wait<1>();
      fence_acc(sc);
      if (lane == 0) mbar_arrive(&empty_k[kt % kStages]);
      softmax_tile<BK>(sc, m, l, alpha, edge(kt), kt * BK, row, col, Sk, causal, scale_log2);
      wgmma_wait<0>();
      fence_acc(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&empty_v[(kt - 1) % kStages]);
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_p<T, BK>(pa, sc);
    }
    // the last tile's O += P V
    mbar_wait(&full_v[(n_kt - 1) % kStages], parity(n_kt - 1));
    named_sync(1 + c);
    fence_acc(acc);
    fence_regs(pa);
    wgmma_fence();
    issue_pv<T, HDP>(acc, pa, vs(n_kt - 1));
    wgmma_commit();
    if (c == 0) named_arrive(2 - c);  // each barrier's arrivals match its syncs
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty_v[(n_kt - 1) % kStages]);

    // out = acc * (1 / l), l summed over the quad that shares a row; rows
    // past Sq and columns past hd are not written (hd is a multiple of 8)
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.0f / l[r];
    }
    const int64_t q_stride = (int64_t)H * hd;
    T* ob = o + ((int64_t)b * Sq * H + h) * hd;
    // through this consumer's Q rows in shared memory (every wgmma that
    // read them has finished), in their 128-byte swizzle, then 16 bytes a
    // thread, each row's columns contiguous
    uint8_t* stage = tiles + c * 64 * 128;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = row[r] - first;
        *reinterpret_cast<uint32_t*>(stage + (j / 8) * L::kQBox + rr * 128 +
                                     (((j % 8) ^ (rr % 8)) * 16) + col * 2) =
            Half16<T>::pack(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(3 + c) : "memory");  // this warpgroup
    constexpr int kChunks = HDP / 8;                // 16-byte chunks a row
#pragma unroll
    for (int i = t; i < 64 * kChunks; i += 128) {
      const int rr = i / kChunks, ch = i % kChunks;
      if (first + rr < Sq && ch * 8 < hd)
        *reinterpret_cast<uint4*>(ob + (first + rr) * q_stride + ch * 8) =
            *reinterpret_cast<const uint4*>(stage + (ch / 8) * L::kQBox + rr * 128 +
                                            (((ch % 8) ^ (rr % 8)) * 16));
    }
  }
}

// ================================================= fp32: plain FMA path ==

template <int BK, int HDP>
struct F32Layout {
  static constexpr int kLdT = HDP + 4;      // Q, K, V rows
  static constexpr int kLdS = BK + 4;       // S rows (P written over S)
  static constexpr int kLdO = HDP + 4;      // O rows
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kLdT * 4;
  static constexpr int kV = kK + BK * kLdT * 4;
  static constexpr int kS = kV + BK * kLdT * 4;
  static constexpr int kO = kS + kBQ * kLdS * 4;
  static constexpr int kStats = kO + kBQ * kLdO * 4;        // m, l
  static constexpr int kBytes = kStats + 2 * kBQ * 4;
};

template <int HDP>
__device__ __forceinline__ void load_f32(float* dst, int ld, const float* src,
                                         int64_t stride, int r0, int n_src,
                                         int hd, int rows) {
  constexpr int kChunks = HDP / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < n_src && c < hd) {
      val = *reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * stride + c);
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

template <int BK, int HDP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int Sq,
                     int Sk, int H, int KV, int hd, int causal, float scale) {
  using L = F32Layout<BK, HDP>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::kQ);
  float* Ks = reinterpret_cast<float*>(smem + L::kK);
  float* Vs = reinterpret_cast<float*>(smem + L::kV);
  float* Ss = reinterpret_cast<float*>(smem + L::kS);   // S, then P in place
  float* Os = reinterpret_cast<float*>(smem + L::kO);
  float* m_s = reinterpret_cast<float*>(smem + L::kStats);
  float* l_s = m_s + kBQ;

  const int qt = q_tile(Sq, causal);
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int64_t q_stride = (int64_t)H * hd;
  const int64_t kv_stride = (int64_t)KV * hd;
  const float* qb = q + ((int64_t)b * Sq * H + h) * hd;
  const float* kb = k + ((int64_t)b * Sk * KV + kvh) * hd;
  const float* vb = v + ((int64_t)b * Sk * KV + kvh) * hd;
  float* ob = o + ((int64_t)b * Sq * H + h) * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kRowsPerWarp;
  // lane: rows row0 + 4 * rg + i (i < 4), columns cg + 8 * j
  const int rg = lane >> 3, cg = lane & 7;

  load_f32<HDP>(Qs, L::kLdT, qb, q_stride, q0, Sq, hd, kBQ);
  for (int i = threadIdx.x; i < kBQ * L::kLdO; i += kThreads) Os[i] = 0.0f;
  if (threadIdx.x < kBQ) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.0f;
  }

  const int n_kt = key_tiles(q0, Sq, Sk, BK, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                    // the last tile's K/V are consumed
    load_f32<HDP>(Ks, L::kLdT, kb, kv_stride, k0, Sk, hd, BK);
    load_f32<HDP>(Vs, L::kLdT, vb, kv_stride, k0, Sk, hd, BK);
    __syncthreads();

    // S = Q K^T (unscaled) for this warp's 16 rows
    {
      float sacc[4][BK / 8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) sacc[i][j] = 0.0f;
      const float* qr = Qs + (row0 + 4 * rg) * L::kLdT;
      const float* kr = Ks + cg * L::kLdT;
#pragma unroll 4
      for (int d = 0; d < HDP; ++d) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qr[i * L::kLdT + d];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float bk = kr[8 * j * L::kLdT + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) sacc[i][j] = fmaf(a[i], bk, sacc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          Ss[(row0 + 4 * rg + i) * L::kLdS + cg + 8 * j] = sacc[i][j];
    }
    __syncwarp();

    // online softmax, one row of the warp at a time (lane: columns
    // lane + 32 * c); P over S, O rescaled by alpha
    for (int r = row0; r < row0 + kRowsPerWarp; ++r) {
      const int qpos = q0 + r;
      float s[BK / 32];
      bool ok[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const int key = k0 + lane + 32 * c;
        ok[c] = key < Sk && (!causal || key <= qpos);
        s[c] = Ss[r * L::kLdS + lane + 32 * c] * scale;
        if (ok[c]) mx = fmaxf(mx, s[c]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        s[c] = ok[c] ? expf(s[c] - m_new) : 0.0f;
        sum += s[c];
        Ss[r * L::kLdS + lane + 32 * c] = s[c];
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_prev - m_new);
      for (int c = lane; c < HDP; c += 32) Os[r * L::kLdO + c] *= alpha;
      if (lane == 0) {
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncwarp();

    // O += P V, 64 columns per pass (8 a lane)
    constexpr int kCols = HDP < 64 ? HDP : 64;
    const float* pr = Ss + (row0 + 4 * rg) * L::kLdS;
#pragma unroll 1
    for (int c0 = 0; c0 < HDP; c0 += kCols) {
      float oacc[4][kCols / 8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) oacc[i][j] = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = pr[i * L::kLdS + kk];
        const float* vr = Vs + kk * L::kLdT + c0 + cg;
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          const float vv = vr[8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) oacc[i][j] = fmaf(p[i], vv, oacc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j)
          Os[(row0 + 4 * rg + i) * L::kLdO + c0 + cg + 8 * j] += oacc[i][j];
    }
  }
  __syncwarp();
  for (int r = row0; r < row0 + kRowsPerWarp; ++r) {
    if (q0 + r >= Sq) break;
    float* orow = ob + (int64_t)(q0 + r) * q_stride;
    for (int c = lane; c < hd; c += 32) orow[c] = Os[r * L::kLdO + c] / l_s[r];
  }
}

// ================================================================ launch ==

template <typename T, int HDP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Sk, int H, int KV, int hd, int causal, float scale,
                 cudaStream_t stream) {
  using L = WgLayout<HDP>;
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv;
  if (!encode_4d(&mq, dt, q, hd, H, Sq, B, 64, kWgBQ) ||
      !encode_4d(&mk, dt, k, hd, KV, Sk, B, 64, L::kBK) ||
      !encode_4d(&mv, dt, v, hd, KV, Sk, B, 64, L::kBK))
    return cudaErrorNotSupported;
  auto kernel = flash_fwd_wgmma_kernel<T, HDP>;
  // above 48 KiB of dynamic shared memory a kernel must opt in, once per
  // instantiation (a refused launch shows in cudaGetLastError below)
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid(H, B, (Sq + kWgBQ - 1) / kWgBQ);
  kernel<<<grid, kWgThreads, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<T*>(o), Sq, Sk, H, KV, hd, causal, scale);
  return cudaGetLastError();
}

template <int BK, int HDP>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KV, int hd, int causal, float scale,
               cudaStream_t stream) {
  constexpr int kBytes = F32Layout<BK, HDP>::kBytes;
  auto kernel = flash_fwd_f32_kernel<BK, HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KV, hd,
      causal, scale);
  return cudaGetLastError();
}

// hd padded to 64, 128 or 256 columns
template <typename T>
int dispatch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int H, int KV, int hd, int causal,
                   float scale, cudaStream_t s) {
  if (hd <= 64) return launch_wgmma<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
  if (hd <= 128) return launch_wgmma<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
  return launch_wgmma<T, 256>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
}

// fp32 at 256 columns takes 32-key tiles to stay inside the 227 KB of
// shared memory
int dispatch_f32(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Sk, int H, int KV, int hd, int causal, float scale,
                 cudaStream_t s) {
  if (hd <= 32) return launch_f32<64, 32>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
  if (hd <= 64) return launch_f32<64, 64>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
  if (hd <= 128) return launch_f32<64, 128>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
  return launch_f32<32, 256>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0;
}

}  // namespace

extern "C" {

// The kernel that serves (hd, dtype): 0 the wgmma kernel (bf16, fp16),
// 1 the fp32 FMA kernel; -1 for what no kernel takes.
int flash_route(int hd, int dtype) {
  if (hd < 8 || hd > 256 || hd % 8) return -1;
  return dtype == kF32 ? kRouteF32
         : dtype == kBF16 || dtype == kF16 ? kRouteWgmma : -1;
}

// q, o: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); all contiguous in one dtype
// (0 f32, 1 bf16, 2 f16), 16-byte aligned.  H a multiple of KV, hd a
// multiple of 8 up to 256.  causal: key j is visible to query i iff j <= i.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int H, int KV, int hd,
                        int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV ||
      flash_route(hd, dtype) < 0 || B > 65535 || H > 65535 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_f32(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
    case kBF16:
      return dispatch_wgmma<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
    default:
      return dispatch_wgmma<__half>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
  }
}

// compiled tiles of the wgmma kernel up to hd 128 (above it: 32 keys):
// 0 -> query rows per block, 1 -> keys per tile, 2 -> threads per block
int flash_tile(int which) {
  return which == 0 ? kWgBQ : which == 1 ? wg_bk(128) : kWgThreads;
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
