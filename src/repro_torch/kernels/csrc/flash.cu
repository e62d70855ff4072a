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
// Grid.  One block of 4 warps per (q tile of 64 rows, h, b); each warp owns
// 16 query rows.  The block walks the key tiles of 64 from 0 up to the
// causal diagonal (tiles above it are skipped, as the reference's `nb`
// bound does); blocks run in no order, so nothing carries between them.
// Causal q tiles with the most key tiles are launched first.  hd is
// zero-padded in shared memory to 32, 64, 128 or 256 columns; any S runs
// (rows past Sq compute on zeros and are not written, keys past Sk are
// masked) and any hd that is a multiple of 8 up to 256.
//
// bf16/fp16 (the model's path): flash_fwd_mma_kernel.  K/V tiles are
// double-buffered in shared memory with cp.async (the next tile loads
// while this one is used).  S = Q K^T and O += P V run on the tensor cores
// with mma.sync m16n8k16 (fp32 accumulators), their operands fetched with
// ldmatrix; S, P, the running m and l and the O accumulator stay in
// registers (up to hd 128 the Q fragments too).  QK^T runs on the
// unscaled q and the fp32 scores are scaled (a scaled q rounded back to
// bf16 would add error the reference does not have); P is rounded to the
// input dtype for PV, while l sums the fp32 p.
// fp32 (the O0 parity path): flash_fwd_f32_kernel, plain FMAs (no TF32)
// with S, P and O staged in shared memory.
//
// Masking.  A masked entry (a key past the diagonal, or past Sk) takes no
// part in the row max and gets p = 0, instead of exp(-1e30 - m): the same
// numbers whenever the row has seen an unmasked key, and no exp(0) = 1 for
// masked keys when it has not (which the -1e30 sentinel alone would give).
//
// Not here yet: wgmma, TMA, warp specialisation, and a backward kernel
// (the backward recomputes the plain math, as the reference's custom_vjp
// does).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile (16-bit path)
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
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int bk,
                                         int causal) {
  const int n = (Sk + bk - 1) / bk;
  return causal ? min(n, (min(q0 + kBQ, Sq) - 1) / bk + 1) : n;
}

// ===================================================== 16-bit: mma.sync ==

template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  __device__ __forceinline__ static void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ __forceinline__ static __nv_bfloat16 cast(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <> struct Mma<__half> {
  __device__ __forceinline__ static void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ __forceinline__ static __half cast(float x) { return __float2half_rn(x); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [r0, r0 + rows) of a (n_src, hd) matrix whose rows are `stride`
// elements apart, into a (rows, HD) shared tile with row stride ld;
// rows past n_src and columns past hd are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_async(T* dst, int ld, const T* src,
                                           int64_t stride, int r0, int n_src,
                                           int hd, int rows) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool valid = r0 + r < n_src && c < hd;
    cp_async16(dst + r * ld + c, valid ? src + (int64_t)(r0 + r) * stride + c : src,
               valid);
  }
}

template <int HD> struct MmaLayout {
  static constexpr int kLd = HD + 8;    // row stride: 16 B of padding keeps
                                        // ldmatrix's 8 rows on distinct banks
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kLd * 2;
  static constexpr int kV = kK + 2 * kBK * kLd * 2;      // K: 2 buffers
  static constexpr int kBytes = kV + 2 * kBK * kLd * 2;  // V: 2 buffers
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                     int H, int KV, int hd, int causal, float scale) {
  using L = MmaLayout<HD>;
  constexpr int kLd = L::kLd;
  constexpr bool kQRegs = HD <= 128;    // Q fragments held in registers
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::kQ);
  T* Ks = reinterpret_cast<T*>(smem + L::kK);
  T* Vs = reinterpret_cast<T*>(smem + L::kV);

  const int qt = q_tile(Sq, causal);
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int64_t q_stride = (int64_t)H * hd;
  const int64_t kv_stride = (int64_t)KV * hd;
  const T* qb = q + ((int64_t)b * Sq * H + h) * hd;
  const T* kb = k + ((int64_t)b * Sk * KV + kvh) * hd;
  const T* vb = v + ((int64_t)b * Sk * KV + kvh) * hd;
  T* ob = o + ((int64_t)b * Sq * H + h) * hd;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kRowsPerWarp;
  const int g = lane >> 2, t = lane & 3;          // mma fragment coordinates
  const int mat = lane >> 3, mr = lane & 7;       // ldmatrix: matrix, row

  const int n_kt = key_tiles(q0, Sq, Sk, kBK, causal);
  load_async<T, HD>(Qs, kLd, qb, q_stride, q0, Sq, hd, kBQ);
  load_async<T, HD>(Ks, kLd, kb, kv_stride, 0, Sk, hd, kBK);
  load_async<T, HD>(Vs, kLd, vb, kv_stride, 0, Sk, hd, kBK);
  cp_async_commit();

  // A fragments of this warp's 16 Q rows: rows mr + 8 * (mat & 1),
  // columns 16 * kk + 8 * (mat >> 1)
  const T* q_frag = Qs + (row0 + mr + 8 * (mat & 1)) * kLd + 8 * (mat >> 1);
  uint32_t qf[kQRegs ? HD / 16 : 1][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const float scale_log2 = scale * kLog2e;        // exp(x) = exp2(x log2 e)

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (kt + 1 < n_kt) {                          // prefetch the next tile
      const int nb = (kt + 1) & 1;
      load_async<T, HD>(Ks + nb * kBK * kLd, kLd, kb, kv_stride, k0 + kBK, Sk, hd, kBK);
      load_async<T, HD>(Vs + nb * kBK * kLd, kLd, vb, kv_stride, k0 + kBK, Sk, hd, kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQRegs) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(qf[kk], q_frag + 16 * kk);
      }
    }
    const T* Kb = Ks + (kt & 1) * kBK * kLd;
    const T* Vb = Vs + (kt & 1) * kBK * kLd;

    // S = Q K^T: 8 n-tiles of 8 keys; B fragments of keys 8 * (j + (mat >> 1))
    // + mr, head columns 16 * kk + 8 * (mat & 1)
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    const T* k_frag = Kb + (8 * (mat >> 1) + mr) * kLd + 8 * (mat & 1);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
        a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
      } else {
        ldmatrix_x4(a, q_frag + 16 * kk);
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_frag + 8 * j * kLd + 16 * kk);
        Mma<T>::run(s[j], a, bk[0], bk[1]);
        Mma<T>::run(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // scale into the exp2 domain, mask, and the online softmax; this lane
    // holds rows g (s[j][0..1]) and g + 8 (s[j][2..3]), keys 8 j + 2 t + e
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0 + row0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = q0 + row0 + g + 8 * (e >> 1);
          if (key >= Sk || (causal && key > qpos)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mx[e >> 1]);    // masked: exp2(-inf) = 0
        rs[e >> 1] += s[j][e];
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];               // per-lane partial sums
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= alpha[0]; acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1]; acc[j][3] *= alpha[1];
    }

    // O += P V: P's C fragments of n-tiles 2 kk, 2 kk + 1 are the A
    // fragment of k-step kk; B fragments (ldmatrix.trans) of keys
    // 16 kk + mr + 8 * (mat & 1), head columns 8 * (j + (mat >> 1))
    const T* v_frag = Vb + (mr + 8 * (mat & 1)) * kLd + 8 * (mat >> 1);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                             Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                             Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < HD / 8; j += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_frag + 16 * kk * kLd + 8 * j);
        Mma<T>::run(acc[j], a, bv[0], bv[1]);
        Mma<T>::run(acc[j + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();          // this tile's buffers are free for the prefetch
  }

  // out = acc / l, l summed over the quad that shares a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g + 8 * r;
    if (row >= Sq) continue;
    T* orow = ob + (int64_t)row * q_stride;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < hd) {                               // hd and c are even
        orow[c] = Mma<T>::cast(acc[j][2 * r] / l[r]);
        orow[c + 1] = Mma<T>::cast(acc[j][2 * r + 1] / l[r]);
      }
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

template <typename T, int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KV, int hd, int causal, float scale,
               cudaStream_t stream) {
  constexpr int kBytes = MmaLayout<HD>::kBytes;
  auto kernel = flash_fwd_mma_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, hd, causal,
      scale);
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

template <typename T>
int dispatch_mma(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Sk, int H, int KV, int hd, int causal, float scale,
                 cudaStream_t s) {
  if (hd <= 32) return launch_mma<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
  if (hd <= 64) return launch_mma<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
  if (hd <= 128) return launch_mma<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
  return launch_mma<T, 256>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
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

// q, o: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); all contiguous in one dtype
// (0 f32, 1 bf16, 2 f16), 16-byte aligned.  H a multiple of KV, hd a
// multiple of 8 up to 256.  causal: key j is visible to query i iff j <= i.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int H, int KV, int hd,
                        int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV ||
      hd < 8 || hd > 256 || hd % 8 || B > 65535 || H > 65535 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_f32(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
    case kBF16:
      return dispatch_mma<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
    case kF16:
      return dispatch_mma<__half>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// compiled tiles: 0 -> query rows per block, 1 -> keys per tile (16-bit
// inputs, and fp32 up to hd 128), 2 -> threads per block
int flash_tile(int which) {
  return which == 0 ? kBQ : which == 1 ? kBK : kThreads;
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
