// Hopper (sm_90a) versions of the fused train-step kernels, with a plain C
// interface for ctypes (built by repro_torch/kernels/build.py).
//
// Every entry point launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() right after the
// launch (or cudaErrorInvalidValue for an argument it does not take), so a
// refused launch is reported to the Python wrapper, which raises.  Each
// kernel takes operands of any alignment and any length: it uses 16-byte
// vectors where every pointer and the row length allow them, scalar
// accesses otherwise, and masks the ragged edge itself (the TPU kernels pad
// the last block instead; padding here would move bytes hbm_bytes() does
// not count).  All arithmetic is in fp32 with one rounding at each write.
// No --use_fast_math: division and square root are IEEE, and the explicit
// __f*_rn intrinsics keep nvcc from contracting a multiply and an add into
// one FMA, so each result rounds where the plain PyTorch version rounds.
//
// ---------------------------------------------------------------------------
// rmsnorm — replaces repro/kernels/fused/norm.py::fused_rmsnorm
//   (_rmsnorm_kernel, launched by fused/common.py::row_blocked_call):
//   y = x * rsqrt(mean(x^2) + eps) * scale per row, statistics in fp32,
//   cast to y's dtype at the write.
// rmsnorm_residual — replaces norm.py::fused_rmsnorm_residual
//   (_rmsnorm_res_kernel): r = x + h rounded to x's dtype first, then the
//   rmsnorm of that rounded r; writes r and y.
//   Bound: bytes (x (+h) read once, y (+r) written once, scale once; about
//   4 FLOPs per element).
//   Design: one block per row (a grid-stride loop over rows when there are
//   more rows than blocks).  Pass 1 reads the row (and h), writes r, and
//   sums squares in fp32; the sum is reduced with warp shuffles and then
//   across warps in shared memory.  Pass 2 reads the row again (x, or the r
//   this thread just wrote) from L1/L2 — a 4096-wide bf16 row is 8 KB — and
//   writes y.  The per-layer scale is a view into the (n_layers, d) stack,
//   so it may sit at any offset: the vector path is taken only when every
//   pointer is 16-byte aligned and d is a multiple of 8.
//
// layernorm — replaces repro/kernels/fused/norm.py::fused_layernorm
//   (_layernorm_kernel): per row in fp32, mu = mean(x), var = mean((x - mu)^2)
//   (the population variance, two passes, as jnp.var computes it; never
//   E[x^2] - mu^2, which cancels when the mean is large against the
//   spread), y = (x - mu) * rsqrt(var + eps) * scale + bias, cast once at
//   the write.  x f32 or bf16; scale and bias each f32 or bf16, views at any
//   offset; any output dtype of the two.
//   Bound: bytes (x read once, y written once, scale and bias once; about
//   7 FLOPs per element).
//   Design: the rmsnorm's shape — one block per row, grid-stride over rows,
//   16-byte vectors where every pointer is aligned and d % 8 == 0, and
//   block_sum — with the row kept in shared memory as fp32 between its
//   three passes: pass 1 reads x from device memory once, stores it and
//   sums it; pass 2 sums (x - mu)^2 from shared memory; pass 3 writes y
//   from shared memory.  Each thread reads back only the elements it
//   stored, so the passes need no barrier of their own (block_sum's
//   barriers order the rows).  d * 4 bytes of dynamic shared memory: 16 KiB
//   at d = 4096, 64 KiB at the largest row (NORM_D_MAX = 16,384).
//
// swiglu — replaces repro/kernels/fused/swiglu.py::fused_swiglu
//   (_swiglu_kernel): y = act(gate) * up in fp32, one rounding at the write;
//   act is silu (g * sigmoid(g), sigmoid = 1 / (1 + exp(-g))) or the tanh
//   form of gelu (jax.nn.gelu's default).
//   Bound: bytes (gate + up read, y written; 3 * n * itemsize).
//   Design: a grid-stride loop over 8-element chunks (one 16-byte vector of
//   bf16, two of f32) and a scalar tail, so any rows * d_ff runs.
//
// adamw — replaces repro/kernels/fused/adamw.py::fused_adamw
//   (_adamw_kernel, one pallas_call per leaf, looped over the tree by
//   repro/train/optim.py::adamw_update inside jit): the AdamW update of
//   every leaf of one dtype combination in one launch.  g, m, v, p each
//   keep their own dtype (f32 or bf16); fp32 math written out in the
//   reference's order; bc = (1 - b1^t, 1 - b2^t) is read from device memory
//   (a (2,) fp32 tensor), so no host sync is needed per step.
//   Bound: bytes (g, m, v, p read, p, m, v written: 7 * n * 4 in fp32,
//   summed over the leaves).
//   Design: eager PyTorch pays its host cost per launch, so a launch per
//   leaf (the TPU kernel's shape) spent 85-128 us a leaf on DeepCAM's 370
//   leaves against a bound under 1 us.  Here one launch takes up to
//   kAdamSegs leaves: a table of segments (the seven pointers and the
//   length of each leaf, 64 B, plus its first chunk and its vector mode)
//   passed by value as a __grid_constant__ kernel parameter (CUDA 12.1+
//   takes 32,764 B of parameters), so nothing is copied to the device and
//   nothing outlives the launch.  Each leaf is cut into chunks of
//   kAdamChunk elements (a leaf's last chunk is ragged, so no chunk
//   crosses a leaf); a persistent grid strides over the chunks of all
//   leaves, and a block finds its chunk's leaf by a binary search over
//   the chunk prefix sum in the table (uniform in the block, so read
//   from the constant cache).  A leaf whose seven pointers sit at one
//   offset from a 4-element vector boundary (16 B of f32, 8 B of bf16) is
//   read in 4-element vectors after a scalar head of 0-3 elements (in its
//   first chunk; every later chunk starts on a boundary) and a scalar
//   tail; any other leaf (a view at unrelated offsets) element by element.
//   The wrapper (repro_torch/kernels/fused/adamw.py::plan) gives each
//   leaf's pointers, length and vector mode and splits a longer list into
//   launches of kAdamSegs; the C entry lays out the chunks.  The outputs may
//   alias the inputs (the in-place update the train step uses): each
//   element is read and then written by the same thread.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };
enum Act { kSilu = 0, kGelu = 1 };

template <typename T> struct Tag { using type = T; };

// call f(Tag<T>{}) for the dtype code, or fail
template <typename F> int with_type(int code, F&& f) {
  if (code == kF32) return f(Tag<float>{});
  if (code == kBF16) return f(Tag<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, back in fp32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// ---- 8 elements as 16 bytes of bf16 or 32 bytes of f32 (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// ---- 4 elements as 16 bytes of f32 or 8 bytes of bf16 (16-byte aligned base)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % 16) == 0;
}

// --------------------------------------------------------------- rmsnorm --

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the sum of `v` over the block, returned to every thread
__device__ float block_sum(float v) {
  __shared__ float partial[32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)((blockDim.x + 31) >> 5) ? partial[lane] : 0.0f;
    t = warp_sum(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  const float out = total;
  __syncthreads();  // `total` and `partial` are reused by the next row
  return out;
}

template <typename T, typename S, typename O, bool RES, bool VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ h,
                               const S* __restrict__ scale, T* __restrict__ r,
                               O* __restrict__ y, int64_t rows, int d, float eps) {
  const int step = VEC ? 8 * blockDim.x : blockDim.x;
  const int first = VEC ? 8 * threadIdx.x : threadIdx.x;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t base = row * (int64_t)d;
    const T* xr = x + base;
    const T* hr = RES ? h + base : nullptr;
    T* rr = RES ? r + base : nullptr;
    O* yr = y + base;
    // pass 1: (r = x + h, written) and the fp32 sum of squares
    float ss = 0.0f;
    for (int i = first; i < d; i += step) {
      if (VEC) {
        float v[8];
        load8(xr + i, v);
        if (RES) {
          float w[8];
          load8(hr + i, w);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = round_to<T>(__fadd_rn(v[j], w[j]));
          store8(rr + i, v);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) ss = fmaf(v[j], v[j], ss);
      } else {
        float v = to_f(xr[i]);
        if (RES) {
          v = round_to<T>(__fadd_rn(v, to_f(hr[i])));
          rr[i] = from_f<T>(v);
        }
        ss = fmaf(v, v, ss);
      }
    }
    const float mean = __fdiv_rn(block_sum(ss), (float)d);
    const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(mean, eps)));
    // pass 2: y = (x * rs) * scale, rounded once at the write
    const T* src = RES ? rr : xr;
    for (int i = first; i < d; i += step) {
      if (VEC) {
        float v[8], s[8];
        load8(src + i, v);
        load8(scale + i, s);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(__fmul_rn(v[j], rs), s[j]);
        store8(yr + i, v);
      } else {
        yr[i] = from_f<O>(__fmul_rn(__fmul_rn(to_f(src[i]), rs), to_f(scale[i])));
      }
    }
  }
}

template <typename T, typename S, typename O, bool RES>
int launch_rmsnorm(const void* x, const void* h, const void* scale, void* r,
                   void* y, int64_t rows, int d, float eps, bool vec,
                   int blocks, int threads, cudaStream_t stream) {
  auto args = [&](auto kernel) {
    kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(h),
        static_cast<const S*>(scale), static_cast<T*>(r), static_cast<O*>(y),
        rows, d, eps);
  };
  if (vec) args(rmsnorm_kernel<T, S, O, RES, true>);
  else args(rmsnorm_kernel<T, S, O, RES, false>);
  return cudaGetLastError();
}

// ------------------------------------------------------------- layernorm --

template <typename T, typename S, typename B, typename O, bool VEC>
__global__ void layernorm_kernel(const T* __restrict__ x,
                                 const S* __restrict__ scale,
                                 const B* __restrict__ bias,
                                 O* __restrict__ y, int64_t rows, int d,
                                 float eps) {
  // the current row in fp32, d floats.  With vectors, element j of the
  // 8-element chunk at i sits at j * (d / 8) + i / 8, so a warp's 32
  // threads touch 32 consecutive words (no bank conflict)
  extern __shared__ float row_f[];
  const int step = VEC ? 8 * blockDim.x : blockDim.x;
  const int first = VEC ? 8 * threadIdx.x : threadIdx.x;
  const int n = VEC ? 8 : 1;
  const int stride = VEC ? d / 8 : 0;
  auto at = [&](int i, int j) { return VEC ? j * stride + i / 8 : i; };
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * (int64_t)d;
    O* yr = y + row * (int64_t)d;
    // pass 1: x into shared memory, and its fp32 sum
    float s = 0.0f;
    for (int i = first; i < d; i += step) {
      float v[8];
      if (VEC) load8(xr + i, v);
      else v[0] = to_f(xr[i]);
#pragma unroll
      for (int j = 0; j < n; ++j) {
        row_f[at(i, j)] = v[j];
        s = __fadd_rn(s, v[j]);
      }
    }
    const float mu = __fdiv_rn(block_sum(s), (float)d);
    // pass 2: the population variance about mu
    float ss = 0.0f;
    for (int i = first; i < d; i += step) {
#pragma unroll
      for (int j = 0; j < n; ++j) {
        const float c = __fsub_rn(row_f[at(i, j)], mu);
        ss = fmaf(c, c, ss);
      }
    }
    const float var = __fdiv_rn(block_sum(ss), (float)d);
    const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    // pass 3: y = ((x - mu) * rs) * scale + bias, rounded once at the write
    for (int i = first; i < d; i += step) {
      float v[8], sc[8], bi[8];
      if (VEC) {
        load8(scale + i, sc);
        load8(bias + i, bi);
      } else {
        sc[0] = to_f(scale[i]);
        bi[0] = to_f(bias[i]);
      }
#pragma unroll
      for (int j = 0; j < n; ++j) {
        v[j] = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(row_f[at(i, j)], mu), rs), sc[j]),
            bi[j]);
      }
      if (VEC) store8(yr + i, v);
      else yr[i] = from_f<O>(v[0]);
    }
  }
}

template <typename T, typename S, typename B, typename O>
int launch_layernorm(const void* x, const void* scale, const void* bias,
                     void* y, int64_t rows, int d, float eps, bool vec,
                     int blocks, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)d * sizeof(float);
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<blocks, threads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale),
        static_cast<const B*>(bias), static_cast<O*>(y), rows, d, eps);
    return (int)cudaGetLastError();
  };
  return vec ? go(layernorm_kernel<T, S, B, O, true>)
             : go(layernorm_kernel<T, S, B, O, false>);
}

// ---------------------------------------------------------------- swiglu --

template <int ACT> __device__ __forceinline__ float act(float g) {
  if (ACT == kSilu) {
    // jax.nn.silu: g * sigmoid(g), sigmoid = 1 / (1 + exp(-g))
    return __fmul_rn(g, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g))));
  }
  // jax.nn.gelu (approximate=True):
  // g * 0.5 * (1 + tanh(sqrt(2/pi) * (g + 0.044715 * g^3)))
  const float k = 0.7978845608028654f;  // sqrt(2/pi)
  const float g3 = __fmul_rn(__fmul_rn(g, g), g);
  const float inner = __fmul_rn(k, __fadd_rn(g, __fmul_rn(0.044715f, g3)));
  return __fmul_rn(g, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

template <typename T, typename O, int ACT, bool VEC>
__global__ void swiglu_kernel(const T* __restrict__ g, const T* __restrict__ u,
                              O* __restrict__ y, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (VEC) {
    const int64_t chunks = n / 8;
    for (int64_t c = tid; c < chunks; c += stride) {
      float gv[8], uv[8];
      load8(g + 8 * c, gv);
      load8(u + 8 * c, uv);
#pragma unroll
      for (int j = 0; j < 8; ++j) gv[j] = __fmul_rn(act<ACT>(gv[j]), uv[j]);
      store8(y + 8 * c, gv);
    }
    done = chunks * 8;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    y[i] = from_f<O>(__fmul_rn(act<ACT>(to_f(g[i])), to_f(u[i])));
  }
}

// ----------------------------------------------------------------- adamw --

struct AdamHyper {
  float lr, b1, b2, omb1, omb2, eps, wd;
};

// the reference's expression order, each operation rounded on its own
__device__ __forceinline__ void adamw1(float g, float m, float v, float p,
                                       float bc1, float bc2, const AdamHyper& k,
                                       float& np, float& nm, float& nv) {
  nm = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  nv = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.omb2, g), g));
  const float step = __fdiv_rn(__fdiv_rn(nm, bc1),
                               __fadd_rn(__fsqrt_rn(__fdiv_rn(nv, bc2)), k.eps));
  np = __fsub_rn(p, __fmul_rn(k.lr, __fadd_rn(step, __fmul_rn(k.wd, p))));
}

// one leaf of a multi-tensor launch: its operands and length (64 B)
struct AdamSeg {
  const void *g, *m, *v, *p;
  void *p_out, *m_out, *v_out;
  int64_t n;
};

constexpr int kAdamChunk = 4096;  // elements a block takes at a time
constexpr int kAdamSegs = 464;    // leaves a launch holds (the table's size)
constexpr int kAdamFields = 9;    // int64 fields of a segment row (below)
constexpr unsigned char kAdamVec = 4;  // mode bit: the 4-element vector path

// the kernel's one parameter: the segments of one launch, each leaf's first
// chunk (a prefix sum; first[n_segs] = the chunks of all leaves) and its
// mode (bits 0-1: the scalar head; bit 2: kAdamVec)
struct AdamTable {
  AdamSeg seg[kAdamSegs];
  const float* bc;
  AdamHyper k;
  int n_segs;
  unsigned first[kAdamSegs + 1];
  unsigned char mode[kAdamSegs];
};
static_assert(sizeof(AdamTable) <= 32764, "AdamTable exceeds the 32,764 B "
              "of kernel parameters");

template <typename G, typename M, typename V, typename P>
__device__ __forceinline__ void adamw_at(const AdamSeg& s, int64_t i,
                                         float bc1, float bc2,
                                         const AdamHyper& k) {
  float np, nm, nv;
  adamw1(to_f(static_cast<const G*>(s.g)[i]), to_f(static_cast<const M*>(s.m)[i]),
         to_f(static_cast<const V*>(s.v)[i]), to_f(static_cast<const P*>(s.p)[i]),
         bc1, bc2, k, np, nm, nv);
  static_cast<P*>(s.p_out)[i] = from_f<P>(np);
  static_cast<M*>(s.m_out)[i] = from_f<M>(nm);
  static_cast<V*>(s.v_out)[i] = from_f<V>(nv);
}

template <typename G, typename M, typename V, typename P>
__global__ void adamw_kernel(const __grid_constant__ AdamTable t) {
  const float bc1 = t.bc[0], bc2 = t.bc[1];
  const int n_chunks = (int)t.first[t.n_segs];
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    // the leaf of chunk c: the last si with first[si] <= c
    int si = 0, hi = t.n_segs - 1;
    while (si < hi) {
      const int mid = (si + hi + 1) >> 1;
      if ((int)t.first[mid] <= c) si = mid; else hi = mid - 1;
    }
    const AdamSeg& s = t.seg[si];
    const int64_t j = c - (int)t.first[si];
    const int64_t head = t.mode[si] & 3;
    // chunk 0 holds the head; every later one starts on a vector boundary
    const int64_t lo = j ? head + j * kAdamChunk : 0;
    const int64_t cap = head + (j + 1) * kAdamChunk;
    const int64_t end = s.n < cap ? s.n : cap;
    int64_t vlo = lo, vhi = lo;
    if (t.mode[si] & kAdamVec) {
      vlo = j ? lo : (head < end ? head : end);
      vhi = vlo + (end - vlo) / 4 * 4;
    }
    for (int64_t i = vlo + 4 * (int64_t)threadIdx.x; i < vhi;
         i += 4 * (int64_t)blockDim.x) {
      float gv[4], mv[4], vv[4], pv[4];
      load4(static_cast<const G*>(s.g) + i, gv);
      load4(static_cast<const M*>(s.m) + i, mv);
      load4(static_cast<const V*>(s.v) + i, vv);
      load4(static_cast<const P*>(s.p) + i, pv);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        adamw1(gv[e], mv[e], vv[e], pv[e], bc1, bc2, t.k, pv[e], mv[e], vv[e]);
      store4(static_cast<P*>(s.p_out) + i, pv);
      store4(static_cast<M*>(s.m_out) + i, mv);
      store4(static_cast<V*>(s.v_out) + i, vv);
    }
    // the scalar head [lo, vlo) and tail [vhi, end) (a scalar leaf: all)
    for (int64_t i = lo + threadIdx.x; i < vlo; i += blockDim.x)
      adamw_at<G, M, V, P>(s, i, bc1, bc2, t.k);
    for (int64_t i = vhi + threadIdx.x; i < end; i += blockDim.x)
      adamw_at<G, M, V, P>(s, i, bc1, bc2, t.k);
  }
}

}  // namespace

extern "C" {

// x, h (null: plain rmsnorm), scale, r (null unless h), y: row-major
// (rows, d); x/h/r share x_dtype, y has out_dtype, scale scale_dtype.
int fused_rmsnorm(const void* x, const void* h, const void* scale, void* r,
                  void* y, long long rows, int d, float eps, int x_dtype,
                  int scale_dtype, int out_dtype, int blocks, int threads,
                  void* stream) {
  if (rows <= 0 || d <= 0 || (h == nullptr) != (r == nullptr) ||
      threads <= 0 || threads > 1024 || threads % 32 || blocks <= 0) {
    return cudaErrorInvalidValue;
  }
  const bool vec = d % 8 == 0 && aligned16(x) && aligned16(h) &&
                   aligned16(scale) && aligned16(r) && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_type(x_dtype, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return with_type(scale_dtype, [&](auto st) {
      using S = typename decltype(st)::type;
      return with_type(out_dtype, [&](auto ot) {
        using O = typename decltype(ot)::type;
        return h ? launch_rmsnorm<T, S, O, true>(x, h, scale, r, y, rows, d,
                                                 eps, vec, blocks, threads, s)
                 : launch_rmsnorm<T, S, O, false>(x, h, scale, r, y, rows, d,
                                                  eps, vec, blocks, threads, s);
      });
    });
  });
}

// x, y: row-major (rows, d), d <= 16384; scale, bias: (d,).  x has
// x_dtype, scale scale_dtype, bias bias_dtype, y out_dtype.
int fused_layernorm(const void* x, const void* scale, const void* bias,
                    void* y, long long rows, int d, float eps, int x_dtype,
                    int scale_dtype, int bias_dtype, int out_dtype,
                    int blocks, int threads, void* stream) {
  if (rows <= 0 || d <= 0 || d > 16384 || threads <= 0 || threads > 1024 ||
      threads % 32 || blocks <= 0) {
    return cudaErrorInvalidValue;
  }
  const bool vec = d % 8 == 0 && aligned16(x) && aligned16(scale) &&
                   aligned16(bias) && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_type(x_dtype, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return with_type(scale_dtype, [&](auto st) {
      using S = typename decltype(st)::type;
      return with_type(bias_dtype, [&](auto bt) {
        using B = typename decltype(bt)::type;
        return with_type(out_dtype, [&](auto ot) {
          using O = typename decltype(ot)::type;
          return launch_layernorm<T, S, B, O>(x, scale, bias, y, rows, d, eps,
                                              vec, blocks, threads, s);
        });
      });
    });
  });
}

// y = act(g) * u over n elements; act 0 = silu, 1 = gelu (tanh form)
int fused_swiglu(const void* g, const void* u, void* y, long long n, int act,
                 int in_dtype, int out_dtype, int blocks, int threads,
                 void* stream) {
  if (n <= 0 || (act != kSilu && act != kGelu) || threads <= 0 ||
      threads > 1024 || blocks <= 0) {
    return cudaErrorInvalidValue;
  }
  const bool vec = aligned16(g) && aligned16(u) && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_type(in_dtype, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return with_type(out_dtype, [&](auto ot) {
      using O = typename decltype(ot)::type;
      auto go = [&](auto kernel) {
        kernel<<<blocks, threads, 0, s>>>(static_cast<const T*>(g),
                                          static_cast<const T*>(u),
                                          static_cast<O*>(y), (int64_t)n);
        return (int)cudaGetLastError();
      };
      if (act == kSilu) {
        return vec ? go(swiglu_kernel<T, O, kSilu, true>)
                   : go(swiglu_kernel<T, O, kSilu, false>);
      }
      return vec ? go(swiglu_kernel<T, O, kGelu, true>)
                 : go(swiglu_kernel<T, O, kGelu, false>);
    });
  });
}

// one multi-tensor AdamW launch over n_segs <= kAdamSegs leaves of one
// dtype combination.  segs: n_segs rows of kAdamFields int64 — the
// pointers g, m, v, p, p_out, m_out, v_out (outputs may equal inputs), the
// length n > 0 and the mode (bits 0-1: the scalar head; kAdamVec: read in
// vectors).  Each leaf's chunks (its first holds the head and kAdamChunk
// elements more, the last is ragged) are laid out here, so the chunks
// cover every element of every leaf whatever the caller's constants.
// blocks: the most the grid may take (held to the chunks).  The table is
// copied into the launch's parameters: segs may be freed on return.
int fused_adamw_multi(const long long* segs, int n_segs, const void* bc,
                      float lr, float b1, float b2, float omb1, float omb2,
                      float eps, float wd, int g_dtype, int m_dtype,
                      int v_dtype, int p_dtype, int blocks, int threads,
                      void* stream) {
  if (n_segs <= 0 || n_segs > kAdamSegs || bc == nullptr || threads <= 0 ||
      threads > 1024 || blocks <= 0) {
    return cudaErrorInvalidValue;
  }
  AdamTable t;
  long long n_chunks = 0;
  for (int i = 0; i < n_segs; ++i) {
    const long long* r = segs + (int64_t)kAdamFields * i;
    const long long n = r[7], mode = r[8];
    if (n <= 0 || (mode & ~(long long)(kAdamVec | 3)) ||
        (!(mode & kAdamVec) && (mode & 3))) {
      return cudaErrorInvalidValue;
    }
    auto ptr = [](long long a) { return reinterpret_cast<void*>(a); };
    t.seg[i] = AdamSeg{ptr(r[0]), ptr(r[1]), ptr(r[2]), ptr(r[3]),
                       ptr(r[4]), ptr(r[5]), ptr(r[6]), (int64_t)n};
    t.first[i] = (unsigned)n_chunks;
    t.mode[i] = (unsigned char)mode;
    const long long body = n - (mode & 3);
    n_chunks += body > 0 ? (body + kAdamChunk - 1) / kAdamChunk : 1;
    if (n_chunks > INT32_MAX) return cudaErrorInvalidValue;
  }
  t.first[n_segs] = (unsigned)n_chunks;
  if (blocks > n_chunks) blocks = (int)n_chunks;
  t.bc = static_cast<const float*>(bc);
  t.k = AdamHyper{lr, b1, b2, omb1, omb2, eps, wd};
  t.n_segs = n_segs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_type(g_dtype, [&](auto gt) {
    using G = typename decltype(gt)::type;
    return with_type(m_dtype, [&](auto mt) {
      using M = typename decltype(mt)::type;
      return with_type(v_dtype, [&](auto vt) {
        using V = typename decltype(vt)::type;
        return with_type(p_dtype, [&](auto pt) {
          using P = typename decltype(pt)::type;
          adamw_kernel<G, M, V, P><<<blocks, threads, 0, s>>>(t);
          return (int)cudaGetLastError();
        });
      });
    });
  });
}

const char* fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
