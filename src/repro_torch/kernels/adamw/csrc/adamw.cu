// AdamW on the card in two passes a leaf: the global norm's sum of squares,
// then the clip, the moments, the step and the decay in one read and one
// write of each tensor.
//
// Not a TPU kernel: the reference (src/repro/optim/adamw.py) leaves AdamW to
// XLA, which fuses it under jit. The port's plain version is
// src/repro_torch/optim/adamw.py: `global_norm`, `clip_by_global_norm` and
// `_leaf_update`, about 27 PyTorch elementwise and reduction kernels a leaf,
// each streaming whole float32 tensors (some 216 bytes a parameter).
//
// What bounds it on an H100: bytes. The norm reads g once (4 bytes a
// parameter); the update reads g and p (float32) and m and v (bfloat16) and
// writes p, m and v (20 bytes a parameter). 24 bytes a parameter over
// 3.35 TB/s is the bound; the arithmetic, about 20 float operations an
// element, hides under it.
//
// Every tensor is taken as `rows` rows of `cols` contiguous elements, row r
// starting `ld` elements after row r - 1 (ld per tensor): a contiguous
// tensor is one row, and a ZeRO-1 block narrowed out of a contiguous
// parameter on any dim is rows of one stride. The wrapper finds the rows
// and refuses any other layout. Both kernels read and write 16 bytes at a
// time where every row of every tensor starts at a 16-byte boundary, and
// one element at a time otherwise.
//
// sumsq (one launch a leaf): each thread squares its floats and sums them in
// double (a float's square is exact in double); a block reduces its
// threads' sums by shuffles and writes one double partial; the last block
// to finish (a ticket counted with atomicAdd after a fence) sums the
// partials in block order and writes the leaf's float32 sum into its slot,
// then puts the ticket back to 0 for the next launch on the stream. The
// grid is at most the caller's `max_blocks` (one wave on the card), so the
// partials and the ticket fit one small workspace that the caller keeps.
// The result does not depend on timing; it is not bit-equal to torch.sum's
// float32 tree, which takes another order (PERF.md gives the gap: well
// inside the benchmark's grad_norm_gap).
//
// norm_scale (one launch a step): sums the parts (the leaves' slots, or the
// mesh groups' all-reduced sums) in their order, as `global_norm`'s Python
// sum does, takes the square root and the clip's scale as
// `clip_by_global_norm` computes it on the card:
//   scale = min(reciprocal(max(norm, f32(1e-12))) * f32(max_norm), 1)
// (PyTorch evaluates `max_norm / t` as `t.reciprocal() * max_norm`), NaN
// kept as torch.clamp keeps it. Nothing goes back to the host.
//
// adamw_step (one launch a leaf): eight elements a thread and step of the
// loop, as two float4 loads of g and of p and one 16-byte load of m and of
// v; a scalar tail takes the last cols % 8 elements of each row. Each
// element follows `_leaf_update` operation by operation, rounded where
// PyTorch rounds:
//   g  = g * scale                                (the clip's mul_)
//   m' = bf16(f32(b1) * m + f32(1 - b1) * g)
//   v' = bf16(f32(b2) * v + (f32(1 - b2) * g) * g)
//   step = (m' * inv_c1) / (sqrt(v' * inv_c2) + f32(eps))
//   p' = p - f32(lr) * (step + f32(wd) * p)
// `t / c` for a Python float c is `t * (1/c)` in PyTorch's CUDA division
// kernel (BinaryDivTrueKernel.cu: the reciprocal taken in float32 on the
// host), so the wrapper passes inv_c1 = f32(1) / f32(c1), and the kernel
// multiplies.
// __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn and __fsqrt_rn keep each
// operation IEEE-rounded and apart: nvcc contracts none of them into an
// FMA, so the result is bit-equal to the plain version given the same scale
// (tests/test_torch_adamw_kernel.py holds it with torch.equal).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
// adamw_step's largest grid (a grid-stride loop covers the rest)
constexpr long long kMaxStepBlocks = 1LL << 20;

struct Hyper {
  float b1, a1, b2, a2, inv_c1, inv_c2, eps, lr, wd;
};

// Row and column of unit u, `per` units a row.
__device__ __forceinline__ void locate(long long u, long long per, long long rows, long long& r,
                                       long long& c) {
  r = rows == 1 ? 0 : u / per;
  c = u - r * per;
}

// The block's sum in thread 0 (all threads must call it).
__device__ __forceinline__ double block_sum(double x, double* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sh[warp] = x;
  __syncthreads();
  x = 0.0;
  if (warp == 0) {
    x = lane < kWarps ? sh[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  }
  __syncthreads();
  return x;
}

__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const float* __restrict__ g, long long rows, long long cols, long long ld, int vec,
             double* __restrict__ partials, unsigned* __restrict__ ticket,
             float* __restrict__ out) {
  __shared__ double sh[kWarps];
  __shared__ bool last;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  double acc = 0.0;
  long long r, c;
  if (vec) {
    const long long c4 = cols >> 2, ct = cols & 3;
#pragma unroll 4
    for (long long u = tid; u < rows * c4; u += stride) {
      locate(u, c4, rows, r, c);
      const float4 x = *reinterpret_cast<const float4*>(g + r * ld + (c << 2));
      acc = fma((double)x.x, (double)x.x, acc);
      acc = fma((double)x.y, (double)x.y, acc);
      acc = fma((double)x.z, (double)x.z, acc);
      acc = fma((double)x.w, (double)x.w, acc);
    }
    for (long long u = tid; u < rows * ct; u += stride) {
      locate(u, ct, rows, r, c);
      const double x = g[r * ld + (c4 << 2) + c];
      acc = fma(x, x, acc);
    }
  } else {
    for (long long u = tid; u < rows * cols; u += stride) {
      locate(u, cols, rows, r, c);
      const double x = g[r * ld + c];
      acc = fma(x, x, acc);
    }
  }
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    double s = 0.0;
    for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) s += __ldcg(partials + j);
    s = block_sum(s, sh);
    if (threadIdx.x == 0) {
      *out = (float)s;
      *ticket = 0u;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
norm_scale_kernel(const float* __restrict__ parts, int n, float max_norm,
                  float* __restrict__ out) {
  __shared__ float buf[kThreads];
  float total = 0.0f;
  for (int base = 0; base < n; base += kThreads) {
    if (base + (int)threadIdx.x < n) buf[threadIdx.x] = parts[base + threadIdx.x];
    __syncthreads();
    if (threadIdx.x == 0) {
      const int m = min(kThreads, n - base);
      for (int k = 0; k < m; ++k) total = __fadd_rn(total, buf[k]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(total);
    out[0] = norm;
    if (max_norm > 0.0f) {
      const float c = isnan(norm) ? norm : fmaxf(norm, 1e-12f);
      const float r = __fmul_rn(__fdiv_rn(1.0f, c), max_norm);
      out[1] = isnan(r) ? r : fminf(r, 1.0f);
    }
  }
}

// One element of `_leaf_update`, g already clipped.
__device__ __forceinline__ void step_one(float& p, float g, __nv_bfloat16& m, __nv_bfloat16& v,
                                         const Hyper& h) {
  m = __float2bfloat16_rn(
      __fadd_rn(__fmul_rn(h.b1, __bfloat162float(m)), __fmul_rn(h.a1, g)));
  v = __float2bfloat16_rn(
      __fadd_rn(__fmul_rn(h.b2, __bfloat162float(v)), __fmul_rn(__fmul_rn(h.a2, g), g)));
  const float mh = __fmul_rn(__bfloat162float(m), h.inv_c1);
  const float vh = __fmul_rn(__bfloat162float(v), h.inv_c2);
  const float step = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps));
  p = __fsub_rn(p, __fmul_rn(h.lr, __fadd_rn(step, __fmul_rn(h.wd, p))));
}

struct Layout {
  long long rows, cols, lp, lg, lm, lv;  // rows, their length, each tensor's row stride
};

__device__ __forceinline__ void step_at(float* p, const float* g, __nv_bfloat16* m,
                                        __nv_bfloat16* v, long long r, long long c,
                                        const Layout& L, bool clip, float s, const Hyper& h) {
  float pj = p[r * L.lp + c];
  const float gj = clip ? __fmul_rn(g[r * L.lg + c], s) : g[r * L.lg + c];
  step_one(pj, gj, m[r * L.lm + c], v[r * L.lv + c], h);
  p[r * L.lp + c] = pj;
}

__global__ void __launch_bounds__(kThreads)
adamw_step_kernel(float* __restrict__ p, const float* __restrict__ g,
                  __nv_bfloat16* __restrict__ m, __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ scale, Layout L, int vec, Hyper h) {
  const bool clip = scale != nullptr;
  const float s = clip ? *scale : 1.0f;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long r, c;
  if (!vec) {
    for (long long u = tid; u < L.rows * L.cols; u += stride) {
      locate(u, L.cols, L.rows, r, c);
      step_at(p, g, m, v, r, c, L, clip, s, h);
    }
    return;
  }
  const long long c8 = L.cols >> 3, ct = L.cols & 7;
  for (long long u = tid; u < L.rows * c8; u += stride) {
    locate(u, c8, L.rows, r, c);
    c <<= 3;
    float4* pp = reinterpret_cast<float4*>(p + r * L.lp + c);
    const float4* gp = reinterpret_cast<const float4*>(g + r * L.lg + c);
    const float4 pa = pp[0], pb = pp[1];
    const float4 ga = gp[0], gb = gp[1];
    uint4 mw = *reinterpret_cast<const uint4*>(m + r * L.lm + c);
    uint4 vw = *reinterpret_cast<const uint4*>(v + r * L.lv + c);
    __nv_bfloat16* me = reinterpret_cast<__nv_bfloat16*>(&mw);
    __nv_bfloat16* ve = reinterpret_cast<__nv_bfloat16*>(&vw);
    float pe[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
    const float ge[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float gk = clip ? __fmul_rn(ge[k], s) : ge[k];
      step_one(pe[k], gk, me[k], ve[k], h);
    }
    pp[0] = make_float4(pe[0], pe[1], pe[2], pe[3]);
    pp[1] = make_float4(pe[4], pe[5], pe[6], pe[7]);
    *reinterpret_cast<uint4*>(m + r * L.lm + c) = mw;
    *reinterpret_cast<uint4*>(v + r * L.lv + c) = vw;
  }
  for (long long u = tid; u < L.rows * ct; u += stride) {  // each row's last cols % 8
    locate(u, ct, L.rows, r, c);
    step_at(p, g, m, v, r, (c8 << 3) + c, L, clip, s, h);
  }
}

inline unsigned grid_for(long long units, long long cap) {
  const long long blocks = (units + kThreads - 1) / kThreads;
  return (unsigned)(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

// Whether every row of a tensor starts at a 16-byte boundary.
inline bool rows_aligned(const void* x, long long rows, long long ld, int elem_bytes) {
  return ((uintptr_t)x & 15u) == 0 && (rows == 1 || (ld * elem_bytes) % 16 == 0);
}

}  // namespace

// C interface for ctypes. Each entry point launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and only this reports it.

// g: rows x cols float32, row stride ld (any alignment); work: max_blocks
// doubles then the ticket, zeroed before the first launch (each launch
// leaves its ticket at 0); out: the leaf's float32 slot.
extern "C" int repro_sumsq(const void* g, long long rows, long long cols, long long ld,
                           void* work, int max_blocks, void* out, void* stream) {
  const int vec = rows_aligned(g, rows, ld, 4);
  double* partials = (double*)work;
  unsigned* ticket = (unsigned*)(partials + max_blocks);
  sumsq_kernel<<<grid_for((rows * cols + 15) / 16, max_blocks), kThreads, 0,
                 (cudaStream_t)stream>>>((const float*)g, rows, cols, ld, vec, partials, ticket,
                                         (float*)out);
  return (int)cudaGetLastError();
}

// parts: n float32; out: [norm, scale] float32 (scale written only when
// max_norm > 0).
extern "C" int repro_norm_scale(const void* parts, int n, float max_norm, void* out,
                                void* stream) {
  norm_scale_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>((const float*)parts, n, max_norm,
                                                              (float*)out);
  return (int)cudaGetLastError();
}

// p, g: float32; m, v: bfloat16; each rows x cols with its own row stride
// (lp, lg, lm, lv), at any alignment. scale: one float32 on the device, or
// null for no clip.
extern "C" int repro_adamw_step(void* p, const void* g, void* m, void* v, const void* scale,
                                long long rows, long long cols, long long lp, long long lg,
                                long long lm, long long lv, float b1, float a1, float b2,
                                float a2, float inv_c1, float inv_c2, float eps, float lr,
                                float wd, void* stream) {
  const Hyper h{b1, a1, b2, a2, inv_c1, inv_c2, eps, lr, wd};
  const Layout L{rows, cols, lp, lg, lm, lv};
  const int vec = rows_aligned(p, rows, lp, 4) && rows_aligned(g, rows, lg, 4) &&
                  rows_aligned(m, rows, lm, 2) && rows_aligned(v, rows, lv, 2);
  adamw_step_kernel<<<grid_for(vec ? rows * (cols >> 3) : rows * cols, kMaxStepBlocks),
                      kThreads, 0, (cudaStream_t)stream>>>(
      (float*)p, (const float*)g, (__nv_bfloat16*)m, (__nv_bfloat16*)v, (const float*)scale, L,
      vec, h);
  return (int)cudaGetLastError();
}
