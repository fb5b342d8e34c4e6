// One chunk of the selective-scan recurrence of the SSM layers.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/ssm_scan.py
// `_scan_kernel` (via `ssm_scan_chunk`, wrapper ops.py `ssm_scan_chunk`),
// whose oracle is src/repro/models/ssm.py `_scan_chunk`. The serving path
// reaches it through models/ssm.py `ssm_apply(impl="pallas")`: once per chunk
// of every SSM layer in prefill, once per layer in each decode step (C = 1).
//
// What it computes, per batch row b and state lane l = d * N + n of
// a, bx (B, C, d_in, N) and h0 (B, d_in, N), all float32:
//   h        = h0[b, l]
//   for t in 0 .. C-1:  h = a[b, t, l] * h + bx[b, t, l];  h_seq[b, t, l] = h
//   h_last[b, l] = h
// The product and the sum are rounded one at a time (__fmul_rn, __fadd_rn:
// no fused multiply-add), as the plain PyTorch version and the reference's
// `a * h + bx` round them, so kernel and plain version agree bit for bit.
//
// What bounds it on an H100: bytes. Each lane and step reads a and bx and
// writes h_seq (12 bytes) for 2 flops; at the prefill chunk (B 4, C 256,
// d_in 3200, N 16) that is 630,784,000 bytes, 0.188 ms at 3.35 TB/s, against
// 105 MFLOP. The running state never leaves a register: one thread owns one
// (b, lane) for the whole chunk and walks t serially. Neighbouring threads
// own neighbouring lanes, so every step's loads and stores are coalesced
// 128-byte rows of a warp. The loop over t is unrolled by kUnroll, with the
// step's loads issued ahead of the dependent chain, so each thread has
// 2 * kUnroll loads in flight while it waits. The TPU kernel's padding of
// d_in to a tile of 256 (a VMEM artefact) is a bounds check here.
//
// Layout: a and bx are read through their batch strides with (C, d_in, N)
// contiguous, so a chunk that is a slice a[:, c*C:(c+1)*C] of a longer
// sequence needs no copy. h0, h_seq and h_last are contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ a, long long a_sb, const float* __restrict__ bx,
                long long bx_sb, const float* __restrict__ h0, float* __restrict__ h_seq,
                float* __restrict__ h_last, int C, long long lanes) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const long long b = blockIdx.y;
  const float* ap = a + b * a_sb + lane;
  const float* bp = bx + b * bx_sb + lane;
  float* hp = h_seq + b * C * lanes + lane;
  float h = h0[b * lanes + lane];
  int t = 0;
  for (; t + kUnroll <= C; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = ap[(long long)(t + u) * lanes];
      bv[u] = bp[(long long)(t + u) * lanes];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      hp[(long long)(t + u) * lanes] = h;
    }
  }
  for (; t < C; ++t) {
    h = __fadd_rn(__fmul_rn(ap[(long long)t * lanes], h), bp[(long long)t * lanes]);
    hp[(long long)t * lanes] = h;
  }
  h_last[b * lanes + lane] = h;
}

}  // namespace

// C interface for ctypes. `lanes` is d_in * N; `a_sb` and `bx_sb` are the
// batch strides of a and bx in elements. Launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and only this reports it.
// Shapes the kernel does not take (an empty one, B above the grid's 65535
// rows) return cudaErrorInvalidValue without launching.
extern "C" int repro_ssm_scan_chunk(const void* a, long long a_sb, const void* bx,
                                    long long bx_sb, const void* h0, void* h_seq,
                                    void* h_last, int B, int C, long long lanes,
                                    void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || lanes <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((lanes + kThreads - 1) / kThreads), (unsigned)B);
  ssm_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, a_sb, (const float*)bx, bx_sb, (const float*)h0, (float*)h_seq,
      (float*)h_last, C, lanes);
  return (int)cudaGetLastError();
}
