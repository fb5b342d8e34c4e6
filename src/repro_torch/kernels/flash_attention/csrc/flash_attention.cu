// Forward flash attention (online softmax, causal / sliding-window, GQA).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// `_fa_kernel` (via `flash_attention`, wrapper ops.py `flash_attention`), which
// the serving path reaches through models/attention.py `attention(impl="pallas")`
// in every layer's prefill.
//
// What it computes, per batch b, query head h (KV head kh = h / (H / KH)) and
// query row qpos of q (B, Sq, H, hd), against k, v (B, Skv, KH, hd):
//   s[kpos] = (q[qpos] . k[kpos]) * hd^-0.5, in float32
//   kept    = kpos < Skv && (!causal || kpos <= qpos) && (!window || qpos - kpos < window)
//   out     = sum_kpos softmax(s)[kpos] * v[kpos], cast to q's type
// The causal mask is top-left aligned: qpos and kpos both start at 0, as in
// the reference (not FlashAttention-2's bottom-right alignment). Masked scores
// are -1e30 and their p is forced to 0; l is clamped at 1e-20 before the
// divide, so a row with nothing kept gives 0. Scores, softmax and the
// accumulator are float32; inputs are bf16 or float32, read through their
// (B, S, H) strides with the head dim contiguous.
//
// Design (simple first; tensor cores, TMA and larger tiles are later work):
// one CTA per (64-row q tile, q head, batch). Each query row is owned by
// TPR = hd/32 consecutive lanes (1 for hd <= 32), each holding DPT = min(hd, 32)
// dims of q and of the accumulator in registers, plus the row's m and l; a dot
// product is reduced across the row's lanes with shuffles. K and V tiles of
// 32 keys are staged through shared memory as float32, each lane's dims in a
// slab of their own, the slabs offset by 4 floats so that the TPR lanes of a
// row read different banks. Tiles wholly above the causal diagonal or wholly
// outside the window are skipped, as the reference skips them; the q tiles
// are launched heaviest first so the causal tail does not straggle.
//
// What bounds it on an H100: operations. Causal prefill does 2*B*H*S^2*hd
// flops (about 69 GFLOP at 4 x 2048 tokens, 32 heads of 64) against about
// 84 MB of q, k, v and o, well above the card's 295 flops/byte. This kernel
// runs them on the float32 CUDA cores from shared memory, not on the tensor
// cores, so it is far from that bound: each 16-byte shared-memory load feeds
// four fused multiply-adds a lane, which holds it near a quarter of the
// float32 peak. PERF.md has its time beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  long long b, s, h;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kBlockQ * (HD > 32 ? HD / 32 : 1))
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                       int H, int group, Strides qs, Strides ks, Strides vs,
                       int causal, int has_window, long long window, float scale) {
  constexpr int DPT = HD > 32 ? 32 : HD;  // dims per thread
  constexpr int TPR = HD / DPT;           // threads per query row
  constexpr int NT = kBlockQ * TPR;
  constexpr int SLAB = kBlockK * DPT + 4;  // floats per lane-part slab
  __shared__ __align__(16) float sk[TPR * SLAB];
  __shared__ __align__(16) float sv[TPR * SLAB];

  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kh = h / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // heaviest tiles first
  const int qpos = q0 + tid / TPR;
  const bool row_ok = qpos < Sq;

  float qr[DPT], acc[DPT];
  const T* qp = q + b * qs.b + (long long)(row_ok ? qpos : 0) * qs.s + h * qs.h + part * DPT;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row_ok ? to_float(qp[i]) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  const int kend = causal ? min(Skv, q0 + kBlockQ) : Skv;
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    // wholly outside the window for every row of the tile (uniform per CTA)
    if (has_window && (long long)q0 - (k0 + kBlockK - 1) >= window) continue;
    __syncthreads();
    for (int idx = tid; idx < kBlockK * HD; idx += NT) {
      const int j = idx / HD, d = idx % HD;
      const int kpos = k0 + j;
      const int at = (d / DPT) * SLAB + j * DPT + d % DPT;
      sk[at] = kpos < Skv ? to_float(kb[(long long)kpos * ks.s + d]) : 0.0f;
      sv[at] = kpos < Skv ? to_float(vb[(long long)kpos * vs.s + d]) : 0.0f;
    }
    __syncthreads();

    const float* skp = sk + part * SLAB;
    const float* svp = sv + part * SLAB;
    // the tile's 32 dot products side by side: 32 independent chains of
    // fused multiply-adds instead of one chain per key
    float s[kBlockK];
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) s[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPT; i += 4) {
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(skp + j * DPT + i);
        s[j] = fmaf(qr[i], kk.x, s[j]);
        s[j] = fmaf(qr[i + 1], kk.y, s[j]);
        s[j] = fmaf(qr[i + 2], kk.z, s[j]);
        s[j] = fmaf(qr[i + 3], kk.w, s[j]);
      }
    }
    unsigned kept = 0;  // bit j: key k0 + j is kept for this row
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = s[j];
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) dot += __shfl_xor_sync(kFullMask, dot, off);
      const int kpos = k0 + j;
      bool ok = kpos < Skv;
      if (causal) ok = ok && kpos <= qpos;
      if (has_window) ok = ok && (long long)qpos - kpos < window;
      kept |= (unsigned)ok << j;
      s[j] = ok ? dot * scale : kNegInf;
      m_new = fmaxf(m_new, s[j]);
    }
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = (kept >> j) & 1u ? expf(s[j] - m_new) : 0.0f;
      psum += p;
#pragma unroll
      for (int i = 0; i < DPT; i += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(svp + j * DPT + i);
        acc[i] = fmaf(p, vv.x, acc[i]);
        acc[i + 1] = fmaf(p, vv.y, acc[i + 1]);
        acc[i + 2] = fmaf(p, vv.z, acc[i + 2]);
        acc[i + 3] = fmaf(p, vv.w, acc[i + 3]);
      }
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (!row_ok) return;
  const float lc = fmaxf(l, 1e-20f);
  T* op = o + (((long long)b * Sq + qpos) * H + h) * HD + part * DPT;
#pragma unroll
  for (int i = 0; i < DPT; ++i) from_float(op + i, acc[i] / lc);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int H, int KH, Strides qs, Strides ks, Strides vs, int causal, int has_window,
           long long window, float scale, cudaStream_t stream) {
  constexpr int NT = kBlockQ * (HD > 32 ? HD / 32 : 1);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T, HD><<<grid, NT, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, H, H / KH, qs, ks, vs, causal,
      has_window, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int Sq,
                int Skv, int H, int KH, Strides qs, Strides ks, Strides vs, int causal,
                int has_window, long long window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal, has_window, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal, has_window, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal, has_window, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal, has_window, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface for ctypes. `bf16` selects __nv_bfloat16 (1) or float (0) for
// q, k, v and o alike; strides are in elements, o is contiguous (B, Sq, H, hd).
// Launches on `stream` and returns cudaGetLastError(): a refused launch never
// runs, and only this reports it. A head dim other than 16, 32, 64 or 128
// returns cudaErrorInvalidValue without launching.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int bf16, int B, int Sq, int Skv, int H, int KH, int hd,
                                     long long q_sb, long long q_ss, long long q_sh,
                                     long long k_sb, long long k_ss, long long k_sh,
                                     long long v_sb, long long v_ss, long long v_sh,
                                     int causal, int has_window, long long window,
                                     float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal,
                                          has_window, window, scale, st)
              : dispatch_hd<float>(hd, q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal,
                                   has_window, window, scale, st);
}
