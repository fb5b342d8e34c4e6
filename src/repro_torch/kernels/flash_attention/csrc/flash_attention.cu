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
// the reference (not FlashAttention-2's bottom-right alignment). Masked
// scores count as -1e30 and their p is 0; l is clamped at 1e-20 before the
// divide, so a row with nothing kept gives 0. Scores, m, l and the
// accumulator are float32; inputs are read through their (B, S, H) strides
// with the head dim contiguous. Key tiles wholly masked for every row of a
// q tile are skipped, as the reference skips them.
//
// Two routes, chosen by dtype (the served configs compute in bfloat16):
//
// bfloat16: a Hopper tensor-core kernel (`flash_attention_tc_kernel`),
// persistent: one CTA of three warpgroups per SM walks the work tiles
// (128-row q tile, head, batch), heaviest q tiles first. Warpgroup 0 is the
// producer: one thread issues TMA loads (cp.async.bulk.tensor) from 4-D
// tensor maps over (hd, heads, S, B) built from the tensors' own strides,
// with the 128-byte swizzle that wgmma reads: each work tile's Q into one of
// two buffers, then its K and V tiles through a three-stage ring of
// mbarriers (full: the bytes landed; empty: both consumers are done), on
// into the next work tile while the consumers store this one's output.
// TMA zero-fills past Skv and past the head dim, so every box is 64 columns
// wide (hd 96 takes two, the second half zeros) and the kpos < Skv mask
// still applies. Warpgroups 1 and 2 each own 64 q rows and, per key tile
// (128 keys; 64 at hd 96 and 128, whose two-box K/V ring fills shared memory):
//   - the mask, only on tiles where it can drop a pair (the ragged end of
//     Skv, the causal diagonal, the window's edge); interior tiles run
//     unmasked;
//   - the online softmax of S in registers: row max over the quad of lanes
//     that share a row, p = exp2(s * scale * log2 e - m * scale * log2 e);
//   - P rounded to bf16 in place: the accumulator layout of one wgmma is the
//     register-A layout of the next, so O += P.V runs as wgmma m64n64k16
//     with A from registers and V MN-major from shared memory, transposed by
//     the instruction, with no transpose in memory, once per 64-column box
//     (at hd 96 the second box's last 32 columns are zeros: a quarter of
//     P.V's products spent on padding, and never stored);
//   - issued with it, the next tile's S = Q.K^T (wgmma m64n128k16, m64n64k16
//     at hd 96 and 128; Q and K both K-major, only the hd/16 steps that are
//     not padding: 6 at hd 96), and one wait for both.
// Then o = O / max(l, 1e-20), stored in 4-byte pairs, rows past Sq and
// columns past hd not written. Every wgmma sits on a path all consumers
// take (one under a branch makes ptxas serialise them all), and an
// mbarrier wait that never ends traps rather than hangs. The one numeric
// change against the plain version: the tensor cores take P in bf16, so p
// is rounded before P.V while l sums the float32 p (as the port's dense
// path casts its softmax weights to bf16 before w @ v); the kernel agrees
// with the plain float32 function within atol = rtol = 1e-2.
//
// float32: the SIMT kernel on the float32 CUDA cores (no tensor-core mode
// meets its 2e-5 tolerance: TF32 keeps 10 mantissa bits). One CTA per
// (64-row q tile, q head, batch); each query row is owned by TPR
// consecutive lanes, the least power of two (1, 2 or 4) that leaves each
// lane at most 32 dims, so that the xor shuffles of a dot product stay
// inside the row's lane group: hd 16 and 32 take 1 lane, 64 two of 32 dims,
// 128 four of 32, and 96 four of DPT = 24 (three lanes of 32 would not tile
// a warp). Each lane holds its DPT dims of q and of the accumulator in
// registers; K and V tiles of 32 keys are staged through shared memory as
// float32.
//
// What bounds it on an H100: operations. Causal prefill at llama3.2-1b's
// shape (4 x 2048 tokens, 32 heads over 8 KV heads of 64) does 68,753,031,168
// flops against 83,886,080 bytes of q, k, v and o: 820 flops a byte, far
// above the card's 295, so the bound is the 989 TFLOP/s of the bf16 tensor
// cores, 0.0695 ms. The tensor-core route reaches about a third of it
// (PERF.md has the times). Probes on an H100 that each removed one part
// (PERF.md) found no single limit: without any wgmma it ran 15% faster,
// without the exp2 11%, with half the K/V loads no faster. Per tile, each
// warpgroup's softmax (dependent max, exp2, sum and pack steps over 64
// scores a thread) waits for its S, and its next S for the softmax; a
// second S accumulator that overlaps them, part of the exp2 on the FMA
// units, and output staged through shared memory are the next steps.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// float32 route: the SIMT kernel on the float32 CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }

struct Strides {
  long long b, s, h;
};

// The SIMT route's split of a query row over lanes (the head note).
template <int HD>
struct Simt {
  static constexpr int TPR = HD <= 32 ? 1 : HD <= 64 ? 2 : 4;  // threads per query row
  static constexpr int DPT = HD / TPR;                           // dims per thread
  static constexpr int NT = kBlockQ * TPR;
  static_assert(DPT * TPR == HD && DPT % 4 == 0 && DPT <= 32, "unsupported head dim");
};

template <typename T, int HD>
__global__ void __launch_bounds__(Simt<HD>::NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                       int H, int group, Strides qs, Strides ks, Strides vs,
                       int causal, int has_window, long long window, float scale) {
  constexpr int DPT = Simt<HD>::DPT;
  constexpr int TPR = Simt<HD>::TPR;
  constexpr int NT = Simt<HD>::NT;
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
  constexpr int NT = Simt<HD>::NT;
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
    case 96: return launch<T, 96>(q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal, has_window, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal, has_window, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 route: tensor cores (wgmma) fed by TMA through an mbarrier ring.
// ---------------------------------------------------------------------------

constexpr int kTcBlockQ = 128;  // q rows per CTA: two consumer warpgroups of 64
constexpr int kStages = 3;      // K+V tiles in flight
constexpr int kTcThreads = 384; // producer warpgroup + two consumer warpgroups
constexpr int kRowBytes = 128;  // one 128-byte swizzle row: 64 bf16 of the head dim
constexpr float kLog2e = 1.4426950408889634f;
// polls of an mbarrier before the kernel traps: a wait this long means a
// deadlock, and a trap reports it where a hang would not return
constexpr uint32_t kMaxPolls = 1u << 26;

template <int HD>
struct Tile {
  static constexpr int NH = (HD + 63) / 64;     // 64-column boxes of the head dim
  static constexpr int BK = HD > 64 ? 64 : 128;  // keys per tile
  static constexpr int QK_STEPS = HD / 16;          // k16 steps of Q.K^T (padding skipped)
  static constexpr int PV_STEPS = BK / 16;          // k16 steps of P.V
  static constexpr int Q_BYTES = NH * kTcBlockQ * kRowBytes;
  static constexpr int KV_BYTES = NH * BK * kRowBytes;  // one K or V tile
  // 1024 bytes of slack to align the base for the swizzle, then two Q
  // buffers, the K and V rings, and 4 + 2 * kStages mbarriers
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * kStages * KV_BYTES + 8 * (4 + 2 * kStages);
  static_assert(SMEM <= 232448, "over the 227 KB of shared memory a block can use");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == kMaxPolls) __trap();
  }
}

// One box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`. Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a tile in the 128-byte-swizzled layout that TMA writes:
// rows of 128 bytes, 8-row groups 1024 bytes apart. Both byte offsets are
// 1024: for a K-major operand the leading one is unused, and for the
// MN-major V tile (64 columns, one swizzle atom wide) the stride between
// 8-key groups is 1024 whichever field the hardware reads it from.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x 128, f32) (+)= A(64 x 16) . B(16 x 128), both bf16 from shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x 64, f32) (+)= A(64 x 16) . B(16 x 64), both bf16 from shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x 64, f32) (+)= A(64 x 16, bf16 from registers) . B(16 x 64, bf16
// from shared memory, MN-major: the last immediate transposes it).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// A work tile is one (128-row q tile, head, batch); w counts them heaviest q
// tile first, heads fastest, so that neighbouring tiles share K/V in L2.
struct Work {
  int q0, h, b;
  int t0, n;  // first key tile and count: keys outside them are masked for every row
};

template <int BK>
__device__ __forceinline__ Work work_tile(int w, int n_qt, int Sq, int Skv, int H, int B,
                                          int causal, int has_window, long long window) {
  Work wk;
  const int rem = w % (H * B);
  wk.q0 = (n_qt - 1 - w / (H * B)) * kTcBlockQ;
  wk.h = rem % H;
  wk.b = rem / H;
  // keys any row of the tile keeps lie in [k_lo, k_end)
  const int k_end = causal ? min(Skv, min(Sq, wk.q0 + kTcBlockQ)) : Skv;
  const long long k_lo = has_window ? max(0ll, (long long)wk.q0 - window + 1) : 0ll;
  wk.t0 = k_lo < k_end ? (int)(k_lo / BK) : 0;
  wk.n = k_lo < k_end ? (k_end + BK - 1) / BK - wk.t0 : 0;
  return wk;
}

// Persistent: one CTA per SM walks the work tiles w = blockIdx.x, + gridDim.x,
// ... Warpgroup 0 is the producer: one thread loads each work tile's Q into
// one of two buffers and its K/V tiles through the ring, running ahead into
// the next work tile while the consumers finish this one; it gives most of
// its registers to the consumers (setmaxnreg). Warpgroups 1 and 2 each own
// 64 q rows and run, per key tile: the mask (only on tiles that need it),
// the online softmax of S in registers, P rounded to bf16 in place as the A
// operand, then O += P.V and the next tile's S = Q.K^T issued together and
// waited on once; then they store the work tile's output while the next
// one's loads land.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                          int Sq, int Skv, int H, int B, int group, int causal, int has_window,
                          long long window, float scale_log2) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;  // two Q buffers
  const uint32_t sk = sq + 2 * T::Q_BYTES;
  const uint32_t sv = sk + kStages * T::KV_BYTES;
  const uint32_t q_full0 = sv + kStages * T::KV_BYTES;  // q_full[2]: a Q tile landed
  const uint32_t q_empty0 = q_full0 + 16;              // q_empty[2]: both consumers are done with it
  const uint32_t full0 = q_empty0 + 16;                // full[s]: tile s's K and V landed
  const uint32_t empty0 = full0 + 8 * kStages;         // empty[s]: both consumers are done with s
  const int n_qt = (Sq + kTcBlockQ - 1) / kTcBlockQ;
  const int n_work = n_qt * H * B;

  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) {
      mbar_init(q_full0 + 8 * j, 1);
      mbar_init(q_empty0 + 8 * j, 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // the producer needs few registers: hand them to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int it = 0;  // K/V tiles loaded so far, across work tiles
    for (int w = blockIdx.x, wt = 0; w < n_work; w += gridDim.x, ++wt) {
      const Work wk = work_tile<T::BK>(w, n_qt, Sq, Skv, H, B, causal, has_window, window);
      const int qb = wt & 1;
      if (wt >= 2) mbar_wait(q_empty0 + 8 * qb, ((wt >> 1) - 1) & 1);
      mbar_expect_tx(q_full0 + 8 * qb, T::Q_BYTES);
#pragma unroll
      for (int hh = 0; hh < T::NH; ++hh)
        tma_load_4d(sq + qb * T::Q_BYTES + hh * kTcBlockQ * kRowBytes, &tq, q_full0 + 8 * qb,
                    hh * 64, wk.h, wk.q0, wk.b);
      const int kh = wk.h / group;
      // at least one tile, which the consumers' first Q.K^T waits for even
      // when no key is kept (its result is then never used)
      for (int i = 0; i < max(wk.n, 1); ++i, ++it) {
        const int s = it % kStages;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * T::KV_BYTES);
        const int k0 = (wk.t0 + i) * T::BK;
#pragma unroll
        for (int hh = 0; hh < T::NH; ++hh) {
          const uint32_t off = s * T::KV_BYTES + hh * T::BK * kRowBytes;
          tma_load_4d(sk + off, &tk, full0 + 8 * s, hh * 64, kh, k0, wk.b);
          tma_load_4d(sv + off, &tv, full0 + 8 * s, hh * 64, kh, k0, wk.b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;  // consumer 0 or 1
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  // accumulator layout: this thread holds rows `row` and `row + 8` of the
  // q tile, and in each 8-column group j the columns 8j + cq and 8j + cq + 1
  const int row = 64 * cw + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);

  float sacc[T::BK / 2];
  float oacc[T::NH][32];
#pragma unroll
  for (int j = 0; j < T::BK / 2; ++j) sacc[j] = 0.0f;

  int it = 0;  // K/V tiles consumed so far, across work tiles
  for (int w = blockIdx.x, wt = 0; w < n_work; w += gridDim.x, ++wt) {
    const Work wk = work_tile<T::BK>(w, n_qt, Sq, Skv, H, B, causal, has_window, window);
    const uint32_t sqw = sq + (wt & 1) * T::Q_BYTES + cw * 64 * kRowBytes;
    const int wq0 = wk.q0 + 64 * cw;  // the warpgroup's first row
    const int r0 = wk.q0 + row, r1 = r0 + 8;
#pragma unroll
    for (int hh = 0; hh < T::NH; ++hh)
#pragma unroll
      for (int j = 0; j < 32; ++j) oacc[hh][j] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf;  // row max of the raw scores
    float l0 = 0.0f, l1 = 0.0f;        // this thread's share of the row sums

    // S = Q . K^T of K/V tile j into sacc (64 x BK, f32), issued, not waited on
    auto issue_qk = [&](int j) {
      const uint32_t ks = sk + (j % kStages) * T::KV_BYTES;
#pragma unroll
      for (int t = 0; t < T::QK_STEPS; ++t) {
        const uint32_t kb = (t % 4) * 32;  // k16 step within the 128-byte row
        const uint64_t da = smem_desc(sqw + (t / 4) * kTcBlockQ * kRowBytes + kb);
        const uint64_t db = smem_desc(ks + (t / 4) * T::BK * kRowBytes + kb);
        if constexpr (T::BK == 128)
          wgmma_ss_n128(sacc, da, db, t > 0);
        else
          wgmma_ss_n64(sacc, da, db, t > 0);
      }
    };

    // Every wgmma is issued on a path all consumers take (a wgmma under a
    // branch makes ptxas serialise them all): the last tile's step issues a
    // Q.K^T of a stage whose result is never read.
    mbar_wait(q_full0 + 8 * (wt & 1), (wt >> 1) & 1);
    mbar_wait(full0 + 8 * (it % kStages), (it / kStages) & 1);
    wgmma_fence();
    issue_qk(it);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    for (int i = 0; i < wk.n; ++i) {
      const int j = it + i;  // this K/V tile, counted across work tiles
      const int s = j % kStages;
      const int k0 = (wk.t0 + i) * T::BK;
      const bool more = i + 1 < wk.n;

      // the mask, only where some pair of this warpgroup's rows and the
      // tile's keys is not kept: the ragged end of Skv, the causal
      // diagonal, the window's edge
      const bool masked = k0 + T::BK > Skv || (causal && k0 + T::BK - 1 > wq0) ||
                          (has_window && (long long)(wq0 + 63) - k0 >= window);
      if (masked) {
#pragma unroll
        for (int e = 0; e < T::BK / 2; ++e) {
          const int kpos = k0 + 8 * (e / 4) + cq + (e & 1);
          const int qpos = (e & 2) ? r1 : r0;
          const bool keep = kpos < Skv && (!causal || kpos <= qpos) &&
                            (!has_window || (long long)qpos - kpos < window);
          if (!keep) sacc[e] = -INFINITY;  // p = exp2(-inf) = 0
        }
      }

      // online softmax: new row max over the quad of lanes that share a row
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int e = 0; e < T::BK / 2; ++e) {
        if (e & 2)
          mx1 = fmaxf(mx1, sacc[e]);
        else
          mx0 = fmaxf(mx0, sacc[e]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 2));
      const float corr0 = ex2((m0 - mx0) * scale_log2);
      const float corr1 = ex2((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      const float mc0 = mx0 * scale_log2, mc1 = mx1 * scale_log2;

      // p = exp2(s * scale * log2 e - m * scale * log2 e); l sums the f32
      // p, the P.V product takes p rounded to bf16, packed in the register
      // layout of wgmma's A operand, which is the accumulator's own
      uint32_t pa[T::PV_STEPS][4];
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int t = 0; t < T::PV_STEPS; ++t) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          p[e] = ex2(fmaf(sacc[8 * t + e], scale_log2, (e & 2) ? -mc1 : -mc0));
        ps0 += (p[0] + p[1]) + (p[4] + p[5]);
        ps1 += (p[2] + p[3]) + (p[6] + p[7]);
        pa[t][0] = pack_bf16(p[0], p[1]);
        pa[t][1] = pack_bf16(p[2], p[3]);
        pa[t][2] = pack_bf16(p[4], p[5]);
        pa[t][3] = pack_bf16(p[6], p[7]);
      }
      l0 = l0 * corr0 + ps0;
      l1 = l1 * corr1 + ps1;
#pragma unroll
      for (int hh = 0; hh < T::NH; ++hh)
#pragma unroll
        for (int e = 0; e < 32; ++e) oacc[hh][e] *= (e & 2) ? corr1 : corr0;

      // O += P . V (V's tile is keys x head dim, head dim contiguous:
      // MN-major), and S = Q . K^T of the next tile into sacc, which P has
      // left free
      if (more) mbar_wait(full0 + 8 * ((j + 1) % kStages), ((j + 1) / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < T::PV_STEPS; ++t)
#pragma unroll
        for (int hh = 0; hh < T::NH; ++hh)
          wgmma_rs_n64(oacc[hh], pa[t],
                       smem_desc(sv + s * T::KV_BYTES + hh * T::BK * kRowBytes + t * 16 * kRowBytes),
                       1);
      issue_qk(j + 1);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hh = 0; hh < T::NH; ++hh) fence_regs(oacc[hh]);
      fence_regs(sacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
    // release what this work tile held: a tile with no key kept its one
    // stage, and the Q buffer (every Q.K^T that read it has completed)
    __syncwarp();
    if (lane == 0) {
      if (wk.n == 0) mbar_arrive(empty0 + 8 * (it % kStages));
      mbar_arrive(q_empty0 + 8 * (wt & 1));
    }
    it += max(wk.n, 1);

    // the row sums over the quad, then o = O / max(l, 1e-20) in bf16
    l0 += __shfl_xor_sync(kFullMask, l0, 1);
    l0 += __shfl_xor_sync(kFullMask, l0, 2);
    l1 += __shfl_xor_sync(kFullMask, l1, 1);
    l1 += __shfl_xor_sync(kFullMask, l1, 2);
    const float inv0 = 1.0f / fmaxf(l0, 1e-20f), inv1 = 1.0f / fmaxf(l1, 1e-20f);
    __nv_bfloat16* o0 = o + (((long long)wk.b * Sq + r0) * H + wk.h) * HD;
    __nv_bfloat16* o1 = o + (((long long)wk.b * Sq + r1) * H + wk.h) * HD;
#pragma unroll
    for (int hh = 0; hh < T::NH; ++hh)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = hh * 64 + 8 * jj + cq;
        if (col >= HD) continue;
        if (r0 < Sq)
          *reinterpret_cast<uint32_t*>(o0 + col) =
              pack_bf16(oacc[hh][4 * jj] * inv0, oacc[hh][4 * jj + 1] * inv0);
        if (r1 < Sq)
          *reinterpret_cast<uint32_t*>(o1 + col) =
              pack_bf16(oacc[hh][4 * jj + 2] * inv1, oacc[hh][4 * jj + 3] * inv1);
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A bf16 tensor (B, S, heads, hd), head dim contiguous, as a 4-D tensor map
// over (hd, heads, S, B) with its strides; boxes of 64 head-dim columns (one
// 128-byte swizzle row, zero-filled past hd) by `rows` positions.
bool encode_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int hd, int heads, int S,
                int B, Strides st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA's rules: a 16-byte-aligned base and strides that are multiples of 16
// bytes (the wrapper checks the same and raises first).
bool tma_ok(const void* p, Strides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (st.b * 2) % 16 == 0 &&
         (st.s * 2) % 16 == 0 && (st.h * 2) % 16 == 0 && st.b > 0 && st.s > 0 && st.h > 0;
}

// The current device's SM count, asked once per device.
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return counts[dev];
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
              int H, int KH, Strides qs, Strides ks, Strides vs, int causal, int has_window,
              long long window, float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  if (!tma_ok(q, qs) || !tma_ok(k, ks) || !tma_ok(v, vs)) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv;
  if (!encode_map(enc, &mq, q, HD, H, Sq, B, qs, kTcBlockQ) ||
      !encode_map(enc, &mk, k, HD, KH, Skv, B, ks, T::BK) ||
      !encode_map(enc, &mv, v, HD, KH, Skv, B, vs, T::BK))
    return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory only after this, on each device
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long n_work = (long long)((Sq + kTcBlockQ - 1) / kTcBlockQ) * H * B;
  if (n_work > INT_MAX) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = n_work < sms ? (int)n_work : sms;  // one CTA per SM, persistent
  flash_attention_tc_kernel<HD><<<grid, kTcThreads, T::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, Sq, Skv, H, B, H / KH, causal, has_window, window,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

int dispatch_tc(int hd, const void* q, const void* k, const void* v, void* o, int B, int Sq,
                int Skv, int H, int KH, Strides qs, Strides ks, Strides vs, int causal,
                int has_window, long long window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_tc<16>(q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal, has_window, window, scale, stream);
    case 32: return launch_tc<32>(q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal, has_window, window, scale, stream);
    case 64: return launch_tc<64>(q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal, has_window, window, scale, stream);
    case 96: return launch_tc<96>(q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal, has_window, window, scale, stream);
    case 128: return launch_tc<128>(q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal, has_window, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface for ctypes. `bf16` selects the route: 1 runs the tensor-core
// kernel on __nv_bfloat16 q, k, v and o, 0 the SIMT kernel on float. Strides
// are in elements; o is contiguous (B, Sq, H, hd). Launches on `stream` and
// returns cudaGetLastError(): a refused launch never runs, and only this
// reports it. Without launching it returns cudaErrorInvalidValue for a head
// dim other than 16, 32, 64, 96 or 128, for bf16 tensors that break TMA's
// 16-byte rule or whose tensor map the driver refuses, and
// cudaErrorSymbolNotFound when the driver has no cuTensorMapEncodeTiled.
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
  return bf16 ? dispatch_tc(hd, q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal, has_window,
                            window, scale, st)
              : dispatch_hd<float>(hd, q, k, v, o, B, Sq, Skv, H, KH, qs, ks, vs, causal,
                                   has_window, window, scale, st);
}
