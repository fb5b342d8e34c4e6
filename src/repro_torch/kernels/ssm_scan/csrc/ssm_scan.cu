// The SSM layers' scan on Hopper: two kernels in one library.
//
// 1. `ssm_scan_chunk`, one chunk of the recurrence, the literal counterpart
//    of the TPU kernel (its note below). No serving path launches it since
//    the fused kernel took its place; it stays with its checks.
// 2. `selective_scan`, the fused selective scan (its note after the first).
//
// -- ssm_scan_chunk ---------------------------------------------------------
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/ssm_scan.py
// `_scan_kernel` (via `ssm_scan_chunk`, wrapper ops.py `ssm_scan_chunk`),
// whose oracle is src/repro/models/ssm.py `_scan_chunk`.
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

#include <cuda_bf16.h>
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

// -- selective_scan ---------------------------------------------------------
//
// B4 redesigned for Hopper: the whole selective scan of one SSM layer in one
// launch. It takes the place of `_scan_kernel` on the serving path
// (models/ssm.py `ssm_apply(impl="pallas")`, once per layer per prefill over
// the whole sequence, once per layer per decode step) together with what
// surrounded it there: exp(dt A), dt x B, the contraction with C and D x.
//
// What it computes, per batch row b, channel d and state n, for dt (B, S,
// d_in) float32, x (B, S, d_in) bfloat16, B and C (B, S, N) bfloat16 or
// float32, A (d_in, N) float32 (already -exp(A_log)), h0 (B, d_in, N)
// float32 and D (d_in) float32:
//   h = h0[b, d, n]
//   for t in 0 .. S-1:
//     a  = expf(dt[b,t,d] * A[d,n])
//     h  = a * h + (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//     y[b,t,d] = (((h_0 C_0 + h_1 C_1) + h_2 C_2) + ...) + D[d] * x[b,t,d]
//                (the sum in n order 0..N-1, then D x)
//   h_last[b, d, n] = h
// Every product and sum is rounded by itself (__fmul_rn, __fadd_rn, no fused
// multiply-add) and the exponential is the accurate `expf`, never `__expf`:
// the rounding order of the plain version (`selective_scan_ref`), so the two
// agree bit for bit where the card's torch.exp is this expf. It runs exactly
// S steps: no padding to chunks.
//
// What bounds it: at hymba-1.5b's prefill (B 4, S 2048, d_in 3200, N 16) a
// layer reads dt, x, B, C, A, h0 and D and writes y and h_last, about 265 MB,
// 0.079 ms at 3.35 TB/s; the (B, S, d_in, N) tensors a, bx and h never leave
// registers. What binds first is the SMs' instruction issue: each (b, t, d,
// n) costs about 15 instructions (the accurate expf is eight, one of them a
// MUFU.EX2; its 419,430,400 MUFU.EX2 alone take 0.1 ms), and with the
// prefetch, the skew's shuffle and the stores a thread at G = 4 issues about
// 130 a step. It runs at about an eighth of the byte bound (PERF.md).
//
// Design. A thread carries G-th of a channel's states, NP = N / G of them,
// in registers across all S steps; the G threads of a channel are adjacent
// lanes of a warp and a block holds kChannels channels of one batch row. G
// trades parallelism (B * d_in * G threads) against the cost of the sum over
// n, which has to run in n order: lane g adds its NP products to the partial
// sum of lane g - 1. So that this chain does not stall a step, lane g runs g
// steps behind lane 0 (a skew): at iteration i it works on step t = i - g,
// and the partial it takes from lane g - 1 by __shfl_up_sync is the one that
// lane made for the same step in iteration i - 1. Lane G - 1 writes y. The
// first and last G - 1 iterations of a lane fall outside [0, S) and run with
// dt = x = B = 0, which leaves h as it is (a = expf(-0) = 1, bx = 0).
// A tile of kTile iterations (kTile + G - 1 steps, for the skew) of B and C
// is staged in shared memory, double-buffered: all channels of the block
// read it. The next tile's B and C are loaded into registers before the
// current tile's steps and stored after them, as are each thread's dt and x
// (its own channel: the loads of a warp are coalesced rows over d), so the
// loads are in flight while the steps run. A prefetched value stays in its
// own type until it is used: a bf16 converted right after its load waits
// for it, and the tile's loads then ran one at a time (a DRAM latency a
// step). B and C are views into the x_proj output at any column offset: a
// bf16 element there may lie on a 2-byte boundary, below cp.async's 4-byte
// copies and TMA's 16-byte strides, so the staging goes through registers.
// G = 4, 32 channels a block and the register cap (kMinBlocks) are what
// measured fastest across hymba's prefill and a rank's channels on an H100
// (scripts/ssm_probe.py --variants): G = 1 leaves the prefill 400 warps, a
// scheduler of the card with one or none, and runs 1.5 times slower; G = 2
// matches G = 4 at the prefill but not at a rank's half of the channels.
//
// Layout: every input is read through its strides, without a copy; y (B, S,
// d_in) and h_last (B, d_in, N) are contiguous float32.

namespace {

constexpr int kTile = 16;
constexpr int kGroup = 4;     // G, the threads of a channel
constexpr int kChannels = 32;  // channels a block
// blocks an SM must hold at once: a cap of 128 registers a thread at G = 4,
// so that hymba's prefill (400 blocks of 128 threads) runs in one wave on
// 132 SMs
constexpr int kMinBlocks = 4;

struct ScanArgs {
  const void* dt;
  long long dt_s[3];
  const void* x;
  long long x_s[3];
  const void* B;
  long long B_s[3];
  const void* C;
  long long C_s[3];
  const void* A;
  long long A_s[2];
  const void* h0;
  long long h0_s[3];
  const void* D;
  long long D_s;
  void* y;
  void* h_last;
  long long batch, S, d_in, N;  // every field 8 bytes: the wrapper packs 31 int64
};

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T zero() { return T(0.f); }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

template <typename TBC, int N>
__global__ void __launch_bounds__(kChannels * kGroup, kMinBlocks)
selective_scan_kernel(const ScanArgs p) {
  constexpr int G = kGroup, NP = N / G;
  constexpr int R = kTile + G - 1;  // staged steps a tile: its own and the skew's
  constexpr int kThreads = kChannels * G;
  constexpr int kStage = (2 * R * N + kThreads - 1) / kThreads;
  __shared__ __align__(16) float sbc[2][2 * R * N];  // [buffer][B rows, then C rows]

  const int tid = threadIdx.x, g = tid % G;
  const int d = blockIdx.x * kChannels + tid / G;
  const int b = blockIdx.y;
  const int S = (int)p.S, d_in = (int)p.d_in;
  // a channel past d_in reads the last channel's inputs and writes nothing
  const bool live = d < d_in;
  const long long dc = live ? d : d_in - 1;
  const long long dts = p.dt_s[1], xts = p.x_s[1];
  const float* dtp = (const float*)p.dt + b * p.dt_s[0] + dc * p.dt_s[2];
  const __nv_bfloat16* xp = (const __nv_bfloat16*)p.x + b * p.x_s[0] + dc * p.x_s[2];
  const TBC* bp = (const TBC*)p.B + b * p.B_s[0];
  const TBC* cp = (const TBC*)p.C + b * p.C_s[0];

  float h[NP], A[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int n = g * NP + j;
    h[j] = ((const float*)p.h0)[b * p.h0_s[0] + dc * p.h0_s[1] + n * p.h0_s[2]];
    A[j] = ((const float*)p.A)[dc * p.A_s[0] + n * p.A_s[1]];
  }
  const float Dd = ((const float*)p.D)[dc * p.D_s];

  // tile k holds iterations k * kTile .. + kTile - 1; its staged row r is
  // step k * kTile - (G - 1) + r, zero outside [0, S). Prefetched values
  // stay in their own type until they are used: a conversion right after
  // its load would wait for it, and the loads would run one at a time.
  TBC stage[kStage];
  __nv_bfloat16 xc[kTile], xn[kTile];
  float dtc[kTile], dtn[kTile];
#define STAGE_LOAD(k)                                                              \
  _Pragma("unroll") for (int m = 0; m < kStage; ++m) {                            \
    const int idx = tid + m * kThreads, which = idx / (R * N), rem = idx % (R * N); \
    const int t = (k) * kTile - (G - 1) + rem / N, n = rem % N;                   \
    TBC v = zero<TBC>();                                                          \
    if (idx < 2 * R * N && (unsigned)t < (unsigned)S)                             \
      v = which ? cp[t * p.C_s[1] + n * p.C_s[2]] : bp[t * p.B_s[1] + n * p.B_s[2]]; \
    stage[m] = v;                                                                 \
  }
#define STAGE_STORE(buf)                                                           \
  _Pragma("unroll") for (int m = 0; m < kStage; ++m) {                            \
    const int idx = tid + m * kThreads;                                           \
    if (idx < 2 * R * N) sbc[buf][idx] = as_float(stage[m]);                      \
  }
#define DX_LOAD(k, dv, xv)                                                         \
  {                                                                               \
    const int t0 = (k) * kTile - g;                                               \
    const float* dq = dtp + t0 * dts;                                             \
    const __nv_bfloat16* xq = xp + t0 * xts;                                      \
    _Pragma("unroll") for (int u = 0; u < kTile; ++u) {                           \
      const bool in = (unsigned)(t0 + u) < (unsigned)S;                           \
      dv[u] = in ? *dq : 0.f;                                                     \
      xv[u] = in ? *xq : zero<__nv_bfloat16>();                                   \
      dq += dts;                                                                  \
      xq += xts;                                                                  \
    }                                                                             \
  }

  const int tiles = (S + G - 1 + kTile - 1) / kTile;
  STAGE_LOAD(0)
  DX_LOAD(0, dtc, xc)
  STAGE_STORE(0)
  __syncthreads();
  float* const y = (float*)p.y + (long long)b * S * d_in + d;
  float carry = 0.f;  // this lane's partial sum of the last iteration
  const bool last = live && g == G - 1;  // the lane that writes y
  for (int k = 0; k < tiles; ++k) {
    const int buf = k & 1;
    const bool more = k + 1 < tiles;
    if (more) {
      STAGE_LOAD(k + 1)
      DX_LOAD(k + 1, dtn, xn)
    }
    float* yq = y + (long long)(k * kTile - g) * d_in;
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const int t = k * kTile + u - g;
      const float* bs = sbc[buf] + (u + G - 1 - g) * N + g * NP;
      const float* cs = bs + R * N;
      const float in = G > 1 ? __shfl_up_sync(0xffffffffu, carry, 1, G) : 0.f;
      const float xf = __bfloat162float(xc[u]), dx = __fmul_rn(dtc[u], xf);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const float a = expf(__fmul_rn(dtc[u], A[j]));
        h[j] = __fadd_rn(__fmul_rn(a, h[j]), __fmul_rn(dx, bs[j]));
        const float q = __fmul_rn(h[j], cs[j]);
        s = j > 0 ? __fadd_rn(s, q) : (g > 0 ? __fadd_rn(in, q) : q);
      }
      carry = s;
      if (last && (unsigned)t < (unsigned)S) *yq = __fadd_rn(s, __fmul_rn(Dd, xf));
      yq += d_in;
    }
    if (more) {
      STAGE_STORE(buf ^ 1)
#pragma unroll
      for (int u = 0; u < kTile; ++u) {
        dtc[u] = dtn[u];
        xc[u] = xn[u];
      }
    }
    __syncthreads();
  }
#undef STAGE_LOAD
#undef STAGE_STORE
#undef DX_LOAD
  if (live) {
    float* hl = (float*)p.h_last + ((long long)b * d_in + dc) * N + g * NP;
#pragma unroll
    for (int j = 0; j < NP; ++j) hl[j] = h[j];
  }
}

template <typename TBC, int N>
int launch(const ScanArgs& p, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.d_in + kChannels - 1) / kChannels), (unsigned)p.batch);
  selective_scan_kernel<TBC, N><<<grid, kChannels * kGroup, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename TBC>
int launch_bc(const ScanArgs& p, cudaStream_t stream) {
  switch (p.N) {
    case 4: return launch<TBC, 4>(p, stream);
    case 8: return launch<TBC, 8>(p, stream);
    case 16: return launch<TBC, 16>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface for ctypes. `args` points to the ScanArgs above, 31 int64
// (strides in elements); `bc_bf16` says whether B and C are bfloat16 (else
// float32).
// Launches on `stream` and returns cudaGetLastError(). What the kernel does
// not take (N other than 4, 8 or 16, an empty shape, a batch above the
// grid's 65535 rows) returns cudaErrorInvalidValue without launching.
extern "C" int repro_selective_scan(const void* args, int bc_bf16, void* stream) {
  const ScanArgs& p = *(const ScanArgs*)args;
  if (p.batch <= 0 || p.batch > 65535 || p.S <= 0 || p.S >= (1LL << 31) || p.d_in <= 0 ||
      p.d_in >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return bc_bf16 ? launch_bc<__nv_bfloat16>(p, s) : launch_bc<float>(p, s);
}
