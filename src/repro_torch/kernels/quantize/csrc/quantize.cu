// Int8 block quantization of the compressed wire, fused with its packing.
//
// quantize_pack replaces the TPU kernel src/repro/kernels/quantize/quantize.py
// `_quant_kernel` (via `quantize_blocks`) together with the pack that
// src/repro/comm/wire.py `_fused_encode` does after it. unpack_dequant replaces
// `_dequant_kernel` (via `dequantize_blocks`) together with the unpack of
// `_fused_decode`.
//
// Packed layout, n = n_blocks * block bytes of int8 codes, then n_blocks
// little-endian float32 scales starting at byte n (n need not be a multiple
// of 4, so scales are read and written by bytes).
//
// Per row of `block` floats:
//   amax = max |x|
//   s    = amax > 0 ? amax * f32(1/127) : 1     (the reciprocal multiply that
//          XLA makes of `amax / 127.0` under jit; a true division differs in
//          the last bit for some rows and breaks byte parity)
//   q    = clamp(rint(x / s), -127, 127)        (a true IEEE division, rint
//          rounds half to even like jnp.round)
// __fdiv_rn and __fmul_rn keep division and product IEEE-rounded whatever the
// flags; the build sets neither --use_fast_math nor -ftz=true.
//
// What bounds them on an H100: bytes. quantize_pack reads 4 bytes and writes
// 1 + 4/block bytes per element, about 5·N; unpack_dequant reads 1 + 4/block
// and writes 4, again about 5·N. Both do one pass and write nothing to device
// memory but their output: the codes and scales never exist apart from the
// packed buffer. One warp owns one row; its lanes stride the row, so loads
// and stores are coalesced. quantize_pack reads its row twice (max, then
// codes); the second read hits L1/L2. Wider loads and several rows per warp
// are left for later. unpack_dequant keeps a warp per row too, with the
// row's scale read once: one thread per element, grid-strided and reading
// its scale per element, was 1.6-1.8x slower at block 256 and only about 5%
// faster at block 64 on an H100 (PERF.md).
//
// NaN and Inf inputs are out of scope, as in the reference's tests: fmaxf
// drops a NaN where jnp.max propagates it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kInv127 = 0x1.020408p-7f;  // f32(1/127), bit pattern 0x3c010204

__global__ void quantize_pack_kernel(const float* __restrict__ x,
                                     uint8_t* __restrict__ packed,
                                     long long n_blocks, int block) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = (long long)gridDim.x * kWarpsPerBlock;
  uint8_t* __restrict__ scales = packed + n_blocks * (long long)block;
  for (long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       row < n_blocks; row += n_warps) {
    const float* __restrict__ xr = x + row * block;
    float amax = 0.0f;
    for (int j = lane; j < block; j += 32) amax = fmaxf(amax, fabsf(xr[j]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(kFullMask, amax, off));
    const float s = amax > 0.0f ? __fmul_rn(amax, kInv127) : 1.0f;
    int8_t* __restrict__ qr = reinterpret_cast<int8_t*>(packed) + row * block;
    for (int j = lane; j < block; j += 32) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(xr[j], s)), -127.0f), 127.0f);
      qr[j] = (int8_t)(int)q;
    }
    if (lane == 0) {
      const unsigned bits = __float_as_uint(s);
      uint8_t* sp = scales + row * 4;
      sp[0] = (uint8_t)(bits);
      sp[1] = (uint8_t)(bits >> 8);
      sp[2] = (uint8_t)(bits >> 16);
      sp[3] = (uint8_t)(bits >> 24);
    }
  }
}

__global__ void unpack_dequant_kernel(const uint8_t* __restrict__ packed,
                                      float* __restrict__ out,
                                      long long n_blocks, int block) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = (long long)gridDim.x * kWarpsPerBlock;
  const uint8_t* __restrict__ scales = packed + n_blocks * (long long)block;
  const int8_t* __restrict__ codes = reinterpret_cast<const int8_t*>(packed);
  for (long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       row < n_blocks; row += n_warps) {
    const uint8_t* sp = scales + row * 4;
    const float s = __uint_as_float((unsigned)sp[0] | ((unsigned)sp[1] << 8) |
                                    ((unsigned)sp[2] << 16) | ((unsigned)sp[3] << 24));
    const long long base = row * block;
    for (int j = lane; j < block; j += 32)
      out[base + j] = __fmul_rn((float)codes[base + j], s);
  }
}

unsigned grid_for(long long n_blocks) {
  long long g = (n_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return (unsigned)(g < (1LL << 20) ? g : (1LL << 20));  // rows are grid-strided
}

}  // namespace

// C interface for ctypes. Each launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and only this reports it.
extern "C" int repro_quantize_pack(const void* x, void* packed, long long n_blocks,
                                   int block, void* stream) {
  quantize_pack_kernel<<<grid_for(n_blocks), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (uint8_t*)packed, n_blocks, block);
  return (int)cudaGetLastError();
}

extern "C" int repro_unpack_dequant(const void* packed, void* out, long long n_blocks,
                                    int block, void* stream) {
  unpack_dequant_kernel<<<grid_for(n_blocks), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (float*)out, n_blocks, block);
  return (int)cudaGetLastError();
}
