// Int8 block quantization of the compressed wire, fused with its packing.
//
// quantize_pack replaces the TPU kernel src/repro/kernels/quantize/quantize.py
// `_quant_kernel` (via `quantize_blocks`) together with the pack that
// src/repro/comm/wire.py `_fused_encode` does after it. unpack_dequant replaces
// `_dequant_kernel` (via `dequantize_blocks`) together with the unpack of
// `_fused_decode`.
//
// Packed layout, n = n_blocks * block bytes of int8 codes, then n_blocks
// little-endian float32 scales starting at byte n.
//
// Per row of `block` floats:
//   amax = max |x|
//   s    = amax > 0 ? amax * f32(1/127) : 1     (the reciprocal multiply that
//          XLA makes of `amax / 127.0` under jit; a true division differs in
//          the last bit for some rows and breaks byte parity)
//   q    = clamp(rint(x / s), -127, 127)        (a true IEEE division, rint
//          rounds half to even like jnp.round)
// __fdiv_rn and __fmul_rn keep division and product IEEE-rounded whatever the
// flags; the build sets neither --use_fast_math nor -ftz=true. The max is
// exact in any order, so the order of a reduction is free.
//
// What bounds them on an H100: bytes. quantize_pack reads 4 bytes and writes
// 1 + 4/block bytes per element, about 5·N; unpack_dequant reads 1 + 4/block
// and writes 4, again about 5·N. Both do one pass and write nothing to device
// memory but their output: the codes and scales never exist apart from the
// packed buffer. Reaching the memory rate takes enough bytes in flight and
// few, wide accesses; the arithmetic (about 20 instructions an element in
// quantize_pack, most of them the IEEE division) has to hide under it, and
// does: with a reciprocal multiply in its place, or without the scale
// stores, quantize_pack is at most 1.4% faster (scripts/quantize_probe.py).
//
// Two routes, chosen by the wrapper from the shape and the pointers alone:
//
// The vector route (quantize_pack_vec_kernel, unpack_dequant_vec_kernel) for
// blocks that are powers of two from 4 to 1024, when the float tensor and the
// packed buffer both start at a 16-byte boundary. Then every row of floats
// starts at a 16-byte boundary, every row of codes and every scale at a
// 4-byte one. A row belongs to a group of G = min(32, block/4) lanes; each
// lane holds V = block/(4G) float4 of it (block 64: 2 rows a warp, one float4
// a lane; block 256: one row, two float4 a lane). A warp takes a tile of U
// such steps (U·V = 4 float4 a lane where the block allows) and issues all
// of its loads before the first reduction; the grid has a warp for every
// tile. quantize_pack reads each row once, as 16-byte loads into registers,
// reduces the max within the group by shuffles, and stores 4 codes a lane as
// one 32-bit word (code j at byte j); the tile's scales go out as one
// contiguous run of 32-bit stores. unpack_dequant loads 4 codes a lane as one
// 32-bit word and its row's scale as one 32-bit load, and stores float4s.
// On an H100 80GB HBM3 at 700 W the route reaches 81-87% of the memory
// bound at blocks 64 and 256 (PERF.md). Measured and not kept: a persistent
// grid (as many CTAs as fit at once, warps striding over tiles) was 4-8%
// slower; streaming hints (__ldcs/__stcs) gained nothing; one step a tile
// was up to 5% slower at block 64, 8 float4 a lane up to 2%.
//
// The scalar route (quantize_pack_kernel, unpack_dequant_kernel) for every
// other block and for pointers off a 16-byte boundary: one warp per row, its
// lanes striding the row by single floats and bytes; quantize_pack reads the
// row twice (max, then codes), and the scales, which may start at any byte,
// go by bytes. At block 64 it reaches 42-48% of the bound, at block 256
// 79-84%, on the same card.
//
// unpack_dequant_sum is not a TPU kernel. It computes in one launch what the
// body of src/repro/comm/collectives.py `compressed_allgather_sum` computes
// after its all-gathers: a vmap of `dequantize_int8` over the n ranks' codes
// and scales (the Pallas `_dequant_kernel` with use_kernel=True), then
// jnp.sum over the ranks. It takes the gathered codes (n, n_blocks, block)
// int8 and scales (n, n_blocks) float32 as two tensors and writes their
// float32 sum, with no (n, N) float32 intermediate (9.9 GB per rank for n = 2
// at llama3.2-1b's gradient). The sum runs in rank order,
//   acc = q0*s0;  acc = acc + q1*s1;  ...
// with __fmul_rn and __fadd_rn, so no FMA contraction: bit-equal to n plain
// dequantizes summed in rank order. Bytes bound it: it reads n*(1 + 4/block)
// and writes 4 bytes per element. Its vector route is unpack_dequant's (the
// same lanes and tiles, one 32-bit code word and one scale load per rank
// and step, float4 stores); its scalar route is one warp per row.
//
// NaN and Inf inputs are out of scope, as in the reference's tests: fmaxf
// drops a NaN where jnp.max propagates it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kInv127 = 0x1.020408p-7f;  // f32(1/127), bit pattern 0x3c010204

__device__ __forceinline__ float scale_of(float amax) {
  return amax > 0.0f ? __fmul_rn(amax, kInv127) : 1.0f;
}

__device__ __forceinline__ int code_of(float x, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.0f), 127.0f);
}

// ---- scalar route ----------------------------------------------------------

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
    const float s = scale_of(amax);
    int8_t* __restrict__ qr = reinterpret_cast<int8_t*>(packed) + row * block;
    for (int j = lane; j < block; j += 32) qr[j] = (int8_t)code_of(xr[j], s);
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

__global__ void unpack_dequant_sum_kernel(const int8_t* __restrict__ codes,
                                          const float* __restrict__ scales,
                                          float* __restrict__ out, long long n_blocks,
                                          int block, int n) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = (long long)gridDim.x * kWarpsPerBlock;
  const long long plane = n_blocks * (long long)block;
  for (long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       row < n_blocks; row += n_warps) {
    const long long base = row * block;
    for (int j = lane; j < block; j += 32) {
      float acc = __fmul_rn((float)codes[base + j], scales[row]);
      for (int k = 1; k < n; ++k)
        acc = __fadd_rn(acc, __fmul_rn((float)codes[k * plane + base + j],
                                       scales[k * n_blocks + row]));
      out[base + j] = acc;
    }
  }
}

// One warp for each of n items (rows on the scalar route, tiles on the
// vector one), up to 2^20 CTAs; beyond that the warps stride over the items.
unsigned grid_for(long long n) {
  long long g = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return (unsigned)(g < (1LL << 20) ? g : (1LL << 20));
}

// ---- vector route ----------------------------------------------------------

// The lanes of a row and the rows of a warp's tile, for a block of BLOCK.
template <int BLOCK>
struct Tile {
  static_assert(BLOCK >= 4 && BLOCK <= 1024 && (BLOCK & (BLOCK - 1)) == 0,
                "the vector route takes powers of two from 4 to 1024");
  static constexpr int G = BLOCK / 4 < 32 ? BLOCK / 4 : 32;  // lanes of one row
  static constexpr int R = 32 / G;                             // rows of one step
  static constexpr int V = BLOCK / (4 * G);                    // float4 of a lane's row
  static constexpr int U = V >= 4 ? 1 : 4 / V;                 // steps of one tile
  static constexpr int ROWS = R * U;                           // rows of one tile
};

// 4 codes of one float4, code j in byte j of the word.
__device__ __forceinline__ unsigned pack4(float4 v, float s) {
  return ((unsigned)code_of(v.x, s) & 0xffu) | (((unsigned)code_of(v.y, s) & 0xffu) << 8) |
         (((unsigned)code_of(v.z, s) & 0xffu) << 16) | ((unsigned)code_of(v.w, s) << 24);
}

__device__ __forceinline__ float4 unpack4(unsigned w, float s) {
  return make_float4(__fmul_rn((float)(int8_t)(w), s), __fmul_rn((float)(int8_t)(w >> 8), s),
                     __fmul_rn((float)(int8_t)(w >> 16), s),
                     __fmul_rn((float)(int8_t)(w >> 24), s));
}

template <int BLOCK>
__global__ void __launch_bounds__(kThreads)
quantize_pack_vec_kernel(const float4* __restrict__ x, uint8_t* __restrict__ packed,
                         long long n_blocks) {
  using T = Tile<BLOCK>;
  const int lane = threadIdx.x & 31;
  const int g = lane / T::G, i = lane % T::G;  // the lane's row in a step, place in the row
  const long long n_tiles = (n_blocks + T::ROWS - 1) / T::ROWS;
  const long long n_warps = (long long)gridDim.x * kWarpsPerBlock;
  unsigned* __restrict__ codes = reinterpret_cast<unsigned*>(packed);
  unsigned* __restrict__ scales = reinterpret_cast<unsigned*>(packed + n_blocks * BLOCK);
  for (long long tile = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       tile < n_tiles; tile += n_warps) {
    const long long row0 = tile * T::ROWS;
    float4 v[T::U][T::V];
#pragma unroll
    for (int u = 0; u < T::U; ++u) {
      const long long row = row0 + u * T::R + g;
#pragma unroll
      for (int k = 0; k < T::V; ++k)
        v[u][k] = row < n_blocks ? x[row * (BLOCK / 4) + i + k * T::G]
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float s[T::U];
#pragma unroll
    for (int u = 0; u < T::U; ++u) {
      float amax = 0.0f;
#pragma unroll
      for (int k = 0; k < T::V; ++k)
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[u][k].x), fabsf(v[u][k].y)),
                                 fmaxf(fabsf(v[u][k].z), fabsf(v[u][k].w))));
#pragma unroll
      for (int off = T::G / 2; off > 0; off >>= 1)  // within the row's group
        amax = fmaxf(amax, __shfl_xor_sync(kFullMask, amax, off));
      s[u] = scale_of(amax);
    }
#pragma unroll
    for (int u = 0; u < T::U; ++u) {
      const long long row = row0 + u * T::R + g;
      if (row < n_blocks) {
#pragma unroll
        for (int k = 0; k < T::V; ++k)
          codes[row * (BLOCK / 4) + i + k * T::G] = pack4(v[u][k], s[u]);
      }
    }
    if constexpr (T::ROWS <= 32) {
      // lane j stores the scale of the tile's row j, which every lane of
      // group j % R holds at step j / R: one contiguous run of ROWS words
      float mine = 0.0f;
#pragma unroll
      for (int u = 0; u < T::U; ++u) {
        const float t = __shfl_sync(kFullMask, s[u], (lane % T::R) * T::G);
        if (lane / T::R == u) mine = t;
      }
      if (lane < T::ROWS && row0 + lane < n_blocks)
        scales[row0 + lane] = __float_as_uint(mine);
    } else {
      // a step's R rows, one lane each: R contiguous words per store
#pragma unroll
      for (int u = 0; u < T::U; ++u) {
        const long long row = row0 + u * T::R + g;
        if (i == 0 && row < n_blocks) scales[row] = __float_as_uint(s[u]);
      }
    }
  }
}

template <int BLOCK>
__global__ void __launch_bounds__(kThreads)
unpack_dequant_vec_kernel(const uint8_t* __restrict__ packed, float4* __restrict__ out,
                          long long n_blocks) {
  using T = Tile<BLOCK>;
  const int lane = threadIdx.x & 31;
  const int g = lane / T::G, i = lane % T::G;
  const long long n_tiles = (n_blocks + T::ROWS - 1) / T::ROWS;
  const long long n_warps = (long long)gridDim.x * kWarpsPerBlock;
  const unsigned* __restrict__ codes = reinterpret_cast<const unsigned*>(packed);
  const float* __restrict__ scales = reinterpret_cast<const float*>(packed + n_blocks * BLOCK);
  for (long long tile = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       tile < n_tiles; tile += n_warps) {
    const long long row0 = tile * T::ROWS;
    unsigned w[T::U][T::V];
    float s[T::U];
#pragma unroll
    for (int u = 0; u < T::U; ++u) {
      const long long row = row0 + u * T::R + g;
      if (row < n_blocks) {
        s[u] = scales[row];
#pragma unroll
        for (int k = 0; k < T::V; ++k) w[u][k] = codes[row * (BLOCK / 4) + i + k * T::G];
      }
    }
#pragma unroll
    for (int u = 0; u < T::U; ++u) {
      const long long row = row0 + u * T::R + g;
      if (row < n_blocks) {
#pragma unroll
        for (int k = 0; k < T::V; ++k)
          out[row * (BLOCK / 4) + i + k * T::G] = unpack4(w[u][k], s[u]);
      }
    }
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// unpack_dequant_vec_kernel's tiles, each rank's codes and scale loaded and
// added in rank order into float4 sums held in registers.
template <int BLOCK>
__global__ void __launch_bounds__(kThreads)
unpack_dequant_sum_vec_kernel(const unsigned* __restrict__ codes,
                              const float* __restrict__ scales, float4* __restrict__ out,
                              long long n_blocks, int n) {
  using T = Tile<BLOCK>;
  const int lane = threadIdx.x & 31;
  const int g = lane / T::G, i = lane % T::G;
  const long long n_tiles = (n_blocks + T::ROWS - 1) / T::ROWS;
  const long long n_warps = (long long)gridDim.x * kWarpsPerBlock;
  const long long plane = n_blocks * (BLOCK / 4);  // 32-bit code words of one rank
  for (long long tile = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       tile < n_tiles; tile += n_warps) {
    const long long row0 = tile * T::ROWS;
    float4 acc[T::U][T::V];
    for (int k = 0; k < n; ++k) {
      unsigned w[T::U][T::V];
      float s[T::U];
#pragma unroll
      for (int u = 0; u < T::U; ++u) {
        const long long row = row0 + u * T::R + g;
        if (row < n_blocks) {
          s[u] = scales[k * n_blocks + row];
#pragma unroll
          for (int v = 0; v < T::V; ++v)
            w[u][v] = codes[k * plane + row * (BLOCK / 4) + i + v * T::G];
        }
      }
#pragma unroll
      for (int u = 0; u < T::U; ++u) {
        if (row0 + u * T::R + g < n_blocks) {
#pragma unroll
          for (int v = 0; v < T::V; ++v) {
            const float4 d = unpack4(w[u][v], s[u]);
            acc[u][v] = k == 0 ? d : add4(acc[u][v], d);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < T::U; ++u) {
      const long long row = row0 + u * T::R + g;
      if (row < n_blocks) {
#pragma unroll
        for (int v = 0; v < T::V; ++v) out[row * (BLOCK / 4) + i + v * T::G] = acc[u][v];
      }
    }
  }
}

// Calls f(std::integral_constant<int, block>{}) for a block the vector
// route takes; false for any other block.
template <class F>
bool by_block(int block, F f) {
  switch (block) {
    case 4: f(std::integral_constant<int, 4>{}); return true;
    case 8: f(std::integral_constant<int, 8>{}); return true;
    case 16: f(std::integral_constant<int, 16>{}); return true;
    case 32: f(std::integral_constant<int, 32>{}); return true;
    case 64: f(std::integral_constant<int, 64>{}); return true;
    case 128: f(std::integral_constant<int, 128>{}); return true;
    case 256: f(std::integral_constant<int, 256>{}); return true;
    case 512: f(std::integral_constant<int, 512>{}); return true;
    case 1024: f(std::integral_constant<int, 1024>{}); return true;
    default: return false;
  }
}

}  // namespace

// C interface for ctypes, one entry point per kernel and route. Each
// launches on `stream` and returns cudaGetLastError(): a refused launch never
// runs, and only this reports it. The vector entry points return
// cudaErrorInvalidValue, launching nothing, for a block they do not take;
// the caller checks the pointers' alignment.
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

extern "C" int repro_quantize_pack_vec(const void* x, void* packed, long long n_blocks,
                                       int block, void* stream) {
  const bool known = by_block(block, [&](auto b) {
    constexpr int B = decltype(b)::value;
    const long long n_tiles = (n_blocks + Tile<B>::ROWS - 1) / Tile<B>::ROWS;
    quantize_pack_vec_kernel<B><<<grid_for(n_tiles), kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)x, (uint8_t*)packed, n_blocks);
  });
  return known ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

extern "C" int repro_unpack_dequant_vec(const void* packed, void* out, long long n_blocks,
                                        int block, void* stream) {
  const bool known = by_block(block, [&](auto b) {
    constexpr int B = decltype(b)::value;
    const long long n_tiles = (n_blocks + Tile<B>::ROWS - 1) / Tile<B>::ROWS;
    unpack_dequant_vec_kernel<B><<<grid_for(n_tiles), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (float4*)out, n_blocks);
  });
  return known ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// unpack_dequant_sum: codes (n, n_blocks, block) int8 and scales (n, n_blocks)
// float32 -> out (n_blocks * block) float32, the sum over the n ranks.
extern "C" int repro_unpack_dequant_sum(const void* codes, const void* scales, void* out,
                                        long long n_blocks, int block, int n,
                                        void* stream) {
  unpack_dequant_sum_kernel<<<grid_for(n_blocks), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const float*)scales, (float*)out, n_blocks, block, n);
  return (int)cudaGetLastError();
}

extern "C" int repro_unpack_dequant_sum_vec(const void* codes, const void* scales, void* out,
                                            long long n_blocks, int block, int n,
                                            void* stream) {
  const bool known = by_block(block, [&](auto b) {
    constexpr int B = decltype(b)::value;
    const long long n_tiles = (n_blocks + Tile<B>::ROWS - 1) / Tile<B>::ROWS;
    unpack_dequant_sum_vec_kernel<B><<<grid_for(n_tiles), kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)codes, (const float*)scales, (float4*)out, n_blocks, n);
  });
  return known ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}
