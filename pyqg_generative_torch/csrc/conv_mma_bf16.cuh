// K1-bf16's layer kernel: a circular "same" convolution as an implicit GEMM
// on Hopper's tensor cores (wgmma), with the zero blocks of a block-diagonal
// (grouped) layer skipped. Used by fused_conv.cu for every layer of the bf16
// chain; K1 in float32 and K2 run the FMA tile body of conv_fma.cuh.
//
// What it computes, per layer: y = conv(bf16(x), bf16(w)) + b, summed in
// float32, ReLU if asked, stored as bf16 (a hidden layer) or float32 (the
// last), NHWC. This is the function of the twin's Pallas kernel at
// compute_dtype=bfloat16 (pyqg_generative_tpu/ml/pallas_conv.py::_fused_call,
// variants dxf/dxb). A layer of G groups computes output channels
// [g*cout/G, (g+1)*cout/G) from input channels [g*cin/G, (g+1)*cin/G) only:
// the weights outside those diagonal blocks are exact zeros (the merged GZ
// mean/variance pair), so skipping them changes no bit of the float32 sum.
//
// Bound on an H100: path 2's merged pair (10 x 64^2, 256 -> 128 -> 64 ... -> 4
// channels in 2 groups) does 42.7 GFLOP on nonzero weights a chain call,
// 0.043 ms at the 989 TFLOP/s dense bf16 peak; it moves about 44 MB, 13 us at
// 3.35 TB/s, so operations bind it. Conv_1 (5x5, 128 -> 64 a group) is 34 us
// of that bound.
//
// Design. A block of two warpgroups computes RB = 4 output rows of one
// member, one chunk of 64 consecutive x (one wgmma M = 64; at W = 64 a whole
// row; lanes x >= W are computed and not stored), for N output channels of
// one group (N = 8, 16, 32 or 64; a ragged group is padded with zero
// weights). It walks the group's input channels in chunks of KC = 16, one
// wgmma k-step:
// - the chunk's input rows (RB + K - 1, circular) with a circular halo of
//   K/2 columns each side are staged in bf16 in shared memory as
//   [8-channel group][row][x][8 channels], so 8 consecutive pixels x 8
//   channels form one contiguous 128-byte core matrix; bf16 input comes in by
//   cp.async, float32 input (the chain's first layer) is cast while staging
//   through registers;
// - the chunk's weights for all K^2 taps, which the host packed into the
//   same core-matrix order ([tap][8-channel half][n][8 channels]), come in
//   by cp.async;
// - the A operand of tap (ky, kx) for output row r is the staged tile with
//   its start shifted by ((r + ky) * SX + kx) * 16 bytes: in wgmma's
//   no-swizzle K-major descriptor that is a change of base address only
//   (LBO = the stride between 8-channel groups, SBO = 128 B), so all K^2
//   taps read one staged tile with no copy per tap.
// Each warpgroup keeps 2 rows of 64 x N float32 accumulators in registers.
// Chunks are double-buffered: the next chunk's loads are issued while the
// tensor cores run this chunk's K^2 * 2 wgmmas. The epilogue adds the
// float32 bias, applies ReLU if asked and stores. No atomics: the sum order
// is fixed, so a call is deterministic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace pqg_tc {

using bf16 = __nv_bfloat16;

constexpr int M_TILE = 64;  // pixels of one wgmma (one x-chunk of a row)
constexpr int KC = 16;      // input channels a chunk (one wgmma k-step)
constexpr int WGS = 2;      // warpgroups a block
constexpr int ROWS = 2;     // output rows a warpgroup
constexpr int RB = WGS * ROWS;
constexpr int THREADS = 128 * WGS;

// Output channels a block computes for a group of `cout_g`.
__host__ __device__ inline int n_tile(int cout_g) {
  return cout_g <= 8 ? 8 : cout_g <= 16 ? 16 : cout_g <= 32 ? 32 : 64;
}

// bf16 elements of one layer's packed weights: per (group, n-tile, chunk),
// K^2 taps of 2 x N x 8 (the host's layout, ml/fused_conv.py).
__host__ inline size_t packed_weight_elems(int K, int cin, int cout,
                                           int groups) {
  const int cin_g = cin / groups, cout_g = cout / groups, N = n_tile(cout_g);
  return (size_t)groups * ((cout_g + N - 1) / N) * ((cin_g + KC - 1) / KC) *
         K * K * N * KC;
}

template <int K, int N>
struct Geo {
  static constexpr int SR = RB + K - 1;      // staged rows
  static constexpr int SX = M_TILE + K - 1;  // staged columns
  static constexpr int IN = 2 * SR * SX * 8;  // bf16 of one input buffer
  static constexpr int WC = K * K * N * KC;   // bf16 of one weight buffer
  static constexpr int SMEM = 2 * (IN + WC) * 2;  // bytes, double-buffered
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset (K direction), stride byte offset (M/N direction), all >> 4.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Shared-memory writes of this thread (st.shared, cp.async) made visible to
// the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// Orders the accumulator registers against the wgmma fences and waits.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, float32, registers) += A (64 x 16) * B (16 x N), bf16 operands
// in shared memory, both K-major.
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b));
}

__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b));
}


template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b) {
  if constexpr (N == 8) wgmma_n8(d, a, b);
  else if constexpr (N == 16) wgmma_n16(d, a, b);
  else if constexpr (N == 32) wgmma_n32(d, a, b);
  else wgmma_n64(d, a, b);
}

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 8 channels from `src` (the first `valid` of them real, the rest zero),
// rounded to bf16 and packed into 16 bytes.
template <typename Tin>
__device__ __forceinline__ uint4 load8_bf16(const Tin* __restrict__ src,
                                            int valid, bool vec) {
  float v[8];
  if constexpr (std::is_same<Tin, float>::value) {
    if (vec && valid >= 8) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(src));
      const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
      return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y),
                        pack2(b.z, b.w));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = k < valid ? src[k] : 0.f;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = k < valid ? __bfloat162float(src[k]) : 0.f;
  }
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// Stage chunk `c0` (channels c0 .. c0+15 of the group) of the input rows
// y0 - K/2 .. y0 + RB + K/2 - 1 and columns x0 - K/2 .. x0 + 64 + K/2 - 1,
// circular, into `buf` as [8-channel group][row][x][8]. Unit u enumerates
// that layout, 16 bytes each.
template <int K, typename Tin>
__device__ __forceinline__ void stage_input(const Tin* __restrict__ xb,
                                            bf16* buf, int H, int W,
                                            int cin, int ch0, int cin_g,
                                            int c0, int y0, int x0,
                                            bool vec) {
  constexpr int R = K / 2, SR = RB + K - 1, SX = M_TILE + K - 1;
  constexpr int UNITS = 2 * SR * SX;
#pragma unroll 4
  for (int u = threadIdx.x; u < UNITS; u += THREADS) {
    const int cg = u / (SR * SX), rem = u % (SR * SX);
    const int sy = rem / SX, sx = rem % SX;
    const int gy = wrap(y0 + sy - R, H), gx = wrap(x0 + sx - R, W);
    const int ch = c0 + cg * 8;  // within the group
    const int valid = min(8, cin_g - ch);
    const Tin* src = xb + ((size_t)gy * W + gx) * cin + ch0 + ch;
    bf16* dst = buf + (size_t)u * 8;
    if constexpr (std::is_same<Tin, bf16>::value) {
      if (vec) {  // whole 8-channel groups, 16-byte aligned
        cp_async16(dst, valid > 0 ? (const void*)src : (const void*)xb,
                   valid > 0 ? 16 : 0);
        continue;
      }
    }
    *reinterpret_cast<uint4*>(dst) = load8_bf16(src, valid, vec);
  }
}

// One layer. Grid: x = x-chunks * row blocks, y = groups * n-tiles, z =
// members; THREADS threads; Geo<K, N>::SMEM bytes of dynamic shared memory.
// w: this layer's packed weights; x, y: NHWC with cin / cout channels.
template <int K, int N, typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS, 1)
conv_mma_kernel(const Tin* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ bias, Tout* __restrict__ y, int H,
                int W, int cin, int cout, int groups, int relu) {
  using G = Geo<K, N>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* in_buf = reinterpret_cast<bf16*>(smem);
  bf16* w_buf = in_buf + 2 * G::IN;

  const int cin_g = cin / groups, cout_g = cout / groups;
  const int ntiles = (cout_g + N - 1) / N, nchunks = (cin_g + KC - 1) / KC;
  const int xchunks = (W + M_TILE - 1) / M_TILE;
  const int x0 = (blockIdx.x % xchunks) * M_TILE;
  const int y0 = (blockIdx.x / xchunks) * RB;
  const int g = blockIdx.y / ntiles, t = blockIdx.y % ntiles, b = blockIdx.z;
  const Tin* xb = x + (size_t)b * H * W * cin;
  const bf16* wb = w + (size_t)(g * ntiles + t) * nchunks * G::WC;
  const bool vec = cin_g % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;

  auto stage = [&](int c, int s) {
    stage_input<K>(xb, in_buf + s * G::IN, H, W, cin, g * cin_g, cin_g,
                   c * KC, y0, x0, vec);
    const bf16* src = wb + (size_t)c * G::WC;
    bf16* dst = w_buf + s * G::WC;
    for (int u = threadIdx.x; u < G::WC / 8; u += THREADS)
      cp_async16(dst + u * 8, src + u * 8, 16);
    cp_async_commit();
  };

  float acc[ROWS][N / 2];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[r][i] = 0.f;
    fence_regs(acc[r]);
  }
  const int wg = threadIdx.x / 128;

  stage(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // chunk c staged; every warpgroup is done with c - 1
    const uint32_t a0 = smem_addr(in_buf + (c & 1) * G::IN);
    const uint32_t b0 = smem_addr(w_buf + (c & 1) * G::WC);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < K * K; ++tap) {
      const int ky = tap / K, kx = tap % K;
      const uint64_t db = make_desc(b0 + tap * N * KC * 2, N * 16, 128);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const uint64_t da = make_desc(
            a0 + ((wg * ROWS + r + ky) * G::SX + kx) * 16,
            G::SR * G::SX * 16, 128);
        wgmma<N>(acc[r], da, db);
      }
    }
    wgmma_commit();
    if (c + 1 < nchunks) stage(c + 1, (c + 1) & 1);
    wgmma_wait_all();
#pragma unroll
    for (int r = 0; r < ROWS; ++r) fence_regs(acc[r]);
  }

  // Epilogue. Accumulator layout of m64nNk16: thread l of warp q holds rows
  // 16q + l/4 (+ 8), columns 8j + 2(l%4) (+ 1), in d[4j + 2i + e].
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int oy = y0 + wg * ROWS + r;
    if (oy >= H) continue;
    Tout* yrow = y + ((size_t)(b * H + oy) * W) * cout + g * cout_g;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ox = x0 + warp * 16 + lane / 4 + 8 * i;
      if (ox >= W) continue;
      Tout* yp = yrow + (size_t)ox * cout;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = t * N + 8 * j + 2 * (lane % 4) + e;
          if (n < cout_g) {
            float v = acc[r][4 * j + 2 * i + e] + bias[g * cout_g + n];
            if (relu) v = fmaxf(v, 0.f);
            if constexpr (std::is_same<Tout, float>::value) yp[n] = v;
            else yp[n] = __float2bfloat16_rn(v);
          }
        }
      }
    }
  }
}

template <int K, int N, typename Tin, typename Tout>
int launch_layer(const Tin* x, const bf16* w, const float* b, Tout* y, int B,
                 int H, int W, int cin, int cout, int groups, int relu,
                 cudaStream_t s) {
  using G = Geo<K, N>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_mma_kernel<K, N, Tin, Tout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int cout_g = cout / groups;
  const dim3 grid(((W + M_TILE - 1) / M_TILE) * ((H + RB - 1) / RB),
                  groups * ((cout_g + N - 1) / N), B);
  conv_mma_kernel<K, N, Tin, Tout><<<grid, THREADS, G::SMEM, s>>>(
      x, w, b, y, H, W, cin, cout, groups, relu);
  return (int)cudaGetLastError();
}

template <int K, typename Tin, typename Tout>
int layer_n(int N, const Tin* x, const bf16* w, const float* b, Tout* y,
            int B, int H, int W, int cin, int cout, int groups, int relu,
            cudaStream_t s) {
  switch (N) {
    case 8: return launch_layer<K, 8>(x, w, b, y, B, H, W, cin, cout, groups, relu, s);
    case 16: return launch_layer<K, 16>(x, w, b, y, B, H, W, cin, cout, groups, relu, s);
    case 32: return launch_layer<K, 32>(x, w, b, y, B, H, W, cin, cout, groups, relu, s);
    default: return launch_layer<K, 64>(x, w, b, y, B, H, W, cin, cout, groups, relu, s);
  }
}

// One layer of `groups` groups on the tensor cores; cudaErrorInvalidValue
// for a kernel size other than 3 or 5 or groups that do not divide the
// widths.
template <typename Tin, typename Tout>
int conv_mma_layer(int K, const Tin* x, const bf16* w, const float* b,
                   Tout* y, int B, int H, int W, int cin, int cout,
                   int groups, int relu, cudaStream_t s) {
  if (groups < 1 || cin % groups || cout % groups)
    return (int)cudaErrorInvalidValue;
  const int N = n_tile(cout / groups);
  if (K == 5) return layer_n<5>(N, x, w, b, y, B, H, W, cin, cout, groups, relu, s);
  if (K == 3) return layer_n<3>(N, x, w, b, y, B, H, W, cin, cout, groups, relu, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace pqg_tc
