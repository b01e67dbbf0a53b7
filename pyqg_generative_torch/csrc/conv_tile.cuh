// The per-tile body of a circular "same" convolution, shared by K1
// (fused_conv.cu, one launch per layer) and K2 (packed_chain.cu, the whole
// chain in one cooperative launch).
//
// A block of TILE^2 threads computes one TILE x TILE tile of output pixels
// (one thread each) of one member, for CO_BLK output channels from co0. It
// stages CC input channels of the tile plus its halo, and their weights, in
// shared memory per pass, accumulates in float32 FMA, adds the bias, applies
// ReLU if asked, and stores in the output type.
//
// Types: Tin is the layer input in device memory, Tc the compute type staged
// in shared memory (float or bf16), Tout the stored output. With Tc = bf16,
// the cast at staging is the JAX twin's cast at each conv's input
// (pallas_conv.py:280, :201, :451); bf16 x bf16 products are exact in
// float32, so the sum is the twin's up to its order. Bias and ReLU stay in
// float32 (:386-388), and rounding a bf16 output when it is stored equals the
// twin's cast at the next conv's input.
//
// Layouts: `packed` false reads and writes NHWC (member stride H*W*C, pixel
// stride C); `packed` true the twin's member-packed (H*W, B*C) (member stride
// C, pixel stride B*C). Kernels are HWIO flattened: w[(tap * cin + ci) * cout
// + co] with tap = ky * K + kx.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pqg {

constexpr int TILE = 16;  // output tile edge; one thread per pixel
constexpr int CC = 8;     // input channels staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int K, int CO_BLK, typename Tc>
struct __align__(16) TileSmem {
  static constexpr int S = TILE + K - 1;  // staged edge: tile plus halo
  Tc in[CC][S][S];
  Tc w[K * K][CC][CO_BLK];
};

template <int K, int CO_BLK, typename Tin, typename Tc, typename Tout>
__device__ __forceinline__ void conv_tile(
    const Tin* __restrict__ x, const Tc* __restrict__ w,
    const float* __restrict__ bias, Tout* __restrict__ y, int B, int H,
    int W, int cin, int cout, bool relu, bool packed, int b, int tile,
    int co0, TileSmem<K, CO_BLK, Tc>& sm) {
  constexpr int R = K / 2;
  constexpr int S = TileSmem<K, CO_BLK, Tc>::S;
  constexpr int NT = TILE * TILE;

  const int tiles_x = (W + TILE - 1) / TILE;
  const int ty0 = (tile / tiles_x) * TILE;
  const int tx0 = (tile % tiles_x) * TILE;
  const int tid = threadIdx.x;
  const int ty = tid / TILE, tx = tid % TILE;
  const size_t xps = packed ? (size_t)B * cin : (size_t)cin;
  const Tin* xb = x + (packed ? (size_t)b * cin : (size_t)b * H * W * cin);
  const Tc zero = from_f32<Tc>(0.f);

  float acc[CO_BLK];
#pragma unroll
  for (int o = 0; o < CO_BLK; ++o) acc[o] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CC) {
    __syncthreads();  // the previous pass (or work item) has finished reading
    for (int i = tid; i < S * S * CC; i += NT) {
      const int c = i % CC, pix = i / CC;
      const int sy = pix / S, sx = pix % S;
      const int gy = ((ty0 + sy - R) % H + H) % H;
      const int gx = ((tx0 + sx - R) % W + W) % W;
      const int ch = c0 + c;
      sm.in[c][sy][sx] =
          ch < cin ? from_f32<Tc>(to_f32(xb[((size_t)gy * W + gx) * xps + ch]))
                   : zero;
    }
    for (int i = tid; i < K * K * CC * CO_BLK; i += NT) {
      const int o = i % CO_BLK, c = (i / CO_BLK) % CC, tap = i / (CO_BLK * CC);
      const int ch = c0 + c, co = co0 + o;
      sm.w[tap][c][o] = (ch < cin && co < cout)
                            ? w[((size_t)tap * cin + ch) * cout + co]
                            : zero;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < CC; ++c) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float v = to_f32(sm.in[c][ty + ky][tx + kx]);
          const Tc* wp = sm.w[ky * K + kx][c];
#pragma unroll
          for (int o = 0; o < CO_BLK; ++o)
            acc[o] = fmaf(v, to_f32(wp[o]), acc[o]);
        }
      }
    }
  }

  const int oy = ty0 + ty, ox = tx0 + tx;
  if (oy < H && ox < W) {
    const size_t yps = packed ? (size_t)B * cout : (size_t)cout;
    Tout* yp = y + (packed ? (size_t)b * cout : (size_t)b * H * W * cout) +
               ((size_t)oy * W + ox) * yps;
#pragma unroll
    for (int o = 0; o < CO_BLK; ++o) {
      const int co = co0 + o;
      if (co < cout) {
        const float r = acc[o] + bias[co];
        yp[co] = from_f32<Tout>(relu ? fmaxf(r, 0.f) : r);
      }
    }
  }
}

// Output channels a work item covers: 32, or 4 for a narrow output layer.
__host__ __device__ inline int co_block(int cout) { return cout > 4 ? 32 : 4; }

}  // namespace pqg
