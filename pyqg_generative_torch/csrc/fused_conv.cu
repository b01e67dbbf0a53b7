// K1: the BatchNorm-folded closure CNN, layers Conv_1..Conv_n, in float32
// (k1_fused_cnn_forward_f32) and with bf16 matmul inputs
// (k1_fused_cnn_forward_bf16).
//
// Replaces pyqg_generative_tpu/ml/pallas_conv.py::_fused_call (body
// _make_kernel), the Pallas kernel of the online closure step, in all its
// per-member variants: "dx" (_conv_dx), "tap" (_conv_out), "dxf" (_conv_dxf)
// and "dxb" (_conv_dxb) compute one function and differ only in how a TPU
// rolls its vectors. Per member it runs a chain of circular "same"
// convolutions, bias on every layer, ReLU on all but the last, with float32
// accumulation: in (B, H, W, Cin0) float32 NHWC, out (B, H, W, Cout_last)
// float32 NHWC, kernels HWIO packed back to back in one buffer (float32 or
// bf16), biases float32.
//
// Bound on an H100 (the FLOP counts follow from the weight shapes):
// - float32, eddy_gan_64 widths at 10 x 64^2: 21.4 GFLOP a call, 0.32 ms at
//   the 67 TFLOP/s float32 peak outside the tensor cores; the 22 MB it must
//   move take 7 us at 3.35 TB/s, so it is bound by operations;
// - bf16, the merged GZ mean/variance pair (256/128/64 channels) at
//   10 x 64^2: 85.4 GFLOP a call (half of it on the zero blocks of the
//   block-diagonal weights), 0.086 ms at 989 TFLOP/s dense bf16; the 44 MB
//   it moves take 13 us, so again operations bind it.
//
// Design, simple and exact first: one direct circular-convolution kernel
// launched per layer (the tile body in conv_tile.cuh), bias and ReLU fused,
// intermediates in a scratch buffer (one 10x64^2x128 activation is 21 MB in
// float32, 10 MB in bf16, and stays in the 50 MB L2). In bf16 the kernel
// stages bf16 in shared memory and stores bf16 intermediates, which halves
// the scratch bytes, but still multiplies on the float32 FMA units. The TPU
// design (the whole chain resident in 100 MB of VMEM) has no counterpart in
// 227 KB of shared memory. Whole-chain fusion with an 8-cell halo, implicit
// GEMM on the tensor cores (wgmma at bf16) and skipping the merged pair's
// zero blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_tile.cuh"

namespace {

using pqg::TILE;
using bf16 = __nv_bfloat16;

template <int K, int CO_BLK, typename Tin, typename Tc, typename Tout>
__global__ void __launch_bounds__(TILE * TILE)
conv_circular_kernel(const Tin* __restrict__ x, const Tc* __restrict__ w,
                     const float* __restrict__ bias, Tout* __restrict__ y,
                     int H, int W, int cin, int cout, int relu) {
  __shared__ pqg::TileSmem<K, CO_BLK, Tc> sm;
  pqg::conv_tile<K, CO_BLK>(x, w, bias, y, gridDim.z, H, W, cin, cout,
                            relu != 0, false, blockIdx.z, blockIdx.x,
                            blockIdx.y * CO_BLK, sm);
}

template <int K, int CO_BLK, typename Tin, typename Tc, typename Tout>
void launch(const Tin* x, const Tc* w, const float* b, Tout* y, int B, int H,
            int W, int cin, int cout, int relu, cudaStream_t s) {
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  const dim3 grid(tiles, (cout + CO_BLK - 1) / CO_BLK, B);
  conv_circular_kernel<K, CO_BLK, Tin, Tc, Tout>
      <<<grid, TILE * TILE, 0, s>>>(x, w, b, y, H, W, cin, cout, relu);
}

template <typename Tin, typename Tc, typename Tout>
int conv_layer(int K, const Tin* x, const Tc* w, const float* b, Tout* y,
               int B, int H, int W, int cin, int cout, int relu,
               cudaStream_t s) {
  const bool wide = pqg::co_block(cout) == 32;
  if (K == 5 && wide) launch<5, 32>(x, w, b, y, B, H, W, cin, cout, relu, s);
  else if (K == 5) launch<5, 4>(x, w, b, y, B, H, W, cin, cout, relu, s);
  else if (K == 3 && wide) launch<3, 32>(x, w, b, y, B, H, W, cin, cout, relu, s);
  else if (K == 3) launch<3, 4>(x, w, b, y, B, H, W, cin, cout, relu, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The chain: layer i reads the float32 input (i = 0) or the scratch half
// written by layer i-1, and writes the other half, or `out` (float32) for
// the last layer.
template <typename Tc>
int run_chain(const float* x, const Tc* wflat, const float* bflat,
              const int* meta, int n_layers, float* out, Tc* scratch, int B,
              int H, int W, cudaStream_t s) {
  size_t half = 0;
  for (int i = 0; i + 1 < n_layers; ++i)
    if ((size_t)meta[3 * i + 2] > half) half = meta[3 * i + 2];
  half *= (size_t)B * H * W;
  const Tc* src = nullptr;
  size_t woff = 0, boff = 0;
  for (int i = 0; i < n_layers; ++i) {
    const int K = meta[3 * i], cin = meta[3 * i + 1], cout = meta[3 * i + 2];
    const bool first = i == 0, last = i + 1 == n_layers;
    const Tc* w = wflat + woff;
    const float* b = bflat + boff;
    Tc* mid = scratch + (i % 2) * half;
    int err;
    if (first && last)
      err = conv_layer(K, x, w, b, out, B, H, W, cin, cout, 0, s);
    else if (first)
      err = conv_layer(K, x, w, b, mid, B, H, W, cin, cout, 1, s);
    else if (last)
      err = conv_layer(K, src, w, b, out, B, H, W, cin, cout, 0, s);
    else
      err = conv_layer(K, src, w, b, mid, B, H, W, cin, cout, 1, s);
    if (err != 0) return err;
    woff += (size_t)K * K * cin * cout;
    boff += cout;
    src = mid;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points run the chain on `stream`. meta holds (K, cin, cout) per
// layer, on the host. scratch holds two activations of B*H*W*max(hidden
// cout) elements of the weights' type. The wrapper checks shapes; each
// returns cudaGetLastError() of the launches (0 = ok).
extern "C" int k1_fused_cnn_forward_f32(const float* x, const float* wflat,
                                        const float* bflat, const int* meta,
                                        int n_layers, float* out,
                                        float* scratch, int B, int H, int W,
                                        void* stream) {
  return run_chain(x, wflat, bflat, meta, n_layers, out, scratch, B, H, W,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int k1_fused_cnn_forward_bf16(const float* x, const bf16* wflat,
                                         const float* bflat, const int* meta,
                                         int n_layers, float* out,
                                         bf16* scratch, int B, int H, int W,
                                         void* stream) {
  return run_chain(x, wflat, bflat, meta, n_layers, out, scratch, B, H, W,
                   static_cast<cudaStream_t>(stream));
}
