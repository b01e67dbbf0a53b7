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
// float32 NHWC, biases float32.
//
// float32: kernels HWIO packed back to back in one buffer. Bound on an H100:
// eddy_gan_64's widths at 10 x 64^2 do 21.4 GFLOP a call, 0.32 ms at the
// 67 TFLOP/s float32 peak outside the tensor cores; the 22 MB it must move
// take 7 us at 3.35 TB/s, so operations bind it. Design: one direct circular-convolution kernel launched per layer (the
// register-blocked FMA tile body of conv_fma.cuh, its chunks staged by
// cp.async), bias and ReLU fused, intermediates in a scratch buffer (one
// 10x64^2x128 activation is 21 MB and stays in the 50 MB L2).
//
// bf16: one implicit-GEMM kernel a layer on the tensor cores (wgmma;
// conv_mma_bf16.cuh, which states its bound and design), reading each
// layer's weights in the core-matrix layout that ml/fused_conv.py packs, and
// skipping the zero blocks of a grouped (block-diagonal) layer. It rounds at
// the twin's places: bf16 at each conv's input (the first layer's float32
// input is cast while staged), float32 bias, ReLU and sum, bf16
// intermediates, a float32 output. A one-layer chain writes the float32 sum
// plus bias, with no ReLU and no rounding.
//
// The TPU design (the whole chain resident in 100 MB of VMEM) has no
// counterpart in 227 KB of shared memory; whole-chain fusion is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "conv_fma.cuh"
#include "conv_mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

// One layer in float32: one block a work item of tile shape T
// (conv_fma.cuh), blocks ordered channel block fastest, then tile, then
// member.
template <class T>
__global__ void __launch_bounds__(pqg::THREADS, pqg::MIN_BLOCKS)
conv_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y, int H,
                int W, int cin, int cout, int relu) {
  pqg::conv_fma_nth<T>(x, w, bias, y, H, W, cin, cout, relu != 0,
                       blockIdx.x);
}

template <class T>
int launch(const float* x, const float* w, const float* b, float* y, int B,
           int H, int W, int cin, int cout, int relu, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_fma_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int id = pqg::tile_of(T::K, cout);
  const int blocks = pqg::tile_items(id, B, H, W, cout);
  conv_fma_kernel<T><<<blocks, pqg::THREADS, T::SMEM, s>>>(
      x, w, b, y, H, W, cin, cout, relu);
  return (int)cudaGetLastError();
}

int conv_layer(int K, const float* x, const float* w, const float* b, float* y,
               int B, int H, int W, int cin, int cout, int relu,
               cudaStream_t s) {
  switch (pqg::tile_of(K, cout)) {
    case pqg::T_K5_WIDE:
      return launch<pqg::K5Wide>(x, w, b, y, B, H, W, cin, cout, relu, s);
    case pqg::T_K3_WIDE:
      return launch<pqg::K3Wide>(x, w, b, y, B, H, W, cin, cout, relu, s);
    case pqg::T_K5_NARROW:
      return launch<pqg::K5Narrow>(x, w, b, y, B, H, W, cin, cout, relu, s);
    case pqg::T_K3_NARROW:
      return launch<pqg::K3Narrow>(x, w, b, y, B, H, W, cin, cout, relu, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The chain: layer i reads the float32 input (i = 0) or the scratch half
// written by layer i-1, and writes the other half, or `out` (float32) for
// the last layer. float32: meta holds (K, cin, cout) a layer and wflat the
// HWIO kernels; bf16: meta holds (K, cin, cout, groups) a layer and wflat
// the tensor-core layout.
template <typename Tc>
int run_chain(const float* x, const Tc* wflat, const float* bflat,
              const int* meta, int n_layers, float* out, Tc* scratch, int B,
              int H, int W, cudaStream_t s) {
  constexpr bool tc = std::is_same<Tc, bf16>::value;
  constexpr int stride = tc ? 4 : 3;
  size_t half = 0;
  for (int i = 0; i + 1 < n_layers; ++i)
    if ((size_t)meta[stride * i + 2] > half) half = meta[stride * i + 2];
  half *= (size_t)B * H * W;
  const Tc* src = nullptr;
  size_t woff = 0, boff = 0;
  for (int i = 0; i < n_layers; ++i) {
    const int* m = meta + stride * i;
    const int K = m[0], cin = m[1], cout = m[2], groups = tc ? m[3] : 1;
    const bool first = i == 0, last = i + 1 == n_layers;
    const Tc* w = wflat + woff;
    const float* b = bflat + boff;
    Tc* mid = scratch + (i % 2) * half;
    int err;
    if constexpr (tc) {
      using pqg_tc::conv_mma_layer;
      if (first && last)
        err = conv_mma_layer(K, x, w, b, out, B, H, W, cin, cout, groups, 0, s);
      else if (first)
        err = conv_mma_layer(K, x, w, b, mid, B, H, W, cin, cout, groups, 1, s);
      else if (last)
        err = conv_mma_layer(K, src, w, b, out, B, H, W, cin, cout, groups, 0, s);
      else
        err = conv_mma_layer(K, src, w, b, mid, B, H, W, cin, cout, groups, 1, s);
      woff += pqg_tc::packed_weight_elems(K, cin, cout, groups);
    } else {
      if (first && last)
        err = conv_layer(K, x, w, b, out, B, H, W, cin, cout, 0, s);
      else if (first)
        err = conv_layer(K, x, w, b, mid, B, H, W, cin, cout, 1, s);
      else if (last)
        err = conv_layer(K, src, w, b, out, B, H, W, cin, cout, 0, s);
      else
        err = conv_layer(K, src, w, b, mid, B, H, W, cin, cout, 1, s);
      woff += (size_t)K * K * cin * cout;
    }
    if (err != 0) return err;
    boff += cout;
    src = mid;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points run the chain on `stream`. meta, on the host, holds
// (K, cin, cout) a layer for float32 and (K, cin, cout, groups) for bf16;
// wflat holds the HWIO kernels (float32) or the tensor-core layout (bf16).
// scratch holds two activations of B*H*W*max(hidden cout) elements of the
// weights' type. The wrapper checks shapes; each returns cudaGetLastError()
// of the launches (0 = ok).
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
