// K1: the BatchNorm-folded closure CNN, layers Conv_1..Conv_n, in float32.
//
// Replaces pyqg_generative_tpu/ml/pallas_conv.py::_fused_call (body
// _make_kernel, variant "dx" = _conv_dx), the Pallas kernel of the online
// closure step. Per member it runs a chain of circular "same" convolutions,
// bias on every layer, ReLU on all but the last, with float32 accumulation:
// in (B, H, W, Cin0) NHWC, out (B, H, W, Cout_last) NHWC, kernels HWIO (the
// flax layout) packed back to back in one buffer, biases likewise.
//
// Bound on an H100 at the main path's shapes (10 members, 64^2, eddy_gan_64):
// 2.136 GFLOP per member-step (Conv_1 alone 1.678), 21.4 GFLOP a call, which
// at the 67 TFLOP/s float32 peak outside the tensor cores is 0.32 ms; the
// bytes (22 MB: the 128-channel input, the weights and the output) take
// 7 us at 3.35 TB/s. So the kernel is bound by operations.
//
// Design, simple and exact first: one direct circular-convolution kernel
// launched per layer, bias and ReLU fused, intermediates in a scratch buffer
// (one 10x64^2x64 float32 activation is 10 MB and stays in the 50 MB L2).
// A block computes a 16x16 tile of output pixels (one thread each) for up to
// 32 output channels; it stages 8 input channels of the tile plus its halo,
// and their weights, in shared memory per pass. The TPU design (the whole
// chain resident in 100 MB of VMEM) has no counterpart in 227 KB of shared
// memory. Whole-chain fusion with an 8-cell halo (2 from the 5x5 layer, 6 from
// the 3x3 layers), implicit GEMM on the tensor cores and bf16 are later work.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;  // output tile edge; one thread per pixel
constexpr int CC = 8;     // input channels staged per pass

template <int K, int CO_BLK>
__global__ void __launch_bounds__(TILE * TILE)
conv_circular_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int H, int W, int cin, int cout, int relu) {
  constexpr int R = K / 2;
  constexpr int S = TILE + K - 1;  // staged edge: tile plus halo
  constexpr int NT = TILE * TILE;
  __shared__ float s_in[CC][S][S];
  __shared__ __align__(16) float s_w[K * K][CC][CO_BLK];

  const int tiles_x = (W + TILE - 1) / TILE;
  const int ty0 = (blockIdx.x / tiles_x) * TILE;
  const int tx0 = (blockIdx.x % tiles_x) * TILE;
  const int co0 = blockIdx.y * CO_BLK;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / TILE, tx = tid % TILE;
  const float* xb = x + (size_t)b * H * W * cin;

  float acc[CO_BLK];
#pragma unroll
  for (int o = 0; o < CO_BLK; ++o) acc[o] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CC) {
    __syncthreads();  // the previous pass has finished reading
    for (int i = tid; i < S * S * CC; i += NT) {
      const int c = i % CC, pix = i / CC;
      const int sy = pix / S, sx = pix % S;
      const int gy = ((ty0 + sy - R) % H + H) % H;
      const int gx = ((tx0 + sx - R) % W + W) % W;
      const int ch = c0 + c;
      s_in[c][sy][sx] =
          ch < cin ? xb[((size_t)gy * W + gx) * cin + ch] : 0.f;
    }
    for (int i = tid; i < K * K * CC * CO_BLK; i += NT) {
      const int o = i % CO_BLK, c = (i / CO_BLK) % CC, tap = i / (CO_BLK * CC);
      const int ch = c0 + c, co = co0 + o;
      s_w[tap][c][o] = (ch < cin && co < cout)
                           ? w[((size_t)tap * cin + ch) * cout + co]
                           : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < CC; ++c) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float v = s_in[c][ty + ky][tx + kx];
          const float* wp = s_w[ky * K + kx][c];
#pragma unroll
          for (int o = 0; o < CO_BLK; ++o) acc[o] = fmaf(v, wp[o], acc[o]);
        }
      }
    }
  }

  const int oy = ty0 + ty, ox = tx0 + tx;
  if (oy < H && ox < W) {
    float* yp = y + (((size_t)b * H + oy) * W + ox) * cout;
#pragma unroll
    for (int o = 0; o < CO_BLK; ++o) {
      const int co = co0 + o;
      if (co < cout) {
        float r = acc[o] + bias[co];
        yp[co] = relu ? fmaxf(r, 0.f) : r;
      }
    }
  }
}

template <int K, int CO_BLK>
void launch(const float* x, const float* w, const float* b, float* y, int B,
            int H, int W, int cin, int cout, int relu, cudaStream_t s) {
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  const dim3 grid(tiles, (cout + CO_BLK - 1) / CO_BLK, B);
  conv_circular_kernel<K, CO_BLK>
      <<<grid, TILE * TILE, 0, s>>>(x, w, b, y, H, W, cin, cout, relu);
}

int conv_layer(int K, const float* x, const float* w, const float* b,
               float* y, int B, int H, int W, int cin, int cout, int relu,
               cudaStream_t s) {
  if (K == 5 && cout > 4) launch<5, 32>(x, w, b, y, B, H, W, cin, cout, relu, s);
  else if (K == 5) launch<5, 4>(x, w, b, y, B, H, W, cin, cout, relu, s);
  else if (K == 3 && cout > 4) launch<3, 32>(x, w, b, y, B, H, W, cin, cout, relu, s);
  else if (K == 3) launch<3, 4>(x, w, b, y, B, H, W, cin, cout, relu, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// Runs the chain on `stream`. meta holds (K, cin, cout) per layer, on the
// host. scratch holds two activations of B*H*W*max(hidden cout) floats. The
// wrapper checks shapes; returns cudaGetLastError() of the launches (0 = ok).
extern "C" int k1_fused_cnn_forward_f32(const float* x, const float* wflat,
                                        const float* bflat, const int* meta,
                                        int n_layers, float* out,
                                        float* scratch, int B, int H, int W,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t half = 0;
  for (int i = 0; i + 1 < n_layers; ++i)
    if ((size_t)meta[3 * i + 2] > half) half = meta[3 * i + 2];
  half *= (size_t)B * H * W;
  const float* src = x;
  size_t woff = 0, boff = 0;
  for (int i = 0; i < n_layers; ++i) {
    const int K = meta[3 * i], cin = meta[3 * i + 1], cout = meta[3 * i + 2];
    const bool last = i + 1 == n_layers;
    float* dst = last ? out : scratch + (i % 2) * half;
    const int err = conv_layer(K, src, wflat + woff, bflat + boff, dst, B, H,
                               W, cin, cout, last ? 0 : 1, s);
    if (err != 0) return err;
    woff += (size_t)K * K * cin * cout;
    boff += cout;
    src = dst;
  }
  return (int)cudaGetLastError();
}
