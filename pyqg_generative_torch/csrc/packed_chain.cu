// K2: the BatchNorm-folded closure CNN, layers Conv_1..Conv_n, for the whole
// ensemble in ONE launch, on the member-packed layout.
//
// Replaces pyqg_generative_tpu/ml/pallas_conv.py::_fused_call_packed (body
// _make_packed_kernel), the variant "packed" of make_online_cnn: one program
// for the whole batch, activations (H*W, B*C) with the B members side by
// side, the K^2 taps looped over tap-major weights, bias on every layer and
// ReLU on all but the last (the packed kernel has no final ReLU). In
// (H*W, B*Cin0) float32, out (H*W, B*Cout_last) float32, kernels HWIO packed
// back to back (float32 or bf16), biases float32 and not tiled over members.
//
// Bound on an H100: at the VAE decoder's widths (the AndrewCNN 4->2 at
// 128/64/32) and 10 x 64^2 it does the work of K1 on eddy_gan_64, 21.35
// GFLOP a call, 0.3187 ms at the 67 TFLOP/s float32 peak; the 22 MB it must
// move take 7 us, so operations bind it.
//
// Design: "one program for the whole batch" on Hopper is one persistent
// cooperative launch. The grid is as many blocks as can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count, capped by
// the largest layer's work), so that cooperative_groups' grid.sync() between
// layers is legal; a grid the card cannot hold is refused with
// cudaErrorCooperativeLaunchTooLarge, which the wrapper raises. Within a
// layer, work items (member, 16x16 tile, block of output channels) are
// striped over the blocks, and each item runs K1's tile body (conv_tile.cuh),
// so the two kernels share one conv routine. Activations ping-pong in the
// wrapper's scratch: 10 x 64^2 x 64 float32 is 10 MB and stays in the 50 MB
// L2. The saving over K1 is the per-layer launches; the cost is a grid-wide
// barrier per layer and the tail of each layer's last wave.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "conv_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using pqg::TILE;
using pqg::TileSmem;
using bf16 = __nv_bfloat16;

constexpr int MAX_LAYERS = 16;

struct Chain {  // passed by value: (K, cin, cout) and offsets per layer
  int n;
  int K[MAX_LAYERS], cin[MAX_LAYERS], cout[MAX_LAYERS];
  long long woff[MAX_LAYERS], boff[MAX_LAYERS];
};

template <typename Tc>
union ChainSmem {  // one tile's staging, whichever shape the layer has
  TileSmem<5, 32, Tc> k5w;
  TileSmem<5, 4, Tc> k5n;
  TileSmem<3, 32, Tc> k3w;
  TileSmem<3, 4, Tc> k3n;
};

// One work item with the layer's shape fixed: the input is float32 for the
// first layer and Tc after it, the output float32 for the last layer and Tc
// before it.
template <int K, int CB, typename Tc>
__device__ __forceinline__ void item(bool first, bool last, const void* src,
                                     const Tc* w, const float* b, void* dst,
                                     int B, int H, int W, int cin, int cout,
                                     int m, int tile, int co0,
                                     TileSmem<K, CB, Tc>& sm) {
  const bool relu = !last;
  if constexpr (std::is_same<Tc, float>::value) {
    pqg::conv_tile<K, CB>(static_cast<const float*>(src), w, b,
                          static_cast<float*>(dst), B, H, W, cin, cout, relu,
                          true, m, tile, co0, sm);
  } else if (first && last) {
    pqg::conv_tile<K, CB>(static_cast<const float*>(src), w, b,
                          static_cast<float*>(dst), B, H, W, cin, cout, relu,
                          true, m, tile, co0, sm);
  } else if (first) {
    pqg::conv_tile<K, CB>(static_cast<const float*>(src), w, b,
                          static_cast<Tc*>(dst), B, H, W, cin, cout, relu,
                          true, m, tile, co0, sm);
  } else if (last) {
    pqg::conv_tile<K, CB>(static_cast<const Tc*>(src), w, b,
                          static_cast<float*>(dst), B, H, W, cin, cout, relu,
                          true, m, tile, co0, sm);
  } else {
    pqg::conv_tile<K, CB>(static_cast<const Tc*>(src), w, b,
                          static_cast<Tc*>(dst), B, H, W, cin, cout, relu,
                          true, m, tile, co0, sm);
  }
}

template <typename Tc>
__global__ void __launch_bounds__(TILE * TILE)
packed_chain_kernel(const float* __restrict__ x, const Tc* __restrict__ wflat,
                    const float* __restrict__ bflat, Chain chain, float* out,
                    Tc* scratch, size_t half, int B, int H, int W) {
  __shared__ ChainSmem<Tc> sm;
  cg::grid_group grid = cg::this_grid();
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  for (int i = 0; i < chain.n; ++i) {
    const int K = chain.K[i], cin = chain.cin[i], cout = chain.cout[i];
    const int cb = pqg::co_block(cout);
    const int nblk = (cout + cb - 1) / cb;
    const int items = B * tiles * nblk;
    const bool first = i == 0, last = i + 1 == chain.n;
    const void* src = first ? static_cast<const void*>(x)
                            : static_cast<const void*>(
                                  scratch + ((i - 1) % 2) * half);
    void* dst = last ? static_cast<void*>(out)
                     : static_cast<void*>(scratch + (i % 2) * half);
    const Tc* w = wflat + chain.woff[i];
    const float* b = bflat + chain.boff[i];
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int co0 = (it % nblk) * cb;
      const int tile = (it / nblk) % tiles;
      const int m = it / (nblk * tiles);
      if (K == 5 && cb == 32)
        item<5, 32>(first, last, src, w, b, dst, B, H, W, cin, cout, m, tile,
                    co0, sm.k5w);
      else if (K == 5)
        item<5, 4>(first, last, src, w, b, dst, B, H, W, cin, cout, m, tile,
                   co0, sm.k5n);
      else if (cb == 32)
        item<3, 32>(first, last, src, w, b, dst, B, H, W, cin, cout, m, tile,
                    co0, sm.k3w);
      else
        item<3, 4>(first, last, src, w, b, dst, B, H, W, cin, cout, m, tile,
                   co0, sm.k3n);
    }
    if (!last) grid.sync();  // layer i is written before layer i+1 reads it
  }
}

template <typename Tc>
int run_packed(const float* x, const Tc* wflat, const float* bflat,
               const int* meta, int n_layers, float* out, Tc* scratch, int B,
               int H, int W, cudaStream_t s) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  Chain chain{};
  chain.n = n_layers;
  long long woff = 0, boff = 0;
  size_t half = 0;
  int max_items = 0;
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  for (int i = 0; i < n_layers; ++i) {
    const int K = meta[3 * i], cin = meta[3 * i + 1], cout = meta[3 * i + 2];
    if (K != 3 && K != 5) return (int)cudaErrorInvalidValue;
    chain.K[i] = K, chain.cin[i] = cin, chain.cout[i] = cout;
    chain.woff[i] = woff, chain.boff[i] = boff;
    woff += (long long)K * K * cin * cout;
    boff += cout;
    if (i + 1 < n_layers && (size_t)cout > half) half = cout;
    const int cb = pqg::co_block(cout);
    const int items = B * tiles * ((cout + cb - 1) / cb);
    if (items > max_items) max_items = items;
  }
  half *= (size_t)B * H * W;

  void (*kernel)(const float*, const Tc*, const float*, Chain, float*, Tc*,
                 size_t, int, int, int) = packed_chain_kernel<Tc>;
  // the resident grid is a property of the kernel and the card: query it
  // once per process (the port drives one card)
  static int resident = 0;
  cudaError_t err = cudaSuccess;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          TILE * TILE, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    resident = per_sm * sms;
  }
  const int blocks = resident < max_items ? resident : max_items;
  void* args[] = {(void*)&x,   (void*)&wflat,   (void*)&bflat, (void*)&chain,
                  (void*)&out, (void*)&scratch, (void*)&half,  (void*)&B,
                  (void*)&H,   (void*)&W};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                    dim3(TILE * TILE), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points run the chain on `stream` in one cooperative launch.
// x and out are member-packed (H*W, B*C) float32; meta holds (K, cin, cout)
// per layer, on the host; scratch holds two activations of B*H*W*max(hidden
// cout) elements of the weights' type. The wrapper checks shapes; each
// returns the launch's error code (0 = ok).
extern "C" int k2_packed_cnn_forward_f32(const float* x, const float* wflat,
                                         const float* bflat, const int* meta,
                                         int n_layers, float* out,
                                         float* scratch, int B, int H, int W,
                                         void* stream) {
  return run_packed(x, wflat, bflat, meta, n_layers, out, scratch, B, H, W,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int k2_packed_cnn_forward_bf16(const float* x, const bf16* wflat,
                                          const float* bflat, const int* meta,
                                          int n_layers, float* out,
                                          bf16* scratch, int B, int H, int W,
                                          void* stream) {
  return run_packed(x, wflat, bflat, meta, n_layers, out, scratch, B, H, W,
                    static_cast<cudaStream_t>(stream));
}
