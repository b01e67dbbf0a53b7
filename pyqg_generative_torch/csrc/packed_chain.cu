// K2: the BatchNorm-folded closure CNN, layers Conv_1..Conv_n, for the whole
// ensemble in ONE launch ("packed": the ensemble packed into one launch).
//
// Replaces pyqg_generative_tpu/ml/pallas_conv.py::_fused_call_packed (body
// _make_packed_kernel), the variant "packed" of make_online_cnn: one program
// for the whole batch, the K^2 taps looped over tap-major weights, bias on
// every layer and ReLU on all but the last (the packed kernel has no final
// ReLU). The twin lays the members side by side in its lanes, (H*W, B*C), a
// TPU layout; here activations are NHWC, as K1's: in (B, H, W, Cin0)
// float32, out (B, H, W, Cout_last) float32, kernels HWIO packed back to back
// (float32 or bf16), biases float32.
//
// Bound on an H100: at the VAE decoder's widths (the AndrewCNN 4->2 at
// 128/64/32) and 10 x 64^2 it does the work of K1 on eddy_gan_64, 21.35
// GFLOP a call, 0.3187 ms at the 67 TFLOP/s float32 peak; the 22 MB it must
// move take 7 us, so operations bind it.
//
// Design: "one program for the whole batch" on Hopper is one persistent
// cooperative launch. The grid is as many blocks as can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count, at the
// shared memory of the largest tile shape, capped by the largest layer's
// work), so that cooperative_groups' grid.sync() between layers is legal; a
// grid the card cannot hold is refused with
// cudaErrorCooperativeLaunchTooLarge, which the wrapper raises. Within a
// layer, work items (member, tile, block of output channels) are drawn by
// the blocks from a counter as they free up, each SM keeping to an even
// share, and each item runs K1's FMA tile body (conv_fma.cuh) in the
// layer's tile shape, so the two kernels share one conv routine and one
// summation order. Every tile shape takes 128 threads; the kernel's
// registers allow 3 blocks an SM (pqg::MIN_BLOCKS) with no spills. A wide
// 3x3 layer runs in half-width items (K3Half). Activations ping-pong in the
// wrapper's scratch: 10 x 64^2 x 64 float32 is 10 MB and stays in the 50 MB
// L2. The saving over K1 is the per-layer
// launches; the cost is a grid-wide barrier per layer.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <vector>

#include "conv_fma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_LAYERS = 16;
constexpr int MAX_DEVICES = 64;

struct Chain {  // passed by value: shape, tile shape and offsets per layer
  int n;
  int cin[MAX_LAYERS], cout[MAX_LAYERS], tile[MAX_LAYERS], items[MAX_LAYERS];
  long long woff[MAX_LAYERS], boff[MAX_LAYERS];
};

// Work-item counters, one set a layer. A block draws its next item from the
// layer's counter when it is free, as the hardware hands a grid's blocks to
// SMs as they free up; striped statically over the resident grid, the items
// of a layer piled up on some SMs, and Conv_1 ran slower. When the grid
// fills the card (every SM holds the same number of blocks), each SM also
// keeps to its share: items / SMs, and one of the items % SMs left over, so
// that no SM takes more than ceil(items / SMs). The counters live in a
// zeroed buffer that the caller owns and passes to the launch: one buffer a
// stream, so that launches on two streams never draw each other's items.
// Each layer's last block to draw past the end resets its counters, so the
// buffer is zero again when the launch ends. A launch that faults leaves it
// dirty, but a kernel fault is sticky: the context refuses every later
// launch.
constexpr int MAX_SMS = 256;  // above %nsmid of a Hopper card
struct Counters {
  unsigned int next_item[MAX_LAYERS];
  unsigned int extra_taken[MAX_LAYERS];
  unsigned int blocks_done[MAX_LAYERS];
  unsigned int sm_taken[MAX_LAYERS][MAX_SMS];
};

__device__ __forceinline__ unsigned int sm_id() {
  unsigned int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

// The next item of layer i for this block, or `items` when it has none
// left; thread 0 only.
__device__ __forceinline__ int draw(Counters* c, int i, int items, int sms,
                                   bool balanced) {
  const unsigned int sm = sm_id();
  if (balanced && sm < MAX_SMS) {
    const unsigned int t = atomicAdd(&c->sm_taken[i][sm], 1u);
    const unsigned int share = items / sms, left = items % sms;
    if (t > share ||
        (t == share && atomicAdd(&c->extra_taken[i], 1u) >= left))
      return items;
  }
  const unsigned int it = atomicAdd(&c->next_item[i], 1u);
  return it < (unsigned int)items ? (int)it : items;
}

// After layer i: the last block past the end resets its counters; thread 0
// only.
__device__ __forceinline__ void finish(Counters* c, int i) {
  __threadfence();
  if (atomicAdd(&c->blocks_done[i], 1u) == gridDim.x - 1) {
    for (int sm = 0; sm < MAX_SMS; ++sm) atomicExch(&c->sm_taken[i][sm], 0u);
    atomicExch(&c->next_item[i], 0u);
    atomicExch(&c->extra_taken[i], 0u);
    atomicExch(&c->blocks_done[i], 0u);
  }
}

// Work item `it` of a layer of tile shape T: the input is float32 for the
// first layer and Tc after it, the output float32 for the last layer and Tc
// before it. Not inlined: each tile shape gets its own registers, where the
// four shapes inlined into the one kernel spilled.
template <class T, typename Tc>
__device__ __noinline__ void item(bool first, bool last, const void* src,
                                  const Tc* w, const float* b, void* dst,
                                  int H, int W, int cin, int cout, int it) {
  const bool relu = !last;
  const float* xf = static_cast<const float*>(src);
  const Tc* xc = static_cast<const Tc*>(src);
  float* yf = static_cast<float*>(dst);
  Tc* yc = static_cast<Tc*>(dst);
  if constexpr (std::is_same<Tc, float>::value)
    pqg::conv_fma_nth<T>(xf, w, b, yf, H, W, cin, cout, relu, it);
  else if (first && last)
    pqg::conv_fma_nth<T>(xf, w, b, yf, H, W, cin, cout, relu, it);
  else if (first)
    pqg::conv_fma_nth<T>(xf, w, b, yc, H, W, cin, cout, relu, it);
  else if (last)
    pqg::conv_fma_nth<T>(xc, w, b, yf, H, W, cin, cout, relu, it);
  else
    pqg::conv_fma_nth<T>(xc, w, b, yc, H, W, cin, cout, relu, it);
}

template <typename Tc>
__global__ void __launch_bounds__(pqg::THREADS, pqg::MIN_BLOCKS)
packed_chain_kernel(const float* __restrict__ x, const Tc* __restrict__ wflat,
                    const float* __restrict__ bflat, Chain chain, float* out,
                    Tc* scratch, Counters* counters, size_t half, int H,
                    int W, int sms, int balanced) {
  __shared__ int drawn;
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < chain.n; ++i) {
    const int cin = chain.cin[i], cout = chain.cout[i];
    const bool first = i == 0, last = i + 1 == chain.n;
    const void* src = first ? static_cast<const void*>(x)
                            : static_cast<const void*>(
                                  scratch + ((i - 1) % 2) * half);
    void* dst = last ? static_cast<void*>(out)
                     : static_cast<void*>(scratch + (i % 2) * half);
    const Tc* w = wflat + chain.woff[i];
    const float* b = bflat + chain.boff[i];
    const int tile = chain.tile[i];
    for (;;) {
      if (threadIdx.x == 0)
        drawn = draw(counters, i, chain.items[i], sms, balanced);
      __syncthreads();
      const int it = drawn;  // rewritten only after the item's first barrier
      if (it >= chain.items[i]) break;
      if (tile == pqg::T_K5_WIDE)
        item<pqg::K5Wide>(first, last, src, w, b, dst, H, W, cin, cout,
                          it);
      else if (tile == pqg::T_K3_HALF)
        item<pqg::K3Half>(first, last, src, w, b, dst, H, W, cin, cout,
                          it);
      else if (tile == pqg::T_K5_NARROW)
        item<pqg::K5Narrow>(first, last, src, w, b, dst, H, W, cin, cout,
                            it);
      else
        item<pqg::K3Narrow>(first, last, src, w, b, dst, H, W, cin, cout,
                            it);
    }
    if (threadIdx.x == 0) finish(counters, i);
    if (!last) grid.sync();  // layer i is written before layer i+1 reads it
  }
}

template <typename Tc>
int run_packed(const float* x, const Tc* wflat, const float* bflat,
               const int* meta, int n_layers, float* out, Tc* scratch,
               Counters* counters, int B, int H, int W, cudaStream_t s) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  void (*kernel)(const float*, const Tc*, const float*, Chain, float*, Tc*,
                 Counters*, size_t, int, int, int, int) =
      packed_chain_kernel<Tc>;
  const int smem = pqg::MAX_TILE_SMEM;
  // the resident grid is a property of the kernel and the card: query it
  // once a device, at the shared memory of the largest tile shape, which
  // every launch takes
  static int resident_of[MAX_DEVICES] = {}, sms_of[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (resident_of[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute((const void*)kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          pqg::THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    sms_of[dev] = sms;
    resident_of[dev] = per_sm * sms;
  }
  const int resident = resident_of[dev];
  int sms = sms_of[dev];

  Chain chain{};
  chain.n = n_layers;
  long long woff = 0, boff = 0;
  size_t half = 0;
  int max_items = 0;
  for (int i = 0; i < n_layers; ++i) {
    const int K = meta[3 * i], cin = meta[3 * i + 1], cout = meta[3 * i + 2];
    int tile = pqg::tile_of(K, cout);
    if (tile < 0) return (int)cudaErrorInvalidValue;
    // a wide 3x3 layer runs in half-width items: at 10 x 64^2 on 132 SMs,
    // 640 items of 16 channels leave the busiest SM 5 x 16 channel-items,
    // 320 of 32 would leave it 3 x 32
    if (tile == pqg::T_K3_WIDE) tile = pqg::T_K3_HALF;
    chain.cin[i] = cin, chain.cout[i] = cout, chain.tile[i] = tile;
    chain.items[i] = pqg::tile_items(tile, B, H, W, cout);
    chain.woff[i] = woff, chain.boff[i] = boff;
    woff += (long long)K * K * cin * cout;
    boff += cout;
    if (i + 1 < n_layers && (size_t)cout > half) half = cout;
    if (chain.items[i] > max_items) max_items = chain.items[i];
  }
  half *= (size_t)B * H * W;

  const int blocks = resident < max_items ? resident : max_items;
  int balanced = blocks == resident;  // every SM holds per_sm blocks
  void* args[] = {(void*)&x,        (void*)&wflat,    (void*)&bflat,
                  (void*)&chain,    (void*)&out,      (void*)&scratch,
                  (void*)&counters, (void*)&half,     (void*)&H,
                  (void*)&W,        (void*)&sms,      (void*)&balanced};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                    dim3(pqg::THREADS), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points run the chain on `stream` in one cooperative launch.
// x and out are NHWC (B, H, W, C) float32; meta holds (K, cin, cout)
// per layer, on the host; scratch holds two activations of B*H*W*max(hidden
// cout) elements of the weights' type; counters is a zeroed buffer of
// k2_counter_words() 32-bit words that serves `stream` alone. The wrapper
// checks shapes; each returns the launch's error code (0 = ok).
extern "C" int k2_counter_words() {
  return (int)(sizeof(Counters) / sizeof(unsigned int));
}

extern "C" int k2_packed_cnn_forward_f32(const float* x, const float* wflat,
                                         const float* bflat, const int* meta,
                                         int n_layers, float* out,
                                         float* scratch, int B, int H, int W,
                                         void* stream, void* counters) {
  return run_packed(x, wflat, bflat, meta, n_layers, out, scratch,
                    static_cast<Counters*>(counters), B, H, W,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int k2_packed_cnn_forward_bf16(const float* x, const bf16* wflat,
                                          const float* bflat, const int* meta,
                                          int n_layers, float* out,
                                          bf16* scratch, int B, int H, int W,
                                          void* stream, void* counters) {
  return run_packed(x, wflat, bflat, meta, n_layers, out, scratch,
                    static_cast<Counters*>(counters), B, H, W,
                    static_cast<cudaStream_t>(stream));
}

// A CUDA graph's kernel nodes, and how many of them launch cooperatively
// (the attribute that K2's grid.sync() needs), so that the wrapper can check
// that stream capture kept K2's cooperative launch. Host-only; returns the
// first error code (0 = ok).
extern "C" int k2_graph_kernel_nodes(void* graph, int* kernels,
                                     int* cooperative) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) err = cudaGraphGetNodes(g, nodes.data(), &n);
  if (err != cudaSuccess) return (int)err;
  *kernels = 0, *cooperative = 0;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(node, &type);
    if (err != cudaSuccess) return (int)err;
    if (type != cudaGraphNodeTypeKernel) continue;
    ++*kernels;
    cudaLaunchAttributeValue value{};
    err = cudaGraphKernelNodeGetAttribute(
        node, cudaLaunchAttributeCooperative, &value);
    if (err != cudaSuccess) return (int)err;
    if (value.cooperative) ++*cooperative;
  }
  return 0;
}
