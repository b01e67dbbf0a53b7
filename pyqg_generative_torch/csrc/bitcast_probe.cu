// K3: how the card packs a pair of bf16 values into one 32-bit register.
//
// Replaces pyqg_generative_tpu/ml/pallas_conv.py::_bitcast_packing, the probe
// that packs a (4, 128) bf16 array (rows 1, 2, 3, 4) into (2, 128) uint32
// words, so that _resolve_variant can tell whether variant "dxb"'s
// pair-packed rolls are legal ('adj_low' or 'adj_high') or must fall back to
// "dxf" ('other'). On Hopper a bf16 pair lives in one register as an
// __nv_bfloat162 built by __halves2bfloat162(a, b), which is how a kernel
// that loads bf16 pairs sees them; this kernel builds word i of column j
// from rows (2i, 2i+1) that way and stores its 32-bit pattern, zero-extended,
// as the int64 the wrapper returns: one allocation and this one launch make
// the whole wrapper call. The wrapper classifies the words as the twin does.
//
// Bound: it moves 2 KB and computes nothing, so a launch (a few us) is all
// its time; it runs once per process, when a model resolves "dxb".
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

__global__ void pack_pairs_kernel(const __nv_bfloat16* __restrict__ x,
                                  int64_t* __restrict__ out, int rows_out,
                                  int cols) {
  for (int i = threadIdx.x; i < rows_out * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols;
    const __nv_bfloat162 p =
        __halves2bfloat162(x[(2 * r) * cols + c], x[(2 * r + 1) * cols + c]);
    uint32_t word;
    memcpy(&word, &p, sizeof(word));
    out[i] = (int64_t)word;  // in [0, 2^32)
  }
}

}  // namespace

// x: (2 * rows_out, cols) bf16; out: (rows_out, cols) int64 words in
// [0, 2^32). One block on `stream`; returns cudaGetLastError() of the launch
// (0 = ok).
extern "C" int k3_pack_bf16_pairs(const __nv_bfloat16* x, int64_t* out,
                                  int rows_out, int cols, void* stream) {
  pack_pairs_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, rows_out, cols);
  return (int)cudaGetLastError();
}
