"""Which of the port's cuDNN and cuBLAS closure layers give the same bits
at every call, and under a captured CUDA graph, on one NVIDIA GPU.

For each layer on seeded weights (the bottleneck's deep decoder and its
dense layer alone, one of its transposed convolutions, the AndrewCNN, the
DeepInversion U-Net, the ANN) it calls the layer twice eagerly, once on a
side stream and once replayed from a graph captured on that stream, and
prints whether each equals the first call bitwise, with cuDNN's
`deterministic` flag off and on. It shows why `device.exact_fp32` asks
cuDNN for deterministic algorithms: without it, the deep decoder's
transposed convolutions sum in another order from call to call, so a
graphed step cannot equal the eager one bitwise.

Run from the repository root on a machine with a GPU:
    python3 scripts/torch_cudnn_determinism.py
"""
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from pyqg_generative_torch.ml import nets  # noqa: E402
from pyqg_generative_torch.ml.weights import params_from_jax, \
    seeded_variables  # noqa: E402


def seeded(module, seed):
    module.load_state_dict(params_from_jax(seeded_variables(module, seed)))
    return module.cuda().eval()


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    up = seeded(nets.Upsampling(100, 4, 2, nx=32), 1)
    dec = seeded(nets.AndrewCNN(4, 2), 2)
    unet = seeded(nets.DeepInversionGenerator(4, 2), 3)
    ann = seeded(nets.ANN(9, 1), 4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn((2, 100), device="cuda", generator=gen)
    x = torch.randn((2, 32, 32, 4), device="cuda", generator=gen)
    st = torch.randn((2, 2, 32, 32, 9), device="cuda", generator=gen)
    h = torch.randn((2, 256, 2, 2), device="cuda", generator=gen)
    layers = {
        "dense": lambda: up.Dense_0(z),
        "upsampling": lambda: up(z),
        "conv_transpose": lambda: nets._conv_transpose_same(
            h, up.ConvTranspose_0, 2),
        "andrew_cnn": lambda: dec(x),
        "deep_inversion": lambda: unet(x),
        "ann": lambda: ann(st)}
    print(torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda)
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        for name, fn in layers.items():
            with torch.no_grad():
                first, again = fn(), fn()
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    on_side = fn()
                    fn()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side):
                    replayed = fn()
                graph.replay()
                torch.cuda.synchronize()
            print(f"deterministic={deterministic} {name}: eager twice "
                  f"{torch.equal(first, again)}, side stream "
                  f"{torch.equal(first, on_side)}, graph "
                  f"{torch.equal(first, replayed)}, max|graph - eager| "
                  f"{float((first - replayed).abs().max()):.3e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
