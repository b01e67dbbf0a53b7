"""pyqg_generative_torch: the PyTorch + CUDA port of pyqg_generative_tpu.

The JAX package beside it is the reference; each module here names its twin.
Members are a leading batch dimension, random draws take an explicit
`torch.Generator`, and the closure CNN's fused Conv_1..Conv_7 chain is a
hand-written CUDA kernel for Hopper (`ml/fused_conv.py`, `csrc/fused_conv.cu`).

Importing the package touches neither CUDA nor the compiler: the kernel is
built with `nvcc` at its first launch. Entry points take `device=None`, which
means CUDA, and raise where CUDA is absent unless the caller passes
`device="cpu"`.
"""

__version__ = "0.1.0"
