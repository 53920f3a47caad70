"""vqvae_tpu_torch — the PyTorch / CUDA port of ``vqvae_tpu``.

The serving path and the shipped training step of the JAX package,
rewritten for an NVIDIA H100: mu-law companding, the strided-conv
encoder and nearest-code search, the codebook upsampler, the
autoregressive WaveNet decode, whose whole sampling loop is one
hand-written CUDA kernel (``csrc/decode.cu``), and the training
forward and backward, whose gated-residual stack and head + CE run in
hand-written CUDA kernels (``csrc/wavenet_train.cu``,
``csrc/head_ce.cu``).  The JAX package stays the reference: parameters
keep its names and layouts, so weight ``.npz`` files cross both ways,
and every module is tested against its JAX counterpart on the CPU.

Nothing here imports JAX.  Importing the package builds nothing; the
first CUDA call of a kernel compiles its source with ``nvcc``.
"""

__version__ = "0.1.0"
