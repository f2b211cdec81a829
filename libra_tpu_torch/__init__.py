"""PyTorch + CUDA port of libra_tpu for NVIDIA Hopper.

Imports torch and numpy, never JAX or the JAX package. The bridged
attention of the prompt pass and of training is a pair of hand-written
CUDA kernels, forward and backward (ops/flash_bridge.py,
csrc/flash_bridge.cu, csrc/flash_bridge_bwd.cu); the quantized decode
path has its own (csrc/int8_matmul.cu, int4_matmul.cu,
decode_attention.cu). On CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""
