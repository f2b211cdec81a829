"""PyTorch + CUDA port of libra_tpu for NVIDIA Hopper.

Imports torch and numpy, never JAX or the JAX package. The prompt pass's
bridged attention is a hand-written CUDA kernel (ops/flash_bridge.py,
csrc/flash_bridge.cu); on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""
