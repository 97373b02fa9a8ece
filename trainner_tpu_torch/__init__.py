"""PyTorch/CUDA port of traiNNer-TPU for NVIDIA Hopper.

Mirrors the layout of the JAX package ``trainner_tpu`` module by module.
Public functions keep its NHWC layout. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""
