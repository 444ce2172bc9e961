"""echoflow_torch: the PyTorch + CUDA port of `echoflow` for NVIDIA Hopper.

The JAX package `echoflow` stays the reference; this package mirrors its
module layout (`models/`, `ops/`, `infer/`, `metrics/`, ...) and imports
neither jax nor `echoflow`. Entry points run on the CUDA device unless the
caller asks for the CPU. The decoder tail runs in the hand-written kernel
of `csrc/decoder_heads.cu`, and the training losses' bilinear warp in the
three kernels of `csrc/warp.cu`.
"""
