"""PyTorch/CUDA port of ``cald_tpu`` (consistency-based active learning for
object detection).

The package mirrors ``cald_tpu``'s layout so each module's counterpart is easy
to find, and keeps its public layouts: NHWC images, ``(B, N, 4)`` xyxy boxes and
fixed detection slots with validity masks. It imports ``torch`` and numpy only;
the JAX package is its reference in the tests, never a dependency.

Kernels written by hand for Hopper live in ``csrc/`` and are built at first use
(``ops/roi_align_cuda.py``). Every kernel has a plain PyTorch version beside it,
which the wrapper takes for tensors on the CPU.
"""
