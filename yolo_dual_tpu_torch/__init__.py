"""PyTorch/CUDA port of yolo_dual_tpu.

Module names mirror the JAX package (`yolo_dual_tpu`), so each port module sits
at the same relative path as its counterpart. Tensors are NCHW; every entry
point takes an explicit `device` that defaults to "cuda" and raises when CUDA
is asked for and absent.

The package imports torch and numpy only. It never imports JAX or the JAX
package; the tests compare the two.
"""

__version__ = "0.1.0"
