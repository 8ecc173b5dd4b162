"""The hand-written CUDA kernels and their dispatch (JAX yolo_dual_tpu/kernels).

JAX's TPU dispatch names have no literal counterpart: `dcnv3_sampling`
launches csrc/dcnv3.cu (K2) on CUDA tensors and runs the plain `dcnv3_core`
on CPU tensors, where JAX picks its Pallas kernel `dcnv3_core_pallas` by the
`use_pallas` heuristic; its backward is `dcnv3_sampling_backward` (K3).
Importing this package builds nothing: each kernel is built at its first
launch (kernels/build.py).

The names load lazily (`_lazy.py`): importing the package imports none of
its modules."""

from yolo_dual_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "dcnv3_sampling": "dcn_sampling",
    "dcnv3_sampling_backward": "dcn_sampling",
    "dcnv3_core": "dcn_sampling",
    "letterbox_normalize": "preprocess",
    "semantic_preprocess": "preprocess",
})
