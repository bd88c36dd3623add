"""muninn-tpu on PyTorch and CUDA: the port of ``muninn_tpu`` to one NVIDIA
H100.

The port goes slice by slice beside the JAX package, which stays the
reference. This slice carries exact flat KNN: ``FlatIndex`` insert,
delete and search at ``precision="highest"``, with search through a
hand-written CUDA kernel (``csrc/flat_topk.cu``) on a CUDA device and its
plain PyTorch version on the CPU. The package imports ``torch`` and numpy,
never ``jax`` and never ``muninn_tpu``.
"""

__version__ = "0.5.0"

from muninn_tpu_torch.ops.distance import Metric, parse_metric  # noqa: F401
from muninn_tpu_torch.index.flat import FlatIndex  # noqa: F401

__all__ = ["Metric", "parse_metric", "FlatIndex", "__version__"]
