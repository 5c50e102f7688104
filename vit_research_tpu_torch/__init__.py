"""PyTorch + CUDA port of vit_research_tpu for NVIDIA Hopper (H100).

The JAX package ``vit_research_tpu`` stays the reference; this package
re-implements its main path (frame embedding -> kNN -> Viterbi -> clips)
on torch tensors, with hand-written CUDA kernels in ``csrc/`` for the
Pallas kernels that path runs. It imports no JAX: JAX-free modules of the
reference package (configs, data, vector store, CLI helpers) are imported
from it directly.
"""

from vit_research_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
