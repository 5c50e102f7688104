"""PyTorch + CUDA port of vit_research_tpu for NVIDIA Hopper (H100).

The JAX package ``vit_research_tpu`` stays the reference; this package
re-implements its main path (frame embedding -> kNN -> Viterbi -> clips)
and its vector store (build-frame-store, search) on torch tensors, with
hand-written CUDA kernels in ``csrc/`` for the reference's Pallas kernels.
It imports nothing of the reference package: the configuration, data,
store and CLI helpers it needs are its own copies, under the reference's
module names (``utils/configs.py``, ``data/*``, ``store/*``, ``db/*``,
``cli/common.py``).
"""

from vit_research_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
