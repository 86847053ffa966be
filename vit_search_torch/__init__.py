"""PyTorch/CUDA port of vit-search-tpu for NVIDIA Hopper (H100).

The package mirrors ``vit_search_tpu``'s layout (``arch``, ``ops``,
``models``, ``data``, ``train``, ``search``) and imports nothing of it. Entry
points run on the CUDA device unless the caller passes ``device="cpu"``;
without a CUDA device they raise instead of carrying on on the CPU.

Hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc`` at
first use (see :mod:`vit_search_torch.ops.kernels`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
