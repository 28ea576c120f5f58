"""PyTorch/CUDA port of the simulator, for one NVIDIA H100.

The JAX package ``consensus_tpu`` stays the reference. This package imports
nothing of it: it keeps its own copy of what it needs, and runs Raft (the
§3b capped main path and the dense engine) and dense PBFT with its
f-ladder, with hand-written CUDA kernels (``csrc/``) on the GPU and their
plain PyTorch versions on the CPU.
"""
from .core.config import Config

__all__ = ["Config"]
