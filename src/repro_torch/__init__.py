"""PyTorch/CUDA port of the JAX model stack (``repro``), for one NVIDIA H100.

The port imports torch and nothing of ``repro`` or JAX; it keeps its own
copy of what it needs (the configs).  Its entry points run on the CUDA card
unless the caller passes ``device="cpu"``.  Each Pallas TPU kernel on a
ported path is a hand-written CUDA kernel under ``kernels/csrc`` with a
plain torch twin beside it.
"""
