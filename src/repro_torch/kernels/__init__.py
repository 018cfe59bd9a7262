"""Hand-written Hopper kernels of the port, each with its plain torch twin.

Kernels are built from ``csrc/`` at first use (``build.py``), never when a
module is imported."""
