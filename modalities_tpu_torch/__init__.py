"""PyTorch/CUDA port of modalities_tpu for NVIDIA Hopper (H100).

The JAX package `modalities_tpu` stays the reference; this package imports
nothing of it (and no JAX). Module paths mirror the JAX package so each file's
counterpart is easy to find; every Pallas TPU kernel on a ported path is a
hand-written sm_90a kernel under `csrc/`, built on first use (ops/_build.py).
"""

__version__ = "0.1.0"
