"""cxxnet_tpu_torch — the PyTorch / CUDA port of cxxnet_tpu for Hopper.

A second package beside ``cxxnet_tpu`` with the same module names.  It
imports ``torch`` and numpy and never JAX or ``cxxnet_tpu``; the kernels
the JAX package writes in Pallas are hand-written CUDA here
(``ops/csrc``), built at first use.  It serves and trains the netconfig
CNNs (``Net``) and serves the TransformerLM through the continuous
decode engine (``LMServe``); see ROADMAP.md for what comes next.
"""

from .wrapper import LMServe, Net

__all__ = ['LMServe', 'Net']
