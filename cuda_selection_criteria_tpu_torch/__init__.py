"""cuda_selection_criteria_tpu_torch - the PyTorch + CUDA port of the
sketch-based genomic similarity engine, for one NVIDIA Hopper card.

The JAX package `cuda_selection_criteria_tpu` beside it is the reference
this port is held against (bit-equal integers, identical output lines).
Importing this package imports neither JAX nor the JAX package; the
host helpers it shares with the reference are copied, not imported,
because the reference package enables JAX's x64 mode on import.
"""

__version__ = "0.1.0"
