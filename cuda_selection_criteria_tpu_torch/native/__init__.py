"""Native (C++) host library: FASTA decode, the single-pass host sketch
builder, threaded sketch-file loaders and fused union histograms."""

from . import fastx

__all__ = ["fastx"]
