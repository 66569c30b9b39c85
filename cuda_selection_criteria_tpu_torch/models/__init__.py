"""Sketch model types: HyperLogLog, SuperMinHash, and stacked sketch banks."""

from .bank import SketchBank, build_bank_from_files
from .hll import HllSketch
from .smh import SuperMinHashSketch

__all__ = ["HllSketch", "SuperMinHashSketch", "SketchBank",
           "build_bank_from_files"]
