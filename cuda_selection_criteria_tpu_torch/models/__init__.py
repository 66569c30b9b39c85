"""Sketch bank: stacked host arrays the selection engine reads."""

from .bank import SketchBank

__all__ = ["SketchBank"]
