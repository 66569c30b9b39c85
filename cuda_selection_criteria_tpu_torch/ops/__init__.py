"""Numerical ops: host constants, torch tensor ops and the hand-written
CUDA screen kernel (ops/screen.py + csrc/screen_fused.cu)."""
