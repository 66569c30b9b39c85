"""Command-line entry points with reference-compatible flags."""
