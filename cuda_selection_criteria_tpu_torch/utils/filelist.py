"""File-list loading (reference: src/build_sketch.cpp:153-180). Copy of
cuda_selection_criteria_tpu/utils/filelist.py with the same messages."""

import os


def load_file_list(list_path, base_path=""):
    """Read a text file of FASTA paths, trimming whitespace/CR, skipping
    empty lines. Paths are optionally prefixed with base_path."""
    if not list_path:
        raise ValueError("No input file provided")
    if not os.path.exists(list_path):
        raise FileNotFoundError(f"No valid input file provided: {list_path}")
    files = []
    with open(list_path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip(" \t\r\n")
            if line:
                files.append(base_path + line)
    return files
