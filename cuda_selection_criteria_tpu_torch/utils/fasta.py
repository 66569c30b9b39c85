"""FASTA/FASTQ ingestion: gzipped (or plain) files -> 2-bit base-code
streams. fasta_codes decodes with the native reader (native/fastx.cpp) when
its library builds, else with fasta_codes_py, the pure-Python reader copied
from cuda_selection_criteria_tpu/utils/fasta.py; both give the same bytes.

Replaces the reference's SeqAn SeqFileIn + per-base switch
(src/build_sketch.cpp:43-92) with a host-side byte translation producing
the code encoding consumed by ops/kmers:

  0..3 = A,C,G,T (case-insensitive), 4 = reset sentinel.

A reset sentinel is emitted for every non-ACGT sequence character (N, IUPAC
ambiguity codes, ...) and one per record boundary - both reset the
reference scanner's rolling window (src/build_sketch.cpp:80, record loop at
:53). Newlines/CR inside a record are dropped (SeqAn concatenates sequence
lines).
"""

import gzip
import io

import numpy as np

from ..native import fastx

SENTINEL = np.uint8(4)

_LUT = np.full(256, SENTINEL, np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _LUT[ord(_ch)] = _code
    _LUT[ord(_ch.lower())] = _code

_SENT_ARR = np.array([SENTINEL], np.uint8)


def _open_maybe_gzip(path):
    fh = open(path, "rb")
    magic = fh.read(2)
    fh.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(fh, "rb")
    return fh


def fasta_codes_py(path):
    """Pure-Python reader: FASTA or FASTQ file -> uint8 code array.

    FASTQ records ('@' header) match SeqAn readRecord's transparent
    format handling (reference: src/build_sketch.cpp:56): the quality
    line is consumed by LENGTH (it may contain '@', '+' or base
    letters), multi-line sequence in either format is concatenated."""
    chunks = [_SENT_ARR]
    with _open_maybe_gzip(path) as fh:
        buf = io.BufferedReader(fh, buffer_size=1 << 20)
        fastq = False
        seq_len = 0
        qual_left = 0
        for line in buf:
            line = line.rstrip(b"\r\n")
            if qual_left > 0:  # inside a FASTQ quality block
                qual_left -= len(line)
                continue
            if not line:
                continue
            if line.startswith(b">") or line.startswith(b"@"):
                fastq = line.startswith(b"@")
                seq_len = 0
                chunks.append(_SENT_ARR)
                continue
            if fastq and line.startswith(b"+"):
                qual_left = seq_len
                continue
            seq_len += len(line)
            chunks.append(_LUT[np.frombuffer(line, np.uint8)])
    if len(chunks) == 1:
        return np.zeros(0, np.uint8)
    return np.concatenate(chunks)


def decoder():
    """The reader fasta_codes uses in this process: "native" or "python"."""
    return "native" if fastx.available() else "python"


def fasta_codes(path):
    """FASTA/FASTQ -> uint8 code array: the native reader when its library
    builds (it releases the interpreter lock, so threads decode in
    parallel), else the pure-Python reader. A file without a record or a
    base gives the Python reader's empty array (the native reader returns
    its lone leading reset; both give no k-mer)."""
    if not fastx.available():
        return fasta_codes_py(path)
    codes = fastx.fasta_codes(path)
    return codes[:0] if codes.size == 1 else codes
