"""SketchBank: stacked sketch arrays for the all-pairs selection engine.

Host numpy, like cuda_selection_criteria_tpu/models/bank.py: registers
(N, 2^p) uint8, aux sketches stacked, cardinalities from the host f64
ERTL-MLE. The screened engine uploads the registers to the device itself
(parallel/screened.ScreenPlan).
"""

from dataclasses import dataclass

import numpy as np

from ..utils import formats
from ..utils.hostref import ertl_mle_batch

PRIMARY_P = 14  # reference hardcodes p=14 for the primary sketch


def _ctz(x):
    return (x & -x).bit_length() - 1


def host_cards(regs, p):
    """f64 ERTL-MLE cardinality per register row, bit-identical to the
    reference's scalar report() (utils/hostref.ertl_mle_batch)."""
    n = regs.shape[0]
    offs = (np.arange(n, dtype=np.int64)[:, None] * 64
            + regs.astype(np.int64))
    hists = np.bincount(offs.ravel(), minlength=n * 64).reshape(n, 64)
    return ertl_mle_batch(hists, p)


@dataclass
class SketchBank:
    """Stacked sketches for N genomes.

    Attributes:
      names: list of genome file paths (identity for output lines).
      regs: uint8 (N, 2^p) primary HLL registers.
      p: primary precision (14).
      cards: float64 (N,) ERTL-MLE cardinalities (host f64).
      aux_kind: None | "hll" | "smh".
      aux: uint8 (N, 2^p_aux) HLL registers, or uint64 (N, m) SMH buckets.
      aux_param: p_aux for "hll", m for "smh".
    """

    names: list
    regs: np.ndarray
    p: int = PRIMARY_P
    cards: np.ndarray = None
    aux_kind: str = None
    aux: np.ndarray = None
    aux_param: int = None

    def __post_init__(self):
        if self.cards is None:
            self.cards = host_cards(self.regs, self.p)

    @property
    def n(self):
        return len(self.names)

    @classmethod
    def from_arrays(cls, names, regs, p=PRIMARY_P, cards=None, aux=None,
                    aux_kind=None, aux_param=None):
        """The port's bank from a reference SketchBank's numpy fields
        (names, regs, p, cards, aux, aux_kind, aux_param): state carried
        across from the JAX package. cards=None recomputes them with the
        host f64 MLE."""
        return cls(
            names=list(names),
            regs=np.ascontiguousarray(regs, np.uint8),
            p=int(p),
            cards=None if cards is None else np.asarray(cards, np.float64),
            aux_kind=aux_kind,
            aux=None if aux is None else np.asarray(aux),
            aux_param=aux_param,
        )

    @classmethod
    def from_sketch_files(cls, files, criterion=None, aux_bytes=256):
        """Load .hll (+ .hll_{p_aux} / .smh{m}) files like the reference's
        selection binaries (src/selection.cpp:122-256): hll_a / hll_an read
        the aux HLL at p_aux = ctz(aux_bytes), smh_a the SMH of
        aux_bytes / 8 buckets.

        Reads with the numpy readers of utils/formats; the threaded
        native loader is a later slice (ROADMAP.md queue 1)."""
        if criterion not in (None, "smh_a", "hll_a", "hll_an"):
            raise NotImplementedError(
                f"loading aux sketches for {criterion!r} is not ported yet "
                "(ROADMAP.md queue 1)")
        regs = np.stack([formats.read_hll(f + ".hll")[1] for f in files])
        aux_kind = aux = aux_param = None
        if criterion in ("hll_a", "hll_an"):
            p_aux = _ctz(aux_bytes)
            aux = np.stack([formats.read_hll(f + f".hll_{p_aux}")[1]
                            for f in files])
            aux_kind, aux_param = "hll", p_aux
        elif criterion == "smh_a":
            m = aux_bytes // 8
            aux = np.stack([formats.read_smh(f + f".smh{m}") for f in files])
            aux_kind, aux_param = "smh", m
        return cls(names=list(files), regs=regs, aux_kind=aux_kind, aux=aux,
                   aux_param=aux_param)

    def sorted_by_cardinality(self):
        """Ascending-cardinality order used by the selection engine;
        mirrors src/selection.cpp:144-149."""
        return np.argsort(self.cards, kind="stable")
