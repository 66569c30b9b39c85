"""All-pairs similar-genome selection: parameters, engine dispatch and the
reference's output format. Port of
cuda_selection_criteria_tpu/parallel/selection.py for the screened engine.
"""

from dataclasses import dataclass

from ..ops import criteria

Z_SCORE_DEFAULT = 1.96  # src/selection.cpp:76
ORDER_N_DEFAULT = 1  # src/selection.cpp:77

ENGINES = ("auto", "screened")


@dataclass(frozen=True)
class SelectionParams:
    """Same fields as the reference package's SelectionParams, so a
    parameter set carries across unchanged. The screened engine reads
    tau, criterion and screen_delta; z_score and order_n belong to the
    hll-aux criteria, and block, precision, confirm, screen_margin,
    adjudicate and screen_dtype to the dense engine, none of which is
    ported yet (ROADMAP.md queue 1)."""

    tau: float  # raw user threshold; effective f32->f64 applied internally
    criterion: str = "smh_a"
    aux_bytes: int = 256
    z_score: float = Z_SCORE_DEFAULT
    order_n: int = ORDER_N_DEFAULT
    block: int = 512
    precision: str = "bf16"
    confirm: str = "fused"
    screen_margin: float = 1e-4
    adjudicate: bool = True
    screen_dtype: str = "auto"
    # Numeric slack on the certified screen threshold (parallel.screened):
    # covers only f32 rounding of the screen statistic.
    screen_delta: float = 1e-3
    # "auto" and "screened" both run the screened engine, on CUDA through
    # the hand-written kernel and on CPU through its plain version.
    engine: str = "auto"

    @property
    def tau_eff(self):
        return criteria.effective_tau(self.tau)


def select_pairs(bank, params, device=None, stats=None):
    """All-pairs selection on a SketchBank; returns reference-ordered
    [(name_i, name_j, jacc)] (src/selection.cpp:297-300).

    device: where the engine runs; None means CUDA (utils/device.resolve).
    stats: see select_pairs_screened."""
    if params.engine not in ENGINES:
        raise ValueError(f"unknown engine {params.engine!r}; the port has "
                         f"{', '.join(ENGINES)}")
    if bank.n < 2:
        return []
    from .screened import select_pairs_screened  # noqa: PLC0415

    return select_pairs_screened(bank, params, device=device, stats=stats)


def format_results(results):
    """Output lines exactly like the reference: `fileA fileB J` with
    std::to_string's fixed 6 decimals (src/selection.cpp:170)."""
    return [f"{a} {b} {j:.6f}" for a, b, j in results]
