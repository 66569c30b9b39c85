"""Shared inputs for the tests that hold the torch port against the JAX
package: banks made once from a numpy seed, handed to both packages."""

import numpy as np

from test_screen import _make_bank

from cuda_selection_criteria_tpu_torch.models import SketchBank


def jax_bank(n, p, m, seed):
    """A planted reference-package SketchBank (built through its own
    HLL/SMH build ops, cards from its jitted MLE)."""
    return _make_bank(n, p, m, np.random.default_rng(seed))


def port_bank(bank, cards=True):
    """The port's bank carrying the reference bank's numpy fields;
    cards=False recomputes the cardinalities with the host f64 MLE."""
    return SketchBank.from_arrays(
        names=bank.names, regs=bank.regs, p=bank.p,
        cards=bank.cards if cards else None, aux=bank.aux,
        aux_kind=bank.aux_kind, aux_param=bank.aux_param)


def rounded(results):
    return [(a, b, round(j, 12)) for a, b, j in results]
