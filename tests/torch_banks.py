"""Shared inputs for the tests that hold the torch port against the JAX
package: banks made once from a numpy seed, handed to both packages."""

import numpy as np
import pytest
import torch

from test_screen import _make_bank, _make_bank_hll_aux

from cuda_selection_criteria_tpu_torch.models import SketchBank


def jax_bank(n, p, m, seed):
    """A planted reference-package SketchBank (built through its own
    HLL/SMH build ops, cards from its jitted MLE)."""
    return _make_bank(n, p, m, np.random.default_rng(seed))


def jax_bank_hll(n, p, p_aux, seed):
    """A planted reference-package SketchBank with an aux HLL bank at
    p_aux, both built from the same items by its own HLL build op."""
    return _make_bank_hll_aux(n, p, p_aux, np.random.default_rng(seed))


def port_bank(bank, cards=True):
    """The port's bank carrying the reference bank's numpy fields;
    cards=False recomputes the cardinalities with the host f64 MLE."""
    return SketchBank.from_arrays(
        names=bank.names, regs=bank.regs, p=bank.p,
        cards=bank.cards if cards else None, aux=bank.aux,
        aux_kind=bank.aux_kind, aux_param=bank.aux_param)


def rounded(results):
    return [(a, b, round(j, 12)) for a, b, j in results]


@pytest.fixture
def one_torch_thread():
    """Run a test on one torch intra-op thread. Each of the suite's
    workers would otherwise start a thread per core for every small CPU
    op, and with all the workers' threads competing for the cores a test
    of many small ops ran twenty times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
