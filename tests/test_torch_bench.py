"""The port's bench protocol (experiments/bench.py, scale_sweep.py,
kernel_tuning.py; utils/hopper.py) against the JAX package's bench.py on
the same inputs, on the CPU at small sizes: the spans and the baseline's
definition exactly, the headline sweep's per-tile counts and hit
coordinates bit-equal to the JAX engine's chunk function (its Pallas
kernel in interpret mode), the raw sweep's checksum to the JAX
screen_s_z sums at rtol 1e-5 (f32 sums of differing order; per-tile S is
bit-equal by tests/test_torch_screen.py); then each CLI's JSON keys and
the validate harnesses' baseline keys."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from cuda_selection_criteria_tpu.ops import criteria as jcriteria
from cuda_selection_criteria_tpu.ops import screen as jscreen
from cuda_selection_criteria_tpu.parallel import screened as jscreened
from cuda_selection_criteria_tpu_torch.experiments import (
    bench, kernel_tuning, scale_sweep, validate_131k_scale,
    validate_ring_scale)
from cuda_selection_criteria_tpu_torch.parallel.mesh import row_mesh
from cuda_selection_criteria_tpu_torch.parallel.selection import (
    SelectionParams)
from cuda_selection_criteria_tpu_torch.utils import hopper, synth

N, TI = 512, 64  # 36 triangle tiles, one span


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread_module():
    """One torch intra-op thread for the module's banks and sweeps (a
    thread per core in each of the suite's workers ran far slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_tiles", [1, 7, 8, 9, 36, 63, 64, 65, 136, 200,
                                     8256])
@pytest.mark.parametrize("chunk", [1, 8, 33, 64])
def test_spans_match_jax(n_tiles, chunk):
    assert bench._spans(n_tiles, chunk) == jbench._spans(n_tiles, chunk)


def test_baseline_definition_reproduces_the_reference():
    """2 * 2^14 bytes a pair at the reference card's 760 GB/s is bench.py's
    CUDA_BASELINE_PAIRS_PER_SEC (rounded there to three digits); off the
    card there is no baseline, and the measurement refuses the CPU."""
    got = hopper.pairs_per_sec_bound(760e9, 14)
    assert got == 760e9 / 32768
    assert round(got, -5) == jbench.CUDA_BASELINE_PAIRS_PER_SEC
    assert hopper.card_baseline("cpu") is None
    assert hopper.ratio(3.0, None) is None and hopper.ratio(3.0, 2.0) == 1.5
    with pytest.raises(ValueError, match="CUDA"):
        hopper.measured_hbm_bytes_per_s("cpu")


@pytest.fixture(scope="module")
def planted():
    """The bench bank at N with near-duplicates planted (so the headline
    sweep has hits to extract): (regs, aux, e)."""
    regs, aux, e, _ = validate_131k_scale.planted_bank(
        N, np.random.default_rng(5), 24)
    return regs, aux, e


@pytest.fixture(scope="module")
def port_setup(planted):
    return bench.setup(N, ti=TI, device="cpu", bank=planted)


def _jax_inputs(planted):
    """bench.measure's device state, as the JAX bench builds it."""
    regs, aux, e = planted
    order = np.argsort(e, kind="stable")
    regs, aux, e = regs[order], aux[order], e[order]
    n_rows_b, n_bands = jcriteria.smh_band_params(jbench.M_SMH, jbench.TAU)
    tau = jcriteria.effective_tau(jbench.TAU)
    values = jscreen.truncate_values(jscreen.bank_values(regs),
                                     float(e.max()), jbench.P)
    d_fp = jscreened.band_fingerprints(jnp.asarray(aux), n_rows_b, n_bands)
    return (jnp.asarray(regs), jnp.asarray(e.astype(np.float32)), d_fp,
            n_bands, values, np.float32(jscreened.screen_tau(tau)),
            np.float32(tau * (1.0 - 1e-5)))


def _span_ids(b, c0, width):
    t = b.span_tiles[(c0, width)]
    return t.row_tiles.numpy(), t.col_tiles.numpy()


def test_setup_matches_jax_bench(planted, port_setup):
    b = port_setup
    regs, e, fp, n_bands, values, tau_scr, tau_cb = _jax_inputs(planted)
    np.testing.assert_array_equal(b.d_regs.numpy(), np.asarray(regs))
    np.testing.assert_array_equal(b.d_e.numpy(), np.asarray(e))
    np.testing.assert_array_equal(b.d_fp.numpy(), np.asarray(fp))
    assert (b.n_bands, b.values, b.tau_scr, b.tau_cb) == (
        n_bands, values, tau_scr, tau_cb)
    assert bench.CHUNK == jbench.CHUNK
    assert b.spans == jbench._spans(36, min(jbench.CHUNK, 36))


def test_headline_sweep_matches_jax_screen_chunk(planted, port_setup):
    """Per-tile counts and every hit tile's coordinates of the port's
    headline sweep equal the JAX _screen_chunk's over the same spans."""
    b = port_setup
    counts, coords = bench.headline_collect(bench.headline_dispatch(b))
    regs, e, fp, n_bands, values, tau_scr, tau_cb = _jax_inputs(planted)
    want_counts, want_coords = [], []
    for k, (c0, width) in enumerate(b.spans):
        r, c = _span_ids(b, c0, width)
        hits, cnt = jscreened._screen_chunk(
            regs, jnp.asarray(r), jnp.asarray(c), e, fp, jnp.int32(N),
            jnp.float32(tau_scr), jnp.float32(tau_cb), jbench.P, values, TI,
            n_bands, True, True)
        cnt = np.asarray(cnt)
        want_counts.append(cnt)
        for t in np.nonzero(cnt)[0]:
            want_coords.append((k, int(t), *np.nonzero(np.asarray(hits[t]))))
    np.testing.assert_array_equal(counts, np.concatenate(want_counts))
    assert counts.sum() >= 24  # the planted pairs at least
    assert len(coords) == len(want_coords) > 0
    for (k, t, rr, cc), (wk, wt, wr, wc) in zip(coords, want_coords):
        assert (k, t) == (wk, wt)
        np.testing.assert_array_equal(rr, wr)
        np.testing.assert_array_equal(cc, wc)


def test_raw_checksum_matches_jax_screen_s_z(planted, port_setup):
    b = port_setup
    got = bench.raw_collect(bench.raw_dispatch(b))
    regs, _, _, _, values, _, _ = _jax_inputs(planted)
    want = 0.0
    for c0, width in b.spans:
        r, c = _span_ids(b, c0, width)
        s, z = jscreen.screen_s_z(regs, jnp.asarray(r), jnp.asarray(c),
                                  jbench.P, values, ti=TI, tj=TI)
        want += float(jnp.sum(s, dtype=jnp.float32))
        if z is not None:
            want += float(jnp.sum(z, dtype=jnp.float32))
    assert got > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5)


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline",
              "raw_kernel_pairs_per_sec", "raw_vs_baseline", "tc_util",
              "baseline_pairs_per_sec", "hbm_bytes_per_sec", "card"}


def _json_lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def test_bench_main_on_cpu(capsys):
    assert bench.main(["--device", "cpu", "--n", "256", "--ti", "64",
                       "--reps", "1", "--ring", "256"]) == 0
    (out,) = _json_lines(capsys)
    assert BENCH_KEYS | {"ring_pairs_per_sec", "ring_vs_baseline"} <= \
        set(out)
    assert out["metric"] == "pair_comparisons_per_sec_per_chip"
    assert out["device"] == "cpu" and out["n_genomes"] == 256
    assert out["value"] > 0 and out["raw_kernel_pairs_per_sec"] > 0
    assert out["ring_pairs_per_sec"] > 0
    # off the card: no baseline, bandwidth, utilization or card line
    for key in ("vs_baseline", "raw_vs_baseline", "tc_util",
                "baseline_pairs_per_sec", "hbm_bytes_per_sec", "card",
                "ring_vs_baseline"):
        assert out[key] is None


def test_bench_main_ring_key_only_when_asked(capsys):
    bench.main(["--device", "cpu", "--n", "128", "--ti", "64", "--reps",
                "1"])
    (out,) = _json_lines(capsys)
    assert BENCH_KEYS <= set(out) and "ring_pairs_per_sec" not in out


def test_scale_sweep_rows_on_cpu(capsys):
    assert scale_sweep.main(["--device", "cpu", "--sizes", "128", "256",
                             "--ti", "64", "--reps", "1"]) == 0
    rows = _json_lines(capsys)
    assert [r["n_genomes"] for r in rows] == [128, 256]
    for r in rows:
        assert set(r) == {"n_genomes", "pairs_per_sec", "vs_baseline",
                          "raw_kernel_pairs_per_sec", "tc_util"}
        assert r["pairs_per_sec"] > 0 and r["vs_baseline"] is None


def test_kernel_tuning_rows_on_cpu(capsys):
    """Configurations K2 can run give a rate; the Pallas knobs it has no
    counterpart for give an error row each, and the sweep goes on."""
    cfgs = ("64:auto:int8:chunk4,128:auto:int8:chunk2,64:2048:int8,"
            "64:auto:bf16,64:auto:int8:fpb6,64:auto:int8:fpb8:chunk4")
    assert kernel_tuning.main(["--device", "cpu", "--n", "256", "--tiles",
                               "4", "--reps", "1", "--configs", cfgs]) == 0
    rows = _json_lines(capsys)
    assert [r["config"] for r in rows] == cfgs.split(",")
    for r in rows[:2] + rows[5:]:
        assert set(r) == {"config", "n_values", "pairs_per_sec", "tc_util"}
        assert r["pairs_per_sec"] > 0 and r["tc_util"] is None
    for r, knob in zip(rows[2:5], ("r_sub=2048", "precision=bf16", "fpb6")):
        assert set(r) == {"config", "error"} and knob in r["error"]


def test_kernel_tuning_parse():
    assert kernel_tuning.parse("512:auto:int8") == (512, 64)
    assert kernel_tuning.parse("1024:auto:int8") == (1024, 1)
    assert kernel_tuning.parse("1024:auto:int8:chunk64:fpb8") == (1024, 64)
    with pytest.raises(ValueError, match="r_sub"):
        kernel_tuning.parse("512:1024:int8")


@pytest.fixture(scope="module")
def small_planted():
    bank, picks, _ = validate_131k_scale.make_bank(256, n_dups=16)
    return bank, picks


def test_validate_harnesses_baseline_keys(monkeypatch, small_planted):
    """validate_131k_scale.run and validate_ring_scale.run carry
    upload_stats and the reference's vs_baseline keys: rate / the card's
    baseline, measured once; null off the card, as is the plan-stage
    peak."""
    bank, _ = small_planted
    params = SelectionParams(tau=0.9, criterion="smh_a", aux_bytes=256)
    rec, _ = validate_131k_scale.run(bank, params, ti=64, chunk=8,
                                     device="cpu")
    assert rec["vs_baseline"] is None and rec["resident_vs_baseline"] is None
    # the plan's bank: the 256 rows in their own order and one zero row
    assert rec["device_bank_bytes"] == (256 + 1) << 14
    assert rec["plan_peak_allocated_bytes"] is None  # a card's number
    assert set(rec["upload_stats"]) == {
        "slabs", "gather_secs", "put_ret_secs", "token_wait_secs",
        "pack_secs", "pack_bits", "wire_wait_secs"}
    rrec, _ = validate_ring_scale.run(bank, params, mesh=row_mesh(["cpu"]),
                                      device="cpu")
    assert rrec["vs_baseline"] is None and rrec["upload_stats"]["slabs"] == 1

    calls = []
    monkeypatch.setattr(hopper, "card_baseline",
                        lambda dev, p=14: calls.append(p) or 1e5)
    rec, _ = validate_131k_scale.run(bank, params, ti=64, chunk=8,
                                     device="cpu")
    assert rec["vs_baseline"] == rec["triangle_pairs_per_sec"] / 1e5
    assert rec["resident_vs_baseline"] == \
        rec["resident_pairs_per_sec"] / 1e5
    rrec, _ = validate_ring_scale.run(bank, params, mesh=row_mesh(["cpu"]),
                                      device="cpu")
    assert rrec["vs_baseline"] == rrec["triangle_pairs_per_sec"] / 1e5
    assert calls == [14, 14]
