"""repro_torch.core.types against repro.core.types: the stopping rule's
truth table, the fp32 column norms, safe_inv, warm_retention_ok and the
atol→SSE threshold.  Inputs are numpy arrays handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro_torch.core import types as ttypes

F = np.float32
# (sse, sse_prev, sse0, atol_sse, rtol) — one row per branch of the rule.
STOP_CASES = {
    "atol_hit": (F(1e-6), F(1.0), F(10.0), F(1e-5), F(0.0)),
    "atol_miss": (F(1e-4), F(1.0), F(10.0), F(1e-5), F(0.0)),
    "atol_off": (F(0.0), F(1.0), F(10.0), F(0.0), F(0.0)),
    "rtol_hit": (F(0.99999), F(1.0), F(10.0), F(0.0), F(1e-4)),
    "rtol_miss": (F(0.5), F(1.0), F(10.0), F(0.0), F(1e-4)),
    "rtol_equal": (F(1.0), F(1.0), F(10.0), F(0.0), F(1e-4)),
    "rise_in_band": (F(10.05), F(10.0), F(10.0), F(0.0), F(1e-4)),
    "rise_out_of_band": (F(10.2), F(10.0), F(10.0), F(0.0), F(1e-4)),
    "rise_band_edge": (F(1.01) * F(10.0), F(9.0), F(10.0), F(0.0), F(1e-6)),
    "rise_rtol_off": (F(12.0), F(10.0), F(10.0), F(0.0), F(0.0)),
    "rtol_0_improving": (F(0.5), F(1.0), F(10.0), F(0.0), F(0.0)),
    "atol_and_rtol": (F(1e-7), F(1e-7), F(10.0), F(1e-6), F(1e-3)),
    "nan_sse": (F(np.nan), F(1.0), F(10.0), F(0.0), F(1e-4)),
    "nan_sse_rtol_off": (F(np.nan), F(1.0), F(10.0), F(1e-3), F(0.0)),
}


@pytest.mark.parametrize("case", sorted(STOP_CASES))
def test_sweep_stop_flags_truth_table(case):
    args = STOP_CASES[case]
    jc, js = jtypes.sweep_stop_flags(*(jnp.float32(a) for a in args))
    tc, ts = ttypes.sweep_stop_flags(*(torch.tensor(a) for a in args))
    assert (bool(tc), bool(ts)) == (bool(jc), bool(js))
    # Python floats (as the solvers pass atol_sse/rtol) decide the same.
    tc2, ts2 = ttypes.sweep_stop_flags(torch.tensor(args[0]),
                                       torch.tensor(args[1]),
                                       torch.tensor(args[2]),
                                       float(args[3]), float(args[4]))
    assert (bool(tc2), bool(ts2)) == (bool(jc), bool(js))


def test_sweep_stop_flags_random_agreement():
    rng = np.random.default_rng(3)
    for _ in range(200):
        sse0 = F(rng.uniform(1, 10))
        sse_prev = F(sse0 * rng.uniform(0.5, 1.0))
        sse = F(sse_prev * rng.uniform(0.98, 1.03))
        atol_sse = F(rng.choice([0.0, sse * rng.uniform(0.9, 1.1)]))
        rtol = F(rng.choice([0.0, 1e-3, 1e-2]))
        args = (sse, sse_prev, sse0, atol_sse, rtol)
        j = jtypes.sweep_stop_flags(*(jnp.float32(a) for a in args))
        t = ttypes.sweep_stop_flags(*(torch.tensor(a) for a in args))
        assert [bool(v) for v in t] == [bool(v) for v in j], args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_column_norms_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, 24)).astype(np.float32)
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    np.testing.assert_allclose(ttypes.column_norms_sq(tx).numpy(),
                               np.asarray(jtypes.column_norms_sq(jx)),
                               rtol=1e-5)
    np.testing.assert_allclose(ttypes.column_norms_sq_t(tx.T).numpy(),
                               np.asarray(jtypes.column_norms_sq_t(jx.T)),
                               rtol=1e-5)
    assert ttypes.column_norms_sq(tx).dtype == torch.float32


def test_safe_inv_zero_columns():
    cn = np.array([4.0, 0.0, 0.5, 0.0, 1e-30], np.float32)
    got = ttypes.safe_inv(torch.tensor(cn)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtypes.safe_inv(
        jnp.asarray(cn))))
    assert np.all(np.isfinite(got)) and got[1] == 0.0 and got[3] == 0.0


def _results(converged, history):
    h = np.asarray(history, np.float32)
    t = ttypes.SolveResult(torch.zeros(2), torch.zeros(3), torch.tensor(0.0),
                           torch.tensor(len(h), dtype=torch.int32),
                           torch.tensor(converged), torch.tensor(h))
    j = jtypes.SolveResult(jnp.zeros(2), jnp.zeros(3), jnp.float32(0.0),
                           jnp.int32(len(h)), jnp.bool_(converged),
                           jnp.asarray(h))
    return t, j


@pytest.mark.parametrize("converged,history,want", [
    (True, [10.0, 20.0, 40.0], True),
    (False, [10.0, 5.0, 1.0], True),
    (False, [10.0, 10.05, np.nan], True),
    (False, [10.0, 12.0, 40.0], False),
    (False, [10.0, 40.0, np.nan, np.nan], False),
    (False, [np.nan, np.nan], True),
])
def test_warm_retention_ok_matches_jax(converged, history, want):
    t, j = _results(converged, history)
    assert ttypes.warm_retention_ok(t) == jtypes.warm_retention_ok(j) == want


@pytest.mark.parametrize("obs,k,atol", [(300, 1, 1e-3), (1000, 8, 3e-7),
                                        (17, 3, 0.0)])
def test_atol_to_sse_is_the_fp32_threshold(obs, k, atol):
    want = jnp.float32(obs * k) * jnp.float32(atol) ** 2
    assert ttypes.atol_to_sse(obs, k, atol) == float(want)
