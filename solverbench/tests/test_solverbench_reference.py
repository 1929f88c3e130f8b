"""The plain reference against fp64 numpy.linalg.lstsq."""
import numpy as np
import torch

from sbtest import spec

ref = spec.reference("lstsq_fp64")


def test_reference_matches_lstsq():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 40)).astype(np.float32)
    ys = rng.normal(size=(5, 3000)).astype(np.float32)   # inconsistent
    ys[0] = x @ rng.normal(size=40).astype(np.float32)   # planted
    old = ref.BLOCK_BYTES
    ref.BLOCK_BYTES = 8 * 40 * 700       # several row blocks
    try:
        got = ref.solve(torch.from_numpy(x), ys)
    finally:
        ref.BLOCK_BYTES = old
    want = np.linalg.lstsq(x.astype(np.float64), ys.T.astype(np.float64),
                           rcond=None)[0]
    assert got.shape == (40, 5)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_coef_error():
    ref_rows = np.array([[1.0, -2.0], [0.5, 0.5]])
    coef = np.array([[1.0, -2.002], [0.5, 0.5]], np.float32)
    err = ref.coef_error(coef, ref_rows)
    assert abs(err[0] - 0.001) < 1e-6
    assert err[1] == 0.0


def test_tf32_rounding():
    # To nearest, ties away from zero.
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12,
                      1.0 + 2.0 ** -11 + 2.0 ** -13, -3.0 - 2.0 ** -10])
    got = ref.to_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -10,
                         -3.0 - 2.0 ** -9])
    assert torch.equal(got, want)


def test_tf32_control_departs_from_fp64():
    # The control is the reference in TF32: on a planted system it is off
    # by TF32's rounding of x, orders above fp32's.
    g = torch.Generator().manual_seed(3)
    x = torch.randn((8192, 128), generator=g)
    a = torch.randn((128, 4), generator=g)
    ys = (x @ a).T.contiguous().numpy()
    exact = ref.solve(x, ys).T
    ctrl = ref.solve(x, ys, precision="tf32").T
    err = ref.coef_error(ctrl, exact)
    assert (err > 1e-5).all() and (err < 1e-2).all()
