"""The port's int8 gradient compression
(``repro_torch.distributed.compression``) against
``repro.distributed.compression``: q, the fp32 scale and the error are
bit-equal to JAX's (both round half to even; the 1e-12 floor), on seeded
trees with exact .5 ties, an all-zero tensor, bf16 and fp32 gradients,
and five steps of error feedback."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.distributed import compression as J
from repro_torch.distributed import compression as T
from repro_torch.models.params import tensor_from_numpy


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tree(seed, dtype):
    r = np.random.default_rng(seed)
    ties = (np.arange(-10, 11, dtype=np.float32) + 0.5)   # scale 1 below
    ties = np.concatenate([ties, [-127.0, 127.0]]).astype(np.float32)
    return {
        "dense": {"w": r.standard_normal((16, 12)).astype(dtype),
                  "b": (r.standard_normal((12,)) * 1e-3).astype(dtype)},
        "ties": ties.astype(dtype),
        "zero": np.zeros((5, 3), dtype),
        "big": (r.standard_normal((4, 7, 9)) * 1e4).astype(dtype),
    }


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    return tensor_from_numpy(tree, "cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _equal(t_tree, j_tree):
    tl, jl = dict(_leaves(t_tree)), dict(_leaves(j_tree))
    assert set(tl) == set(jl)
    for name in tl:
        a, b = _np(tl[name]), np.asarray(jl[name])
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8),
                                      err_msg=name)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["fp32", "bf16"])
def test_compress_bit_equal(dtype):
    g = _tree(0, dtype)
    err = {k: v for k, v in _tree(1, np.float32).items()}
    err = {"dense": {kk: vv * 1e-2 for kk, vv in err["dense"].items()},
           "ties": np.zeros_like(err["ties"]), "zero": err["zero"],
           "big": err["big"] * 1e-2}
    jq, js, je = J.compressed_tree(
        {k: (jnp.asarray(v) if not isinstance(v, dict) else
             {kk: jnp.asarray(vv) for kk, vv in v.items()})
         for k, v in g.items()},
        {k: (jnp.asarray(v) if not isinstance(v, dict) else
             {kk: jnp.asarray(vv) for kk, vv in v.items()})
         for k, v in err.items()})
    tq, ts, te = T.compressed_tree(_to_t(g), _to_t(err))
    _equal(tq, jq)
    _equal(ts, js)
    _equal(te, je)
    assert tq["zero"].abs().max() == 0 and float(ts["zero"]) == np.float32(
        1e-12) / np.float32(127.0)
    _equal(T.decompressed_tree(tq, ts), J.decompressed_tree(jq, js))


def test_ties_round_half_to_even():
    """max |g| = 127 makes the scale 1: the .5 ties land on even q."""
    g = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 127.0])
    q, scale, err = T.compress(g, torch.zeros_like(g))
    assert float(scale) == 1.0
    assert q.tolist() == [0, 2, 2, 0, -2, -2, 127]
    jq, _, _ = J.compress(jnp.asarray(g.numpy()), jnp.zeros(7))
    assert np.asarray(jq).tolist() == q.tolist()


def test_error_feedback_five_steps():
    r = np.random.default_rng(7)
    params = {"a": np.zeros((8, 6), np.float32), "b": np.zeros((6,),
                                                               np.float32)}
    t_err = T.init_error_tree(_to_t(params))
    j_err = J.init_error_tree({k: jnp.asarray(v) for k, v in params.items()})
    _equal(t_err, j_err)
    for _ in range(5):
        g = {k: r.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        fed = {k: torch.tensor(g[k]) + t_err[k] for k in g}
        tq, ts, t_err = T.compressed_tree(_to_t(g), t_err)
        jq, js, j_err = J.compressed_tree(
            {k: jnp.asarray(v) for k, v in g.items()}, j_err)
        _equal(tq, jq)
        _equal(ts, js)
        _equal(t_err, j_err)
        # deq + err is the fed-back gradient g + err_prev, exactly (the
        # error is within half a scale step of deq: Sterbenz)
        for k in g:
            deq = T.decompress(tq[k], ts[k])
            np.testing.assert_array_equal((deq + t_err[k]).numpy(),
                                          fed[k].numpy())
