"""The port's optimizers, LR schedule and gradient clipping against the JAX
package's ``repro.optim``: AdamW and Adafactor over several steps on 1-D,
2-D and stacked 3-D leaves (fp32 and bf16 parameters), the cosine
schedule across its warmup, the global norm and its clip, and JAX's own
optimizer tests (``tests/test_substrates.py::TestOptim``) on the port.

Inputs come from numpy with a seed.  Tolerance: ``TOL`` of each leaf's
largest magnitude for states and fp32 parameters (the same fp32
arithmetic in another order), one bf16 rounding for bf16 parameters,
1e-6 relative for the schedule (XLA and torch may differ in the last bit
of a cosine).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as JO
from repro.optim.schedule import clip_by_global_norm as j_clip
from repro.optim.schedule import cosine_schedule as j_cosine
from repro.optim.schedule import global_norm as j_global_norm

import repro_torch.optim as TO
from repro_torch.models.params import tree_items, tree_map
from repro_torch.optim.schedule import clip_by_global_norm, cosine_schedule
from repro_torch.optim.schedule import global_norm

TOL = 1e-5
SHAPES = {"bias": (7,), "w": (6, 5), "stacked": {"w": (3, 4, 9)}}


def _params(rng, dtype=np.float32):
    def draw(shape):
        return rng.standard_normal(shape).astype(dtype)
    return {"bias": draw((7,)), "w": draw((6, 5)),
            "stacked": {"w": draw((3, 4, 9))}}


def _jax_tree(tree, dtype=None):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _torch_tree(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32)).to(
            dtype or torch.float32), tree)


def _compare(jtree, ttree, tol=TOL):
    for path, a in jax.tree_util.tree_leaves_with_path(jtree):
        node = ttree
        for p in path:
            node = node[p.key]
        a = np.asarray(a, np.float32)
        b = node.float().numpy()
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() <= tol * scale, jax.tree_util.keystr(path)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_updates_over_steps_match_jax(kind, dtype):
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    j_init, j_update = JO.make_optimizer(kind)
    t_init, t_update = TO.make_optimizer(kind)
    jp = _jax_tree(p0, jdt)
    tp = _torch_tree(p0, tdt)
    js, ts = j_init(jp), t_init(tp)
    for step in range(6):
        g = _params(rng)
        lr = 1e-2 * (step + 1)
        jp, js = j_update(_jax_tree(g, jdt), js, jp, lr=lr)
        tp2, ts2 = t_update(_torch_tree(g, tdt), ts, tp,
                            lr=torch.tensor(lr) if step % 2 else lr)
        assert tp2 is tp and ts2 is ts                 # in place
    assert int(ts["count"]) == int(js["count"]) == 6
    state_parts = ("m", "v", "master") if kind == "adamw" else (
        "stats", "master")
    assert sorted(ts) == sorted(state_parts + ("count",))
    for part in state_parts:
        _compare(js[part], ts[part])
    for _, t in tree_items(tp):
        assert t.dtype == tdt
    _compare(jp, tp, TOL if dtype == "float32" else 2 ** -7)


def test_adafactor_factors_the_trailing_two_dims():
    params = _torch_tree(_params(np.random.default_rng(1)))
    stats = TO.adafactor_init(params)["stats"]
    assert stats["bias"]["v"].shape == (7,)
    assert stats["w"]["vr"].shape == (6,) and stats["w"]["vc"].shape == (5,)
    assert stats["stacked"]["w"]["vr"].shape == (3, 4)
    assert stats["stacked"]["w"]["vc"].shape == (3, 9)
    jstats = JO.adafactor_init(_jax_tree(_params(
        np.random.default_rng(1))))["stats"]
    _compare(jstats, stats)


def test_adamw_master_is_a_distinct_fp32_copy():
    params = {"w": torch.ones(4, dtype=torch.bfloat16),
              "f": torch.ones(3)}
    st = TO.adamw_init(params)
    assert st["master"]["w"].dtype == torch.float32
    assert st["master"]["f"].data_ptr() != params["f"].data_ptr()
    g = {"w": torch.full((4,), 0.1, dtype=torch.bfloat16),
         "f": torch.full((3,), 0.1)}
    params2, st2 = TO.adamw_update(g, st, params, lr=1e-2)
    assert params2["w"].dtype == torch.bfloat16
    assert st2["master"]["w"].dtype == torch.float32


@pytest.mark.parametrize("kind,bound", [("adamw", 1e-2), ("adafactor", 1e-1)])
def test_quadratic_converges(kind, bound):
    """JAX's ``TestOptim._quadratic`` on the port."""
    init, update = TO.make_optimizer(kind)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init(params)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, state = update(grads, state, params, lr=0.05,
                               weight_decay=0.0)
    assert float(params["w"].abs().max()) < bound


def test_make_optimizer_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown optimizer"):
        TO.make_optimizer("sgd")


def test_cosine_schedule_across_warmup():
    kw = dict(peak_lr=3e-3, warmup_steps=5, total_steps=20)
    for step in range(0, 26):
        ref = float(j_cosine(jnp.int32(step), **kw))
        got = cosine_schedule(step, **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - ref) <= 1e-6 * max(ref, 1e-12), step
    assert float(cosine_schedule(0, **kw)) == 0.0
    assert float(cosine_schedule(5, **kw)) == pytest.approx(3e-3, rel=1e-6)
    assert float(cosine_schedule(25, **kw)) == pytest.approx(3e-4, rel=1e-6)
    assert float(cosine_schedule(torch.tensor(7), **kw)) == float(
        cosine_schedule(7, **kw))


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clipped", "kept"])
def test_clip_by_global_norm(max_norm):
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((10,)).astype(np.float32) * 3,
            "b": {"c": rng.standard_normal((4, 3)).astype(np.float32)}}
    ttree = _torch_tree(tree)
    ttree["b"]["c"] = ttree["b"]["c"].bfloat16()
    jtree = _jax_tree(tree)
    jtree["b"]["c"] = jtree["b"]["c"].astype(jnp.bfloat16)
    jclipped, jnorm = j_clip(jtree, max_norm)
    before = {k: t.clone() for k, t in tree_items(ttree)}
    out, norm = clip_by_global_norm(ttree, max_norm)
    assert out is ttree                                  # in place
    assert abs(float(norm) - float(jnorm)) <= 1e-6 * float(jnorm)
    assert abs(float(global_norm(before)) - float(j_global_norm(jtree))) \
        <= 1e-6 * float(jnorm)
    assert ttree["b"]["c"].dtype == torch.bfloat16
    _compare(jclipped, ttree, 2 ** -8)
    if max_norm > float(jnorm):
        for k, t in tree_items(ttree):
            assert torch.equal(t, before[k])
    else:
        assert float(global_norm(ttree)) == pytest.approx(max_norm,
                                                          rel=1e-2)


def test_global_norm_of_a_bf16_tree_sums_in_fp32():
    t = {"x": torch.full((1000,), 3.0, dtype=torch.bfloat16)}
    assert float(global_norm(t)) == pytest.approx(3.0 * 1000 ** 0.5,
                                                  rel=1e-6)
    assert tree_map(lambda a: a.dtype, t) == {"x": torch.bfloat16}
