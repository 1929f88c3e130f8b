"""The paper's solver on the port's LM activations, against JAX's on JAX's:
``TestSolverIntegration``'s two cases (``tests/test_system.py``) on
qwen3-8b's smoke model with JAX's weights carried across, then the
``launch.serve`` CLI and the three ``examples/torch_*.py`` on the CPU.

Features agree to 1e-5 of their largest magnitude; so do the fitted
coefficients (1e-5 of the largest |coef|), and both fits recover the
planted readout to JAX's bound, ‖coef − w‖/‖w‖ < 1e-2.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.configs.registry import get as jget
from repro.models.common import embed_tokens, rmsnorm
from repro.models.model import init_model, make_smoke_batch
from repro.models.transformer import run_backbone
from repro_torch.configs.registry import get as tget
from repro_torch.launch import serve as tserve
from repro_torch.models.model import probe_features
from repro_torch.models.params import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5


def _close(port, ref, tol=TOL):
    port = port.detach().cpu().numpy().astype(np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= tol * np.abs(ref).max()


@pytest.fixture(scope="module")
def features():
    """JAX's features from JAX's model, and the port's from the same
    weights and tokens (qwen3-8b smoke, 8 x 32 tokens: 256 x 64)."""
    jcfg, tcfg = jget("qwen3-8b").smoke(), tget("qwen3-8b").smoke()
    params = init_model(jcfg, jax.random.PRNGKey(0))
    batch = make_smoke_batch(jcfg, jax.random.PRNGKey(1), batch=8, seq=32)
    x = embed_tokens(params["embed"], batch["tokens"], jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(32)[None], (8, 32))
    h, _, _ = run_backbone(jcfg, params["backbone"], x, mode="train",
                           positions=pos)
    jfeats = rmsnorm(h, params["final_ln"]).reshape(-1, jcfg.d_model)
    tparams = params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tfeats = probe_features(tcfg, tparams,
                            torch.tensor(np.asarray(batch["tokens"])))
    return jfeats, tfeats


def test_features_match(features):
    jfeats, tfeats = features
    assert tuple(tfeats.shape) == (256, 64)
    _close(tfeats, jfeats)


@pytest.mark.parametrize("k", [1, 8])
def test_linear_probe_on_activations(features, k):
    jfeats, tfeats = features
    w = np.random.default_rng(2).normal(
        size=(64,) if k == 1 else (64, k)).astype(np.float32)
    jres = J.fit_linear_probe(jfeats, jfeats @ jnp.array(w), max_iter=100,
                              rtol=1e-10)
    tres = T.fit_linear_probe(tfeats, tfeats @ torch.tensor(w),
                              max_iter=100, rtol=1e-10, device="cpu")
    _close(tres.coef, jres.coef)
    for coef in (np.asarray(jres.coef), tres.coef.numpy()):
        assert np.linalg.norm(coef - w) / np.linalg.norm(w) < 1e-2


def test_feature_selection_on_activations(features):
    jfeats, tfeats = features
    idx = [3, 17, 41]
    jsel = J.solvebakf(jfeats, jfeats[:, idx[0]] * 2 - jfeats[:, idx[1]]
                       + 3 * jfeats[:, idx[2]], max_feat=3)
    tsel = T.solvebakf(tfeats, tfeats[:, idx[0]] * 2 - tfeats[:, idx[1]]
                       + 3 * tfeats[:, idx[2]], max_feat=3)
    assert set(tsel.selected.tolist()) == set(idx)
    assert tsel.selected.tolist() == np.asarray(jsel.selected).tolist()
    _close(tsel.coef, jsel.coef)


@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_serve_cli_on_cpu(capsys, temperature):
    argv = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--batch",
            "3", "--prompt-len", "12", "--gen", "5", "--temperature",
            temperature]
    out = tserve.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 12 tok x3: ")
    assert lines[1].startswith("decode 5 steps: ") and "tok/s" in lines[1]
    assert lines[2] == "generated ids:"
    assert out.shape == (3, 5) and out.dtype == np.int32
    assert ((out >= 0) & (out < tget("qwen3-8b").smoke().padded_vocab)).all()
    np.testing.assert_array_equal(tserve.main(argv), out)   # seeded


def test_serve_cli_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen3-8b", "--smoke"])


@pytest.mark.parametrize("arch", ["mamba2-370m", "dbrx-132b", "zamba2-7b",
                                  "arctic-480b"])
@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_serve_cli_serves_the_moe_ssm_and_hybrid_families(capsys, arch,
                                                          temperature):
    """The MoE, SSM and hybrid families through launch/serve on the CPU:
    its three lines, ids in the vocab, seeded and repeatable."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "20", "--gen", "4", "--temperature",
            temperature]
    out = tserve.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 20 tok x2: ")
    assert lines[1].startswith("decode 4 steps: ") and "tok/s" in lines[1]
    assert lines[2] == "generated ids:"
    assert out.shape == (2, 4) and out.dtype == np.int32
    assert ((out >= 0) & (out < tget(arch).smoke().padded_vocab)).all()
    np.testing.assert_array_equal(tserve.main(argv), out)   # seeded


@pytest.mark.parametrize("name,want", [
    ("torch_quickstart", ["[bakp_gram] sweeps=", "[bak] SSE per sweep:",
                          "[wide] residual=",
                          "[bakf] planted=[7, 80, 201] "
                          "selected=[7, 80, 201]"]),
    ("torch_feature_selection", ["planted   : ", "solvebakf : ",
                                 "stepwise  : ", "speed-up  : ",
                                 "SSE path  :"]),
    ("torch_linear_probe", ["features: (1024, 64) (tall system",
                            "bak probe: ",
                            "probe recovers planted direction: "
                            "[2.0, -1.5, 0.7]"]),
])
def test_examples_print_their_lines(name, want):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py"),
                          "--device", "cpu"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.splitlines()
    assert len(lines) == len(want)
    for line, prefix in zip(lines, want):
        assert line.startswith(prefix), (line, prefix)
    if name == "torch_feature_selection":
        assert lines[0][12:] == lines[1][12:lines[1].index("]") + 1]
