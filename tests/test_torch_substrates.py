"""The port's training substrates against the JAX package's: the
synthetic data stream, checkpoints (each package restores the other's),
the checkpoint manager, the straggler monitor, the ``launch.train`` CLI
(loss descends; ``--resume`` continues the stream exactly, as JAX's
``tests/test_system.py::TestFaultTolerance`` checks its own restart) and
``examples/torch_train_tiny_lm.py``, on the CPU.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.fault_tolerance as JF
from repro.checkpoint import latest_step as j_latest_step
from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.data import SyntheticLM as JSyntheticLM

import repro_torch.distributed.fault_tolerance as TF
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.data import DataState, SyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.models.params import tree_items

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the training loops here run many tiny
    ops, which the suite's parallel workers would otherwise make wait on
    each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("vocab,seq,batch,hosts,noise", [
    (128, 16, 4, 1, 0.05), (256206, 33, 8, 2, 0.05), (50, 8, 6, 3, 0.0)])
def test_synthetic_stream_equals_jax(vocab, seq, batch, hosts, noise):
    for host in range(hosts):
        j = JSyntheticLM(vocab, seq, batch, host_count=hosts, host_id=host,
                         noise=noise)
        t = SyntheticLM(vocab, seq, batch, host_count=hosts, host_id=host,
                        noise=noise)
        for _ in range(4):
            a, b = j.next_batch(), t.next_batch()
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for k in a:
                assert b[k].dtype == a[k].dtype == np.int32
                assert b[k].tobytes() == a[k].tobytes()
        j.skip_to(9)
        t.skip_to(9)
        assert t.next_batch()["tokens"].tobytes() == \
            j.next_batch()["tokens"].tobytes()
        assert t.state.to_dict() == j.state.to_dict() == {"seed": 17,
                                                          "step": 10}


def test_data_state_round_trip():
    s = DataState.from_dict({"seed": "3", "step": 11.0})
    assert (s.seed, s.step) == (3, 11) and s.to_dict() == {"seed": 3,
                                                             "step": 11}


# ------------------------------------------------------------ checkpoints

def _trees(rng):
    w = rng.standard_normal((2, 3, 4)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    jtree = {"params": {"layer": {"w": jnp.array(w),
                                  "b": jnp.array(b, jnp.bfloat16)}},
             "opt": {"count": jnp.int32(7)}}
    ttree = {"params": {"layer": {"w": torch.tensor(w),
                                  "b": torch.tensor(b).bfloat16()}},
             "opt": {"count": torch.tensor(7, dtype=torch.int32)}}
    return jtree, ttree


def _same(ttree, jtree):
    flat_j = {".".join(p.key for p in path): np.asarray(a)
              for path, a in jax.tree_util.tree_leaves_with_path(jtree)}
    flat_t = dict(tree_items(ttree))
    assert sorted(flat_j) == sorted(flat_t)
    for k, a in flat_j.items():
        t = flat_t[k]
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert t.view(torch.int16).numpy().tobytes() == \
                a.view(np.int16).tobytes(), k
        else:
            assert t.numpy().dtype == a.dtype and \
                t.numpy().tobytes() == a.tobytes(), k


def test_each_package_restores_the_other(tmp_path):
    jtree, ttree = _trees(np.random.default_rng(0))
    j_save(str(tmp_path / "jax"), 40, jtree, extras={"data_step": 41})
    save_checkpoint(str(tmp_path / "port"), 40, ttree,
                    extras={"data_step": 41})
    for name in ("arrays.npz", "manifest.json"):       # the same bytes
        assert (tmp_path / "jax" / "step_00000040" / name).read_bytes() == \
            (tmp_path / "port" / "step_00000040" / name).read_bytes()
    got, extras, step = restore_checkpoint(str(tmp_path / "jax"), ttree,
                                           device="cpu")
    assert step == 40 and extras == {"data_step": 41}
    _same(got, jtree)
    jgot, jextras, jstep = j_restore(str(tmp_path / "port"), jtree)
    assert jstep == 40 and jextras == {"data_step": 41}
    _same(ttree, jgot)
    assert jgot["params"]["layer"]["b"].dtype == jnp.bfloat16


def test_keep_k_and_staging(tmp_path):
    """JAX's ``TestCheckpoint.test_roundtrip_and_keep_k`` on the port, plus
    a stale ``.tmp`` staging directory: ignored by ``latest_step`` and
    by either package's restore, replaced by the next save of its step."""
    _, ttree = _trees(np.random.default_rng(1))
    d = str(tmp_path)
    for step in (10, 20, 30, 40):
        save_checkpoint(d, step, ttree, extras={"data_step": step}, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000030", "step_00000040"]
    os.makedirs(os.path.join(d, "step_00000050.tmp"))
    assert latest_step(d) == j_latest_step(d) == 40
    restored, extras, step = restore_checkpoint(d, ttree, device="cpu")
    assert step == 40 and extras["data_step"] == 40
    assert restored["params"]["layer"]["b"].dtype == torch.bfloat16
    save_checkpoint(d, 50, ttree, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000040", "step_00000050"]
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), ttree, device="cpu")


def test_restore_checks_shape_and_bytes(tmp_path):
    _, ttree = _trees(np.random.default_rng(2))
    save_checkpoint(str(tmp_path), 1, ttree)
    bad = {"params": {"layer": {"w": torch.zeros(2, 3, 5),
                                "b": torch.zeros(5, dtype=torch.bfloat16)}},
           "opt": {"count": torch.tensor(0, dtype=torch.int32)}}
    with pytest.raises(ValueError, match="layer/w"):
        restore_checkpoint(str(tmp_path), bad, device="cpu")
    npz = tmp_path / "step_00000001" / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    at = raw.index(np.float32(ttree["params"]["layer"]["w"][0, 0, 0])
                   .tobytes())
    raw[at] ^= 0xFF                                  # one flipped byte
    npz.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        restore_checkpoint(str(tmp_path), ttree, device="cpu")


# ------------------------------------------------- manager, stragglers

def test_checkpoint_manager_matches_jax(tmp_path):
    j = JF.CheckpointManager(str(tmp_path / "j"), interval_steps=10, keep=2)
    t = TF.CheckpointManager(str(tmp_path / "t"), interval_steps=10, keep=2)
    assert [t.should_save(s) for s in range(25)] == \
        [j.should_save(s) for s in range(25)]
    jtree, ttree = _trees(np.random.default_rng(3))
    for s in (10, 20, 30):
        j.save(s, jtree, extras={"data_step": s + 1})
        t.save(s, ttree, extras={"data_step": s + 1})
    assert sorted(os.listdir(t.directory)) == sorted(
        os.listdir(j.directory))
    assert t.latest_step() == j.latest_step() == 30
    tree, extras, step = t.restore_latest(ttree, device="cpu")
    assert step == 30 and extras == {"data_step": 31}
    _same(tree, j.restore_latest(jtree)[0])
    old = signal.getsignal(signal.SIGTERM)
    try:
        t.install_preemption_handler()
        assert not t.should_save(5)
        os.kill(os.getpid(), signal.SIGTERM)
        assert t.should_save(5)
    finally:
        signal.signal(signal.SIGTERM, old)


def test_straggler_monitor_matches_jax(monkeypatch):
    """The same step times (a clock fed to both modules) flag the same
    steps: none before 8 are seen, then those past median + k·MAD."""
    times = [0.01, 0.011, 0.0105, 0.0098, 0.0102, 0.01, 0.0101, 0.0099,
             0.05, 0.0103, 0.0097, 0.2, 0.01]
    flags = {}
    for mod in (JF, TF):
        clock = iter(np.cumsum([0.0] + [x for t_ in times for x in (t_, 1.0)]))
        monkeypatch.setattr(mod.time, "monotonic", lambda: next(clock))
        mon = mod.StragglerMonitor(window=16, k=3.0)
        out = []
        for _ in times:
            mon.step_start()
            out.append(mon.step_end())
        flags[mod] = (out, mon.summary())
    assert flags[TF] == flags[JF]
    assert flags[TF][0][8] and flags[TF][0][11] and sum(flags[TF][0]) == 2
    assert TF.StragglerMonitor().summary() == {"median_s": 0.0, "flagged": 0}


# ------------------------------------------------- the train CLI, example

def _train(tmp_path, *extra):
    argv = ["--arch", "h2o-danube-1.8b", "--smoke", "--device", "cpu",
            "--steps", "30", "--batch", "8", "--seq", "32", "--log-every",
            "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "15", *extra]
    return ttrain.main(argv)


def test_train_cli_descends_and_resumes_exactly(tmp_path, capsys):
    losses = _train(tmp_path)
    out = capsys.readouterr().out.splitlines()
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])
    assert out[0].startswith("step     0 ce=") and "lr=0.00e+00" in out[0]
    assert out[-1].startswith("final: first10=")
    assert sorted(os.listdir(tmp_path)) == ["step_00000015"]
    manifest = json.loads((tmp_path / "step_00000015" /
                           "manifest.json").read_text())
    assert manifest["extras"] == {"data_step": 16}
    resumed = _train(tmp_path, "--resume")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 15"
    assert out[1].startswith("step    16 ce=")
    np.testing.assert_allclose(resumed, losses[16:], rtol=1e-6)


def test_train_cli_encdec_and_vlm(tmp_path, capsys):
    for arch in ("seamless-m4t-large-v2", "qwen2-vl-2b"):
        argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "4",
                "--batch", "4", "--seq", "16"]
        a, b = ttrain.main(argv), ttrain.main(argv)
        assert len(a) == 4 and all(np.isfinite(a)) and a == b   # seeded


def test_train_cli_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "qwen3-8b", "--smoke", "--steps", "1"])


def test_train_example_prints_its_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_tiny_lm.py"),
         "--device", "cpu", "--steps", "40"], env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.splitlines()
    want = ["step    0  ce=", "step   25  ce=",
            "loss: ", "checkpoint roundtrip ok (data_step=40)",
            "prompt tail: [12, 13, 14, 15]  generated: ",
            "pattern accuracy: "]
    assert len(lines) == len(want)
    for line, prefix in zip(lines, want):
        assert line.startswith(prefix), (line, prefix)
