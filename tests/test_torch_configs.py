"""The port's configs against the JAX package's: every registered
architecture and its ``smoke()`` field by field, the derived numbers
(``resolved_head_dim``, ``padded_vocab``, ``n_params``,
``n_active_params``), the shape cells and the registry.  The port keeps
its own copy of these data files (it imports nothing of ``repro``), so
this is what keeps the two copies equal.
"""
import dataclasses

import pytest

import repro.configs.base as jbase
import repro.configs.registry as jreg
import repro_torch.configs.base as tbase
import repro_torch.configs.registry as treg

ARCHS = sorted(jreg.ARCHS)


def test_registry_names_and_cells():
    assert sorted(treg.ARCHS) == ARCHS
    assert treg.LONG_CONTEXT_ARCHS == jreg.LONG_CONTEXT_ARCHS
    assert ({k: dataclasses.asdict(v) for k, v in tbase.SHAPE_CELLS.items()}
            == {k: dataclasses.asdict(v)
                for k, v in jbase.SHAPE_CELLS.items()})
    assert ([(a, c.name) for a, c in treg.all_cells()]
            == [(a, c.name) for a, c in jreg.all_cells()])
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get("no-such-arch")


def test_schema_fields():
    t = [(f.name, f.default) for f in dataclasses.fields(tbase.ModelConfig)]
    j = [(f.name, f.default) for f in dataclasses.fields(jbase.ModelConfig)]
    assert t == j


def _same(tcfg, jcfg):
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim
    assert tcfg.padded_vocab == jcfg.padded_vocab
    assert tcfg.is_encdec == jcfg.is_encdec
    assert tcfg.n_params() == jcfg.n_params()
    assert tcfg.n_active_params() == jcfg.n_active_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches(arch):
    _same(treg.get(arch), jreg.get(arch))
    assert ([c.name for c in treg.cells_for(arch)]
            == [c.name for c in jreg.cells_for(arch)])


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_matches(arch):
    _same(treg.get(arch).smoke(), jreg.get(arch).smoke())


def test_qwen3_8b_full_width():
    cfg = treg.get("qwen3-8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == (
        36, 4096, 32, 8, 128, 12288, 151936)
    assert cfg.padded_vocab == 152064
    assert cfg.dtype == "bfloat16" and cfg.qk_norm
