"""The port's config registry against the JAX package's: ``get`` and
``reduced`` field by field for every ported name (the dense family, the
mixture-of-experts kimi-k2 and llama4-maverick, the latent-attention
minicpm3, the Mamba hybrid jamba-1.5-large-398b and the recurrent
xlstm-125m) and its ``-smoke`` form; every other assigned architecture
raises ``NotImplementedError`` naming its ROADMAP item and what it
waits on."""
import dataclasses

import pytest

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg

DENSE = ["stablelm-3b", "starcoder2-7b", "llama3-405b", "llama3.2-1b",
         "gpt2", "deepseek-llm-7b-base", "tiny-llm"]
FAMILIES = ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b", "minicpm3-4b"]
RECURRENT = ["jamba-1.5-large-398b", "xlstm-125m"]
PORTED = DENSE + FAMILIES + RECURRENT
# JAX fields of the families still to port, which the port's config
# leaves out
LEFT_OUT = ("mrope_sections", "encoder_decoder", "n_encoder_layers",
            "n_frontend_tokens", "frontend")
# sub-configs, compared field by field (the two packages' classes differ)
NESTED = ("lora", "moe", "mla", "mamba", "xlstm")


def _same(got, want):
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name in NESTED and g is not None:
            assert w is not None, f.name
            for sub in dataclasses.fields(g):
                assert getattr(g, sub.name) == getattr(w, sub.name), \
                    (f.name, sub.name)
        else:
            assert g == w, f.name
    for f in dataclasses.fields(want):
        if not hasattr(got, f.name):
            assert f.name in LEFT_OUT, f.name
            assert getattr(want, f.name) == f.default or (
                f.default_factory is not dataclasses.MISSING), f.name


@pytest.mark.parametrize("suffix", ["", "-smoke"])
@pytest.mark.parametrize("name", PORTED)
def test_get_equals_jax_field_for_field(name, suffix):
    _same(treg.get(name + suffix), jreg.get(name + suffix))


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("kw", [{}, dict(d_model=128, n_groups=2,
                                        vocab=1024)])
def test_reduced_equals_jax(name, kw):
    _same(tbase.reduced(treg.get(name), **kw),
          jbase.reduced(jreg.get(name), **kw))


def test_the_dense_names_are_the_jax_dense_names():
    """Every JAX name whose layers are GQA, MLA, Mamba or xLSTM with an
    MLP, MoE or no block (no frontend, no encoder) is ported, and no
    other: the dense names and, since each family was ported, the MoE,
    MLA, Mamba and xLSTM ones."""
    ported = [n for n in jreg.all_names()
              if all(m in ("attn", "mla", "mamba", "mlstm", "slstm")
                     and f in ("mlp", "moe", "none")
                     for m, f in jreg.get(n).pattern)
              and not jreg.get(n).encoder_decoder
              and not jreg.get(n).frontend]
    assert sorted(treg.ported_names()) == sorted(ported) == sorted(PORTED)
    assert sorted(treg.ported_names() + list(treg.OTHER_FAMILIES)) == \
        sorted(jreg.all_names())


@pytest.mark.parametrize("suffix", ["", "-smoke"])
@pytest.mark.parametrize("name", sorted(treg.OTHER_FAMILIES))
def test_other_families_raise(name, suffix):
    jreg.get(name + suffix)            # the JAX package has it
    with pytest.raises(NotImplementedError, match="other model families"):
        treg.get(name + suffix)
    with pytest.raises(NotImplementedError,
                       match=treg.OTHER_FAMILIES[name].split(" (")[0]):
        treg.get(name + suffix)


@pytest.mark.parametrize("suffix", ["", "-smoke"])
@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_families_resolve(name, suffix):
    """jamba-1.5-large-398b and xlstm-125m, once among the names that
    raised, resolve with their sub-configs: Mamba's at d_state 16, d_conv
    4, expand 2 (dt_rank ceil(d_model/16)), the xLSTM's at expand 2,
    conv width 4; ``-smoke`` leaves both as they are."""
    assert name not in treg.OTHER_FAMILIES and name in treg.ported_names()
    cfg = treg.get(name + suffix)
    assert cfg.name == name + suffix
    if name.startswith("jamba"):
        assert cfg.mamba == tbase.MambaConfig(16, 4, 2, None)
        assert cfg.xlstm is None and cfg.moe.n_experts == (
            4 if suffix else 16)
    else:
        assert cfg.xlstm == tbase.XLSTMConfig(2, 4 / 3, 4)
        assert cfg.mamba is None and cfg.d_ff == 0


def test_unknown_names_raise_key_error():
    for name in ("gpt-5", "gpt-5-smoke", "stablelm-3b-smoke-smoke-x"):
        with pytest.raises(KeyError):
            treg.get(name)
