"""The port's config registry against the JAX package's: ``get`` and
``reduced`` field by field for every name (the dense family, the
mixture-of-experts kimi-k2 and llama4-maverick, the latent-attention
minicpm3, the Mamba hybrid jamba-1.5-large-398b, the recurrent
xlstm-125m, the encoder-decoder whisper-large-v3 and the
vision-language qwen2-vl-72b) and its ``-smoke`` form; the port's names
are the JAX package's, and none raises ``NotImplementedError``."""
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
FRONTENDS = ["whisper-large-v3", "qwen2-vl-72b"]
PORTED = DENSE + FAMILIES + RECURRENT + FRONTENDS
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
    assert sorted(f.name for f in dataclasses.fields(got)) == sorted(
        f.name for f in dataclasses.fields(want))


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
    """Every JAX name is ported, in the JAX package's order, and no other:
    the dense names and, since each family was ported, the MoE, MLA,
    Mamba, xLSTM, encoder-decoder and vision ones; every pattern is made
    of the port's mixers and feed-forward blocks."""
    assert treg.all_names() == jreg.all_names()
    assert sorted(treg.all_names()) == sorted(PORTED)
    for n in treg.all_names():
        assert all(m in ("attn", "mla", "mamba", "mlstm", "slstm")
                   and f in ("mlp", "moe", "none")
                   for m, f in treg.get(n).pattern), n


@pytest.mark.parametrize("suffix", ["", "-smoke"])
@pytest.mark.parametrize("name", FRONTENDS)
def test_frontend_families_resolve(name, suffix):
    """whisper-large-v3 and qwen2-vl-72b, the last names that raised,
    resolve with their frontend fields: whisper an encoder as deep as its
    decoder (32 layers, one at ``-smoke``) and 1500 audio frames (16),
    qwen2-vl 1024 patch embeddings (16) and M-RoPE sections (16, 24, 24)
    summing to half its head dim of 128 ((8, 12, 12) of 64)."""
    cfg = treg.get(name + suffix)
    assert cfg.name == name + suffix
    smoke = bool(suffix)
    if name.startswith("whisper"):
        assert cfg.encoder_decoder and cfg.frontend == "audio"
        assert cfg.n_encoder_layers == cfg.n_layers == (1 if smoke else 32)
        assert cfg.n_frontend_tokens == (16 if smoke else 1500)
        assert cfg.mrope_sections == ()
    else:
        assert not cfg.encoder_decoder and cfg.frontend == "vision"
        assert cfg.n_encoder_layers == 0
        assert cfg.n_frontend_tokens == (16 if smoke else 1024)
        assert cfg.mrope_sections == ((8, 12, 12) if smoke else (16, 24, 24))
        assert sum(cfg.mrope_sections) == cfg.head_dim // 2


@pytest.mark.parametrize("suffix", ["", "-smoke"])
@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_families_resolve(name, suffix):
    """jamba-1.5-large-398b and xlstm-125m resolve with their
    sub-configs: Mamba's at d_state 16, d_conv 4, expand 2 (dt_rank
    ceil(d_model/16)), the xLSTM's at expand 2, conv width 4; ``-smoke``
    leaves both as they are."""
    assert name in treg.all_names()
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
