"""The port's analytic parameter counts (``models/counting.py``) against
the JAX package's, as integers, for every name of the registry and its
``-smoke`` form: ``count_params``, ``count_active_params`` and the
``ModelConfig`` methods that return them."""
import pytest

from repro.configs.registry import all_names
from repro.configs.registry import get as jget
from repro.models import counting as jcounting
from repro_torch.configs.registry import all_names as tall_names
from repro_torch.configs.registry import get as tget
from repro_torch.models import counting

NAMES = [n + s for n in all_names() for s in ("", "-smoke")]


def test_registry_names_agree():
    assert sorted(tall_names()) == sorted(all_names())


@pytest.mark.parametrize("name", NAMES)
def test_counts_equal_jax(name):
    jcfg, tcfg = jget(name), tget(name)
    total, active = counting.count_params(tcfg), \
        counting.count_active_params(tcfg)
    assert type(total) is int and type(active) is int
    assert total == jcounting.count_params(jcfg) == jcfg.param_count()
    assert active == jcounting.count_active_params(jcfg) \
        == jcfg.active_param_count()
    assert tcfg.param_count() == total
    assert tcfg.active_param_count() == active
    assert active <= total
    if tcfg.moe is None:
        assert active == total
