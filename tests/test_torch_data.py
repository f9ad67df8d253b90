"""The port's own copy of the data layer against ``repro.data``: every
array ``build_task`` returns is bitwise equal."""
import numpy as np
import pytest

from repro.data.tasks import build_task as jax_build_task
from repro_torch.data.tasks import build_task

CASES = [
    ("genomic", dict(n_clients=3, train_size=90, test_size=45, val_size=30,
                     seed=5)),
    ("genomic", dict(n_clients=5, train_size=250, test_size=100,
                     val_size=60, seed=0)),
    ("genomic", dict(n_clients=4, train_size=120, test_size=40, val_size=40,
                     seed=1, non_iid_alpha=0.5, n_features=6)),
    ("tweets", dict(n_clients=3, train_size=60, test_size=24, val_size=24,
                    seed=7)),
    ("tweets", dict(n_clients=4, train_size=100, test_size=30, val_size=30,
                    seed=3, non_iid_alpha=0.3, llm_seq_len=32)),
]


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,kw", CASES)
def test_build_task_bitwise(name, kw):
    got, want = build_task(name, **kw), jax_build_task(name, **kw)
    assert (got.name, got.n_classes, got.n_clients, got.vocab_size,
            got.llm_seq_len) == (want.name, want.n_classes, want.n_clients,
                                 want.vocab_size, want.llm_seq_len)
    for attr in ("test_qX", "test_qy", "val_qX", "val_qy", "weights"):
        _assert_same(getattr(got, attr), getattr(want, attr))
    for cg, cw in zip(got.clients, want.clients):
        assert cg.n == cw.n
        _assert_same(cg.qX, cw.qX)
        _assert_same(cg.qy, cw.qy)
        for k in ("tokens", "labels"):
            _assert_same(cg.llm_batch[k], cw.llm_batch[k])
