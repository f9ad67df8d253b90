"""The port's clients axis (``n_devices > 1``) on the CPU, held to one
shard and to the JAX package's single-device runs.

The CPU gives the shards (``sharding.client_devices(n, "cpu")`` is n
CPU shards), as forced host devices do for the JAX package's
``tests/test_client_sharding.py``.  A sharded run is bitwise the
one-shard run: no op of the local phase mixes clients, keys follow
client position, and padding clients are inert.  Against JAX each
sharded run keeps the port-to-JAX tolerances of
``test_torch_orchestrator.py``: integers exactly, losses within 1e-5,
θ_g within 1e-4.  The sharded LLM stage against JAX's is in
``test_torch_batched_llm.py``, the sharded fused loop in
``test_torch_fused_rounds.py`` and ``test_torch_fused_population.py``,
and every option combination over shards in
``test_torch_orchestrator.py``.
"""
import numpy as np
import pytest
import torch

from repro.core.orchestrator import run_experiment as jax_run_experiment
from repro.data.tasks import build_task as jax_build_task
from repro.distributed import sharding as jshd
from repro_torch.core.orchestrator import run_experiment
from repro_torch.data.tasks import build_task
from repro_torch.distributed import sharding as shd
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

CPU = torch.device("cpu")


# --- unit: the sharding helpers ---------------------------------------------
@pytest.mark.parametrize("n_clients,n_shards", [(5, 8), (8, 8), (9, 8),
                                                (16, 1), (3, 2), (1, 4)])
def test_pad_client_count_matches_jax(n_clients, n_shards):
    assert shd.pad_client_count(n_clients, n_shards) \
        == jshd.pad_client_count(n_clients, n_shards)
    with pytest.raises(ValueError):
        shd.pad_client_count(4, 0)


def test_ragged_clients_error_says_pad():
    with pytest.raises(ValueError, match="pad to 8"):
        shd.check_client_divisibility(5, 8)
    shd.check_client_divisibility(16, 8)
    shd.check_client_divisibility(5, 1)
    with pytest.raises(ValueError, match="pad"):
        shd.put_client_stacks([CPU] * 8, {"x": np.zeros((5, 2))}, 5)
    assert shd.shard_bounds(6, 3) == [(0, 2), (2, 4), (4, 6)]


def test_client_specs_match_jax_rules():
    """A leaf rides the axis exactly when the JAX package's rule shards
    it: leading dimension equal to the client count."""
    C = 6
    arrays = {"qX": np.zeros((C, 12, 4)), "qy": np.zeros((C, 12)),
              "iters": np.zeros((C,)), "ckeys": np.zeros((C, 2), np.uint32),
              "theta_g": np.zeros((16,)), "scalar": np.float32(1.0)}
    got = shd.client_specs(arrays, C)
    want = jshd.client_specs(arrays, C)
    for k in arrays:
        assert (got[k] == shd.CLIENTS) == (want[k] != jshd.P()), k
    assert got["theta_g"] is None and got["qX"] == shd.CLIENTS


def test_client_tree_specs_is_strict():
    ok = [{"a_lora_a": torch.zeros(4, 3, 2)}, {"b": torch.zeros(4)}]
    assert tree_leaves(shd.client_tree_specs(ok, 4)) == [shd.CLIENTS] * 2
    with pytest.raises(ValueError, match="leading dim 4"):
        shd.client_tree_specs([{"a": torch.zeros(3, 2)}], 4)
    with pytest.raises(ValueError, match="leading dim 4"):
        shd.client_tree_specs({"s": torch.tensor(1.0)}, 4)


def test_put_client_stacks_cuts_rows_and_replicates_the_rest():
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    th = np.arange(5, dtype=np.float32)
    shards = shd.put_client_stacks([CPU] * 4, {"x": x, "theta": th}, 8)
    assert len(shards) == 4
    for s, sh in enumerate(shards):
        np.testing.assert_array_equal(sh["x"].numpy(), x[2 * s:2 * s + 2])
        np.testing.assert_array_equal(sh["theta"].numpy(), th)
    back = shd.gather_clients([sh["x"] for sh in shards])
    np.testing.assert_array_equal(back.numpy(), x)


def test_put_replicated_never_cuts_a_leaf_as_long_as_the_axis():
    """θ_g or a base leaf whose leading dimension happens to equal the
    padded client count goes whole to every shard."""
    th = torch.arange(8, dtype=torch.float32)
    base = {"embed": torch.ones(8, 3), "layers": [{"w": torch.zeros(8)}]}
    for tree in (th, base):
        placed = shd.put_replicated([CPU] * 8, tree)
        assert len(placed) == 8
        for p in placed:
            for a, b in zip(tree_leaves(p), tree_leaves(tree)):
                assert a.shape == b.shape and torch.equal(a, b)


def test_client_tree_roundtrip_keeps_the_optimizer_state():
    """Adapters and AdamW states (a named tuple) cut and gathered back."""
    adapters = [{"wq_lora_a": torch.randn(6, 4, 2),
                 "wq_lora_b": torch.randn(6, 2, 4)}]
    state = adamw.init(adapters, n_clients=6)
    shards = shd.put_client_tree([CPU] * 3, state, 6)
    assert all(isinstance(s, adamw.AdamWState) for s in shards)
    assert [tuple(s.step.shape) for s in shards] == [(2,)] * 3
    back = shd.gather_clients(shards)
    assert isinstance(back, adamw.AdamWState)
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert torch.equal(a, b)
    shards = shd.put_client_tree([CPU] * 2, adapters, 6)
    assert shards[1][0]["wq_lora_a"].shape == (3, 4, 2)
    assert torch.equal(shd.gather_clients(shards)[0]["wq_lora_b"],
                       adapters[0]["wq_lora_b"])


def test_client_devices_on_the_cpu():
    assert shd.client_devices(8, "cpu") == [CPU] * 8
    assert shd.client_devices(1, "cpu") == [CPU]
    with pytest.raises(ValueError):
        shd.client_devices(0, "cpu")


def _one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


def test_more_shards_than_cards_raise_naming_the_visible_count(monkeypatch):
    """Shards never share a card unless asked: on one card, two shards
    raise and the message names the count."""
    _one_card(monkeypatch)
    with pytest.raises(ValueError, match="wants 2 CUDA devices but 1 is "
                                         "visible"):
        shd.client_devices(2, "cuda")
    assert shd.client_devices(1, "cuda:0") == [torch.device("cuda", 0)]
    assert shd.client_devices(2, "cuda:0", share_devices=True) \
        == [torch.device("cuda", 0)] * 2


def test_n_devices_without_a_card_raises(monkeypatch):
    """``n_devices=2`` on the default device, with no card: the entry
    point raises rather than falling back to CPU shards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = build_task("genomic", n_clients=3, train_size=30, test_size=12,
                      val_size=12, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_experiment(task, method="qfl", engine="batched", n_devices=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shd.client_devices(2)


def test_a_cohort_that_does_not_divide_the_shards_raises():
    task = build_task("genomic", n_clients=5, train_size=50, test_size=12,
                      val_size=12, seed=1)
    with pytest.raises(ValueError, match="does not divide across 2 shards"):
        run_experiment(task, device="cpu", method="qfl", engine="batched",
                       rounds="fused", n_devices=2, c_round=3)


# --- 8 shards against one shard, and against JAX's one device ----------------
CASES = {
    # the paper's default optimizer, 8 clients: one a shard
    "nm-exact": (dict(n_clients=8, train_size=64, test_size=24,
                      val_size=24, seed=5),
                 dict(optimizer="nelder-mead", n_rounds=2, maxiter0=3)),
    # finite shots: every client draws its keys wherever it lands
    "spsa-fake": (dict(n_clients=8, train_size=64, test_size=24,
                       val_size=24, seed=5),
                  dict(optimizer="spsa", n_rounds=2, maxiter0=3,
                       backend="fake", seed=4)),
    # noiseless SPSA: its update takes raw loss differences
    "spsa-exact": (dict(n_clients=3, train_size=60, test_size=24,
                        val_size=24, seed=1),
                   dict(optimizer="spsa", n_rounds=2, maxiter0=4)),
    # C=5 over 8 shards: 3 inert padding clients
    "nm-ragged": (dict(n_clients=5, train_size=50, test_size=20,
                       val_size=20, seed=7),
                  dict(optimizer="nelder-mead", n_rounds=2, maxiter0=3,
                       seed=2)),
}


def _series_equal(a, b):
    for attr in ("maxiters", "cum_evals", "selected", "server_loss",
                 "client_losses", "server_val_acc", "server_test_acc",
                 "comm_time_s", "ratios"):
        assert a.series(attr) == b.series(attr), attr
    np.testing.assert_array_equal(a.theta_g, b.theta_g)
    assert a.terminated_early == b.terminated_early


def _held_to_jax(got, want):
    for attr in ("t", "maxiters", "cum_evals", "selected"):
        assert got.series(attr) == want.series(attr), attr
    for attr in ("server_loss", "client_losses"):
        np.testing.assert_allclose(got.series(attr), want.series(attr),
                                   atol=1e-5, rtol=0, err_msg=attr)
    np.testing.assert_allclose(got.theta_g, want.theta_g, atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_eight_shards_equal_one_and_hold_to_jax(name):
    tkw, rkw = CASES[name]
    kw = dict(method="qfl", engine="batched", early_stop=False, **rkw)
    task = build_task("genomic", **tkw)
    one = run_experiment(task, device="cpu", **kw)
    shard = run_experiment(task, device="cpu", n_devices=8, **kw)
    _series_equal(one, shard)
    _held_to_jax(shard, jax_run_experiment(jax_build_task("genomic", **tkw),
                                           **kw))


# --- the LLM stage ---------------------------------------------------------
def test_llm_qfl_run_over_eight_shards():
    """A sharded LLM-QFL run (Step 1 and the rounds) keeps the one-shard
    run's budgets and selections, and every other bit.  (The sharded
    stage against JAX's: ``test_torch_batched_llm.py``.)"""
    tkw = dict(n_clients=3, train_size=45, test_size=15, val_size=15,
               seed=2)
    kw = dict(method="llm-qfl", engine="batched", optimizer="nelder-mead",
              n_rounds=2, maxiter0=3, llm_steps=2, early_stop=False,
              select_frac=0.67)
    task = build_task("genomic", **tkw)
    one = run_experiment(task, device="cpu", **kw)
    shard = run_experiment(task, device="cpu", n_devices=8, **kw)
    _series_equal(one, shard)
    assert one.llm_losses == shard.llm_losses
    assert one.llm_f1 == shard.llm_f1
    assert len(set(map(tuple, shard.series("maxiters")))) > 1


def test_shards_on_other_devices_exchange_by_copies(monkeypatch):
    """A shard on another device than the lead has buffers of its own,
    and the round's exchanges are copies.  Two spellings of the CPU
    (``cpu`` and ``cpu:0``, unequal devices) stand for two cards: the
    engines over them equal one shard bit for bit."""
    devices = [torch.device("cpu"), torch.device("cpu", 0)]
    monkeypatch.setattr(shd, "client_devices",
                        lambda n, device=None, share_devices=False:
                        devices[:n])
    task = build_task("genomic", n_clients=3, train_size=30, test_size=12,
                      val_size=12, seed=1)
    kw = dict(method="qfl", engine="batched", n_rounds=2, maxiter0=2,
              early_stop=False, optimizer="spsa", backend="fake")
    for extra in (dict(rounds="host"), dict(rounds="fused"),
                  dict(rounds="fused", c_round=2, dropout=0.25)):
        one = run_experiment(task, device="cpu", **kw, **extra)
        two = run_experiment(task, device="cpu", n_devices=2, **kw,
                             **extra)
        for attr in ("maxiters", "cum_evals", "selected", "server_loss",
                     "client_losses"):
            for got, want in zip(two.series(attr), one.series(attr)):
                np.testing.assert_array_equal(got, want, err_msg=attr)
        np.testing.assert_array_equal(two.theta_g, one.theta_g)
    from repro_torch.core.fused_rounds import FusedRoundDriver
    from repro_torch.quantum import backends, qnn
    spec = qnn.QNNSpec("vqc", n_qubits=4, n_classes=task.n_classes)
    driver = FusedRoundDriver(task, spec, backends.get("exact"),
                              device="cpu", n_devices=2, maxiter0=2,
                              n_rounds=1)
    assert [sh["remote"] for sh in driver.program.shards] == [False, True]
