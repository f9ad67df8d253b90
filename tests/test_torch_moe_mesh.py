"""The MoE block on a device mesh (``distributed.parallel.moe_dispatch`` /
``moe_combine``), laid out as the JAX package's constraints lay it: the
routing metadata replicated, the token rows on the batch axes, the
``(E, C_e, d)`` expert buffers on ``'model'``.

- The devices' dispatch shares (``ffn.dispatch_rows`` on row slices and
  expert ranges) sum bitwise to the whole dispatch, and their combine
  shares (``ffn.combine_rows``) concatenate bitwise to the whole combine
  over every expert, and sum to it over expert ranges within float32
  rounding.
- On a (2, 2) fake mesh, kimi-k2-smoke's train step: the dispatched and
  combined ``(T·k, d)`` rows are ``T·k / 2`` a device, and no DTensor of
  the block over the ``T`` tokens holds them whole on a device.
- The train pairs of kimi-k2-smoke and llama4-maverick-smoke trace on
  (2, 2), and the record names the dispatch's all-reduce with its bytes:
  a device's ``(E / 2, C_e, d)`` buffer a MoE layer, twice under remat.

Each fake process group is set up and torn down inside its test.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get
from repro_torch.distributed import parallel
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import ffn

B, S, NM = 4, 64, 2
TRAIN = InputShape("t", S, B, "train")


def _routing(T, m, seed):
    g = torch.Generator().manual_seed(seed)
    xn = torch.randn(T, 16, generator=g)
    logits = torch.randn(T, m.n_experts, generator=g)
    return xn, ffn.route(logits, m)


@pytest.mark.parametrize("name", ["kimi-k2-1t-a32b-smoke",
                                  "llama4-maverick-400b-a17b-smoke"])
def test_dispatch_shares_sum_bitwise(name):
    m = get(name).moe
    E, k, T = m.n_experts, m.top_k, 96
    xn, r = _routing(T, m, 3)
    flat_e = r.experts.reshape(-1)
    whole = ffn.dispatch_rows(xn, 0, flat_e, r.pos, r.keep, k, r.capacity,
                              0, E)
    for dp, tp in ((2, 2), (4, 1), (3, 4)):
        T_l, E_l = T // dp, E // tp
        shares = [torch.stack([ffn.dispatch_rows(
            xn[i * T_l:(i + 1) * T_l], i * T_l, flat_e, r.pos, r.keep, k,
            r.capacity, j * E_l, (j + 1) * E_l) for i in range(dp)]).sum(0)
            for j in range(tp)]
        assert torch.equal(torch.cat(shares), whole)
    out = torch.randn(whole.shape, generator=torch.Generator().manual_seed(4))
    y = ffn.combine_rows(out, 0, flat_e, r.pos, r.keep, r.gates, r.capacity,
                         0, E)
    rows = torch.cat([ffn.combine_rows(out, i * 24, flat_e, r.pos, r.keep,
                                       r.gates[i * 24:(i + 1) * 24],
                                       r.capacity, 0, E) for i in range(4)])
    assert torch.equal(rows, y)
    parts = sum(ffn.combine_rows(out[j * (E // 2):(j + 1) * (E // 2)], 0,
                                 flat_e, r.pos, r.keep, r.gates, r.capacity,
                                 j * (E // 2), (j + 1) * (E // 2))
                for j in range(2))
    torch.testing.assert_close(parts, y, rtol=1e-6, atol=1e-6)


class _Spy(TorchDispatchMode):
    """Records each d-wide tensor an op makes: (op, is a DTensor, rows
    on this device, global rows), rows being the second-to-last dim."""

    def __init__(self, d):
        super().__init__()
        self.d, self.seen = d, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor) and o.dim() >= 2 \
                    and o.shape[-1] == self.d:
                if isinstance(o, DTensor):
                    self.seen.append((str(func), True,
                                      o._local_tensor.shape[-2], o.shape[-2]))
                else:
                    self.seen.append((str(func), False, o.shape[-2],
                                      o.shape[-2]))
        return out


def test_block_keeps_tokens_sharded(monkeypatch):
    cfg = get("kimi-k2-1t-a32b-smoke")
    T, k = (B // NM) * S, cfg.moe.top_k
    spies = []
    orig = ffn.moe_update

    def spied(params, cfg_, x):
        spy = _Spy(cfg_.d_model)
        spies.append(spy)
        with spy:
            return orig(params, cfg_, x)

    monkeypatch.setattr(ffn, "moe_update", spied)
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        rec = D.run_traced(cfg, TRAIN, mesh, n_micro=NM)
    assert spies and rec["memory"]["temp_bytes"] > 0
    for spy in spies:
        # the rows gathered on a device: the dispatch's xn[tok] and the
        # combine's out[slot], each (T·k / 2, d)
        gathered = [rows for op, is_dt, rows, _ in spy.seen
                    if not is_dt and op == "aten.index.Tensor"]
        assert len(gathered) >= 2 and set(gathered) == {T * k // 2}
        over_tokens = [(rows, g) for _, is_dt, rows, g in spy.seen
                       if is_dt and g in (T, T * k)]
        assert over_tokens and all(rows == g // 2 for rows, g in over_tokens)


@pytest.mark.parametrize("name", ["kimi-k2-1t-a32b-smoke",
                                  "llama4-maverick-400b-a17b-smoke"])
def test_moe_train_pairs_trace_on_a_mesh(name):
    cfg = get(name)
    m = cfg.moe
    T = (B // NM) * S
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        rec = D.run_one(name, "train_4k", "test", save=False, mesh=mesh,
                        n_micro=NM, batch=B)
        assert rec["status"] == "ok", rec.get("error")
        rec = D.run_traced(cfg, TRAIN, mesh, n_micro=NM)
    moe_layers = cfg.n_groups * sum(1 for _, f in cfg.pattern if f == "moe")
    disp = rec["labelled_collectives"][parallel.MOE_DISPATCH]
    assert set(disp) == {"all-reduce"}
    # a device's bf16 (E / 2, C_e, d) buffer, each MoE layer's dispatch
    # run twice a microbatch (its forward and the rematerialised one)
    per = (m.n_experts // 2) * ffn.capacity(T, m) * cfg.d_model * 2
    assert disp["all-reduce"]["count"] == 2 * NM * moe_layers
    assert disp["all-reduce"]["bytes"] == 2 * NM * moe_layers * per
    assert rec["replicated_ops"] == ["aten.searchsorted.Tensor"]
