"""The port stands alone: no file of ``src/repro_torch`` or
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``,
and importing the whole port leaves ``jax`` out of ``sys.modules``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).replace(
        ".__init__", "") for p in PORT.rglob("*.py"))


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_has_its_modules():
    for name in ("random", "convert", "kernels.ref", "kernels.ops",
                 "kernels.statevector_gates", "quantum.tape",
                 "quantum.qnn", "quantum.backends", "optim.batched_nm",
                 "core.batched_engine", "core.orchestrator", "data.tasks",
                 "tree", "configs.base", "configs.paper_models",
                 "models.common", "models.attention", "models.ffn",
                 "models.layers", "models.model", "peft.lora",
                 "optim.adamw", "core.llm_client", "core.batched_llm",
                 "kernels.lora_matmul", "kernels.flash_attention",
                 "kernels.int4_matmul", "kernels.distill_kl",
                 "quantum.statevector", "quantum.circuits",
                 "optim.gradfree", "optim.batched_spsa", "core.distill",
                 "distributed.sharding",
                 "device", "launch", "launch.train", "launch.serve",
                 "configs.registry", "configs.stablelm_3b",
                 "configs.starcoder2_7b", "configs.llama3_405b",
                 "models.counting", "launch.train_lm", "kernels.counts",
                 "distributed.parallel", "launch.mesh",
                 "launch.hlo_analysis", "launch.dryrun"):
        assert f"repro_torch.{name}" in MODULES


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_imports(path):
    for mod in _imported(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_fresh_interpreter_imports_port_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_to_run_alone(tmp_path):
    """Copied away from the repo, the smoke script exits non-zero and
    prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
