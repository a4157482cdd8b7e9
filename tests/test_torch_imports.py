"""The port stands alone and never falls back to the CPU.

* an AST scan: no file of ``src/repro_torch`` and not ``chip_smoke.py``
  imports ``jax``, ``jaxlib`` or ``repro``;
* every entry point that creates tensors defaults to the card and raises
  without one;
* ``chip_smoke.py`` exits non-zero, printing no result, without a card
  and without the repository beside it.
"""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_the_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_import_scan_covers_the_slice():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES[:-1]}
    for mod in ("compress/spec.py", "compress/plan.py",
                "compress/backends.py", "kernels/ref.py", "kernels/build.py",
                "kernels/dasha_update.py", "kernels/ops.py",
                "core/theory.py", "core/oracles.py", "core/rng.py",
                "data/pipeline.py", "methods/accounting.py",
                "methods/rules.py", "methods/substrates.py",
                "methods/engine.py", "methods/driver.py", "convert.py",
                "core/tree.py", "compress/treelevel.py",
                "configs/__init__.py", "configs/mamba2_780m.py",
                "models/common.py", "models/init.py", "models/ssm.py",
                "models/blocks.py", "models/lm.py", "optim/base.py",
                "optim/distributed.py", "launch/train.py",
                "kernels/ssd_chunk.py", "launch/serve.py",
                "kernels/slab_writeback.py", "fed/__init__.py", "fed/net.py",
                "fed/wire.py", "fed/sim.py", "fed/vecsim.py"):
        assert mod in names
    for src in ("dasha_update.cu", "ssd_chunk.cu", "slab_writeback.cu"):
        assert (ROOT / "src/repro_torch/kernels/csrc" / src).exists()


def test_fed_package_imports_neither_jax_nor_the_reference():
    """Importing the federated slice (and through it the methods layer and
    the kernels) loads no module of JAX or of the reference package."""
    code = ("import sys; import repro_torch.fed; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert run.returncode == 0, run.stdout + run.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry_points():
    from repro_torch import convert
    from repro_torch.compress import make_round_compressor
    from repro_torch.core.oracles import FiniteSumProblem, StochasticProblem
    from repro_torch.data.pipeline import (synthetic_classification,
                                           synthetic_quadratic)
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import (SyntheticTextConfig, make_lm_batch,
                                           make_node_batches)
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.fed import VecFedSim
    from repro_torch.methods import (FlatSubstrate, Hyper, Method,
                                     SampledFlatSubstrate)
    from repro_torch.models import init_params, lm

    def method_init():
        feats = torch.zeros((2, 3, 4))
        problem = FiniteSumProblem(lambda x, a, y: (a @ x) ** 2, feats,
                                   torch.zeros((2, 3)))
        rc = make_round_compressor("identity", 4, 2, device="cpu")
        m = Method.build("dasha", rc, FlatSubstrate(problem, 2, 4),
                         Hyper(gamma=0.1, a=1.0))
        return m.init(torch.zeros(4), 0)

    def vecsim_init():
        feats = torch.zeros((4, 3, 4))
        problem = FiniteSumProblem(lambda x, a, y: (a @ x) ** 2, feats,
                                   torch.zeros((4, 3)))
        rc = make_round_compressor("identity", 4, 4, device="cpu")
        sim = VecFedSim("dasha", rc, SampledFlatSubstrate(problem, 4, 4,
                                                          c=2),
                        Hyper(gamma=0.1, a=1.0))
        return sim.init(torch.zeros(4), 0)

    state = {"x": np.zeros(4), "g": np.zeros(4), "g_local": np.zeros((2, 4)),
             "h_local": np.zeros((2, 4)), "t": 0, "bits_sent": 0.0}
    return {
        "make_round_compressor": lambda: make_round_compressor("randk", 8, 2,
                                                               k=2),
        "synthetic_classification": lambda: synthetic_classification(
            0, 2, 3, 4),
        "synthetic_quadratic": lambda: synthetic_quadratic(0, 4),
        "StochasticProblem": lambda: StochasticProblem(
            loss=None, sample=None, n=2),
        "Method.init": method_init,
        "VecFedSim.init": vecsim_init,
        "convert.state_from_numpy": lambda: convert.state_from_numpy(
            state, seed=0),
        "convert.problem_from_numpy": lambda: convert.problem_from_numpy(
            None, np.zeros((2, 3, 4)), np.zeros((2, 3))),
        "convert.plan_from_numpy": lambda: convert.plan_from_numpy(
            "passthrough", 1.0),
        "convert.params_from_numpy": lambda: convert.params_from_numpy(
            {"w": np.zeros(3, np.float32)}),
        "convert.tree_state_from_numpy": lambda:
            convert.tree_state_from_numpy(
                {k: ({"w": np.zeros(3)} if k in ("x", "g", "g_local",
                                                  "h_local") else v)
                 for k, v in state.items()}, seed=0),
        "init_params": lambda: init_params(
            get_smoke_config("mamba2-780m"), 0),
        "make_lm_batch": lambda: make_lm_batch(
            0, SyntheticTextConfig(vocab_size=16, seq_len=8), 2),
        "make_node_batches": lambda: make_node_batches(
            0, SyntheticTextConfig(vocab_size=16, seq_len=8), 2, 1),
        "launch.train": lambda: train_mod.train(
            get_smoke_config("mamba2-780m"),
            train_mod.build_parser().parse_args([])),
        "convert.cache_from_numpy": lambda: convert.cache_from_numpy(
            {"conv": np.zeros((1, 2, 3, 4), np.float32)}),
        "lm.init_cache": lambda: lm.init_cache(
            get_smoke_config("mamba2-780m"), 1, 8),
        "launch.serve": lambda: serve_mod.serve(
            get_smoke_config("mamba2-780m"),
            serve_mod.build_parser().parse_args([])),
    }


ENTRY_POINTS = ["Method.init", "StochasticProblem", "VecFedSim.init",
                "convert.cache_from_numpy", "convert.params_from_numpy",
                "convert.plan_from_numpy", "convert.problem_from_numpy",
                "convert.state_from_numpy", "convert.tree_state_from_numpy",
                "init_params", "launch.serve", "launch.train",
                "lm.init_cache", "make_lm_batch", "make_node_batches",
                "make_round_compressor", "synthetic_classification",
                "synthetic_quadratic"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card_and_raise_without_it(no_cuda,
                                                               name):
    entry = _entry_points()
    assert sorted(entry) == ENTRY_POINTS
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry[name]()


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(tmp_path)}
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert run.stdout == ""
