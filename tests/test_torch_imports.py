"""The port stands alone and never falls back to the CPU.

* an AST scan: no file of ``src/repro_torch``, not ``chip_smoke.py`` and
  not ``scripts/torch_lint.py`` imports ``jax``, ``jaxlib`` or ``repro``;
* the lint's layers (``repro_torch.analysis``' ``tags``, ``findings``,
  ``rng_lint`` and the CLI) import no torch, so the CLI stays fast;
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
SRC_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
PORT_FILES = SRC_FILES + [ROOT / "chip_smoke.py",
                          ROOT / "scripts" / "torch_lint.py"]
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
             for p in SRC_FILES}
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
                "fed/wire.py", "fed/sim.py", "fed/vecsim.py",
                "fed/faults.py", "bench/fed_faults.py", "bench/fed_async.py",
                "methods/lanes.py", "bench/__init__.py", "bench/common.py",
                "bench/fig1_gradient.py", "bench/fig2_finite_sum.py",
                "bench/fig3_stochastic.py", "bench/fig5_quadratic_pl.py",
                "bench/table1_complexity.py", "bench/quickstart.py",
                "bench/run.py", "bench/obs_trace.py", "obs/__init__.py",
                "obs/timeline.py", "obs/metrics.py", "obs/handle.py",
                "obs/attrib.py", "obs/vecreplay.py", "checkpoint/__init__.py",
                "checkpoint/io.py", "models/attention.py",
                "configs/starcoder2_3b.py", "configs/minitron_8b.py",
                "configs/qwen15_110b.py", "bench/fig4_dnn.py",
                "models/moe.py", "configs/gemma3_12b.py",
                "configs/phi35_moe_42b.py",
                "configs/deepseek_v2_lite_16b.py",
                "configs/zamba2_1p2b.py", "configs/llama32_vision_11b.py",
                "configs/whisper_tiny.py", "compress/legacy.py",
                "core/dasha.py", "core/marina.py", "core/compressors.py",
                "core/node_compress.py", "core/pytree_util.py",
                "core/__init__.py", "launch/mesh.py", "launch/specs.py",
                "launch/analytic.py", "launch/roofline.py",
                "launch/collectives.py", "launch/dryrun.py",
                "models/sharding.py", "analysis/__init__.py",
                "analysis/findings.py", "analysis/tags.py",
                "analysis/rng_lint.py", "analysis/dispatch_audit.py",
                "analysis/recompile.py", "bench/driver_bench.py"):
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


def test_lint_layers_import_no_torch():
    """The static lint (its registry, findings, AST rules and the CLI)
    loads no module of torch, JAX or the reference package: the CLI stays
    fast, as the reference's does."""
    code = ("import sys; sys.path.insert(0, 'scripts'); import torch_lint; "
            "import repro_torch.analysis.tags, "
            "repro_torch.analysis.findings, repro_torch.analysis.rng_lint; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert run.returncode == 0, run.stdout + run.stderr


def test_checkpoint_package_imports_neither_jax_nor_the_reference():
    """``repro_torch.checkpoint`` reads and writes the reference's format
    with numpy and torch alone: importing it loads no module of JAX or of
    the reference package."""
    code = ("import sys; import repro_torch.checkpoint; "
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
    from repro_torch.bench import common as bench_common
    from repro_torch.bench import fed_async, fed_faults
    from repro_torch.bench import driver_bench, obs_trace, quickstart
    from repro_torch.bench import run as bench_run
    from repro_torch.launch import dryrun as dryrun_mod
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.fed import FedSim, VecFedSim, simulate
    from repro_torch.methods import (FlatSubstrate, Hyper, Method,
                                     SampledFlatSubstrate, Sweeper)
    from repro_torch.models import init_params, lm
    from repro_torch.optim.distributed import (DashaTrainConfig,
                                               dasha_train_init)

    def method_init():
        feats = torch.zeros((2, 3, 4))
        problem = FiniteSumProblem(lambda x, a, y: (a @ x) ** 2, feats,
                                   torch.zeros((2, 3)))
        rc = make_round_compressor("identity", 4, 2, device="cpu")
        m = Method.build("dasha", rc, FlatSubstrate(problem, 2, 4),
                         Hyper(gamma=0.1, a=1.0))
        return m.init(torch.zeros(4), 0)

    def fed_args():
        feats = torch.zeros((4, 3, 4))
        problem = FiniteSumProblem(lambda x, a, y: (a @ x) ** 2, feats,
                                   torch.zeros((4, 3)))
        rc = make_round_compressor("identity", 4, 4, device="cpu")
        return ("dasha", rc, SampledFlatSubstrate(problem, 4, 4, c=2),
                Hyper(gamma=0.1, a=1.0))

    def vecsim_init():
        return VecFedSim(*fed_args()).init(torch.zeros(4), 0)

    def fedsim_init():
        return FedSim(*fed_args()).init(torch.zeros(4), 0)

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
        "Sweeper.run": lambda: Sweeper(lambda v: None).run(
            np.array([0.1, 0.2]), {"x": torch.zeros(4)}, 1),
        "bench.glm_problem": lambda: bench_common.glm_problem(),
        "bench.logreg_nonconvex_problem": lambda:
            bench_common.logreg_nonconvex_problem(),
        "bench.quickstart": lambda: quickstart.main([]),
        "bench.fed_async.equivalence_check": lambda:
            fed_async.equivalence_check(rounds=1),
        "bench.fed_async.severity_sweep": lambda:
            fed_async.severity_sweep(d=64, rounds=1),
        "bench.fed_async.tau_sweep": lambda: fed_async.tau_sweep(d=64,
                                                                 rounds=1),
        "bench.fed_faults.degradation_sweep": lambda:
            fed_faults.degradation_sweep(d=64, rounds=1),
        "bench.fed_faults.equivalence_check": lambda:
            fed_faults.equivalence_check(rounds=1),
        "bench.fed_faults.obs_compile_check": lambda:
            fed_faults.obs_compile_check(d=64, rounds=1),
        "bench.obs_trace": lambda: obs_trace.main([]),
        "bench.driver_bench": lambda: driver_bench.main([]),
        "bench.run": lambda: bench_run.main(["--only", "table1"]),
        "VecFedSim.init": vecsim_init,
        "FedSim.init": fedsim_init,
        "simulate": lambda: simulate(*fed_args(), torch.zeros(4), 0,
                                     rounds=1),
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
        "dasha_train_init": lambda: dasha_train_init(
            {"w": torch.zeros(3)}, DashaTrainConfig(gamma=0.1), 0),
        "launch.serve": lambda: serve_mod.serve(
            get_smoke_config("mamba2-780m"),
            serve_mod.build_parser().parse_args([])),
        "launch.dryrun.dryrun_one": lambda: dryrun_mod.dryrun_one(
            "whisper-tiny", "decode_32k"),
        "launch.mesh.make_host_mesh": lambda: mesh_mod.make_host_mesh(),
        "launch.mesh.make_production_mesh": lambda:
            mesh_mod.make_production_mesh(),
    }


ENTRY_POINTS = ["FedSim.init", "Method.init", "StochasticProblem",
                "Sweeper.run", "VecFedSim.init", "bench.driver_bench",
                "bench.fed_async.equivalence_check",
                "bench.fed_async.severity_sweep", "bench.fed_async.tau_sweep",
                "bench.fed_faults.degradation_sweep",
                "bench.fed_faults.equivalence_check",
                "bench.fed_faults.obs_compile_check", "bench.glm_problem",
                "bench.logreg_nonconvex_problem", "bench.obs_trace",
                "bench.quickstart",
                "bench.run",
                "convert.cache_from_numpy", "convert.params_from_numpy",
                "convert.plan_from_numpy", "convert.problem_from_numpy",
                "convert.state_from_numpy", "convert.tree_state_from_numpy",
                "dasha_train_init", "init_params",
                "launch.dryrun.dryrun_one", "launch.mesh.make_host_mesh",
                "launch.mesh.make_production_mesh", "launch.serve",
                "launch.train",
                "lm.init_cache", "make_lm_batch", "make_node_batches",
                "make_round_compressor", "simulate",
                "synthetic_classification", "synthetic_quadratic"]


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
