"""The port's dry run on the CPU (``repro_torch.launch.dryrun``).

* each family's smoke config x the three serving shapes on a fake 2x2
  mesh: status ``ok`` (or ``skip`` under the reference's rule), the
  reference's row keys (``trace_s`` for ``compile_s``), memory that adds up
  and collectives that were counted;
* each family's smoke config x train_4k on a fake 2x2 mesh: ``ok``, kind
  ``train``, ``model_gflops`` 6 x active params x tokens, and a peak that
  holds the backward's saved tensors (every layer's remat input) beside
  the arguments;
* starcoder2-3b x decode_32k at full width on both production meshes, in
  a subprocess (a process group is global to its process);
* the CLI's rows, summary line and exit code: train_4k is ``ok`` (the
  sharded trainer), long_500k of a full-attention arch ``skip``, and a
  FAIL row exits 1.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import roofline as j_roofline
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.specs import SHAPES

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("starcoder2-3b", "mamba2-780m", "phi3.5-moe-42b-a6.6b",
            "deepseek-v2-lite-16b", "zamba2-1.2b", "llama-3.2-vision-11b",
            "whisper-tiny", "gemma3-12b")
SERVING = [s for s, info in SHAPES.items() if info["kind"] != "train"]
# the reference's ok row (src/repro/launch/dryrun.py): its own keys, the
# keys of memory_per_device and those of Roofline.row()
REF_KEYS = {"arch", "shape", "status", "mesh", "chips", "compile_s", "kind",
            "tokens", "model_gflops", "hlo_raw_gflops", "argument_gb",
            "output_gb", "temp_gb", "alias_gb", "peak_gb", "coll_detail"} | \
    set(j_roofline.Roofline(1.0, 1.0, 1.0, 1, {}).row())


def _fake_2x2():
    return tmesh.make_fake_mesh((2, 2), ("data", "model"), device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_configs_trace_on_a_fake_2x2_mesh(arch):
    for shape in SERVING:
        row = dryrun.dryrun_one(arch, shape, config=get_smoke_config(arch),
                                mesh_fn=_fake_2x2, verbose=False,
                                device="cpu")
        assert not torch.distributed.is_initialized()
        if row["status"] == "skip":
            assert shape == "long_500k" and row["why"]
            continue
        assert row["status"] == "ok", row.get("error")
        assert set(row) - {"trace_s"} == REF_KEYS - {"compile_s"}
        assert row["mesh"] == "2x2" and row["chips"] == 4
        assert row["peak_gb"] == pytest.approx(
            row["argument_gb"] + row["temp_gb"] + row["output_gb"]
            - row["alias_gb"])
        assert row["argument_gb"] > 0 and row["peak_gb"] >= \
            row["argument_gb"]
        if SHAPES[shape]["kind"] == "decode":
            assert row["alias_gb"] > 0       # the cache, written in place
        assert row["bottleneck"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_train_rows_trace_on_a_fake_2x2_mesh(arch):
    cfg = get_smoke_config(arch)
    row = dryrun.dryrun_one(arch, "train_4k", config=cfg,
                            mesh_fn=_fake_2x2, verbose=False, device="cpu")
    assert not torch.distributed.is_initialized()
    assert row["status"] == "ok", row.get("error")
    assert set(row) - {"trace_s"} == REF_KEYS - {"compile_s"}
    assert row["kind"] == "train" and row["mesh"] == "2x2"
    info = SHAPES["train_4k"]
    tokens = info["seq"] * info["global_batch"]
    assert row["tokens"] == tokens
    assert row["model_gflops"] == pytest.approx(
        6.0 * cfg.active_param_count() * tokens / 1e9)
    assert row["peak_gb"] == pytest.approx(
        row["argument_gb"] + row["temp_gb"] + row["output_gb"]
        - row["alias_gb"])
    # the backward's saved tensors: each layer's remat input, one node's
    # (global batch / 2 data ranks) rows, kept until the backward
    saved = cfg.num_layers * tokens // 2 * cfg.d_model * \
        torch.empty((), dtype=cfg.torch_dtype).element_size()
    assert row["peak_gb"] > row["argument_gb"] + saved / 1e9
    assert row["coll_detail"].get("all-reduce_count", 0) > 0


def test_full_width_decode_on_both_production_meshes(tmp_path):
    out = tmp_path / "rows.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "starcoder2-3b", "--shape", "decode_32k", "--both-meshes",
         "--device", "cpu", "--json", str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert run.returncode == 0, run.stderr[-3000:]
    assert "2 ok / 0 skip / 0 FAIL" in run.stdout
    rows = json.loads(out.read_text())
    assert [(r["mesh"], r["chips"]) for r in rows] == [("16x16", 256),
                                                      ("2x16x16", 512)]
    for r in rows:
        # the local arguments: params and the 8 / 4 cache rows of a rank
        assert 0.1 < r["argument_gb"] < r["peak_gb"] < 80
        assert r["coll_detail"].get("all-reduce_count", 0) > 0


def test_cli_rows_summary_and_exit_code(tmp_path, capsys):
    out = tmp_path / "rows.json"
    rc = dryrun.main(["--arch", "whisper-tiny", "--device", "cpu",
                      "--json", str(out)])
    assert rc == 0
    assert not torch.distributed.is_initialized()
    text = capsys.readouterr().out
    assert "3 ok / 1 skip / 0 FAIL" in text
    rows = {r["shape"]: r for r in json.loads(out.read_text())}
    assert rows["train_4k"]["status"] == "ok"
    assert rows["train_4k"]["kind"] == "train"
    assert rows["long_500k"]["status"] == "skip"
    assert rows["prefill_32k"]["status"] == rows["decode_32k"]["status"] \
        == "ok"


def test_cli_exits_1_on_a_failed_pair(monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(dryrun, "input_specs", broken)
    rc = dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                      "--device", "cpu"])
    assert rc == 1
    assert not torch.distributed.is_initialized()
    assert "0 ok / 0 skip / 1 FAIL" in \
        capsys.readouterr().out
