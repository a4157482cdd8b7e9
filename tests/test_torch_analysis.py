"""Rule self-tests for ``repro_torch.analysis`` (the port of
``tests/test_analysis.py``): every port rule is seeded with a minimal
violation that MUST produce a finding, next to a clean variant that MUST
NOT, so a lint pass can never rot into a no-op; the gate itself runs over
``src/repro_torch`` with the port's allowlist; the dispatch audits are
exercised on real calls, including the two memory guards of
``tests/test_fed_scale.py`` (``:193`` and ``:246``) on the port; the build
sentinel counts a build made through ``kernels.build``'s listeners."""
import dataclasses
import functools
import inspect
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import (AllowEntry, Finding, apply_allowlist,
                                  lint_paths, lint_source, load_allowlist,
                                  tags)
from repro_torch.analysis import dispatch_audit, recompile, rng_lint
from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _rules(src, roots=()):
    return [f.rule for f in lint_source(src, loop_roots=roots)]


def _loop(body, helper=""):
    """A module whose ``Loop.run_chunk`` (the root) runs ``body`` each
    round, with an optional helper it calls."""
    return ("import torch\nimport numpy as np\n" + helper +
            "class Loop:\n"
            "    def run_chunk(self, state, length):\n"
            "        for j in range(length):\n"
            + "".join("            " + ln + "\n" for ln in body))


ROOTS = ("Loop.run_chunk",)


# ---------------------------------------------------------------------------
# RNG discipline (AST): the reference's four key rules as five port rules
# ---------------------------------------------------------------------------

def test_stream_reuse_is_caught():
    """Reference: test_key_reuse_is_caught."""
    src = ("def f(dev, seed, t):\n"
           "    g1 = generator(dev, seed, t, 'mask')\n"
           "    g2 = generator(dev, seed, t, 'mask')\n"
           "    return g1, g2\n")
    assert "rng-stream-reuse" in _rules(src)
    # derive_seed of the generator's parts names the same stream
    src2 = ("def f(dev, seed, t):\n"
            "    return generator(dev, seed, t, 'plan'), "
            "derive_seed(seed, t, 'plan')\n")
    assert "rng-stream-reuse" in _rules(src2)


def test_distinct_parts_are_clean():
    """Reference: test_split_keys_are_clean."""
    src = ("def f(dev, seed, t):\n"
           "    a = torch.rand((3,), generator=generator(dev, seed, t, "
           "'mask'))\n"
           "    b = torch.rand((3,), generator=generator(dev, seed, t, "
           "'coin'))\n"
           "    return a, b\n")
    assert _rules(src) == []


@pytest.mark.parametrize("call", [
    "torch.rand((3,))", "torch.randn(3, device=dev)",
    "torch.randint(0, 5, (3,))", "torch.randperm(5)",
    "torch.bernoulli(p)", "torch.multinomial(p, 2)",
    "torch.normal(0.0, 1.0, (3,))", "torch.poisson(p)",
    "torch.rand_like(p)", "p.uniform_()", "p.normal_()",
    "p.bernoulli_(0.5)", "p.random_(0, 4)", "p.exponential_()",
    "np.random.rand(3)", "np.random.choice(5, 2)", "np.random.seed(seed)",
])
def test_global_draw_is_caught(call):
    """Reference: test_raw_key_consumption_is_caught (rng-raw-key's draw
    from a key minted on the spot: here a draw from a global stream)."""
    src = f"import numpy as np\ndef f(p, dev, seed):\n    return {call}\n"
    assert "rng-global-draw" in _rules(src)


@pytest.mark.parametrize("call", [
    "torch.rand((3,), generator=g)", "p.uniform_(generator=g)",
    "p.bernoulli_(0.5, generator=g)", "np.random.default_rng(seed)",
    "torch.randint(0, 5, (3,), generator=generator(dev, seed, 'plan'))",
])
def test_seeded_draw_is_clean(call):
    src = f"import numpy as np\ndef f(p, dev, seed, g):\n    return {call}\n"
    assert _rules(src) == []


@pytest.mark.parametrize("call", [
    "generator(dev, 0, 'mask')", "derive_seed(7, 'data')",
    "torch.manual_seed(0)", "g.manual_seed(42)",
    "np.random.default_rng(5)", "generator(dev, -1)",
])
def test_fixed_seed_is_caught(call):
    """Reference: test_raw_key_consumption_is_caught (a hard-coded
    ``PRNGKey(0)`` at the sample site)."""
    src = f"import numpy as np\ndef f(dev, g):\n    return {call}\n"
    assert "rng-fixed-seed" in _rules(src)


def test_seed_from_the_run_is_clean():
    src = ("def f(dev, seed, t, g):\n"
           "    g.manual_seed(derive_seed(seed, t, 'coin'))\n"
           "    return generator(dev, seed, 'mask')\n")
    assert _rules(src) == []


def test_exclusive_arms_are_not_reuse():
    """Reference: test_exclusive_ifexp_arms_are_not_reuse; the port also
    exempts the arms of an ``if`` statement and the code after an ``if``
    whose body returns."""
    ifexp = ("def f(dev, seed, flag):\n"
             "    return (generator(dev, seed, 'mask') if flag\n"
             "            else generator(dev, seed, 'mask'))\n")
    stmt = ("def f(dev, seed, flag):\n"
            "    if flag:\n"
            "        g = generator(dev, seed, 'mask')\n"
            "    else:\n"
            "        g = generator(dev, seed, 'mask')\n"
            "    return g\n")
    early = ("def f(dev, seed, flag):\n"
             "    if flag is None:\n"
             "        return derive_seed(seed, 'mask')\n"
             "    return generator(dev, seed, 'mask')\n")
    for src in (ifexp, stmt, early):
        assert _rules(src) == [], src
    # the same uses one after the other are reuse
    assert "rng-stream-reuse" in _rules(
        "def f(dev, seed, flag):\n"
        "    if flag:\n"
        "        a = derive_seed(seed, 'mask')\n"
        "    return generator(dev, seed, 'mask')\n")


def test_generator_fanout_is_caught():
    """Reference: rng-key-fanout (no test of its own there): one generator
    object handed to two consumers couples their draws by order."""
    src = ("def f(dev, seed, n):\n"
           "    g = generator(dev, seed, 'plan')\n"
           "    idx = torch.randperm(n, generator=g)\n"
           "    u = torch.rand((n,), generator=g)\n"
           "    return idx, u\n")
    assert "rng-generator-fanout" in _rules(src)
    param = ("def f(g: torch.Generator, n):\n"
             "    return draw_a(g, n), draw_b(g, n)\n")
    assert "rng-generator-fanout" in _rules(param)


def test_one_consumer_per_generator_is_clean():
    src = ("def f(dev, seed, n, flag):\n"
           "    g = generator(dev, seed, 'plan')\n"
           "    h = generator(dev, seed, 'coin')\n"
           "    a = torch.randperm(n, generator=g)\n"
           "    b = (torch.rand((n,), generator=h) if flag\n"
           "         else torch.randn((n,), generator=h))\n"
           "    return a, b\n")
    assert _rules(src) == []


def test_unregistered_stream_tag_is_caught():
    """Reference: test_unregistered_fold_tag_is_caught."""
    src = ("def f(dev, seed, t):\n"
           "    return generator(dev, seed, t, 'maks')\n")
    assert "rng-stream-tag" in _rules(src)
    assert "rng-stream-tag" in _rules(
        "def f(seed):\n    return derive_seed(seed, 'dtaa')\n")


def test_registered_stream_tag_is_clean():
    """Reference: test_registered_fold_tag_is_clean."""
    src = ("from repro_torch.analysis.tags import MASK_TAG\n"
           "def f(dev, seed, t, path):\n"
           "    a = generator(dev, seed, t, MASK_TAG, path)\n"
           "    return a, derive_seed(seed, t, 'compress', path)\n")
    assert _rules(src) == []
    # the registry stays consistent both ways, and its values are unique
    assert tags.REGISTERED_TAGS["MASK_TAG"] == tags.MASK_TAG == "mask"
    assert tags.TAG_NAMES["mask"] == "MASK_TAG"
    assert len(tags.TAG_NAMES) == len(tags.REGISTERED_TAGS)


# ---------------------------------------------------------------------------
# Round-loop hygiene (AST)
# ---------------------------------------------------------------------------

def test_host_sync_in_loop_root_is_caught():
    """Reference: test_host_sync_in_scan_body_is_caught."""
    src = _loop(["state = state + 1", "v = float(state.sum())"])
    assert "loop-host-sync" in _rules(src, ROOTS)
    # the same function outside the roots is no loop
    assert _rules(src) == []


def test_item_call_in_loop_reachable_fn_is_caught():
    """Reference: test_item_call_in_scan_reachable_fn_is_caught."""
    helper = "def helper(c):\n    return c.item()\n"
    src = _loop(["state = state * 2", "v = helper(state)"], helper)
    found = lint_source(src, loop_roots=ROOTS)
    assert [(f.rule, f.symbol) for f in found] == \
        [("loop-host-sync", "helper")]


@pytest.mark.parametrize("line", [
    "v = state.cpu()", "v = state.tolist()", "v = state.numpy()",
    "v = state.to('cpu')", "v = int(state.argmax())",
    "v = bool(state.any())", "v = torch.nonzero(state)",
    "v = state.unique()", "v = torch.masked_select(state, state > 0)",
    "v = torch.where(state > 0)", "v = state.repeat_interleave(state)",
    "torch.cuda.synchronize()", "v = torch.as_tensor(np.ones(3), device=dev)",
    "v = torch.tensor([1.0], device=dev)", "v = state.to(dev)",
    "v = f'{state.sum()}'", "v = torch.equal(state, state)",
])
def test_each_host_sync_is_caught(line):
    src = _loop(["dev = state.device", line])
    assert "loop-host-sync" in _rules(src, ROOTS), line


@pytest.mark.parametrize("line", [
    "v = int(state.shape[0])", "v = float(len(state))",
    "v = state.to(torch.float32)", "v = state.repeat_interleave(2, 0)",
    "v = state.to(dev, non_blocking=True)", "v = int(np.sum(j))",
    "v = torch.where(state > 0, state, 0.0)",
    "v = torch.full((3,), 1.0, device=dev)",
])
def test_host_reads_are_clean(line):
    src = _loop(["dev = state.device", line])
    assert _rules(src, ROOTS) == [], line


def test_fresh_lambda_rule_has_no_counterpart():
    """Reference: test_fresh_lambda_in_scan_body_is_caught.  The port's
    round-path caches are keyed by ints, bools and dtypes, never by a
    callable, so a fresh lambda costs a round nothing and the lint has no
    rule for it; the module says so."""
    from repro_torch.kernels import dasha_update
    from repro_torch.models import common
    assert "scan-fresh-lambda" in rng_lint.__doc__
    src = _loop(["f = lambda t: t + 1", "state = f(state)"])
    assert _rules(src, ROOTS) == []
    for fn in (dasha_update.quantize_plan, dasha_update.sparsify_plan,
               common.dtype_scalar):
        assert isinstance(fn, functools._lru_cache_wrapper)
        for p in inspect.signature(fn).parameters.values():
            assert p.annotation in ("int", "bool", "str", "float",
                                    "torch.dtype"), (fn, p)


def test_inline_lambda_is_linted_with_its_function():
    """Reference: test_inline_treemap_lambda_is_clean: an inline lambda is
    clean, and a sync inside one is its function's."""
    clean = _loop(["state = tree_map(lambda t: t + 1, state)"])
    assert _rules(clean, ROOTS) == []
    synced = _loop(["state = tree_map(lambda t: t.item(), state)"])
    assert [(f.rule, f.symbol) for f in lint_source(
        synced, loop_roots=ROOTS)] == [("loop-host-sync", "Loop.run_chunk")]


@pytest.mark.parametrize("stmt", [
    ["if state.sum() > 0:", "    state = state - 1"],
    ["while state.max() > 1:", "    state = state / 2"],
    ["assert torch.isfinite(state).all()"],
])
def test_tensor_if_in_loop_is_caught(stmt):
    """Reference: test_tracer_if_in_scan_body_is_caught (``if``; the port
    adds ``while`` and ``assert``)."""
    assert "loop-tensor-if" in _rules(_loop(stmt), ROOTS)


def test_static_tests_are_clean():
    """Reference: test_static_shape_if_is_clean."""
    src = _loop(["if state.ndim > 1 and state.dtype == torch.float32:",
                 "    state = state.sum(-1)",
                 "if state is not None and isinstance(state, torch.Tensor):",
                 "    state = state + 1",
                 "while len(state) > 4 and 'x' in {}:",
                 "    break",
                 "assert state.shape[0] == 3 or state.t >= 0"])
    assert _rules(src, ROOTS) == []


def test_stale_root_is_a_finding():
    """A declared root that matches no function fails as a stale
    allowlist entry does."""
    found = lint_source(_loop(["pass"]), loop_roots=("Loop.gone",))
    assert [f.rule for f in found] == ["loop-root-stale"]


def test_syntax_error_becomes_finding():
    assert "syntax-error" in _rules("def f(:\n")


# ---------------------------------------------------------------------------
# The gate and the allowlist
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_findings():
    return lint_paths([str(PORT)], repo_root=str(ROOT),
                      loop_roots=rng_lint.LOOP_ROOTS)


def test_gate_passes_over_the_port(port_findings):
    """``scripts/torch_lint.py``'s gate: no kept finding, no stale entry,
    every root resolves, and every entry has a reason."""
    entries = load_allowlist()
    kept, stale = apply_allowlist(port_findings, entries)
    assert kept == [], "\n".join(f.render() for f in kept)
    assert stale == []
    assert not [f for f in port_findings if f.rule == "loop-root-stale"]
    hot = rng_lint.hot_functions([str(PORT)], repo_root=str(ROOT),
                                 loop_roots=rng_lint.LOOP_ROOTS)
    for suffix, qual in rng_lint.LOOP_ROOTS:
        assert any(p.endswith(suffix) and q == qual for p, q in hot)
    assert entries and all(e.reason.strip() for e in entries)


def test_lint_script_exits_by_the_gate(tmp_path, capsys):
    """The CLI: 0 over the port; 1 on a planted finding and on a stale
    entry."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import torch_lint
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    assert torch_lint.main([]) == 0
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\ndef f():\n    return torch.rand(3)\n")
    assert torch_lint.main([str(bad), "--repo-root", str(tmp_path)]) == 1
    assert torch_lint.main([str(bad), "--no-allowlist"]) == 1
    # the port's roots over a tree that lacks them: each one is stale
    (tmp_path / "good.py").write_text("def f():\n    return 1\n")
    assert torch_lint.main([str(tmp_path / "good.py"), "--no-allowlist"]) == 1
    assert "loop-root-stale" in capsys.readouterr().out


def test_allowlist_suppresses_and_reports_stale():
    """Reference: test_allowlist_suppresses_and_reports_stale."""
    found = [Finding(rule="rng-stream-reuse", path="src/a/b.py", line=3,
                     symbol="f", message="m")]
    hit = AllowEntry(rule="rng-stream-reuse", path="a/b.py", symbol="f",
                     reason="intentional")
    stale = AllowEntry(rule="rng-stream-reuse", path="gone.py", symbol="g",
                       reason="left behind")
    kept, stale_out = apply_allowlist(found, [hit, stale])
    assert kept == []
    assert stale_out == [stale]
    kept2, _ = apply_allowlist(
        found, [AllowEntry(rule="rng-stream-reuse", path="a/b.py",
                           symbol="other", reason="")])
    assert kept2 == found


def test_apply_allowlist_matches_the_reference():
    """The same findings and entries give the reference's (kept, stale),
    field for field."""
    from repro.analysis import findings as ref
    rows = [("r1", "src/a/b.py", 3, "f"), ("r1", "src/a/b.py", 9, "g"),
            ("r2", "src/c.py", 1, ""), ("r2", "x/src/c.py", 5, "h.k"),
            ("r3", "src/d.py", 2, "f")]
    allow = [("r1", "a/b.py", "f"), ("r2", "c.py", ""), ("r3", "d.py", "g"),
             ("r2", "c.py", "h.k"), ("r1", "zz.py", "f")]
    ours = apply_allowlist(
        [Finding(r, p, ln, s, "m") for r, p, ln, s in rows],
        [AllowEntry(r, p, s, "why") for r, p, s in allow])
    theirs = ref.apply_allowlist(
        [ref.Finding(r, p, ln, s, "m") for r, p, ln, s in rows],
        [ref.AllowEntry(r, p, s, "why") for r, p, s in allow])
    assert [[dataclasses.astuple(x) for x in part] for part in ours] == \
        [[dataclasses.astuple(x) for x in part] for part in theirs]


def test_load_allowlist_rejects_an_entry_without_reason(tmp_path):
    p = tmp_path / "a.toml"
    p.write_text('[[allow]]\nrule = "x"\npath = "y.py"\n')
    with pytest.raises(ValueError, match="reason"):
        load_allowlist(str(p))


# ---------------------------------------------------------------------------
# Dispatch audits (real calls on the CPU)
# ---------------------------------------------------------------------------

def test_large_temp_regression_fails():
    """Reference: test_large_temp_regression_fails."""
    n, d = 256, 16

    def leaky(state):
        gram = state @ state.T                 # an (n, n) temporary
        return state + gram @ state * 1e-6

    st = torch.ones((n, d))
    with pytest.raises(AssertionError, match="large op outputs"):
        dispatch_audit.assert_large_outputs(leaky, st, max_big=1)
    dispatch_audit.assert_large_outputs(lambda s: s * 2.0, st, max_big=1)
    # views and in-place results make no storage of their own
    assert dispatch_audit.large_outputs(
        lambda s: s.add_(1.0).reshape(-1)[: n * d], st) == []


def test_large_outputs_inside_a_python_loop():
    """Reference: test_large_outputs_recurses_into_scan: eager torch runs
    a chunk's rounds as Python, so every round's outputs are seen."""
    def run(xs):
        c = torch.zeros(())
        for x in xs:
            c = c + torch.outer(x, x).sum()   # (d, d) inside the loop
        return c

    xs = torch.ones((4, 64))
    big = dispatch_audit.large_outputs(run, xs, min_bytes=64 * 64 * 4)
    assert [o.shape for o in big] == [(64, 64)] * 4
    assert big[0].op == "aten::outer" or "mul" in big[0].op


def test_carry_report_counts_bytes():
    """Reference: test_scan_carry_report_counts_bytes (the async ring
    counts by field)."""
    from repro_torch.fed.vecsim import _Pipeline
    rep = dispatch_audit.carry_report(torch.ones((32, 4)))
    assert rep.carry_bytes == 32 * 4 * 4
    pipe = _Pipeline(2, 10, 3, 8, "cpu")
    rep = dispatch_audit.carry_report(pipe)
    assert rep.fields["msgs"] == 2 * 3 * 8 * 4
    assert rep.fields["ids"] == 2 * 3 * 8
    assert rep.carry_bytes == 4 * (10 + 3 * 10 + 3 + 1) + 2 * 3 * 8 * 4 + \
        2 * 3 * 8


def test_inplace_report_counts_state_fields():
    """Reference: test_donation_report_counts_declared_leaves: eager torch
    has no donation, so the report says which fields a call wrote in place
    and how many new buffers of their size it made."""
    def f(state, y):
        state["a"].add_(y)
        return {"a": state["a"], "b": state["b"] * y}

    st = {"a": torch.ones((8,)), "b": torch.ones((8,))}
    rep = dispatch_audit.inplace_report(f, st, 2.0)
    assert rep.fields["a"].in_place and not rep.fields["b"].in_place
    assert rep.fields["b"].new_of_size == 1
    assert "in place" in rep.render()


def test_collective_report_counts_no_collective_on_one_device():
    out = dispatch_audit.collective_report(lambda x: x * 2, torch.ones(3))
    assert out["all-reduce"] == 0 and out["all-reduce_count"] == 0


def _glm(n, m=2, d=64):
    from repro_torch.core.oracles import FiniteSumProblem
    from repro_torch.data.pipeline import synthetic_classification
    feats, labels = synthetic_classification(0, n, m, d, device="cpu")
    return FiniteSumProblem(
        lambda x, a, y: (1.0 - 1.0 / (1.0 + torch.exp(y * torch.dot(a, x))))
        ** 2, feats, labels)


def _sampled_method(n, c, d=64):
    from repro_torch.compress import make_round_compressor
    from repro_torch.methods import (FlatSubstrate, Hyper, Method,
                                     SampledFlatSubstrate)
    prob = _glm(n, d=d)
    rc = make_round_compressor("randk", d, c, k=8, backend="sparse",
                               device="cpu")
    sub = FlatSubstrate(prob, n, d) if c == n \
        else SampledFlatSubstrate(prob, n, d, c=c)
    m = Method.build("dasha", rc, sub,
                     Hyper(gamma=0.01, a=0.1, variant="dasha"))
    return m, m.init(torch.zeros(d), 1, device="cpu")


def test_sampled_step_is_o_of_c_not_n():
    """The CI memory guard of ``tests/test_fed_scale.py:193`` on the port
    (n = 4,096, c = 64, d = 64).  Large outputs: exactly 2, the
    reference's budget: the scatter store writes the round's cohort rows
    into a new (n, d) ``h_local`` and ``g_local`` (two out-of-place
    ``index_copy``, so a caller's state is never written) and makes no
    other n-sized buffer; its temporaries stay far below one (n, d) array,
    and the 64-of-4,096 round costs a small fraction of the full round's
    flops."""
    n, d = 4096, 64
    m, st = _sampled_method(n, 64)
    big = dispatch_audit.assert_large_outputs(m.step, st, max_big=2)
    assert [(o.op, o.shape) for o in big] == \
        [("aten::index_copy", (n, d))] * 2
    temp = dispatch_audit.temp_bytes(m.step, st)
    assert temp < n * d * 4 / 4, f"temps {temp} B ~ O(n*d)"
    flops = dispatch_audit.flops(m.step, st)
    m_full, st_full = _sampled_method(n, n)
    flops_full = dispatch_audit.flops(m_full.step, st_full)
    assert 0 < flops < 0.2 * flops_full, (flops, flops_full)


def _slab_chunk(n, c=64, d=64, chunk=16):
    from repro_torch.compress import make_round_compressor
    from repro_torch.fed import VecFedSim
    from repro_torch.methods import Hyper, SampledFlatSubstrate
    rc = make_round_compressor("randk", d, c, k=8, backend="sparse",
                               device="cpu")
    sub = SampledFlatSubstrate(_glm(n, d=d), n, d, c=c)
    sim = VecFedSim("dasha", rc, sub,
                    Hyper(gamma=0.01, a=0.1, variant="dasha"), chunk=chunk)
    st = sim.init(torch.zeros(d), 1, device="cpu")
    md = np.ones((chunk, n), np.float32)
    return sim, st, md


def test_slab_chunk_is_free_of_n_sized_outputs_and_carry():
    """The memory guard of ``tests/test_fed_scale.py:246`` on the port
    (n = 4,096, c = 64, d = 64): a slab chunk materializes ZERO (n,
    d)-sized outputs, and the state its rounds carry (the slab state, two
    (U, d) slabs plus O(d) vectors) does not change when n doubles."""
    n, d, chunk = 4096, 64, 16
    carries = []
    for size in (n, 2 * n):
        sim, st, md = _slab_chunk(size, d=d, chunk=chunk)
        dispatch_audit.assert_large_outputs(
            sim._chunk_slab, st, chunk, md, md,
            lambda s: torch.sum(s.g ** 2), None, max_big=0,
            min_bytes=size * d * 4)
        _, uniq, _, _, _ = sim._slab_chunk_xs(st, chunk, md, md)
        slab, _, _ = sim._slab_enter(st, torch.as_tensor(uniq))
        rep = dispatch_audit.carry_report(slab)
        u_pad = uniq.size
        assert u_pad == min(chunk * 64, size)
        assert rep.carry_bytes <= 2 * u_pad * d * 4 + 16 * d * 4 + 4096
        carries.append(rep.fields)
    assert carries[0] == carries[1]


def test_audit_peak_counts_arguments_and_temporaries():
    def f(x):
        y = x * 2.0              # a temporary of x's size
        return (y + 1.0).sum()

    x = torch.ones((1024,))
    _, rep = dispatch_audit.audit(f, x)
    assert rep.arg_bytes == 4096
    assert rep.peak_over_args >= 2 * 4096
    assert 4096 <= rep.temp_bytes <= 3 * 4096


# ---------------------------------------------------------------------------
# Build sentinels
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A kernel source directory with one file and an ``nvcc`` that writes
    an empty library: ``build`` then runs its real start/finish path."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// one source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    return out


def test_watch_counts_builds(fake_nvcc):
    """Reference: test_recompile_watch_catches_fresh_jit: a cold build
    counts 1, a warm cache 0, and a library moved aside builds again."""
    seen = []
    observer = recompile.subscribe(lambda name, s: seen.append(name))
    n_listeners = len(build._LISTENERS)
    try:
        with recompile.watch("cold") as cold:
            build.build_all()
        assert cold.count == 1 and cold.builds == ("fake",)
        with recompile.watch("warm") as warm:
            build.build_all()
        recompile.assert_no_builds(warm)
        lib = build.library_path("fake")
        os.replace(lib, str(lib) + ".aside")
        with recompile.watch("regressed") as bad:
            build.build_all()
        with pytest.raises(AssertionError, match="built 1 kernel"):
            recompile.assert_no_builds(bad)
        # every region took its listener off the build module again
        assert len(build._LISTENERS) == n_listeners
    finally:
        recompile.unsubscribe(observer)
    assert seen == ["fake", "fake"]


def test_call_sentinel_counts_calls():
    """Reference: test_lowering_sentinel_counts_traces: eager torch has no
    lowering, so the sentinel counts calls."""
    sent = recompile.wrap(lambda x: x + 1.0, name="step")
    x = torch.ones((4,))
    sent(x)
    sent(x)
    sent.assert_calls(2)
    with pytest.raises(AssertionError, match="2 calls"):
        sent.assert_calls(1)
    assert "step" in repr(sent)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 26's runtime gate, on the CPU
# ---------------------------------------------------------------------------

def test_enclosing_function_names_a_runtime_site():
    """A sync warning's file:line maps to the finding's ``symbol``."""
    from repro_torch.methods import driver
    src = Path(driver.__file__)
    lines = src.read_text().splitlines()
    at = {name: next(i + 1 for i, ln in enumerate(lines) if key in ln)
          for name, key in (("_to_host", "return torch.stack(values)"),
                            ("Driver._run_chunk",
                             "state = box[0] = self.step(box[0], d)"))}
    for name, line in at.items():
        assert rng_lint.enclosing_function(str(src), line) == name
    assert rng_lint.enclosing_function(str(src), 1) == ""


def test_phase26_sites_are_flagged_and_its_plant_is_kept():
    """The sites the card reported on phase 26b's three paths lie in
    functions the lint flags there, and the planted ``.item()`` in
    ``Driver._run_chunk`` (compiled at the file's own line numbers) is a
    kept finding: the card gate's premises, checked on the CPU."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    flagged, kept = chip_smoke._flagged()
    assert kept == []
    seen = {"driver": [("methods/driver.py", "_to_host")],
            "trainer": [("methods/driver.py", "_to_host")],
            "vec_slab": [("fed/vecsim.py", "VecFedSim._chunk_ys"),
                         ("fed/vecsim.py", "VecFedSim._chunk_slab")]}
    for tag, sites in seen.items():
        for path, fn in sites:
            assert ("src/repro_torch/" + path, fn) in flagged[tag], (tag, fn)
    planted, text = chip_smoke._planted_run_chunk()
    from repro_torch.methods import driver
    assert planted.__code__.co_filename == driver.__file__
    assert planted.__code__.co_firstlineno == \
        driver.Driver._run_chunk.__code__.co_firstlineno
    found = lint_source(text, "src/repro_torch/methods/driver.py",
                        loop_roots=("Driver._run_chunk",))
    kept, _ = apply_allowlist(found, load_allowlist())
    assert [(f.rule, f.symbol) for f in kept] == \
        [("loop-host-sync", "Driver._run_chunk")]
