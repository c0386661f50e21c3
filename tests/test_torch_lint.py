"""repro_torch.analysis.lint: the port's lint held against the reference's.

* Parity: the framework-neutral fixtures of ``tests/test_lint.py`` (loaded
  by path) give the same ``(line, col, rule)`` under both linters, rule by
  rule; the lines that call jax, which the port's rules do not read, are
  left out and listed in ``JAX_LINES``. Suppression, skip-file and syntax
  errors agree too.
* A torch bad/good fixture pair for every rule with a torch object.
* Calibration on the tree: the per-slot loops are clean as they stand and
  flagged with one ``.item()`` added; the numpy oracles stay clean; the
  engine is clean because of its ``.copy()`` snapshots; ``graph.py``'s
  ``torch.clamp_min`` residual passes with its suppression stripped.
* The registry against the reference's, the reporters, the CLI, and the
  tree linting clean on the default paths.

Fixtures live in string literals, so linting THIS file sees no fixture AST.
"""
import ast
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint
from repro_torch.analysis.lint import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src", "repro_torch")


def _load_reference_tests():
    spec = importlib.util.spec_from_file_location(
        "_reference_lint_fixtures", os.path.join(REPO, "tests", "test_lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference_tests()

NEUTRAL_RULES = ("rng-offset-derivation", "torn-publish", "unvalidated-capacity-mask",
                 "hardcoded-tiling")
NEUTRAL_FIXTURES = ("SEED_OFFSET_BAD", "SEED_OFFSET_GOOD", "TORN_PUBLISH_BAD",
                    "TORN_PUBLISH_GOOD", "CAPACITY_MASK_BAD", "CAPACITY_MASK_GOOD",
                    "TILING_BAD", "TILING_GOOD")
# lines of the fixtures that call jax: the reference's rules read them
# (jax.random.PRNGKey is a seeder, pl.BlockSpec a block shape), the port's
# have no jax object there; left out of the comparison
JAX_LINES = {
    "SEED_OFFSET_BAD": ("jax.random.PRNGKey(2 * seed)",),
    "TILING_BAD": ("pl.BlockSpec((64, Lp)",),
}


def _fixture(name):
    return textwrap.dedent(getattr(REF, name))


def _line_of(src, text):
    (line,) = [i for i, ln in enumerate(src.splitlines(), 1) if text in ln]
    return line


def _keys(findings, skip=()):
    return [(f.line, f.col, f.rule) for f in findings if f.line not in skip]


def _both(src, rules):
    return (ref_lint.lint_source(src, "fixture.py", rules=rules),
            lint.lint_source(src, "fixture.py", rules=rules))


# -------------------------------------------------------------------- parity
@pytest.mark.parametrize("rule", NEUTRAL_RULES)
@pytest.mark.parametrize("name", NEUTRAL_FIXTURES)
def test_neutral_fixtures_agree_with_the_reference(name, rule):
    src = _fixture(name)
    skip = {_line_of(src, t) for t in JAX_LINES.get(name, ())}
    want, got = _both(src, [rule])
    assert _keys(got, skip) == _keys(want, skip)


@pytest.mark.parametrize("name,text", [(n, t) for n, ts in JAX_LINES.items() for t in ts])
def test_left_out_lines_are_jax_calls_the_port_does_not_read(name, text):
    src = _fixture(name)
    line = _line_of(src, text)
    assert "jax." in text or "pl." in text
    want, got = _both(src, None)
    assert line in {f.line for f in want}
    assert line not in {f.line for f in got}


def _suppression_cases():
    bad = REF.SEED_OFFSET_BAD.replace("jax.random.PRNGKey(2 * seed)",
                                      "jax.random.PRNGKey(seed)")
    line = "np.random.default_rng(seed + 1)"
    return {
        "same_line": bad.replace(line, line + "  # lint: disable=rng-offset-derivation"),
        "preceding_comment": bad.replace(
            "spec = " + line,
            "# lint: disable=rng-offset-derivation\n        spec = " + line),
        "disable_all": bad.replace(line, line + "  # lint: disable=all"),
        "wrong_rule": bad.replace(line, line + "  # lint: disable=torn-publish"),
        "skip_file": "# lint: skip-file\n" + textwrap.dedent(bad),
        "syntax_error": "def f(:\n",
    }


@pytest.mark.parametrize("case", sorted(_suppression_cases()))
def test_suppression_skip_file_and_syntax_errors_agree(case):
    src = textwrap.dedent(_suppression_cases()[case])
    want, got = _both(src, ["rng-offset-derivation"])
    assert _keys(got) == _keys(want)
    expect = {"wrong_rule": ["rng-offset-derivation"], "syntax_error": ["syntax-error"]}
    assert [f.rule for f in got] == expect.get(case, [])


def test_finding_format_and_reporters_match_the_reference():
    src = _fixture("SEED_OFFSET_BAD")
    want, got = _both(src, ["rng-offset-derivation"])
    port_f, ref_f = got[0], want[0]
    assert port_f.render().split(": ")[:2] == ref_f.render().split(": ")[:2]
    assert set(port_f.to_dict()) == set(ref_f.to_dict())
    port_report = json.loads(lint.render_json(got, ["fixture.py"]))
    ref_report = json.loads(ref_lint.render_json(want, ["fixture.py"]))
    assert set(port_report) == set(ref_report)
    assert port_report["version"] == ref_report["version"] == 1
    assert set(port_report["findings"][0]) == set(ref_report["findings"][0])
    assert set(port_report["rules"]) == set(lint.RULES)
    assert lint.render_text([]) == ref_lint.render_text([]) == "clean: no findings"
    assert lint.render_text(got).splitlines()[-1] == "1 finding(s): rng-offset-derivation=1"


def test_registry_parity():
    port, gone = set(lint.RULES), set(lint.NO_TORCH_OBJECT)
    assert not port & gone
    assert lint.RENAMED == {"impure-scan-body": "impure-graph-capture",
                            "donation-use-after-dispatch": "graph-static-rebind"}
    for name in ref_lint.RULES:
        assert (lint.RENAMED.get(name, name) in port) != (name in gone), name
    assert not set(lint.RENAMED) & port
    assert gone == {"sort-in-loop", "nonhashable-jit-static"}
    assert all(len(reason) > 40 for reason in lint.NO_TORCH_OBJECT.values())
    assert port == {
        "aliased-buffer-dispatch", "rng-offset-derivation", "torn-publish",
        "unvalidated-capacity-mask", "hardcoded-tiling", "host-sync-in-hot-loop",
        "impure-graph-capture", "graph-static-rebind",
    }


# --------------------------------------------------------- torch fixtures --
ALIAS_BAD = """
    import numpy as np
    import torch

    class Engine:
        def __init__(self, dev):
            self.dev = dev
            self.pending = np.zeros(4, np.int64)
            self.staging = torch.zeros(4, dtype=torch.int64).pin_memory()

        def step(self, s, nxt):
            toks = torch.from_numpy(self.pending[:, None]).to(self.dev, non_blocking=True)
            self.pending[s] = nxt
            return toks

        def stage(self, buf, dst):
            dst.copy_(self.staging, non_blocking=True)
            self.staging.fill_(0)
            pinned = torch.as_tensor(buf).pin_memory()
            buf[0] = 1
            return pinned
"""

ALIAS_GOOD = """
    import numpy as np
    import torch

    class Engine:
        def __init__(self, dev):
            self.dev = dev
            self.pending = np.zeros(4, np.int64)
            self.staging = torch.zeros(4, dtype=torch.int64).pin_memory()

        def step(self, s, nxt):
            toks = torch.from_numpy(self.pending[:, None].copy()).to(self.dev, non_blocking=True)
            self.pending[s] = nxt
            return toks

        def stage(self, buf, dst):
            dst.copy_(self.staging.clone(), non_blocking=True)
            self.staging.fill_(0)
            pinned = torch.tensor(buf).pin_memory()
            buf[0] = 1
            return pinned
"""

RNG_BAD = """
    import torch
    from torch import manual_seed

    def seeded(seed, rank, dev):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        torch.manual_seed(2 * seed)
        torch.cuda.manual_seed_all(seed + rank)
        manual_seed(seed - 3)
        return gen
"""

RNG_GOOD = """
    import numpy as np
    import torch

    def seeded(seed, dev):
        child = np.random.SeedSequence(seed, spawn_key=(1,))
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(child.generate_state(1)[0]))
        torch.manual_seed(seed)
        return gen
"""

CAPACITY_BAD = """
    import torch

    def residual(spec, held, c_t):
        used = held.sum(0)
        free = c_t - used
        left = spec.c - torch.einsum("lrk->rk", held)
        return free / torch.clamp_min(left, 1e-9)
"""

CAPACITY_GOOD = """
    import torch
    import torch.nn.functional as F
    from torch import clamp_min

    def residual(spec, held, c_t):
        used = held.sum(0)
        a = torch.clamp_min(c_t - used, 0.0)
        b = (spec.c - used).clamp(min=0.0)
        r = F.relu(c_t - used)
        d = torch.where(c_t - used > 0, c_t - used, 0.0)
        e = clamp_min(c_t - used, 0.0)
        return a + b + r + d + e
"""

TILING_BAD = """
    from repro_torch.kernels import autotune

    FLASH_TC_BLOCK_Q = 64
    ROWS_PER_TILE = (4, 8)
"""

TILING_GOOD = """
    from repro_torch.kernels import autotune

    FLASH_TC_BLOCK_Q = autotune.FLASH_TC_BLOCK_Q
    MULTICLASS_ITERS = 24
"""

HOST_SYNC_BAD = """
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    def run(spec, arrivals, eta, T):
        rewards = torch.empty(T)
        y = torch.zeros(3)
        for t in range(T):
            rewards[t] = (y * arrivals[t]).sum()
            if rewards[t].item() > 0:
                y = y + 1
            k = F.one_hot(arrivals[t].long())
            lr = float(eta)
        return rewards, k, lr

    def fill(y, x, n):
        while n > 0:
            y.index_add_(0, x, x)
            idx = torch.nonzero(x)
            n -= 1
        return y, idx

    def project(z, steps):
        for i in range(steps):
            z = ops.proj_sortscan(z)
            torch.cuda.synchronize()
        return z.cpu()

    def capture(g, x):
        with torch.cuda.graph(g):
            v = x.sum().item()
        return v
"""

HOST_SYNC_GOOD = """
    import numpy as np
    import torch
    import torch.nn.functional as F

    def run(spec, arrivals, eta, T, K):
        rewards = torch.empty(T)
        y = torch.zeros(3)
        for t in range(T):
            rewards[t] = (y * arrivals[t]).sum()
            k = F.one_hot(arrivals[t].long(), K)
        return rewards.tolist(), float(eta), k  # host reads after the loop

    def oracle(z, c, dev):
        c = np.asarray(c, np.float64)
        out = torch.zeros(z.shape, device=dev)
        for i in range(z.shape[0]):
            lanes = np.nonzero(c[i])[0]
            out[i] = float(c[i]) + len(c[i].tolist()) + len(lanes)
        return out

    def report(xs):
        total = 0.0
        for x in xs:
            total += x.item()
        for i in range(3):
            print(xs[i].item())
        return total
"""

IMPURE_BAD = """
    import torch

    class Runner:
        def capture(self, step, static_x, log):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static_y = step(static_x)
                self.calls += 1
                log.append(static_y)
                print("captured")
            return graph, static_y

    def graphed(model, x):
        seen = []

        def fwd(inp):
            global STEPS
            STEPS = 1
            seen.append(inp)
            return model(inp)
        return torch.cuda.make_graphed_callables(fwd, (x,))
"""

IMPURE_GOOD = """
    import torch

    def capture(step, static_x, static_out, counter):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = step(static_x)
            static_out.copy_(y)
            counter.add_(1)
            static_out[0] = y[0]
            parts = []
            parts.append(y)
        return graph
"""

REBIND_BAD = """
    import torch

    def serve(step, batches, static_x):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_y = step(static_x)
        outs = []
        for batch in batches:
            static_x = batch
            graph.replay()
            outs.append(static_y.clone())
        return outs

    def serve_graphed(model, x, batches):
        def fwd():
            return model(x)
        g = torch.cuda.make_graphed_callables(fwd, ())
        x = batches[0]
        return g()
"""

REBIND_GOOD = """
    import torch

    def serve(step, batches, static_x):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_y = step(static_x)
        outs = []
        for batch in batches:
            static_x.copy_(batch)
            graph.replay()
            outs.append(static_y.clone())
        static_y = None  # written by the capture, not read by it
        return outs
"""

# rule -> (bad, good, number of findings in bad, path the fixture is linted as)
TORCH_PAIRS = {
    "aliased-buffer-dispatch": (ALIAS_BAD, ALIAS_GOOD, 3, "fixture.py"),
    "rng-offset-derivation": (RNG_BAD, RNG_GOOD, 4, "fixture.py"),
    "unvalidated-capacity-mask": (CAPACITY_BAD, CAPACITY_GOOD, 2, "fixture.py"),
    "hardcoded-tiling": (TILING_BAD, TILING_GOOD, 2, "src/repro_torch/kernels/flash.py"),
    "host-sync-in-hot-loop": (HOST_SYNC_BAD, HOST_SYNC_GOOD, 6, "fixture.py"),
    "impure-graph-capture": (IMPURE_BAD, IMPURE_GOOD, 5, "fixture.py"),
    "graph-static-rebind": (REBIND_BAD, REBIND_GOOD, 2, "fixture.py"),
}


def test_every_torch_rule_has_a_fixture_pair():
    assert set(TORCH_PAIRS) == set(lint.RULES) - {"torn-publish"}


@pytest.mark.parametrize("rule", sorted(TORCH_PAIRS))
def test_torch_bad_fixture_is_flagged_and_good_is_clean(rule):
    bad, good, n, path = TORCH_PAIRS[rule]
    found = lint.lint_source(textwrap.dedent(bad), path)
    assert {f.rule for f in found} == {rule}, [f.render() for f in found]
    assert len(found) == n, [f.render() for f in found]
    assert lint.lint_source(textwrap.dedent(good), path) == []


def test_host_sync_findings_name_each_sync():
    found = lint.lint_source(textwrap.dedent(HOST_SYNC_BAD), "fixture.py")
    msgs = " ".join(f.message for f in found)
    for what in (".item()", "one_hot without num_classes", "float() of the argument 'eta'",
                 "torch.nonzero", "torch.cuda.synchronize", "CUDA graph capture"):
        assert what in msgs, what


def test_torch_capacity_guards_are_what_the_reference_does_not_know():
    src = textwrap.dedent(CAPACITY_GOOD)
    want, got = _both(src, ["unvalidated-capacity-mask"])
    assert got == [] and len(want) == 5  # one residual of torch.where is its comparison


@pytest.mark.parametrize("rule", sorted(TORCH_PAIRS))
def test_cli_exit_codes_on_fixtures(rule, tmp_path, capsys):
    bad, good, n, _ = TORCH_PAIRS[rule]
    (tmp_path / "bad.py").write_text(textwrap.dedent(bad))
    (tmp_path / "good.py").write_text(textwrap.dedent(good))
    report = tmp_path / "report.json"
    rc_bad = cli.main([str(tmp_path / "bad.py"), "--rule", rule, "--json-out", str(report)])
    rc_good = cli.main([str(tmp_path / "good.py"), "--rule", rule])
    capsys.readouterr()
    assert (rc_bad, rc_good) == (1, 0)
    assert json.loads(report.read_text())["count"] == n


def test_cli_flags(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(RNG_BAD))
    assert cli.main([str(bad), "--rule", "torn-publish"]) == 0
    assert cli.main([str(bad), "--rule", "no-such-rule"]) == 2
    capsys.readouterr()
    assert cli.main([str(bad), "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == 1 and doc["count"] == 4 and doc["paths"] == [str(bad)]
    assert cli.main(["--list-rules"]) == 0
    listing = capsys.readouterr().out.splitlines()
    assert sorted(ln.split()[0] for ln in listing) == sorted(lint.RULES)


def test_cli_lints_the_tree_clean_on_its_default_paths():
    """``python -m repro_torch.analysis.lint`` from the repository's root:
    the port, the tests and chip_smoke.py lint clean."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", "--format", "json"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    doc = json.loads(proc.stdout)
    assert doc["paths"] == list(cli.DEFAULT_PATHS)
    assert (proc.returncode, doc["findings"]) == (0, []), proc.stderr


# ------------------------------------------------------ calibration (tree) --
def _read(rel):
    with open(os.path.join(SRC, rel), encoding="utf-8") as f:
        return f.read()


def _first_range_loop(src, fn_name):
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    return next(n for n in ast.walk(fn)
                if isinstance(n, ast.For) and isinstance(n.iter, ast.Call)
                and getattr(n.iter.func, "id", None) == "range")


# the per-slot loops: OGASCHED's slots, a budgeted baseline's ports, the
# lifecycle's slots, the offline comparator's iterations
SLOT_LOOPS = [("core/ogasched.py", "run"), ("core/baselines.py", "_budgeted_fill"),
              ("sched/lifecycle.py", "run_batch"), ("core/regret.py", "offline_optimum_batch")]


@pytest.mark.parametrize("rel,fn_name", SLOT_LOOPS)
def test_per_slot_loop_is_clean_and_an_added_item_is_flagged(rel, fn_name):
    src = _read(rel)
    rule = ["host-sync-in-hot-loop"]
    assert lint.lint_source(src, rel, rules=rule) == []
    first = _first_range_loop(src, fn_name).body[0]
    lines = src.splitlines()
    lines.insert(first.lineno - 1, " " * first.col_offset + "torch.zeros(()).item()")
    found = lint.lint_source("\n".join(lines) + "\n", rel, rules=rule)
    assert [(f.line, f.rule) for f in found] == [(first.lineno, "host-sync-in-hot-loop")]


@pytest.mark.parametrize("rel,fn_name", [("kernels/ref.py", "proj_rows_exact_np"),
                                         ("core/projection.py", "project_cluster_np")])
def test_numpy_oracles_stay_clean(rel, fn_name):
    src = _read(rel)
    loop = _first_range_loop(src, fn_name)
    body = ast.unparse(loop)
    assert "float(c[" in body  # a float() of a numpy array the rule must pass
    assert lint.lint_source(src, rel) == []


def test_engine_is_clean_because_of_its_copies():
    src = _read("serve/engine.py")
    assert lint.lint_source(src, "serve/engine.py") == []
    stripped = src
    for snap, view in (("self.pending[:, None].copy()", "self.pending[:, None]"),
                       ("self.pos.copy()", "self.pos")):
        assert stripped.count(snap) == 1
        stripped = stripped.replace(snap, view)
    found = lint.lint_source(stripped, "serve/engine.py")
    assert {f.rule for f in found} == {"aliased-buffer-dispatch"}
    assert sorted(f.message.split("'")[1] for f in found) == ["self.pending", "self.pos"]


def test_clamp_min_residual_passes_without_its_suppression():
    """``graph.residual_capacity``'s ``torch.clamp_min(c - used, 0.0)``: the
    reference's rule needs the suppression, the port's does not."""
    src = _read("core/graph.py")
    marker = "# lint: disable=unvalidated-capacity-mask"
    (line,) = [ln for ln in src.splitlines() if marker in ln]
    assert line.strip() == marker  # a comment line of its own
    stripped = src.replace(line + "\n", "")
    rule = ["unvalidated-capacity-mask"]
    assert lint.lint_source(stripped, "core/graph.py", rules=rule) == []
    want = ref_lint.lint_source(stripped, "core/graph.py", rules=rule)
    assert ["clamp_min" in stripped.splitlines()[f.line - 1] for f in want] == [True]
