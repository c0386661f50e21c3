"""The helpers the port's multi-device tests share, and their tests.

``run_oracle`` runs a JAX reference script in a fresh interpreter with N
host devices: jax reads ``XLA_FLAGS`` once, when it initialises, and the
test process has one device. The scripts compute every case under
``jax.jit`` (an un-jitted ``jax.grad`` under a mesh raises on jax 0.9.0)
and save their results to an npz under "/"-joined keys; ``nested`` builds
a saved tree back. ``leaves`` keys a port tree's leaves (dicts and lists;
anything else, a PartitionSpec included, is a leaf) by their path.
``record_hints`` logs the placement hints ``meshctx.constrain`` resolves.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.train import meshctx
from repro_torch.train.meshctx import P

REPO = pathlib.Path(__file__).resolve().parents[1]


def run_oracle(script: str, n_devices: int, out_path, *args) -> None:
    """Run ``script`` with ``n_devices`` host devices; it writes its
    results to ``out_path`` (``sys.argv[1]``; ``args`` follow)."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={n_devices}"}
    res = subprocess.run([sys.executable, "-c", script, str(out_path), *map(str, args)],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0 and os.path.exists(out_path), res.stdout + res.stderr[-4000:]


def nested(flat: dict, prefix: str, leaf=lambda a: a) -> dict:
    """The entries of ``flat`` whose "/"-joined keys start with ``prefix``,
    as a nested dict of ``leaf(array)``."""
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            *parents, name = k[len(prefix):].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = leaf(v)
    return out


def leaves(tree, path: tuple = ()) -> dict:
    """{path from the root: leaf}, a list's entries keyed by their index."""
    if isinstance(tree, dict):
        return {n: t for k, v in tree.items() for n, t in leaves(v, path + (k,)).items()}
    if isinstance(tree, list):
        return {n: t for i, v in enumerate(tree) for n, t in leaves(v, path + (i,)).items()}
    return {path: tree}


def record_hints(monkeypatch) -> list:
    """Every hint ``constrain`` resolves from here on, as (shape,
    PartitionSpec) pairs in call order (``resolve_spec`` patched)."""
    log = []
    real = meshctx.resolve_spec

    def resolve(shape, spec, mesh):
        out = real(shape, spec, mesh)
        log.append((tuple(shape), out))
        return out

    monkeypatch.setattr(meshctx, "resolve_spec", resolve)
    return log


def test_nested_rebuilds_the_saved_tree():
    tree = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    flat = {"p/" + "/".join(k): v for k, v in leaves(tree).items()}
    assert nested({**flat, "q/a": 4}, "p/") == tree
    assert nested(flat, "p/", lambda v: 10 * v)["a"]["c"] == {"d": 20}


def test_leaves_keys_lists_by_index_and_keeps_specs_whole():
    spec = P("data", None)
    got = leaves({"blocks": [{"w": 1}, {"w": 2}], "s": spec})
    assert got == {("blocks", 0, "w"): 1, ("blocks", 1, "w"): 2, ("s",): spec}


_PROBE = """
import sys
import jax, numpy as np
np.savez(sys.argv[1], n=jax.device_count(), args=np.array(sys.argv[2:]))
"""


def test_run_oracle_gives_the_script_its_devices_and_arguments(tmp_path):
    out = tmp_path / "probe.npz"
    run_oracle(_PROBE, 3, out, "x", 7)
    with np.load(out) as data:
        assert int(data["n"]) == 3 and list(data["args"]) == ["x", "7"]


def test_run_oracle_reports_the_scripts_failure(tmp_path):
    with pytest.raises(AssertionError, match="oracle failed on purpose"):
        run_oracle("raise SystemExit('oracle failed on purpose')", 1, tmp_path / "none.npz")
