"""PyTorch-aware static analysis of the port (counterpart of
``repro.analysis.lint``): the reference's bug taxonomy, each rule read for
the torch shape of its bug.

============================  ================================================
rule                          what it guards in the port
============================  ================================================
aliased-buffer-dispatch       ``torch.from_numpy(buf).to(dev,
                              non_blocking=True)`` then a write into ``buf``:
                              the serve engine's decode race
rng-offset-derivation         ``seed + k`` into numpy / ``random`` seeders,
                              ``torch.manual_seed`` or ``<obj>.manual_seed``
torn-publish                  checkpoint manifest published before the
                              payload was durable (as in the reference)
unvalidated-capacity-mask     capacity minus usage with no floor; the torch
                              guards (``torch.clamp_min``, ``.clamp``, ...)
                              count as the ``jnp`` ones do
hardcoded-tiling              tile constants outside ``kernels/autotune.py``
host-sync-in-hot-loop         ``.item()`` / ``.cpu()`` / ``nonzero`` /
                              ``F.one_hot`` without ``num_classes`` in a
                              per-slot loop or a CUDA graph capture
impure-graph-capture          side effects in a CUDA graph capture run once
                              (the reference's impure-scan-body)
graph-static-rebind           a tensor a graph captured, rebound instead of
                              ``copy_``'d (the reference's
                              donation-use-after-dispatch)
============================  ================================================

``RENAMED`` maps the reference's two rules whose counterpart has another
name; ``NO_TORCH_OBJECT`` names the reference's rules that guard nothing in
eager torch, each with its reason; they are not registered.

Usage::

    from repro_torch.analysis import lint
    findings = lint.lint_paths(["src/repro_torch", "tests", "chip_smoke.py"])

    PYTHONPATH=src python -m repro_torch.analysis.lint

Suppress an intentional instance with ``# lint: disable=<rule>`` on the
flagged line (or a comment line directly above it).
"""
from repro_torch.analysis.lint.core import (  # noqa: F401
    RULES,
    Finding,
    FileContext,
    Rule,
    iter_py_files,
    lint_file,
    lint_paths,
    lint_source,
    register,
)

# importing the rule modules populates the registry
from repro_torch.analysis.lint import (  # noqa: E402,F401
    rules_buffers,
    rules_capacity,
    rules_ckpt,
    rules_jit,
    rules_rng,
    rules_tiling,
)
from repro_torch.analysis.lint.reporters import (  # noqa: F401
    render_json,
    render_text,
)

# the reference's rules whose torch counterpart guards another shape of
# the bug under another name
RENAMED = {
    "impure-scan-body": "impure-graph-capture",
    "donation-use-after-dispatch": "graph-static-rebind",
}

# the reference's rules whose bug cannot happen in eager torch
NO_TORCH_OBJECT = {
    "sort-in-loop": (
        "the bug was an XLA:CPU miscompile that hoisted a sort out of a "
        "fori_loop under shard_map as loop-invariant; eager torch runs each "
        "operation where it is written and hoists nothing, so a sort in a "
        "loop costs only time"
    ),
    "nonhashable-jit-static": (
        "eager torch has no static arguments: the port uses no "
        "torch.compile, and its CUDA sources are built once each, not per "
        "argument value"
    ),
}

__all__ = [
    "RULES",
    "NO_TORCH_OBJECT",
    "RENAMED",
    "Finding",
    "FileContext",
    "Rule",
    "register",
    "lint_source",
    "lint_file",
    "lint_paths",
    "iter_py_files",
    "render_text",
    "render_json",
]
