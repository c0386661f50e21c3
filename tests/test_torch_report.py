"""``repro_torch.analysis.report`` against ``repro.analysis.report`` on the
same records: every column equal but the roofline fraction, which is the
reference's times the ratio of the two packages' peak FLOP rates."""
import json
import sys

import pytest

from repro.analysis import report as ref_report
from repro.analysis import roofline as ref_rl
from repro_torch.analysis import report, roofline as rl

FRAC_COLUMN = 6  # of a row split on "|"


def _record(arch, shape, kind, flops, args, temp, coll, mesh="16x16", n=256, **extra):
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "n_devices": n, "kind": kind,
           "status": "ok",
           "memory": {"argument_size_in_bytes": args, "output_size_in_bytes": args // 2,
                      "temp_size_in_bytes": temp},
           "cost": {"flops": flops},
           "collectives": {"all-gather": {"bytes": coll, "count": 4}},
           "model_flops": flops * n * 0.61, **extra}
    rec["roofline"] = rl.roofline(rec, n)
    return rec


def _records(mesh="16x16", n=256):
    return [
        _record("stablelm-3b", "train_4k", "train", 5.3e12, 2_000_000_000, 9_000_000_000,
                10**8, mesh, n),
        _record("gemma2-27b", "prefill_32k", "prefill", 2.2e13, 5_000_000_000, 3 * 10**9,
                10**7, mesh, n),
        _record("mamba2-780m", "decode_32k", "decode", 3.1e9, 9_000_000_000, 10**8,
                10**11, mesh, n),
        {"arch": "qwen2-72b", "shape": "long_500k", "mesh": mesh, "status": "skipped",
         "reason": "qwen2-72b is full-attention; 500k-token dense KV decode is excluded"},
        {"arch": "dbrx-132b", "shape": "train_4k", "mesh": mesh, "status": "error",
         "reason": "x"},
    ]


def _split(text):
    return [ln.split("|") for ln in text.splitlines()]


def _hold(got: str, want: str, rows, n):
    """Rows equal cell by cell; the ok rows' fraction is the reference's
    value scaled by the peaks' ratio, printed as the reference prints."""
    g, w = _split(got), _split(want)
    assert len(g) == len(w)
    ok = iter(r for r in rows if r["status"] == "ok")
    for gl, wl in zip(g, w):
        if len(gl) > FRAC_COLUMN and gl[2].strip() in ("compute", "memory", "collective"):
            r = next(ok)
            s = ref_rl.dryrun_summary(r)
            frac = s["model_flops"] / (n * ref_rl.PEAK_FLOPS * s["t_dominant_s"])
            assert gl[FRAC_COLUMN].strip() == f"{frac * ref_rl.PEAK_FLOPS / rl.PEAK_FLOPS:.3f}"
            gl, wl = gl[:FRAC_COLUMN] + gl[FRAC_COLUMN + 1:], wl[:FRAC_COLUMN] + wl[FRAC_COLUMN + 1:]
        assert gl == wl


@pytest.mark.parametrize("mesh,n", [("16x16", 256), ("2x16x16", 512)])
def test_table_equals_the_reference_but_the_fraction(mesh, n):
    rows = _records(mesh, n)
    _hold(report.table(rows, n), ref_report.table(rows, n), rows, n)
    assert report.IMPROVE == ref_report.IMPROVE


def test_main_tabulates_both_meshes_and_the_variants(tmp_path, monkeypatch):
    art = tmp_path / "art"
    art.mkdir()
    rows = {256: _records(), 512: _records("2x16x16", 512)}
    variant = _record("stablelm-3b", "train_4k", "train", 4.1e12, 10**9, 8 * 10**9, 10**6,
                      variant="dots", overrides={"remat_policy": "dots"})
    for recs in rows.values():
        for r in recs:
            (art / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").write_text(json.dumps(r))
    (art / "stablelm-3b__train_4k__16x16__dots.json").write_text(json.dumps(variant))
    got = report.main(["--art", str(art), "--out", str(tmp_path / "port.md")])
    monkeypatch.setattr(sys, "argv", ["report", "--art", str(art),
                                      "--out", str(tmp_path / "ref.md")])
    ref_report.main()
    want = (tmp_path / "ref.md").read_text()
    assert (tmp_path / "port.md").read_text() == got
    g_parts, w_parts = got.split("\n## "), want.split("\n## ")
    assert len(g_parts) == len(w_parts) == 4
    for g, w, (recs, n) in zip(g_parts[1:], w_parts[1:], (
            (sorted(rows[256], key=lambda r: (r["arch"], r["shape"])), 256),
            (sorted(rows[512], key=lambda r: (r["arch"], r["shape"])), 512),
            ([variant], 256))):
        g_title, g_table = g.split("\n", 1)
        w_title, w_table = w.split("\n", 1)
        assert g_title.split(" (")[0] == w_title.split(" (")[0]
        _hold(g_table, w_table, recs, n)
