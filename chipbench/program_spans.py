"""The program's own span aggregates (``repro_torch.spans``), which the
program records only while a torch profiler runs: in a run of the
benchmark, the traced run's window alone. A reader sums the self times of
the spans it names (a span's time less the spans inside it, so no time is
counted twice) over the window's slots. A program without the module, or
whose window recorded none of the named spans, gives None."""
import importlib


def self_ms_per_slot(rec, names):
    """Host ms a slot in the self time of the spans ``names``, or None."""
    try:
        spans = importlib.import_module("repro_torch.spans")
    except ImportError:
        return None
    snap = spans.snapshot()
    found = [snap[n][2] for n in names if n in snap]
    if not found:
        return None
    return 1e-6 * sum(found) / rec["slots"]
