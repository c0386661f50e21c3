"""slot_replay_pct: the share of the window's slots that the program ran
as a replay of its slot's CUDA graph (the count of
``repro_torch.oga_step.replay`` spans over the slots), % (program spans,
the traced run). None where the program records no such span, or has no
span module."""
import importlib

REPLAY_SPAN = "repro_torch.oga_step.replay"


def read(rec):
    try:
        spans = importlib.import_module("repro_torch.spans")
    except ImportError:
        return None
    count = spans.snapshot().get(REPLAY_SPAN, (0,))[0]
    if not count:
        return None
    return 100.0 * count / rec["slots"]
