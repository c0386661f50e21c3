"""slot_ms: the whole measured window over the slots it completed, ms
(host clock; the window spans many slots)."""


def read(rec):
    return 1e3 * rec["window_s"] / rec["slots"]
