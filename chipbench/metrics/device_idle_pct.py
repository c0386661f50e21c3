"""device_idle_pct: the share of the traced window in which no operation
ran on the card, % (device trace)."""


def read(rec):
    t = rec["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
