"""slot_p95_ms: the 95th percentile, linearly interpolated, of every window
slot's time from the host handing over x(t) to its decision, ms, timed by
CUDA events on the card's clock. None where the cell's entry runs no single
slots (a lifecycle segment)."""
import statistics


def read(rec):
    lat = rec.get("slot_latency_ms")
    if not lat or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
