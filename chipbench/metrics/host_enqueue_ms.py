"""host_enqueue_ms: host time from the call into the program's entry to
its return, per slot, ms (host clock, the traced run): what the host
spends handing a slot's work to the card."""


def read(rec):
    return 1e3 * sum(rec["entry_s"]) / rec["slots"]
