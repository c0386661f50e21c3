"""launches_per_slot: device kernels per slot (device trace)."""


def read(rec):
    ops = rec["trace"]["device_ops"]
    return sum(1 for _, kind, _, _ in ops if kind == "kernel") / rec["slots"]
