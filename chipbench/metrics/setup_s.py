"""setup_s: seconds from the start of the process to the opening of the
window: imports, inputs drawn on the card, the kernels' build and tuning
where the checkout has none yet, the cell's warm-up (host clock)."""


def read(rec):
    return rec["setup_s"]
