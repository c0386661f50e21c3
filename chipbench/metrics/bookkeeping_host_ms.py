"""bookkeeping_host_ms: host time per slot in the lifecycle's bookkeeping
(the self time of ``repro_torch.lifecycle.step``, of its phases and of
``repro_torch.lifecycle.record``, the event record's writes), ms (program
spans, the traced run). None where the program records no such span."""
from chipbench import program_spans

PHASES = ("evict", "enqueue", "admit", "allocate", "serve", "depart", "update")


def read(rec):
    return program_spans.self_ms_per_slot(
        rec, tuple(f"repro_torch.lifecycle.{n}" for n in ("step", *PHASES, "record")))
