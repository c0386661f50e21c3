"""launch_host_ms: host time per slot in the program's launch path (the
``repro_torch.launch`` spans: the autotune table's lookup, the wrapper's
operand checks, the kernel's launch and its counters), ms (program spans,
the traced run). None where the program records no such span."""
from chipbench import program_spans


def read(rec):
    return program_spans.self_ms_per_slot(rec, ("repro_torch.launch",))
