"""segment_setup_ms: host time per slot in the lifecycle's set-up of each
segment (the ``repro_torch.lifecycle.setup`` span of ``run_batch``: the
inputs' checks, the static operands' packing, the initial state, the event
buffers), ms (program spans, the traced run). None where the program
records no such span."""
from chipbench import program_spans


def read(rec):
    return program_spans.self_ms_per_slot(rec, ("repro_torch.lifecycle.setup",))
