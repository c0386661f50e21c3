"""pack_host_ms: host time per slot in the packing around the kernels (the
self time of the ``repro_torch.ops.oga_update`` spans, the OGA update's
rows, k* rows, eta column and unpacking, and of ``repro_torch.ops.project``,
the projection's), ms (program spans, the traced run). None where the
program records no such span."""
from chipbench import program_spans


def read(rec):
    return program_spans.self_ms_per_slot(
        rec, ("repro_torch.ops.oga_update", "repro_torch.ops.project"))
