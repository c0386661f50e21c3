"""reward_host_ms: host time per slot in the program's reward (the self
time of its ``repro_torch.reward`` spans: ``reward.total_reward`` and
``reward.service_rates``), ms (program spans, the traced run). None where
the program records no such span."""
from chipbench import program_spans


def read(rec):
    return program_spans.self_ms_per_slot(rec, ("repro_torch.reward",))
