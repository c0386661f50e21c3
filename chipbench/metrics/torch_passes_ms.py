"""torch_passes_ms: device time per slot of every operation that is not one
of the program's own CUDA kernels (PyTorch's kernels, copies and fills:
the reward, the packing, the lifecycle's bookkeeping), ms (device trace)."""
from chipbench import tracing


def read(rec):
    ops = rec["trace"]["device_ops"]
    other = sum(dur for name, _, _, dur in ops if not tracing.is_program_kernel(name))
    return 1e-3 * other / rec["slots"]
