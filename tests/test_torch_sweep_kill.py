"""The port's streamed, checkpointed sweep survives ``kill -9``: the
counterpart of ``tests/test_sweep_resume.py::
test_sigkill_midsweep_resume_bitwise_equal``, on the CPU and at a size
that keeps it to seconds.

A subprocess runs ``sweep_stream(checkpoint_dir=...)`` over 24 configs in
chunks of 4 (each chunk stretched by a sleep in ``summarize`` so the kill
lands mid-sweep) and is SIGKILLed once 2 chunks verify; a fresh process
resumes it. The resumed summaries must equal an uninterrupted run's bit
for bit, and the chunks that survived the kill must not be rewritten
(their payload sha256 is unchanged: they were loaded, not recomputed).
Every wait has its own timeout, 60 s at most.
"""
import hashlib
import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.ckpt import checkpoint as C
from repro_torch.sched import sweep, trace

REPO = pathlib.Path(__file__).resolve().parents[1]
BASE = dict(T=24, L=6, R=16, K=4)
ALGOS = ("ogasched", "fairness")
N_POINTS, CHUNK = 24, 4
NUM_CHUNKS = N_POINTS // CHUNK

_SCRIPT = textwrap.dedent(
    f"""
    import sys, time
    import numpy as np
    from repro_torch.sched import sweep, trace

    ckpt_dir, out_path, slow = sys.argv[1], sys.argv[2], sys.argv[3] == "slow"
    points = sweep.make_grid(trace.TraceConfig(**{BASE!r}), seeds=range({N_POINTS}))
    if slow:
        real = sweep.summarize
        def slow_summarize(out):
            time.sleep(0.5)
            return real(out)
        sweep.summarize = slow_summarize
    summary = sweep.sweep_stream(points, {ALGOS!r}, chunk_size={CHUNK},
                                 checkpoint_dir=ckpt_dir, device="cpu")
    np.savez(out_path, **{{k.replace("/", "|"): v for k, v in summary.items()}})
    print("RESUME-SWEEP-DONE")
    """
)


def _spawn(ckpt_dir, out_path, slow):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-c", _SCRIPT, ckpt_dir, out_path, "slow" if slow else "fast"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO,
    )


def _chunk_shas(d):
    out = {}
    for s in C.available_steps(d):
        if C.verify_checkpoint(d, s):
            with open(os.path.join(d, f"step_{s:08d}.npz"), "rb") as f:
                out[s] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_sigkill_midsweep_resume_bitwise_equal(tmp_path):
    d = str(tmp_path / "ckpt")
    out = str(tmp_path / "resumed.npz")
    points = sweep.make_grid(trace.TraceConfig(**BASE), seeds=range(N_POINTS))

    # phase 1: run until >= 2 chunks are durably committed, then kill -9
    p = _spawn(d, str(tmp_path / "unused.npz"), slow=True)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and p.poll() is None:
            if sum(C.verify_checkpoint(d, s) for s in C.available_steps(d)) >= 2:
                break
            time.sleep(0.01)
        if p.poll() is not None:
            stdout, stderr = p.communicate(timeout=10)
            raise AssertionError("sweep exited before it could be killed:\n" + stdout + stderr)
        os.kill(p.pid, signal.SIGKILL)
    finally:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)
    assert p.returncode == -signal.SIGKILL

    ck = sweep.SweepCheckpoint(d, points, ALGOS, chunk_size=CHUNK)
    survived = ck.completed_chunks()
    assert 2 <= survived < NUM_CHUNKS  # killed mid-sweep, progress durable
    before = _chunk_shas(d)

    # phase 2: resume in a fresh process; it must complete
    p2 = _spawn(d, out, slow=False)
    try:
        stdout, stderr = p2.communicate(timeout=60)
    finally:
        if p2.poll() is None:
            p2.kill()
            p2.wait(timeout=30)
    assert "RESUME-SWEEP-DONE" in stdout, stdout + stderr
    assert ck.completed_chunks() == NUM_CHUNKS
    after = _chunk_shas(d)
    for s in range(survived):
        assert after[s] == before[s], f"chunk {s} was rewritten on resume"

    # phase 3: the uninterrupted run, in this process
    ref = sweep.sweep_stream(points, ALGOS, chunk_size=CHUNK, device="cpu")
    with np.load(out) as got:
        assert set(got.files) == {k.replace("/", "|") for k in ref}
        for k in ref:
            np.testing.assert_array_equal(got[k.replace("/", "|")], ref[k], err_msg=k)
