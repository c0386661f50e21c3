"""How far the bf16 Mamba-2 mixer lands from float32's at mamba2-780m's
full widths, in both packages (not a test; prints one JSON line):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_ssd_bf16_drift.py [--tokens 512]

``apply_mamba2`` casts dt and A to the input's dtype before ``ssd_scan``
(``src/repro/models/ssm.py:132``), so in a bf16 config the chunk's
cumulative sum of dt A runs in bf16. At these widths it reaches thousands
within a chunk of 256, where bf16's spacing is 16, and the exponentials of
its differences (the decays) lose every digit. The script runs one layer
of the reference's parameters on one seeded input three ways: the
reference in bf16, the port in bf16, and the port in float32, and prints
the largest output and state differences between them.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jconfigs
from repro.models import ssm as jssm
from repro_torch.configs import base as tconfigs
from repro_torch.models import ssm as tssm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=512)
    args = ap.parse_args(argv)
    cfg, jcfg = tconfigs.get("mamba2-780m"), jconfigs.get("mamba2-780m")
    jp = jssm.init_mamba2(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in jp.items()}
    x = np.random.default_rng(0).standard_normal((1, args.tokens, cfg.d_model))
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb, np.float32))
    jout, jcache = jax.jit(lambda p, a: jssm.apply_mamba2(p, a, jcfg, return_state=True))(jp, xb)
    tout, tcache = tssm.apply_mamba2(tp, xt.to(torch.bfloat16), cfg, return_state=True)
    fout, fcache = tssm.apply_mamba2({k: v.float() for k, v in tp.items()}, xt, cfg,
                                     return_state=True)
    ref, port, f32 = (np.asarray(jout, np.float32), tout.float().numpy(), fout.numpy())
    states = (np.asarray(jcache["state"], np.float32), tcache["state"].float().numpy(),
              fcache["state"].numpy())
    res = {"tokens": args.tokens, "chunk": cfg.ssm_chunk,
           "max_abs_out_f32": float(np.abs(f32).max()),
           "out_ref_bf16_vs_f32": float(np.abs(ref - f32).max()),
           "out_port_bf16_vs_f32": float(np.abs(port - f32).max()),
           "out_port_bf16_vs_ref_bf16": float(np.abs(port - ref).max()),
           "max_abs_state_f32": float(np.abs(states[2]).max()),
           "state_ref_bf16_vs_f32": float(np.abs(states[0] - states[2]).max()),
           "state_port_bf16_vs_f32": float(np.abs(states[1] - states[2]).max())}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
