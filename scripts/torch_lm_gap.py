#!/usr/bin/env python3
"""How far the port's reduced LM is from the JAX package's, and why.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/torch_lm_gap.py [--seeds 4]

Both packages run ``stablelm-12b.reduced()`` from the same JAX weights
(``params_from_jax``) on the CPU, for ``--seeds`` weight seeds x 2
numpy-seeded token batches ``[2, 16]``, and the script reports the max
abs difference of the forward logits.  It does so twice: as JAX runs by
default, and in a child process with
``XLA_FLAGS=--xla_allow_excess_precision=false``, where XLA rounds every
bf16 intermediate that the JAX program writes (by default XLA on the
CPU may keep such intermediates in f32).  The port rounds where the
program writes, so the second gap is the one due to the port itself.
Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def gaps(seeds: int) -> list:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config as jget
    from repro.models import LM as JLM
    from repro_torch.configs import get_config as tget
    from repro_torch.models import LM as TLM
    from repro_torch.models.model import params_from_jax

    jcfg, tcfg = jget("stablelm-12b").reduced(), tget("stablelm-12b").reduced()
    forward = jax.jit(JLM(jcfg).forward)
    out = []
    for seed in range(seeds):
        params = JLM(jcfg).init(jax.random.PRNGKey(seed))
        model = TLM(tcfg, device="cpu")
        model.load_state_dict(params_from_jax(
            tcfg, jax.tree.map(np.asarray, params)))
        for tseed in range(2):
            tokens = np.random.default_rng(tseed).integers(
                0, jcfg.vocab_size, (2, 16)).astype(np.int32)
            want = np.asarray(forward(params, jnp.asarray(tokens))[0])
            got = model.forward(torch.from_numpy(tokens))[0].numpy()
            out.append(float(np.max(np.abs(got - want))))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    if args.child:
        print(json.dumps(gaps(args.seeds)))
        return 0
    default = gaps(args.seeds)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run(
        [sys.executable, __file__, "--child", "--seeds", str(args.seeds)],
        env=env, capture_output=True, text=True, check=True)
    strict = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps({
        "runs": len(default),
        "max_abs_logit_gap_default": default,
        "max_abs_logit_gap_strict_bf16": strict,
        "strict_runs_below_1e-5": sum(g < 1e-5 for g in strict),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
