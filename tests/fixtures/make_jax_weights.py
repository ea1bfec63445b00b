"""Write the JAX-trained-weights fixture that the port reads back.

    JAX_PLATFORMS=cpu python tests/fixtures/make_jax_weights.py

Writes, under tests/fixtures/jax_weights/, with the JAX package's own
`train/checkpoint.save_params` (flax's `to_bytes`):

  * attmil.msgpack: the classification zoo's `attmil` at input width 64
    (2 classes), initialised from PRNGKey(0);
  * survival_meanmil.msgpack: the survival CLI's MeanMIL at input width 64
    (`SurvivalHead`, 4 classes), from PRNGKey(1);
  * outputs.npz: three bags of 37, 300 and 1000 patches (numpy seed 2024;
    the last padded to 1100 rows under a mask), and the JAX package's CPU
    outputs for them: attmil's logits, MeanMIL's hazards and survival.

`tests/test_torch_msgpack.py` checks that this script still writes these
bytes; the port loads them on the CPU there and on the card in
`chip_smoke.py` phase 14 (d).
"""
import os
import sys

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rrtmil_tpu.harness.survival import build_survival_model  # noqa: E402
from rrtmil_tpu.models import zoo  # noqa: E402
from rrtmil_tpu.train.checkpoint import save_params  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_weights")
D_IN = 64
LENGTHS = ((37, 37), (300, 300), (1000, 1100))   # (patches, rows)


def bags():
    rng = np.random.default_rng(2024)
    out = []
    for n, rows in LENGTHS:
        x = np.zeros((1, rows, D_IN), np.float32)
        x[0, :n] = rng.standard_normal((n, D_IN))
        mask = np.arange(rows)[None] < n
        out.append((x, mask, n))
    return out


def models():
    """(attmil, survival MeanMIL) as the JAX package builds them."""
    surv, _ = build_survival_model("MeanMIL", D_IN)
    return zoo.build_model("attmil", input_dim=D_IN), surv


def write(out_dir=OUT):
    os.makedirs(out_dir, exist_ok=True)
    attmil, surv = models()
    data = bags()
    x0, m0, n0 = data[0]
    p_cls = attmil.init(jax.random.PRNGKey(0), jnp.asarray(x0),
                        mask=jnp.asarray(m0), length=n0)["params"]
    p_surv = surv.init(jax.random.PRNGKey(1), jnp.asarray(x0),
                       mask=jnp.asarray(m0), length=n0)["params"]
    save_params(os.path.join(out_dir, "attmil.msgpack"), p_cls)
    save_params(os.path.join(out_dir, "survival_meanmil.msgpack"), p_surv)
    arrays = {}
    for i, (x, mask, n) in enumerate(data):
        kw = dict(mask=jnp.asarray(mask), length=n, deterministic=True)
        logits = attmil.apply({"params": p_cls}, jnp.asarray(x), **kw)
        hazards, survival = surv.apply({"params": p_surv}, jnp.asarray(x),
                                       **kw)
        arrays.update({f"x_{i}": x[0, :n], f"rows_{i}": x.shape[1],
                       f"logits_{i}": np.asarray(logits),
                       f"hazards_{i}": np.asarray(hazards),
                       f"survival_{i}": np.asarray(survival)})
    np.savez_compressed(os.path.join(out_dir, "outputs.npz"), **arrays)


if __name__ == "__main__":
    write()
