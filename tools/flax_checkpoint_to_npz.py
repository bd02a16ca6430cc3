#!/usr/bin/env python3
"""Write the parameters of a JAX package checkpoint as an ``.npz`` that the
PyTorch port loads.

    python tools/flax_checkpoint_to_npz.py --dataset synthetic2 --workdir WD \
        --out params.npz [--model-type disentangled] [--step E]

Restores the latest checkpoint (or epoch ``--step``) under
``<workdir>/<checkpoint_dir>/<dataset>_<model_type>`` with
``snd_vae_tpu.checkpoint.Checkpointer``, its template from
``snd_vae_tpu.train.init_state`` on the dataset's test split, and saves
``flatten_dict(params, sep="/")`` with ``numpy.savez``.  The port reads the
file with ``snd_vae_tpu_torch.params.load_flax_npz``:

    model.load_state_dict(load_flax_npz("params.npz"))

The script needs JAX and the JAX package; the port needs neither.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Mapping, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def write_npz(params: Mapping, out: str) -> None:
    """A flax parameter tree as an ``.npz`` of its ``"module/leaf"`` paths."""
    from flax.traverse_util import flatten_dict

    flat = flatten_dict(params, sep="/")
    np.savez(out, **{k: np.asarray(v) for k, v in flat.items()})


def convert(cfg, checkpoint_dir: str, out: str, step: Optional[int] = None) -> int:
    """Restore the checkpoint of epoch ``step`` (the latest when None) under
    ``checkpoint_dir`` for ``cfg`` and write its parameters to ``out``;
    returns the epoch restored."""
    import jax

    from snd_vae_tpu.checkpoint import Checkpointer
    from snd_vae_tpu.data import loaders
    from snd_vae_tpu.train import init_state

    ck = Checkpointer(checkpoint_dir)
    step = ck.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    with jax.enable_x64(False):   # the f32 template the JAX package trains
        _, template = init_state(cfg, loaders.load_dataset(cfg, "test", num_graphs=2))
        state = ck.restore(template, step)
    write_npz(state.params, out)
    ck.close()
    return step


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="synthetic2")
    p.add_argument("--model-type", default=None, dest="model_type")
    p.add_argument("--workdir", default=".")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    from snd_vae_tpu import config

    cfg = config.preset(args.dataset)
    if args.model_type:
        cfg = cfg.with_(model_type=args.model_type)
    directory = os.path.join(args.workdir, cfg.train.checkpoint_dir,
                             f"{cfg.dataset}_{cfg.model_type}")
    step = convert(cfg, directory, args.out, args.step)
    print(f"wrote the parameters of epoch {step} of {directory} to {args.out}")


if __name__ == "__main__":
    main()
