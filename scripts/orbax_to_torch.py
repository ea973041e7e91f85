#!/usr/bin/env python
"""Convert the JAX package's orbax training snapshots into the PyTorch
port's snapshots, which ``build_session`` and ``cli_matching`` restore.

    python scripts/orbax_to_torch.py --kind matching \\
        --orbax_dir outputs/matching/snapshots --out_dir torch_run/snapshots
    python scripts/orbax_to_torch.py --kind fg --orbax_dir <run>/snapshot \\
        --out_dir <torch run>/snapshot [--config '{"base_channels": 32}']

``--orbax_dir`` is a snapshot root (``<root>/step_N``, as JAX
``utils/checkpoint.py`` writes them; its newest step is converted) or one
step directory.  The train states are JAX
``train/matching.py:MatchingTrainState`` (``params``),
``train/fg_gan.py:FGGanTrainState`` (``g_params``, ``d_params``, ``d_sn``)
and ``train/bg_gan.py:BGGanTrainState`` (``g_params``, ``d_params``).
Each tree goes into the port's module through the weight bridge
(``utils/bridge.py:load_jax_tree``), the module built from the port's
config (its defaults, overridden by the JSON of ``--config``), and is
written as ``<out_dir>/step_N/state.pt``: ``{"model": ..., "step": N}``
for matching, ``{"generator": ..., "discriminator": ..., "step": N}`` for
the GANs.  Optimizer state is not carried over: a converted snapshot
serves (``match_ckpt_dir``, ``fg_ckpt_dir``, ``bg_ckpt_dir``) and
evaluates, but the port's trainers resume only their own snapshots.

Runs on the CPU only.  Reading orbax needs ``orbax`` and so ``jax``,
which the port itself never imports; nothing of the JAX package is
imported here (orbax restores a snapshot to nested dicts of arrays on its
own).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

KINDS = ("matching", "fg", "bg")


def restore_orbax(step_dir: str) -> dict:
    """The snapshot at ``step_dir`` as nested dicts of NumPy arrays, keyed
    by the train state's field names."""
    import orbax.checkpoint as ocp
    with ocp.PyTreeCheckpointer() as ckptr:
        return ckptr.restore(os.path.abspath(step_dir))


def port_config(kind: str, overrides: dict | None = None):
    """The port's config of ``kind`` with ``overrides`` applied."""
    from sketchyscenecolorization_torch import config
    cls = {"matching": config.MatchingConfig, "fg": config.FGGanConfig,
           "bg": config.BGGanConfig}[kind]
    return dataclasses.replace(cls(), **(overrides or {}))


def convert_state(state: dict, kind: str, cfg) -> dict:
    """A restored JAX train state -> the port's snapshot mapping."""
    from sketchyscenecolorization_torch.models import bg_gan, fg_gan
    from sketchyscenecolorization_torch.models.rmi import RMI
    from sketchyscenecolorization_torch.utils.bridge import load_jax_tree
    step = int(state["step"])
    if kind == "matching":
        return {"model": load_jax_tree(RMI(cfg), state["params"]).state_dict(),
                "step": step}
    models = fg_gan if kind == "fg" else bg_gan
    gen = load_jax_tree(models.build_generator(cfg), state["g_params"])
    disc = load_jax_tree(models.build_discriminator(cfg), state["d_params"],
                         sn=state.get("d_sn") or None)
    return {"generator": gen.state_dict(), "discriminator": disc.state_dict(),
            "step": step}


def snapshot_step(orbax_dir: str):
    """(step, step directory) to convert: ``orbax_dir`` itself when it is
    a step directory, else its newest step."""
    from sketchyscenecolorization_torch.utils.checkpoint import (
        _STEP_RE, latest_checkpoint)
    match = _STEP_RE.match(os.path.basename(os.path.normpath(orbax_dir)))
    if match:
        return int(match.group(1)), orbax_dir
    found = latest_checkpoint(orbax_dir)
    if found is None:
        raise FileNotFoundError(f"no step_N snapshot under {orbax_dir}")
    return found


def convert_snapshot(orbax_dir: str, kind: str, out_dir: str, cfg=None):
    """Convert the snapshot of ``orbax_dir``; returns the written step
    directory."""
    from sketchyscenecolorization_torch.utils.checkpoint import \
        save_checkpoint
    cfg = cfg if cfg is not None else port_config(kind)
    step, path = snapshot_step(orbax_dir)
    saved = convert_state(restore_orbax(path), kind, cfg)
    if saved["step"] != step:
        raise ValueError(f"{path} holds step {saved['step']}")
    return save_checkpoint(out_dir, step, saved)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("--orbax_dir", required=True,
                   help="snapshot root (step_N directories) or one step")
    p.add_argument("--out_dir", required=True,
                   help="the port's snapshot root to write step_N/state.pt")
    p.add_argument("--config", default="{}",
                   help="JSON of fields of the port's MatchingConfig, "
                        "FGGanConfig or BGGanConfig that the JAX run "
                        "changed from their defaults")
    args = p.parse_args(argv)
    cfg = port_config(args.kind, json.loads(args.config))
    print("wrote", convert_snapshot(args.orbax_dir, args.kind, args.out_dir,
                                    cfg))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
