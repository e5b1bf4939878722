#!/usr/bin/env python3
"""Export a ``vdiff_tpu`` Orbax checkpoint as the reference-format ``.pt``
that the PyTorch port loads.

    python scripts/export_orbax_to_pt.py --ckpt-dir <exp>/ckpts/ckpt_last \\
        --config-path vdiff_tpu/configs/synthetic_smoke.json --out ckpt_last.pt

Restores the checkpoint directory that the JAX trainer writes
(``vdiff_tpu/train_lib.py::CheckpointManager``: ``params``, ``ema_params``,
``step``, ``epoch``) and writes ``{"model": sd, "ema": {"shadow": sd},
"step", "epoch"}`` with torch tensors under the reference's key names
(``vdiff_tpu_torch.models.convert.flax_params_to_state_dict``). The experiment
config gives the UNet's layout (levels, blocks per level, multi-tag
embedding, resampling). The optimizer state is not carried: the ``.pt``
serves ``python -m vdiff_tpu_torch.generate`` and ``eval``, not a resumed
run. A checkpoint trained without EMA has no ``ema`` entry, so the port's
``--use-ema`` refuses it, as the JAX CLIs do.

This script imports the JAX package and orbax; the port itself does not.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def export(ckpt_dir: str, config_path: str, out: str) -> dict:
    """Write ``out`` from the checkpoint ``ckpt_dir``; returns what was
    written: the step, the epoch and whether EMA weights were there."""
    import orbax.checkpoint as ocp
    import torch

    from vdiff_tpu.data import DATA_INFO
    from vdiff_tpu.factory import DEFAULT_CONFIG_PATH, load_experiment_config
    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict

    config, _ = load_experiment_config(config_path, DEFAULT_CONFIG_PATH)
    model_cfg = dict(config["model"],
                     multitags=DATA_INFO[config["data"]["name"]].get("multitags", False))
    payload = ocp.StandardCheckpointer().restore(os.path.abspath(ckpt_dir))

    def state_dict(params):
        sd = flax_params_to_state_dict(params, model_cfg)
        return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}

    ckpt = {"model": state_dict(payload["params"]), "step": int(payload["step"])}
    if "epoch" in payload:
        ckpt["epoch"] = int(payload["epoch"])
    has_ema = payload.get("ema_params") is not None
    if has_ema:
        ckpt["ema"] = {"shadow": state_dict(payload["ema_params"])}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save(ckpt, out)
    return {"out": out, "step": ckpt["step"], "epoch": ckpt.get("epoch"), "ema": has_ema,
            "tensors": len(ckpt["model"])}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="Export a vdiff_tpu Orbax checkpoint as a reference-format .pt for "
                    "vdiff_tpu_torch (weights and EMA weights; the optimizer state is not "
                    "carried, so the .pt serves generate and eval, not --resume).")
    p.add_argument("--ckpt-dir", required=True, help="an Orbax checkpoint directory (ckpt_<n>)")
    p.add_argument("--config-path", required=True,
                   help="the experiment JSON the checkpoint was trained with")
    p.add_argument("--out", required=True, help="the .pt file to write")
    args = p.parse_args(argv)
    info = export(args.ckpt_dir, args.config_path, args.out)
    print(f"wrote {info['out']}: {info['tensors']} tensors, step {info['step']}, "
          f"epoch {info['epoch']}, ema {'yes' if info['ema'] else 'none in the checkpoint'}")
    return info


if __name__ == "__main__":
    main()
