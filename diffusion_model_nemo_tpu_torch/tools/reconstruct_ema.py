"""Reconstruct a post-hoc EMA profile from training snapshots into a .dmn.

Counterpart of the JAX package's ``tools/reconstruct_ema.py``. Training with
``trainer.posthoc_ema_sigma_rels=[0.05,0.10]`` writes power-function EMA
snapshots (``training/posthoc_ema.py``; by default ``<run dir>/phema``); this
tool reconstructs the EMA of any relative width after the fact and writes
an archive whose EMA weights are the reconstruction, which either package
restores:

    python -m diffusion_model_nemo_tpu_torch.tools.reconstruct_ema \\
        --archive DDPM.dmn --snapshots run/phema --sigma_rel 0.08 \\
        --output DDPM_sr008.dmn [--t N] [--gamma G]

It runs on the host alone (numpy, float64 sums): no device is touched.
"""

from __future__ import annotations

import argparse
from typing import Any, Optional, Sequence

from ..training.checkpoints import load_archive, load_aux_weights, save_archive
from ..training.posthoc_ema import list_snapshots, reconstruct

__all__ = ["main"]


def _paths(tree: Any, prefix: str = "") -> set:
    if isinstance(tree, dict):
        return set().union(*(_paths(v, f"{prefix}/{k}") for k, v in tree.items())) if tree else set()
    return {prefix}


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--archive", required=True, help="base .dmn archive")
    ap.add_argument("--snapshots", required=True, help="phema snapshot directory")
    ap.add_argument("--sigma_rel", type=float, default=None)
    ap.add_argument("--gamma", type=float, default=None)
    ap.add_argument("--t", type=int, default=None, help="target profile time (default: the latest snapshot)")
    ap.add_argument("--output", required=True, help="output .dmn path")
    args = ap.parse_args(argv)

    cfg, params, _old_ema, extra = load_archive(args.archive)
    aux = load_aux_weights(args.archive)
    snaps = list_snapshots(args.snapshots)
    print(f"{len(snaps)} snapshots in {args.snapshots} (t = {snaps[0][1]}..{snaps[-1][1]})"
          if snaps else "no snapshots found")
    ema = reconstruct(args.snapshots, sigma_rel=args.sigma_rel, gamma=args.gamma, t=args.t)
    if _paths(params) != _paths(ema):
        raise ValueError(f"snapshot tree does not match the archive's parameter tree: "
                         f"{sorted(_paths(params) ^ _paths(ema))[:8]}")
    save_archive(args.output, cfg, params, ema_params=ema, extra=extra, aux_weights=aux or None)
    print(f"Wrote {args.output} (EMA = post-hoc reconstruction, sigma_rel={args.sigma_rel} "
          f"gamma={args.gamma} t={args.t or 'latest'})")
    return args.output


if __name__ == "__main__":
    main()
