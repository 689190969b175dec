"""Multi-process launcher:
``python -m synapseml_tpu_torch.parallel.launch [--device cpu] [script ...]``.

Counterpart of ``synapseml_tpu/parallel/launch.py``, the container entry
a train-job chart runs: joins the job's ``torch.distributed`` group from
the ``SYNAPSEML_COORDINATOR`` / ``SYNAPSEML_NUM_PROCESSES`` /
``SYNAPSEML_PROCESS_ID`` environment (parallel/distributed.py — the
analogue of the reference's NetworkInit socket rendezvous,
lightgbm/.../TrainUtils.scala networkInit), then either

- executes a user training script with the group live (torchrun-style:
  ``... launch my_train.py --epochs 3``), or
- with no script, runs a built-in smoke fit: a data-parallel GBDT over
  the world group, each rank on its own seeded rows, proving every rank
  joined and the collectives work.

It runs on the card (NCCL between ranks) unless ``--device cpu`` is
given (gloo), and raises without CUDA otherwise.
``SYNAPSEML_CHECKPOINT_DIR``, where set, is created before the run.
"""
from __future__ import annotations

import argparse
import os
import runpy
import sys

import numpy as np
import torch

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.gbdt.boosting import BoostParams, train_row_sharded
from synapseml_tpu_torch.parallel import distributed


def _smoke_fit(device: str) -> int:
    rank, world = distributed.process_index(), distributed.process_count()
    rng = np.random.default_rng(rank)
    n = 4096
    x = rng.normal(size=(n, 8))
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float64)
    booster = train_row_sharded(
        BoostParams(objective="binary", num_iterations=10, num_leaves=15),
        x, y, mesh=distributed.global_mesh(), device=device)
    acc = float(np.mean((booster.predict(x, device=device) > 0.5)
                        == (y > 0.5)))
    print(f"[launch] process {rank}/{world} device={device} "
          f"smoke-fit acc={acc:.3f}", flush=True)
    return 0 if acc > 0.7 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m synapseml_tpu_torch.parallel.launch")
    ap.add_argument("--device", default=device_policy.DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    ap.add_argument("script", nargs="?", help="training script to run")
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="the script's arguments")
    opts = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = device_policy.resolve(opts.device)
    joined = distributed.initialize(device=opts.device)
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"[launch] distributed={'joined' if joined else 'single-process'} "
          f"process={distributed.process_index()}/"
          f"{distributed.process_count()} local_devices={local}", flush=True)
    ckpt = os.environ.get("SYNAPSEML_CHECKPOINT_DIR")
    if ckpt:
        os.makedirs(ckpt, exist_ok=True)
    if opts.script:
        sys.argv = [opts.script] + opts.args
        runpy.run_path(opts.script, run_name="__main__")
        return 0
    return _smoke_fit(opts.device)


if __name__ == "__main__":
    raise SystemExit(main())
