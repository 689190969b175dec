"""One rank of a data-parallel run of the port, launched by :func:`run_ranks`.

``python tests/torch_dp_worker.py SPEC RANK`` joins a ``torch.distributed``
group of ``spec["world"]`` ranks (``file://`` rendezvous in the spec's
directory, so concurrent test workers never race for a port; a timeout on
every collective, so a divergence fails instead of hanging), runs the
spec's cases in order and pickles ``{case name: result}`` to
``rank<R>.pkl`` beside the spec. A case that raises records its
traceback and the rank goes on with the next case.

Case kinds (``case["kind"]``):
- ``train``: ``boosting.train(**kw, mesh=group)``, the same rows on every
  rank (``checkpoint=True`` writes to ``ckpt_<case>``, and
  ``init_from_checkpoint=<case>`` continues from what that case wrote);
- ``row_sharded``: ``boosting.train_row_sharded`` on this rank's part
  (``kw[name + "_parts"][rank]`` for x, y, weight and group);
- ``collectives``: the ordered sum, max, tiled gather and ragged row
  gather of ``kw["sum"][rank]``, ``kw["rows"][rank]`` etc.;
- ``one_rank``: a one-rank subgroup of each backend in
  ``kw["backends"]`` made by every rank, and rank 0's ``train`` on each;
- ``call``: ``case["fn"]`` (``"module:name"``) on this rank's
  ``case["args"][rank]`` (numpy arrays become CPU tensors) with
  ``group=``, its tensors returned as numpy.
Each fit runs on every device of ``case["devices"]`` (default
``["cpu"]``) and records the booster, the ``iteration_hook`` calls, its
wall seconds, the K1 and K2 launches of the fit (the counters set to 0
just before it) and the collectives' calls, bytes and, with
``time_collectives=True`` in ``kw``, their synchronised seconds.

Importing this module loads neither torch nor the port, so the parent
process can use :func:`run_ranks` for free.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run_ranks(work_dir: str, world: int, cases: list, timeout: float = 240.0,
              threads: int = 1, extra_env=None) -> list:
    """Run ``cases`` on ``world`` worker processes; returns each rank's
    ``{case name: result}``. Raises ``RuntimeError`` (after killing every
    worker) if one fails or the ``timeout`` in seconds runs out."""
    os.makedirs(work_dir, exist_ok=True)
    rendezvous = os.path.join(work_dir, "rendezvous")
    if os.path.exists(rendezvous):   # a stale one would mislead the ranks
        os.remove(rendezvous)
    spec_path = os.path.join(work_dir, "spec.pkl")
    with open(spec_path, "wb") as fh:
        pickle.dump({"world": world, "cases": cases,
                     "init": "file://" + rendezvous,
                     "threads": threads,
                     "pg_timeout_s": min(120.0, timeout)}, fh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                  if p]), OMP_NUM_THREADS=str(threads), **(extra_env or {}))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), spec_path, str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"data-parallel workers did not finish within "
                           f"{timeout} s") from None
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    bad = [(r, p.returncode, log) for r, (p, log) in enumerate(
        zip(procs, logs)) if p.returncode != 0]
    if bad:
        raise RuntimeError("worker failed: " + "\n".join(
            f"rank {r} rc {rc}:\n{log[-4000:]}" for r, rc, log in bad))
    out = []
    for r in range(world):
        with open(os.path.join(work_dir, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _fit(fn, kw, device, pg, torch, kernels, collectives):
    hook = []
    kw = dict(kw)
    if kw.pop("hook", False):
        kw["iteration_hook"] = hook.append
    collectives.stats.reset()
    collectives.stats.timed = kw.pop("time_collectives", False)
    kernels.histogram.launches = kernels.forest_traverse.launches = 0
    if device == "cuda":
        torch.cuda.synchronize()
    start = time.perf_counter()
    booster = fn(**kw, mesh=pg, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    stats = collectives.stats
    return {"booster": booster, "hook": hook, "seconds": seconds,
            "k1_launches": kernels.histogram.launches,
            "k2_launches": kernels.forest_traverse.launches,
            "collective_calls": stats.calls, "collective_bytes": stats.bytes,
            "collective_s": stats.seconds}


def _run_case(case, rank, pg, out_dir):
    import torch
    import torch.distributed as dist

    from synapseml_tpu_torch.gbdt import boosting, kernels
    from synapseml_tpu_torch.parallel import collectives

    kind, kw = case["kind"], dict(case.get("kw", {}))
    if kind == "call":
        import importlib

        import numpy as np
        module, name = case["fn"].split(":")
        args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                for a in case["args"][rank]]
        out = getattr(importlib.import_module(module), name)(*args, group=pg)
        return [o.cpu().numpy() for o in out]
    if kind == "collectives":
        dev = case.get("devices", ["cpu"])[0]
        x = torch.from_numpy(kw["sum"][rank]).to(dev)
        return {
            "sum": collectives.all_reduce_sum(x, pg).cpu().numpy(),
            "max": collectives.all_reduce_max(x, pg).cpu().numpy(),
            "gather": collectives.all_gather(x, pg).cpu().numpy(),
            "rows": [collectives.gather_rows(a[rank], pg, dev)
                     for a in kw["rows"]],
            "size": collectives.axis_size(pg),
            "index": collectives.axis_index(pg)}
    if "p" in kw:
        kw["p"] = boosting.BoostParams(**kw["p"])
    if kind == "row_sharded":
        for name in ("x", "y", "weight", "group"):
            parts = kw.pop(name + "_parts", None)
            if parts is not None:
                kw[name] = parts[rank]
        fn = boosting.train_row_sharded
        kw["stats_out"] = stats = {}
    else:
        fn = boosting.train
    if kw.pop("checkpoint", False):
        kw["checkpoint_dir"] = os.path.join(out_dir, "ckpt_" + case["name"])
    resume = kw.pop("init_from_checkpoint", None)
    if resume is not None:   # a checkpoint an earlier case wrote
        kw["init_model"] = boosting.load_checkpoint(
            os.path.join(out_dir, "ckpt_" + resume))[0]
    result = {}
    if kind == "one_rank":
        groups = {b: dist.new_group([0], backend=b)
                  for b in kw.pop("backends")}
        if rank == 0:
            for b, g in groups.items():
                result[b] = _fit(fn, kw, case["devices"][0], g, torch, kernels,
                                 collectives)
        return result
    for dev in case.get("devices", ["cpu"]):
        result[dev] = _fit(fn, kw, dev, pg, torch, kernels, collectives)
        if kind == "row_sharded":
            result[dev]["stats_out"] = dict(stats)
        if "checkpoint_dir" in kw and rank == 0:
            result[dev]["checkpoint"] = boosting.load_checkpoint(
                kw["checkpoint_dir"])
    return result


def main(spec_path: str, rank: int) -> int:
    import datetime

    import torch
    import torch.distributed as dist

    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    torch.set_num_threads(spec["threads"])
    out_dir = os.path.dirname(spec_path)
    dist.init_process_group(
        "gloo", init_method=spec["init"], rank=rank,
        world_size=spec["world"],
        timeout=datetime.timedelta(seconds=spec["pg_timeout_s"]))
    results = {}
    try:
        for case in spec["cases"]:
            try:
                results[case["name"]] = _run_case(case, rank,
                                                  dist.group.WORLD, out_dir)
                # rank 0 may still be writing a checkpoint a later case reads
                dist.barrier()
            except Exception:
                results[case["name"]] = {"error": traceback.format_exc()}
                if isinstance(sys.exc_info()[1], RuntimeError) and (
                        "timed out" in str(sys.exc_info()[1]).lower()):
                    break   # the group is gone; later cases would hang too
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(results, fh)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
