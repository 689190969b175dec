"""One rank of a data-parallel run of the port, launched by :func:`run_ranks`.

``python tests/torch_dp_worker.py SPEC RANK`` joins a ``torch.distributed``
group of ``spec["world"]`` ranks (a timeout on every collective, so a
divergence fails instead of hanging), runs the spec's cases in order and
pickles ``{case name: result}`` to ``rank<R>.pkl`` beside the spec. A
case that raises records its traceback and the rank goes on with the
next case. How the ranks join (``run_ranks(init=...)``):
- ``"file"``: gloo over a ``file://`` rendezvous in the spec's directory
  (concurrent test workers never race for a port), before the cases;
- ``"env"``: ``distributed.initialize`` from the ``SYNAPSEML_*``
  environment (a coordinator on a free loopback port), before the cases;
- ``"rendezvous"``: the parent runs a ``distributed.DriverRendezvous`` on
  loopback (port 0) and the FIRST case joins through it: a ``partitions``
  case with ``rendezvous=True`` (``fit_partitions(rendezvous=...)``) or a
  ``join`` case (``rendezvous_and_initialize``); the later cases run on
  the group it formed.

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
  ``group=``, its tensors returned as numpy;
- ``partitions``: ``data.partitions.fit_partitions`` on this rank's
  record batches ``kw["batches_parts"][rank]`` (and ``group_parts``),
  recording ``stats_out`` and the group's backend;
- ``join``: ``distributed.rendezvous_and_initialize``, recording the
  reply, the group's size, rank and backend, the current CUDA device
  where the rendezvous names a ``local_device``, and what a second
  ``initialize()`` returns.
Each fit runs on every device of ``case["devices"]`` (default
``["cpu"]``) and records the booster, the ``iteration_hook`` calls, its
wall seconds, the K1 and K2 launches of the fit (the counters set to 0
just before it) and the collectives' calls, bytes and, with
``time_collectives=True`` in ``kw``, their synchronised seconds.

Importing this module loads neither torch nor the port, so the parent
process can use :func:`run_ranks` for free (``init="rendezvous"`` runs
the port's driver in the parent).
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def free_port() -> int:
    """A loopback port that is free now (the OS's pick: none of the fixed
    bases other tests probe from)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(work_dir: str, world: int, cases: list, timeout: float = 240.0,
              threads: int = 1, extra_env=None, init: str = "file",
              backend: str = "gloo", local_device=None) -> list:
    """Run ``cases`` on ``world`` worker processes; returns each rank's
    ``{case name: result}``. Raises ``RuntimeError`` (after killing every
    worker) if one fails or the ``timeout`` in seconds runs out. ``init``
    says how the ranks join (see the module's docstring); ``backend`` and
    ``local_device`` are the rendezvous dict's for ``"rendezvous"``."""
    os.makedirs(work_dir, exist_ok=True)
    rendezvous = os.path.join(work_dir, "rendezvous")
    if os.path.exists(rendezvous):   # a stale one would mislead the ranks
        os.remove(rendezvous)
    spec = {"world": world, "cases": cases, "init": init,
            "file": "file://" + rendezvous, "threads": threads,
            "pg_timeout_s": min(120.0, timeout)}
    rank_env = [{} for _ in range(world)]
    driver = None
    if init == "env":
        coordinator = f"127.0.0.1:{free_port()}"
        rank_env = [{"SYNAPSEML_COORDINATOR": coordinator,
                     "SYNAPSEML_NUM_PROCESSES": str(world),
                     "SYNAPSEML_PROCESS_ID": str(r)} for r in range(world)]
    elif init == "rendezvous":
        from synapseml_tpu_torch.parallel.distributed import DriverRendezvous
        driver = DriverRendezvous(world, host="127.0.0.1", port=0,
                                  timeout=min(120.0, timeout)).start()
        spec["rendezvous"] = {
            "driver_host": "127.0.0.1", "driver_port": driver.port,
            "my_host": "127.0.0.1", "coordinator_port": free_port(),
            "backend": backend, "local_device": local_device}
    spec_path = os.path.join(work_dir, "spec.pkl")
    with open(spec_path, "wb") as fh:
        pickle.dump(spec, fh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                  if p]), OMP_NUM_THREADS=str(threads), **(extra_env or {}))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), spec_path, str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(env, **rank_env[r]), text=True)
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
    if driver is not None:
        driver.wait()
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


def _run_case(case, rank, pg, out_dir, spec):
    import torch
    import torch.distributed as dist

    from synapseml_tpu_torch.data import partitions
    from synapseml_tpu_torch.gbdt import boosting, kernels
    from synapseml_tpu_torch.parallel import collectives, distributed

    kind, kw = case["kind"], dict(case.get("kw", {}))
    rdv = dict(spec.get("rendezvous") or {}, rank_hint=rank)
    if kind == "join":
        local = rdv.pop("local_device")
        reply = distributed.rendezvous_and_initialize(
            **rdv, local_device_ids=None if local is None else [local],
            timeout=spec["pg_timeout_s"], device="cpu")
        return {"reply": reply, "world": dist.get_world_size(),
                "rank": dist.get_rank(), "backend": dist.get_backend(),
                "cuda_device": (torch.cuda.current_device()
                                if local is not None else None),
                "again": distributed.initialize(device="cpu")}
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
    if kind in ("row_sharded", "partitions"):
        for name in ("x", "y", "weight", "group", "batches"):
            parts = kw.pop(name + "_parts", None)
            if parts is not None:
                kw[name] = parts[rank]
        kw["stats_out"] = stats = {}
    if kind == "row_sharded":
        fn = boosting.train_row_sharded
    elif kind == "partitions":
        # the group is fit_partitions' to form (or adopt) and to choose
        fn, pg = partitions.fit_partitions, None
        kw["params"], kw["partitions"] = kw.pop("p"), kw.pop("batches")
        if kw.pop("rendezvous", False):
            kw["rendezvous"] = rdv
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
        kw.pop("rendezvous", None)   # the group is formed once
        if kind in ("row_sharded", "partitions"):
            result[dev]["stats_out"] = dict(stats)
        if kind == "partitions":
            result[dev]["backend"] = dist.get_backend()
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
    if spec["init"] == "file":
        dist.init_process_group(
            "gloo", init_method=spec["file"], rank=rank,
            world_size=spec["world"],
            timeout=datetime.timedelta(seconds=spec["pg_timeout_s"]))
    elif spec["init"] == "env":
        from synapseml_tpu_torch.parallel import distributed
        distributed.initialize(backend="gloo", device="cpu",
                               timeout=spec["pg_timeout_s"])
    results = {}
    try:
        for case in spec["cases"]:
            try:
                results[case["name"]] = _run_case(
                    case, rank, dist.group.WORLD, out_dir, spec)
                # rank 0 may still be writing a checkpoint a later case reads
                if dist.is_initialized():
                    dist.barrier()
            except Exception:
                results[case["name"]] = {"error": traceback.format_exc()}
                if isinstance(sys.exc_info()[1], RuntimeError) and (
                        "timed out" in str(sys.exc_info()[1]).lower()):
                    break   # the group is gone; later cases would hang too
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(results, fh)
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
