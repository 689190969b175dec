"""The port's multi-process bootstrap (``synapseml_tpu_torch/parallel/
distributed.py``) and launcher (``parallel/launch.py``), on the CPU; the
counterparts of ``tests/test_parallel.py:109-176`` and
``tests/test_deployment.py:105``.

- The driver rendezvous: roster order by rank hint, the same roster on
  every worker, ``announce`` retrying until the driver binds.
- ``initialize``: a no-op for one process without a coordinator; one
  process with an explicit coordinator (through the rendezvous) forms a
  world of one; two processes join from the ``SYNAPSEML_*`` environment
  and reduce in rank order, bit for bit.
- ``python -m synapseml_tpu_torch.parallel.launch --device cpu`` runs its
  smoke fit; without ``--device`` and without a card it exits non-zero.
- Neither ``data/partitions.py`` nor ``parallel/distributed.py`` imports
  pandas or pyarrow, and no module of the port imports them at module
  level: the machine with the card has neither.

The worker processes (``tests/torch_dp_worker.py``) are launched once a
fixture, with a timeout that kills them.
"""
import ast
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from synapseml_tpu_torch.parallel import collectives, distributed
from synapseml_tpu_torch.parallel.distributed import (DriverRendezvous,
                                                      WorkerInfo, announce)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from torch_dp_worker import free_port, run_ranks  # noqa: E402


def test_rendezvous_roster_and_ranks():
    """Driver rendezvous collects workers and assigns deterministic ranks
    (ref: LightGBMBase.createDriverNodesThread:394-432,
    TrainUtils.getNetworkInitNodes:236-277)."""
    drv = DriverRendezvous(num_workers=3, host="127.0.0.1").start()
    replies = {}
    lock = threading.Lock()

    def worker(name, hint):
        r = announce("127.0.0.1", drv.port, WorkerInfo(host=name,
                                                       rank_hint=hint))
        with lock:
            replies[name] = r

    ts = [threading.Thread(target=worker, args=(f"host{i}", 2 - i))
          for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in ts)
    drv.wait()
    assert len(replies) == 3
    # rank order follows rank_hint: host2 (hint 0) -> 0, host1 -> 1, host0 -> 2
    assert replies["host2"]["process_id"] == 0
    assert replies["host0"]["process_id"] == 2
    rosters = {json.dumps(r["roster"]) for r in replies.values()}
    assert len(rosters) == 1  # everyone sees the identical roster
    assert [w["host"] for w in replies["host0"]["roster"]] == [
        "host2", "host1", "host0"]


def test_worker_announce_retries_until_driver_up():
    """Workers may start before the driver: announce retries with backoff
    (ref: TrainUtils.networkInit:279-295)."""
    port = free_port()
    result = {}

    def worker():
        result["r"] = announce("127.0.0.1", port, WorkerInfo(host="w0"))

    t = threading.Thread(target=worker)
    t.start()
    time.sleep(0.4)  # let the first connection attempt fail
    drv = DriverRendezvous(num_workers=1, host="127.0.0.1", port=port).start()
    t.join(timeout=30)
    assert not t.is_alive()
    drv.wait()
    assert result["r"]["process_id"] == 0


def test_initialize_noop_single_process(monkeypatch):
    for var in ("SYNAPSEML_COORDINATOR", "SYNAPSEML_NUM_PROCESSES",
                "SYNAPSEML_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False  # 1 process -> no-op
    assert not dist.is_initialized()
    # a world of one without a group: this process alone
    assert distributed.process_count() == 1
    assert distributed.global_mesh() is collectives.ALONE
    assert distributed.global_mesh({"dp": 1}) is collectives.ALONE
    with pytest.raises(ValueError, match="cannot be formed"):
        distributed.global_mesh({"dp": 2})
    a = np.arange(6, dtype=np.int64).reshape(3, 2)
    assert distributed.host_allgather_rows(a) is a
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(num_processes=2)
    with pytest.raises(ValueError, match="one device"):
        distributed.initialize("127.0.0.1:1", 1, 0, local_device_ids=[0, 1])


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """One worker announces to a driver and joins a world of one through
    an explicit coordinator (roster[0]'s address)."""
    return run_ranks(str(tmp_path_factory.mktemp("one")), 1,
                     [{"name": "join", "kind": "join"}], timeout=120,
                     init="rendezvous")[0]["join"]


def test_explicit_coordinator_forms_a_world_of_one(one_process):
    assert "error" not in one_process, one_process["error"]
    assert one_process["reply"]["process_id"] == 0
    assert one_process["reply"]["roster"] == [{"host": "127.0.0.1",
                                               "rank_hint": 0}]
    assert (one_process["world"], one_process["rank"],
            one_process["backend"]) == (1, 0, "gloo")
    assert one_process["again"] is False   # the formed group is adopted


_SUM = [np.asarray([1e8, 1.0, -3.5, 2.0 ** -30], np.float32),
        np.asarray([-1e8, 3.0, 0.25, 1.0], np.float32)]
_ROWS = [np.arange(6, dtype=np.float64).reshape(3, 2) / 3.0,
         np.asarray([[np.nextafter(1.0, 2.0), -7.0]], np.float64)]


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Two workers join from the SYNAPSEML_* environment and run the
    collectives."""
    return run_ranks(str(tmp_path_factory.mktemp("env")), 2,
                     [{"name": "coll", "kind": "collectives",
                       "kw": {"sum": _SUM, "rows": [_ROWS]}}],
                     timeout=120, init="env")


def test_two_processes_join_from_the_environment(two_processes):
    """The reduction is the rank-ordered float32 sum (x0 + x1), bitwise on
    both ranks; the ragged float64 row gather is exact."""
    want = _SUM[0] + _SUM[1]
    for rank, res in enumerate(two_processes):
        out = res["coll"]
        assert "error" not in out, out["error"]
        assert (out["size"], out["index"]) == (2, rank)
        assert out["sum"].tobytes() == want.tobytes()
        np.testing.assert_array_equal(out["gather"], np.concatenate(_SUM))
        np.testing.assert_array_equal(out["rows"][0], np.concatenate(_ROWS))


def _launch(*args, **env_extra):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    for var in ("SYNAPSEML_COORDINATOR", "SYNAPSEML_NUM_PROCESSES",
                "SYNAPSEML_PROCESS_ID", "SYNAPSEML_CHECKPOINT_DIR"):
        env.pop(var, None)
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-m", "synapseml_tpu_torch.parallel.launch", *args],
        env=env, capture_output=True, text=True, timeout=180, cwd=ROOT)


def test_launch_entry_single_process_smoke(tmp_path):
    """The chart's train command, single-process, on the CPU: joins as a
    no-op, creates SYNAPSEML_CHECKPOINT_DIR, runs the built-in smoke fit
    (accuracy > 0.7) and exits 0."""
    ckpt = tmp_path / "ckpt"
    r = _launch("--device", "cpu", SYNAPSEML_CHECKPOINT_DIR=str(ckpt))
    assert r.returncode == 0, r.stderr
    assert "distributed=single-process process=0/1" in r.stdout
    assert "smoke-fit acc=" in r.stdout
    assert ckpt.is_dir()


def test_launch_defaults_to_the_card():
    """Without --device the launcher runs on the card; without one it
    exits non-zero, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run would pass")
    r = _launch()
    assert r.returncode != 0
    assert "CUDA" in r.stderr and "smoke-fit" not in r.stdout


_NO_FRAMES = ("pandas", "pyarrow")


def _imports(tree, module_level: bool):
    """Top-level names imported in ``tree``; with ``module_level`` only
    those that run when the module is imported (not inside a function)."""
    names, stack = [], [tree]
    while stack:
        node = stack.pop()
        for child in ast.iter_child_nodes(node):
            if module_level and isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                names += [a.name.split(".")[0] for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                names.append((child.module or "").split(".")[0])
            stack.append(child)
    return names


def _port_modules():
    out = []
    for d, _, files in os.walk(os.path.join(ROOT, "synapseml_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_pandas_or_pyarrow_on_the_port_import_path():
    """Batches are told apart by duck typing (partitions._as_table)."""
    for rel in ("data/partitions.py", "parallel/distributed.py",
                "parallel/launch.py"):
        with open(os.path.join(ROOT, "synapseml_tpu_torch", rel)) as fh:
            names = _imports(ast.parse(fh.read()), module_level=False)
        assert not set(names) & set(_NO_FRAMES), rel
    for path in _port_modules():
        with open(path) as fh:
            names = _imports(ast.parse(fh.read()), module_level=True)
        assert not set(names) & set(_NO_FRAMES), path
    # the check sees an import inside a function only when asked to
    src = "import numpy\ndef f():\n    import pandas\n"
    assert _imports(ast.parse(src), module_level=True) == ["numpy"]
    assert "pandas" in _imports(ast.parse(src), module_level=False)
