"""Which point-to-point and all-to-all calls a gloo group takes on CUDA tensors.

    python3 tools/gloo_cuda_probe.py            # 2 gloo ranks sharing card 0

Two processes join a gloo group over a ``file://`` rendezvous and, for
each transport, send a known CUDA tensor to the other rank and check what
arrives:

- ``p2p``: ``dist.batch_isend_irecv`` (an ``isend`` to the next rank, an
  ``irecv`` from the previous one) on CUDA tensors;
- ``a2a_rotate``: ``dist.all_to_all_single`` with zero-size splits but
  for the next rank, on CUDA tensors;
- ``a2a_tiled``: ``dist.all_to_all_single`` with equal splits, on CUDA
  tensors;
- ``staged``: the same ``batch_isend_irecv`` on pinned host copies.

Each prints one JSON line: whether it raised (and what), whether the
received tensor is the sent one, and its wall ms for a 16 MiB block (the
median of 5). A transport is probed in a child of its own, so a crash in
one does not hide the others. Needs a CUDA device and ``torch.distributed``
with gloo; no network (loopback and a file rendezvous only).
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

KINDS = ("p2p", "a2a_rotate", "a2a_tiled", "staged")
MIB16 = 4 * 1024 * 1024       # float32 values in 16 MiB


def _transfer(kind, x, world, rank, dist, torch):
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    if kind in ("p2p", "staged"):
        send = x.cpu().pin_memory() if kind == "staged" else x
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, nxt),
               dist.P2POp(dist.irecv, recv, prv)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return recv.to(x.device)
    if kind == "a2a_rotate":
        m = x.shape[0]
        ins = [m if j == nxt else 0 for j in range(world)]
        outs = [m if j == prv else 0 for j in range(world)]
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, outs, ins)
        return out
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    return out


def child(kind: str, rank: int, world: int, rendezvous: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://" + rendezvous,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    res = {"kind": kind, "rank": rank}
    try:
        x = (torch.arange(MIB16, dtype=torch.float32, device=dev)
             + rank * 1e6).reshape(world * 2, -1)
        got = _transfer(kind, x, world, rank, dist, torch)
        torch.cuda.synchronize()
        prv = (rank - 1) % world
        if kind == "a2a_tiled":
            rows = x.shape[0] // world
            want = torch.cat([(torch.arange(MIB16, dtype=torch.float32,
                                            device=dev) + j * 1e6)
                              .reshape(world * 2, -1)[rank * rows:
                                                      (rank + 1) * rows]
                              for j in range(world)])
        else:
            want = (torch.arange(MIB16, dtype=torch.float32, device=dev)
                    + prv * 1e6).reshape(world * 2, -1)
        res["device_out"] = str(got.device)
        res["correct"] = bool(torch.equal(got, want))
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            start = time.perf_counter()
            _transfer(kind, x, world, rank, dist, torch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - start) * 1e3)
        res["ms_16mib"] = statistics.median(ms)
    except Exception as exc:  # the probe's finding, printed
        res["raised"] = f"{type(exc).__name__}: {str(exc)[:300]}"
    print(json.dumps(res), flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    world = 2
    for kind in KINDS:
        with tempfile.TemporaryDirectory() as work:
            rdv = os.path.join(work, "rendezvous")
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), kind, str(r),
                 str(world), rdv], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(world)]
            for r, p in enumerate(procs):
                try:
                    out, _ = p.communicate(timeout=120)
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                    out += "\ntimed out"
                print(json.dumps({"kind": kind, "rank": r,
                                  "rc": p.returncode,
                                  "log_tail": out[-1500:]}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5:
        child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        sys.exit(main())
