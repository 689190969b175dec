"""Small control-flow ONNX graphs served through ``ONNXModel``, with their
numpy forwards.

Each graph takes ``x [N, WIDTH]`` float32 and returns tensors whose first
axis is the batch, so the batched executor can pad and slice them:
- :func:`if_on_device`: an ``If`` whose condition is computed on the
  device (``ReduceSum(x) > 0``): both branches run and one is selected,
  with no read of the condition on the host, so a bucket can be captured;
- :func:`loop_on_host`: a ``Loop`` with a host trip count and a scan
  output (``acc = 0.5 acc + x`` three times, every step kept);
- :func:`loop_on_device_below`: for batches smaller than ``below`` rows,
  a ``Loop`` whose condition the body computes on the device (doubling
  until the batch's sum reaches ``LIMIT``, at most ``MAX_TRIPS`` times),
  nested in an ``If`` on the batch size; larger batches double once. The
  device loop reads its condition on the host every iteration, so its
  buckets cannot be captured; the larger ones can.

Imports the port's graph builder only (no JAX): ``chip_smoke.py`` and the
tests build the same bytes.
"""
import numpy as np

from synapseml_tpu_torch.onnx import GraphBuilder

WIDTH = 4
LIMIT = 1000.0
MAX_TRIPS = 64
F32 = np.float32


def body(name, inputs, nodes, outputs, inits=None):
    """A subgraph: bare-named inputs and outputs, ``nodes`` as (op_type,
    inputs, outputs, attrs), ``inits`` as initializers."""
    b = GraphBuilder(name=name, name_prefix=f"{name}__")
    for n in inputs:
        b.add_input(n)
    for n, a in (inits or {}).items():
        b.add_initializer(n, a)
    for op_type, ins, outs, attrs in nodes:
        b.add_node(op_type, ins, outputs=outs, name=f"{name}_{outs[0]}",
                   **attrs)
    for n in outputs:
        b.add_output(n, F32, None)
    return b.build().graph


def _graph():
    g = GraphBuilder(opset=17)
    g.add_input("x", F32, ["N", WIDTH])
    return g


def if_on_device() -> bytes:
    g = _graph()
    g.add_node("ReduceSum", ["x"], outputs=["s"], keepdims=0)
    g.add_initializer("zero", np.zeros((), F32))
    g.add_node("Greater", ["s", "zero"], outputs=["c"])
    then_b = body("thenb", [], [("Mul", ["x", "k"], ["t"], {})], ["t"],
                  inits={"k": np.linspace(1.0, 2.0, WIDTH).astype(F32)})
    else_b = body("elseb", [], [("Sub", ["x", "k"], ["e"], {})], ["e"],
                  inits={"k": np.full(WIDTH, 0.25, F32)})
    g.add_node("If", ["c"], outputs=["y"], then_branch=then_b,
               else_branch=else_b)
    g.add_output("y", F32, ["N", WIDTH])
    return g.to_bytes()


def if_on_device_reference(x: np.ndarray) -> np.ndarray:
    if x.sum() > 0:
        return x * np.linspace(1.0, 2.0, WIDTH).astype(F32)
    return x - F32(0.25)


TRIPS = 3


def loop_on_host() -> bytes:
    g = _graph()
    g.add_initializer("M", np.int64(TRIPS))
    g.add_initializer("c0", np.array(True))
    step = body("body", ["i", "cond_in", "acc"],
                [("Identity", ["cond_in"], ["cond_out"], {}),
                 ("Mul", ["acc", "half"], ["h"], {}),
                 ("Add", ["h", "x"], ["acc_out"], {})],
                ["cond_out", "acc_out", "acc_out"],
                inits={"half": F32(0.5)})
    g.add_node("Loop", ["M", "c0", "x"], outputs=["final", "steps"],
               body=step)
    g.add_node("Transpose", ["steps"], outputs=["rows"], perm=[1, 0, 2])
    g.add_output("final", F32, ["N", WIDTH])
    g.add_output("rows", F32, ["N", TRIPS, WIDTH])
    return g.to_bytes()


def loop_on_host_reference(x: np.ndarray):
    acc, steps = x, []
    for _ in range(TRIPS):
        acc = acc * F32(0.5) + x
        steps.append(acc)
    return acc, np.stack(steps, 1)


def loop_on_device_below(below: int = 16) -> bytes:
    g = _graph()
    g.add_node("Shape", ["x"], outputs=["shape"])
    g.add_initializer("zero_i", np.array([0], np.int64))
    g.add_node("Gather", ["shape", "zero_i"], outputs=["n"], axis=0)
    g.add_initializer("below", np.array([below], np.int64))
    g.add_node("Less", ["n", "below"], outputs=["small"])
    g.add_initializer("limit", F32(LIMIT))
    # bounded: warmup's first run feeds zeros, whose sum never grows
    g.add_initializer("M", np.int64(MAX_TRIPS))
    g.add_initializer("c0", np.array(True))
    while_body = body("wbody", ["i", "cond_in", "acc"],
                      [("Add", ["acc", "acc"], ["acc_out"], {}),
                       ("ReduceSum", ["acc_out"], ["s"], {"keepdims": 0}),
                       ("Less", ["s", "limit"], ["cond_out"], {})],
                      ["cond_out", "acc_out"])
    then_b = body("thenb", [], [("Loop", ["M", "c0", "x"], ["looped"],
                                 {"body": while_body})], ["looped"])
    else_b = body("elseb", [], [("Add", ["x", "x"], ["doubled"], {})],
                  ["doubled"])
    g.add_node("If", ["small"], outputs=["y"], then_branch=then_b,
               else_branch=else_b)
    g.add_output("y", F32, ["N", WIDTH])
    return g.to_bytes()


def loop_on_device_reference(x: np.ndarray, below: int = 16) -> np.ndarray:
    """``x`` is the padded batch the graph sees."""
    if len(x) >= below:
        return x + x
    acc = x
    for _ in range(MAX_TRIPS):
        acc = acc + acc
        if not acc.sum() < LIMIT:
            break
    return acc


def rows(n: int, seed: int = 0) -> np.ndarray:
    """Positive rows, so the device loop's sum grows."""
    return np.random.default_rng(seed).uniform(
        0.5, 1.5, (n, WIDTH)).astype(F32)
