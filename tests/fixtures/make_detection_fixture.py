"""Generate the detection-head fixture, ``detection_head_io.npz``.

Runs the JAX package on the CPU, eagerly (its bound forward): torchvision
Faster R-CNN R50-FPN's second stage at its published width
(``detection_head.FULL``, the graph built with the JAX package's
``GraphBuilder``, weights from ``detection_head.WEIGHT_SEED``) over
``detection_head.inputs()`` (seed ``detection_head.INPUT_SEED``). Stores
both NMS stages' rows, the 100 detections (boxes, scores, labels, rows),
the ``RoiAlign`` output's largest |value| (``pooled_span``), how many
proposals the first stage keeps and how many (kept proposal, foreground
class) pairs clear the 0.05 score threshold (the class scores recomputed
in numpy from the reference's pooled features), the seeds and the jax
version. The inputs and weights come back from their seeds.

Run from the repo root:  python tests/fixtures/make_detection_fixture.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import detection_head as head  # noqa: E402


def pairs_over_threshold(pooled: np.ndarray, rows1: np.ndarray) -> int:
    """(kept proposal, foreground class) pairs whose softmax score clears
    ``head.SCORE_THRESH``, from the pooled features, in float32."""
    p = head.parameters(head.FULL)
    h = pooled.reshape(len(pooled), -1)
    h = np.maximum(h @ p["fc6_w"].T + p["fc6_b"], 0)
    h = np.maximum(h @ p["fc7_w"].T + p["fc7_b"], 0)
    logits = h @ p["cls_w"].T + p["cls_b"]
    e = np.exp(logits - logits.max(1, keepdims=True))
    probs = e / e.sum(1, keepdims=True)
    kept = rows1[:, 0] >= 0
    return int((probs[kept][:, 1:] > head.SCORE_THRESH).sum())


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from synapseml_tpu.onnx import GraphBuilder, import_model

    start = time.perf_counter()
    fn = import_model(head.head_graph(GraphBuilder, head.FULL)).bind()
    feeds = head.inputs(head.FULL)
    out = fn(*[jnp.asarray(feeds[k]) for k in head.INPUTS])
    out = {k: np.asarray(v) for k, v in zip(head.OUTPUTS, out)}
    assert all(np.isfinite(out[k]).all() for k in ("pooled", "det_boxes"))
    kept = int((out["rows1"][:, 0] >= 0).sum())
    pairs = pairs_over_threshold(out["pooled"], out["rows1"])
    np.savez_compressed(
        head.OUT, **{k: out[k].astype(np.int64) if k.startswith("rows")
                     or k in ("det_labels", "det_rows") else out[k]
                     for k in head.OUTPUTS if k != "pooled"},
        pooled_span=np.float64(np.abs(out["pooled"]).max()),
        kept_proposals=np.int64(kept), pairs_over_threshold=np.int64(pairs),
        weight_seed=np.int64(head.WEIGHT_SEED),
        input_seed=np.int64(head.INPUT_SEED),
        jax_version=np.asarray(jax.__version__))
    print(f"wrote {head.OUT} ({os.path.getsize(head.OUT)} bytes) in "
          f"{time.perf_counter() - start:.1f} s; stage 1 kept {kept} of "
          f"{head.FULL['proposals']}; {pairs} pairs over "
          f"{head.SCORE_THRESH}; |pooled| <= {np.abs(out['pooled']).max():.4f}")


if __name__ == "__main__":
    main()
