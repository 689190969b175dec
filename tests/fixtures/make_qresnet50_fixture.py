"""Write ``qresnet50_io.npz``: the JAX package's outputs of the quantized
ResNet-50 224 (``tests/fixtures/qresnet50.py``, ``FULL``, with the stem's
accumulator) for ``entry()``'s first two images, on the CPU.

    python tests/fixtures/make_qresnet50_fixture.py    # ~30 s

It stores the calibrated ranges the graph was built with (``range_keys``,
``ranges``: the calibration's float forward depends on the BLAS, so a
rebuild elsewhere reads them back with ``qresnet50.stored_ranges()``), the
graph's sha256, the reference's eager forward's outputs — the uint8
logits before the last ``DequantizeLinear`` (``logits_q``), the float
logits, and the first convolution's int32 accumulator as its sha256 and
its per-channel sums (``stem_acc_sha256``, ``stem_acc_channel_sums`` int64
``[2, 64]``) — and the uint8 logits of the same forward under ``jax.jit``
(``logits_q_jit``): XLA's fusions move some requantizations by one step
(ROADMAP Queue 3), and the port holds the eager forward bitwise.
"""
import hashlib
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
IMAGES = 2


def main() -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import make_resnet50_fixture as resnet_fx
    import qresnet50 as qr
    from synapseml_tpu.onnx import GraphBuilder, import_model

    start = time.perf_counter()
    layers = qr.float_layers(qr.FULL)
    calibrated = qr.ranges(layers, qr.images(qr.CALIB_IMAGES, qr.FULL))
    blob = qr.graph(GraphBuilder, qr.FULL, accumulator=True,
                    calibrated=calibrated)
    fn = import_model(blob).bind()
    x = resnet_fx.images(IMAGES)
    logits, logits_q, acc = (np.asarray(o) for o in fn(x))
    logits_q_jit = np.asarray(jax.jit(fn)(x)[1])
    assert logits_q.dtype == np.uint8 and logits_q.shape == (IMAGES, 1000)
    assert acc.dtype == np.int32 and acc.shape == (IMAGES, 64, 112, 112)
    keys = sorted(calibrated)
    np.savez_compressed(
        qr.OUT, range_keys=np.asarray(keys),
        ranges=np.asarray([calibrated[k] for k in keys], np.float64),
        graph_sha256=np.asarray(hashlib.sha256(blob).hexdigest()),
        logits_q=logits_q, logits=logits, logits_q_jit=logits_q_jit,
        stem_acc_sha256=np.asarray(hashlib.sha256(acc.tobytes()).hexdigest()),
        stem_acc_channel_sums=acc.astype(np.int64).sum(axis=(2, 3)),
        jax_version=np.asarray(jax.__version__))
    gap = np.abs(logits_q.astype(int) - logits_q_jit.astype(int))
    print(f"wrote {qr.OUT} in {time.perf_counter() - start:.1f} s; logits_q "
          f"span {int(logits_q.min())}..{int(logits_q.max())}, "
          f"{len(np.unique(logits_q))} distinct values; under jit "
          f"{int((gap != 0).sum())} differ, by at most {int(gap.max())}")


if __name__ == "__main__":
    main()
