"""Time the port's ONNX phases of one tree's ``chip_smoke.py`` on the card.

Runs phases 20-25 (``onnx_phases``, ``transformer_phases``,
``onnx_model_phase``, ``onnx_model_warmup_phase``) of the ``chip_smoke.py``
found in TREE, with TREE's own package, and prints one JSON line of their
rates: ResNet-50 ``bind()`` images/s and the BERT-base encoder's
sequences/s at batch 128, ``ONNXModel.transform`` images/s eager and warm.
Every check of those phases still runs; a failed one exits non-zero.

To compare two commits on one card, unpack the parent beside the change
(``git archive <sha> | tar -x -C chiprun_archive/parent``) and run the two
in turns in one call, parent, change, change, parent:

    for t in parent change change parent; do
        python3 tools/abba_onnx_phases.py chiprun_archive/$t; done
"""
import contextlib
import io
import json
import os
import sys
import time


def main(tree: str) -> None:
    root = os.path.abspath(tree)
    sys.path[:0] = [root, os.path.join(root, "tests", "fixtures")]
    os.chdir(root)
    import torch

    import chip_smoke as cs

    def reset():
        pass

    def read():
        return {"forest_traverse": 0, "histogram": 0}

    torch.cuda.set_device(0)
    buf = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cs.onnx_phases("abba", reset, read)
        cs.transformer_phases("abba", reset, read)
        eager = cs.onnx_model_phase("abba", reset, read)
        cs.onnx_model_warmup_phase("abba", reset, read, eager)
    out = {"tree": os.path.basename(root),
           "device": torch.cuda.get_device_name(0),
           "seconds": time.perf_counter() - start}
    rates = {"onnx_resnet50_224": ("resnet_bind_images_per_s",
                                   "throughput_batch128", "images_per_s"),
             "onnx_bert_base_causal": ("encoder_sequences_per_s",
                                       "throughput_batch128",
                                       "sequences_per_s"),
             "onnx_model_resnet50": ("transform_images_per_s", "transform",
                                     "images_per_s"),
             "onnx_model_warmup_resnet50": ("warm_transform_images_per_s",
                                            "transform", "images_per_s")}
    for line in buf.getvalue().splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            if d.get("phase") in rates:
                name, table, key = rates[d["phase"]]
                out[name] = {k: v[key] for k, v in d[table].items()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
