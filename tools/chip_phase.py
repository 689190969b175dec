"""Run one phase function of ``chip_smoke.py`` alone on the card.

    python3 tools/chip_phase.py mlm_phase          # phase 33
    python3 tools/chip_phase.py decode_phase       # phase 32
    python3 tools/chip_phase.py onnx_sequence_string_ops   # phase 37
    python3 tools/chip_phase.py signal_speech      # phase 38
    python3 tools/chip_phase.py dp_layouts         # phase 40
    python3 tools/chip_phase.py quantized          # phase 41
    python3 tools/chip_phase.py sequence_parallel  # phase 42

A phase is named by its function or by the ``phase`` its JSON lines carry
(:data:`PHASES`).

The phase gets the card's ``nvidia-smi`` name and power limit and the
kernels' launch counters, as ``chip_smoke.main`` passes them; the kernels
are not built, so a phase that launches K1 or K2 does not belong here.
Every check of the phase runs; a failed one is printed and the phase goes
on, and the exit code is 1 if any failed. Its JSON lines are the phase's
own, the last one ``{"phase_s": ..., "failed": [...]}``.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = {"onnx_index_ops": "mlm_phase", "onnx_vision_ops": "vae_phase",
          "onnx_detection_ops": "detection_phase",
          "onnx_random_ops": "random_phase",
          "onnx_sequence_string_ops": "sequence_string_phase",
          "signal_speech": "speech_phase", "dp_layouts": "dp_layouts_phase",
          "quantized": "quantized_phase",
          "sequence_parallel": "sequence_parallel_phase"}


def main(name: str) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests", "fixtures")]
    import chip_smoke as cs
    from synapseml_tpu_torch.gbdt.kernels import forest_traverse, histogram

    failed = []

    def check(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)
            print(f"chip_phase: FAILED: {msg}", flush=True)

    def reset():
        forest_traverse.launches = 0
        histogram.launches = 0

    def read():
        return {"forest_traverse": forest_traverse.launches,
                "histogram": histogram.launches}

    cs.check = check
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    start = time.perf_counter()
    getattr(cs, PHASES.get(name, name))(smi, reset, read)
    print(json.dumps({"phase_s": time.perf_counter() - start,
                      "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
