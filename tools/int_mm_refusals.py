"""Map the shapes ``torch._int_mm`` refuses on the card.

    python3 tools/int_mm_refusals.py

Calls ``torch._int_mm`` (cuBLASLt's s8 x s8 -> s32 GEMM) on random int8
operands over a grid of rows x K x N, every shape inside its documented
checks (rows > 16, K and N multiples of 8), and prints one JSON line: the
card, torch's and CUDA's versions, the shapes tried, and for each (K, N)
the row counts that raised. ``synapseml_tpu_torch.onnx.importer._int_mm``
pads the rows where this map shows refusals.
"""
import json
import subprocess

import torch

ROWS = [17, 20, 24, 32, 40, 48, 49, 64, 98, 100, 128, 196, 256, 392, 784,
        1024, 6272]
KS = [8, 16, 24, 32, 40, 48, 64, 72, 80, 96, 104, 112, 120, 128, 136, 144,
      152, 160, 256, 576]
NS = [8, 16, 24, 32, 40, 48, 56, 64, 128, 1000, 1024, 3072]


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    refused, tried = {}, 0
    for k in KS:
        for n in NS:
            bad = []
            for rows in ROWS:
                a = torch.randint(-128, 128, (rows, k), dtype=torch.int8,
                                  device="cuda")
                b = torch.randint(-128, 128, (k, n), dtype=torch.int8,
                                  device="cuda")
                tried += 1
                try:
                    torch._int_mm(a, b)
                    torch.cuda.synchronize()
                except RuntimeError:
                    bad.append(rows)
            if bad:
                refused[f"k{k}_n{n}"] = bad
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "shapes": tried,
                      "refused_shapes": sum(map(len, refused.values())),
                      "refused": refused}))


if __name__ == "__main__":
    main()
