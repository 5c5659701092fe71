"""K3's bfloat16 kernels alone, on one NVIDIA GPU: their build, their
machine code, their GPU tests and chip_smoke.py's K3 rows.

    python tools/bench_k3_torch.py [--no-tests]

Prints the card's name and power limit; the ptxas report (registers, spill)
of every K3 kernel in csrc/packed_conv.cu and its HGMMA / HMMA / FFMA
counts (`cuobjdump -sass` of the built library); runs `pytest
tests/test_torch_kernels_gpu.py -k conv2d` unless --no-tests; then K3f,
K3dx and K3w in bfloat16 at blocks 2 and 3 of the scaled configuration and
of the flagship in bfloat16 (batch 24), each against its plain version
under chip_smoke.py's bars, with the kernel's CUDA-event and device times
beside the plain version's and the library call's (the same code as
chip_smoke.py's phase 3: `chip_smoke.k3_bf16_kernels`), and a summary of
device ms, bound and share of bound per row. A check of a K3 change in
about two minutes of card time, before the whole chip_smoke.py. Imports the
port only; needs a card; exits non-zero when a bar fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-tests", action="store_true", help="skip the K3 GPU tests")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_k3_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.config import Config, scaled_config
    from dcase2019_task4_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    info = _build.build()
    print(f"built in {info['seconds']:.1f} s")
    lines = info["log"].splitlines()
    for i, line in enumerate(lines):
        if "conv3x3" in line and "Compiling entry" in line:
            print(line.strip())
            print("  ", " ".join(s.strip() for s in lines[i + 1:i + 3] if "bytes" in s or "registers" in s))
    for name, counts in _build.sass_counts(info["path"], ("conv3x3",)).items():
        print(f"{name[:90]}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    cs.check_mma(info["path"])

    if not args.no_tests:
        tests = subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_kernels_gpu.py", "-q",
                                "-p", "no:randomly", "-k", "conv2d"], cwd=REPO, capture_output=True, text=True)
        print(tests.stdout[-3000:], tests.stderr[-2000:])
        if tests.returncode != 0:
            return tests.returncode

    device = torch.device("cuda", 0)
    rows = {name: cs.Row() for name in cs.KERNELS}
    rng = np.random.default_rng(cs.SEED)
    flagship = Config()
    flagship = dataclasses.replace(flagship, model=dataclasses.replace(flagship.model, compute_dtype="bfloat16"))
    cs.k3_bf16_kernels(device, rows, rng, scaled_config())
    cs.k3_bf16_kernels(device, rows, rng, flagship, "_flagship")
    print("row: device ms (events ms), bound ms, share of bound, library device ms")
    for name, row in rows.items():
        if not row.shapes:
            continue
        share = f"{100.0 * row.bound / row.device_ms:.1f} %" if row.device_ms else "not measured"
        print(f"  {name}: {cs.shown(row.device_ms)} ({row.ms:.4f}), {row.bound:.4f} by {row.bound_by}, {share}, "
              f"library {cs.shown(row.library_device_ms)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
