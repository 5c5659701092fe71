"""The two FP32-FMA product kernels alone, on one NVIDIA GPU: K1's onedot
kernel (csrc/fused_mel_onedot.cu) and K3's float32 weight gradient
(`conv3x3_wgrad_kernel`, csrc/packed_conv.cu).

    python tools/bench_fp32_products_torch.py [--no-tests]

Prints the card's name and power limit; the ptxas report (registers,
stack, spill) of every instantiation of the two kernels and their HGMMA /
HMMA / FFMA counts (`cuobjdump -sass` of the built library, through
chip_smoke.py's `check_mma`, which fails on a tensor-core instruction
there); runs their GPU tests (`pytest tests/test_torch_kernels_gpu.py -k
"onedot or wgrad_float32 or conv2d_packed_gradients"`) unless --no-tests;
then chip_smoke.py's phase-3 rows of the two (`chip_smoke.onedot_kernels`
at the flagship frontend, float32 and int16 audio, against one cuBLAS SGEMM
of the same product; `chip_smoke.k3_f32_kernels` for the weight gradient
alone at the flagship's blocks 2 and 3, against `conv2d_weight` and
autograd through `F.conv2d`), each against its plain version under
chip_smoke.py's bars, and a summary of device ms, bound, share of bound and
the library's device ms. About two minutes of card time. Imports the port
only; needs a card; exits non-zero when a bar fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KERNELS = ("fused_stft_mel_onedot_kernel", "onedot_fold_kernel", "conv3x3_wgrad_kernel")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-tests", action="store_true", help="skip the GPU tests of the two kernels")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_fp32_products_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    info = _build.build()
    print(f"built in {info['seconds']:.1f} s")
    lines = info["log"].splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(k in line for k in KERNELS):
            print(line.strip())
            print("  ", " ".join(s.strip() for s in lines[i + 1:i + 4] if "bytes" in s or "registers" in s))
    cs.check_mma(info["path"])
    mix = ("FFMA", "LDS", "LDG", "LDGSTS", "STS", "STG", "BAR", "I2F", "IMAD", "ISETP")
    for name, counts in _build.sass_counts(info["path"], KERNELS, mix).items():
        print(f"{name[:90]}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))

    if not args.no_tests:
        tests = subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_kernels_gpu.py", "-q",
                                "-p", "no:randomly", "-k", "onedot or wgrad_float32 or conv2d_packed_gradients"],
                               cwd=REPO, capture_output=True, text=True)
        print(tests.stdout[-3000:], tests.stderr[-2000:])
        if tests.returncode != 0:
            return tests.returncode

    device = torch.device("cuda", 0)
    rows = {name: cs.Row() for name in cs.KERNELS}
    rng = np.random.default_rng(cs.SEED)
    cs.onedot_kernels(device, rows, rng)
    cs.k3_f32_kernels(device, rows, rng, which=("wgrad",))
    print("row: device ms (events ms), bound ms, share of bound, library device ms")
    for name, row in rows.items():
        if not row.shapes:
            continue
        share = f"{100.0 * row.bound / row.device_ms:.1f} %" if row.device_ms else "not measured"
        print(f"  {name}: {cs.shown(row.device_ms)} ({row.ms:.4f}), {row.bound:.4f} by {row.bound_by}, {share}, "
              f"library {cs.shown(row.library_device_ms)}")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
