"""Run one cell of the benchmark of ``fnft_tpu_torch`` once.

    python3 nftbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``nftbench/``
and ``fnft_tpu_torch/``. With ``--trace 0`` the last line of standard
output is the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics read from a profiled window; the numbers that decided ``correct``
are the last lines of standard error and the last key of that line. Each
run writes its call times, clocks and memory to
``chiprun_out/nftbench/`` in the checkout. Without enough CUDA devices,
or where ``jax``, ``jaxlib``, ``flax`` or ``fnft_tpu`` were loaded, it
exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".nftbench_cache"
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from nftbench.harness.registry import Registry
    from nftbench.harness.runner import forbidden_modules, run_cell

    reg = Registry()
    chips = reg.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"nftbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, registry=reg,
                      out_dir=ROOT / "chiprun_out" / "nftbench")
    found = forbidden_modules()
    if found:
        print(f"nftbench: the run loaded {found}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
