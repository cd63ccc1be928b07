"""Readings that the limits of ``correct`` are set from, for one cell on
the card: the numbers compared for the program on many seeds (the lower
readings) and for the controls on some of them (the upper readings): the
program's own complex64 path, and the reference computed in complex64
put in the program's place.

    python3 nftbench/calibrate.py --workload <name> --seeds 12 \
        --control-seeds 3 [--first-seed N]

One process builds the entry once and, for each seed, makes that seed's
pool, runs the program once on each batch of it and judges the outputs as
a run does (``runner.judge``, with no limit). Prints one JSON line a seed
and kind, and writes them to
``chiprun_out/nftbench/calibrate.<workload>.json``.
"""

import argparse
import collections
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def lowered(batch: dict) -> dict:
    """The batch with every complex128 tensor in complex64."""
    import torch

    return {k: v.to(torch.complex64)
            if torch.is_tensor(v) and v.dtype == torch.complex128 else v
            for k, v in batch.items()}


def main(argv=None) -> int:
    import torch

    from nftbench.harness.generate import generate
    from nftbench.harness.registry import Registry
    from nftbench.harness.runner import judge

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    reg = Registry()
    cell = reg.cell(args.workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    ref = reg.reference(cfg["entry"])
    unlimited = {"check": reg.limits(args.workload)["check"],
                 "limits": collections.defaultdict(lambda: math.inf)}
    dev = torch.device("cuda")
    fn = reg.entry(cfg["entry"]).build(cfg, dev)
    batch = traffic["batch"]

    def readings(pool, kept, seed, observe=None) -> dict:
        _, checks = judge(ref, cfg, unlimited, pool, kept, seed, batch,
                          observe)
        return {k: c["value"] for k, c in checks.items()}

    def ref64(c, item, pl):
        return ref.expected(c, item, pl, torch.complex64)

    lines = []
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        pool = generate(reg, traffic, cfg, seed, dev)
        t0 = time.perf_counter()
        kept = {p: fn(item) for p, item in enumerate(pool)}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        recs = [{"seed": seed, "kind": "program",
                 "call_s": (t1 - t0) / len(pool),
                 **readings(pool, kept, seed),
                 "reference_s": time.perf_counter() - t1}]
        if k < args.control_seeds:
            try:
                kept64 = {p: fn(lowered(item)) for p, item in enumerate(pool)}
                got = readings(pool, kept64, seed)
            except Exception as exc:   # a control that fails sets no limit
                got = {"failed": repr(exc)[:300]}
            recs.append({"seed": seed, "kind": "program_complex64", **got})
            recs.append({"seed": seed, "kind": "reference_complex64",
                         **readings(pool, dict(enumerate(pool)), seed,
                                    ref64)})
        for rec in recs:
            lines.append(rec)
            print(json.dumps(rec), flush=True)
        del kept, pool
    out = ROOT / "chiprun_out" / "nftbench"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"calibrate.{args.workload}.json").write_text(json.dumps(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
