#!/usr/bin/env python3
"""Where the wall time of one run of the port's training CLI goes on the
card, outside its steps: ``python -m trainner_tpu_torch.train`` on
``options/sr/train_sr.yml`` at full width (as ``chip_smoke.py``'s cli
phase runs it: a seeded corpus, 12 iterations, a resume to 14), each run
under cProfile, the second also under ``chip_smoke.py``'s launch trace.

    python3 scripts/cli_overhead.py [--top 30]

Prints each run's wall seconds and the functions with the most cumulative
time, then the card's name and power limit.
"""

import argparse
import cProfile
import io
import os
import pstats
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--top", type=int, default=30)
    args = parser.parse_args()

    import torch

    import chip_smoke
    from trainner_tpu_torch.ops import _build
    from trainner_tpu_torch.train import cli

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    _build.build_all()
    root = tempfile.mkdtemp(prefix="cli_overhead_")
    chip_smoke._write_corpus(os.path.join(root, "corpus"))
    runs = []
    for name, traced, resume in (("cold", False, False),
                                 ("warm", False, False),
                                 ("traced", True, False),
                                 ("resume", False, True)):
        label = "warm" if resume else name
        path = chip_smoke._cli_options(root, os.path.join(root, "corpus"),
                                       name=label)
        argv = ["-opt", path]
        if resume:
            import json

            with open(path) as f:
                opt = json.load(f)
            opt["path"]["resume_state"] = os.path.join(
                root, label, "experiments", opt["name"], "training_state",
                f"{chip_smoke.CLI_NITER}.state")
            opt["train"]["niter"] = chip_smoke.CLI_RESUME_NITER
            path = os.path.join(root, "resume.json")
            with open(path, "w") as f:
                json.dump(opt, f)
            argv = ["-opt", path]
        prof = cProfile.Profile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof.enable()
        if traced:
            with chip_smoke._launch_trace() as t:
                cli.main(argv)
        else:
            cli.main(argv)
        torch.cuda.synchronize()
        prof.disable()
        wall = time.perf_counter() - t0
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(
            args.top)
        runs.append((name, wall))
        print(f"cli_overhead: {name} run {wall:.2f} s"
              + (f" (trace records {t['records']})" if traced else ""))
        print(out.getvalue())
    print(f"cli_overhead: runs {[(n, round(w, 2)) for n, w in runs]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())


if __name__ == "__main__":
    main()
