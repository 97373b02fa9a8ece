#!/usr/bin/env python3
"""Times a profiler session's opening and closing on the card, as
``chip_smoke.py``'s launch traces open and close them
(``torch.profiler.profile`` over the device's activity), against the
profiler's own enable and disable calls (``torch.autograd``'s
``_enable_profiler`` / ``_disable_profiler``), which return the same raw
results without building the profiler's event lists. Each session holds
about as many device records as a training CLI's trace.

    python3 scripts/profiler_session_cost.py [--sessions 6] [--launches 4000]

Prints, for each way, the median seconds to open and to close a session
and the device records it held, then the card's name and power limit.
"""

import argparse
import inspect
import statistics
import subprocess
import time


def _records(results) -> int:
    from torch.autograd import DeviceType

    return sum(1 for e in results.events()
               if e.device_type() == DeviceType.CUDA)


def main() -> None:
    import torch
    from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)
    from torch.profiler import profile

    parser = argparse.ArgumentParser()
    parser.add_argument("--sessions", type=int, default=6)
    parser.add_argument("--launches", type=int, default=4000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    x = torch.zeros(1024, device="cuda")

    def body():
        for _ in range(args.launches):
            x.add_(1.0)
        torch.cuda.synchronize()

    body()

    def high():
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            body()
            t2 = time.perf_counter()
        t3 = time.perf_counter()
        return t1 - t0, t3 - t2, _records(prof.profiler.kineto_results)

    def low():
        from torch._C._profiler import _ExperimentalConfig

        config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                False, False, _ExperimentalConfig())
        acts = {ProfilerActivity.CUDA}
        t0 = time.perf_counter()
        _prepare_profiler(config, acts)
        _enable_profiler(config, acts)
        t1 = time.perf_counter()
        body()
        t2 = time.perf_counter()
        results = _disable_profiler()
        t3 = time.perf_counter()
        return t1 - t0, t3 - t2, _records(results)

    src = inspect.getsource(torch.autograd.profiler.profile.__exit__)
    when = "lazily" if "_needs_processing" in src else "at once"
    print(f"torch {torch.__version__}: the autograd profiler's __exit__ "
          f"parses its results {when}")
    for name, fn in (("torch.profiler.profile", high),
                     ("_enable_profiler/_disable_profiler", low),
                     ("torch.profiler.profile", high)):
        runs = [fn() for _ in range(args.sessions)]
        print(f"{name}: {args.sessions} sessions of {args.launches} "
              f"launches: open {statistics.median(r[0] for r in runs):.4f} s,"
              f" close {statistics.median(r[1] for r in runs):.4f} s "
              f"(median), device records {[r[2] for r in runs]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi)


if __name__ == "__main__":
    main()
