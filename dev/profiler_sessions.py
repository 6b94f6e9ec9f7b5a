"""Whether a torch.profiler session still holds its device kernel as the
process ages (a development script: not part of the package or its
tests).

    python dev/profiler_sessions.py [--hold S] [--waits 30,30,30] [--late]

Each session traces one small elementwise kernel and prints, as a JSON
line, the seconds since the start, the kernel's start minus the start of
its ``cudaLaunchKernel`` on the host (microseconds; null when the trace
holds no device kernel) and the number of device events.  A first session
runs at once unless ``--late``; then two after each wait.  ``--hold S``
keeps each session open S seconds after the kernel ends.  The last line
counts the sessions that held their kernel.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hold", type=float, default=0.0)
    ap.add_argument("--waits", default="30,30,30")
    ap.add_argument("--late", action="store_true",
                    help="no session before the first wait")
    args = ap.parse_args()
    x = torch.zeros(1024, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def session() -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            x.add_(1)
            torch.cuda.synchronize()
            time.sleep(args.hold)
        ev = prof.events()
        dev = [e for e in ev if e.device_type == DeviceType.CUDA]
        kern = [e for e in dev if "elementwise" in e.name]
        launch = [e for e in ev if e.device_type == DeviceType.CPU
                  and "LaunchKernel" in e.name]
        gap = (kern[-1].time_range.start - launch[-1].time_range.start
               if kern and launch else None)
        return dict(hold_s=args.hold, t_s=time.perf_counter() - t0,
                    kernel_minus_launch_us=gap, device_events=len(dev))

    rows = [] if args.late else [session()]
    for wait in (float(w) for w in args.waits.split(",")):
        time.sleep(wait)
        rows += [session(), session()]
    for r in rows:
        print(json.dumps(r), flush=True)
    held = sum(r["kernel_minus_launch_us"] is not None for r in rows)
    print(json.dumps(dict(hold_s=args.hold, sessions=len(rows),
                          held_the_kernel=held)))


if __name__ == "__main__":
    main()
