"""Whether a torch.profiler session still holds its device kernel as the
process ages (a development script: not part of the package or its
tests).

    python dev/profiler_sessions.py [--hold S] [--pre S] [--waits 30,30,30] [--late]
    python dev/profiler_sessions.py --series T [--every S] [--busy] [--pre S --hold S]

Each session traces one small elementwise kernel and prints, as a JSON
line, the seconds since the start, the kernel's start minus the start of
its ``cudaLaunchKernel`` on the host (microseconds; null when the trace
holds no device kernel) and the number of device events.  A first session
runs at once unless ``--late``; then two after each wait.  ``--hold S``
keeps each session open S seconds after the kernel ends.  The last line
counts the sessions that held their kernel.  ``--pre S`` sleeps S seconds
inside each session before the kernel is launched; each line also gives
the kernel's start and the session's last host event, in microseconds
from the session's first host event.  ``--series T`` instead runs, after
the first session, a pair of sessions every S seconds (``--every``) for T
seconds: one without pre or hold, one with them; ``--busy`` keeps the card
busy with matmuls between pairs.
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
    ap.add_argument("--pre", type=float, default=0.0)
    ap.add_argument("--series", type=float, default=0.0)
    ap.add_argument("--every", type=float, default=2.0)
    ap.add_argument("--busy", action="store_true")
    ap.add_argument("--late", action="store_true",
                    help="no session before the first wait")
    args = ap.parse_args()
    x = torch.zeros(1024, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def session(pre: float = args.pre, hold: float = args.hold) -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pre)
            x.add_(1)
            torch.cuda.synchronize()
            time.sleep(hold)
        ev = prof.events()
        dev = [e for e in ev if e.device_type == DeviceType.CUDA]
        kern = [e for e in dev if "elementwise" in e.name]
        launch = [e for e in ev if e.device_type == DeviceType.CPU
                  and "LaunchKernel" in e.name]
        gap = (kern[-1].time_range.start - launch[-1].time_range.start
               if kern and launch else None)
        host = [e for e in ev if e.device_type == DeviceType.CPU]
        first = min((e.time_range.start for e in host), default=0.0)
        return dict(hold_s=hold, pre_s=pre,
                    t_s=time.perf_counter() - t0,
                    kernel_minus_launch_us=gap, device_events=len(dev),
                    kernel_at_us=(kern[-1].time_range.start - first
                                  if kern else None),
                    last_host_us=max((e.time_range.end for e in host),
                                     default=0.0) - first)

    a = torch.randn(4096, 4096, device="cuda")

    def wait(seconds: float) -> None:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            if args.busy:
                for _ in range(20):
                    a @ a
                torch.cuda.synchronize()
            else:
                time.sleep(min(0.05, seconds))

    rows = [] if args.late else [session()]
    if args.series:
        while time.perf_counter() - t0 < args.series:
            wait(args.every)
            rows += [session(0.0, 0.0), session()]
            print(json.dumps(rows[-2]), json.dumps(rows[-1]), flush=True)
    else:
        for w in (float(w) for w in args.waits.split(",")):
            wait(w)
            rows += [session(), session()]
    if not args.series:
        for r in rows:
            print(json.dumps(r), flush=True)
    held = sum(r["kernel_minus_launch_us"] is not None for r in rows)
    print(json.dumps(dict(hold_s=args.hold, pre_s=args.pre, sessions=len(rows),
                          held_the_kernel=held)))


if __name__ == "__main__":
    main()
