"""Which device records does a ``torch.profiler`` session drop, and which
way of opening a session keeps the traced call whole?

Run on a CUDA machine from the repo root:

    python3 tools/profiler_probe.py [SECONDS]

It builds the SSD-scan library (``src/repro_torch/csrc/ssd_chunk.cu``),
then, every 20 s of a process that keeps the card busy with the scan in
between, profiles four sessions of each way of opening one around one scan
call (three device kernels: state ``S``, hand-off ``H``, output ``O``):

- ``spin``: one 0.1 ms spin kernel and a synchronize;
- ``sleep25``: a synchronize and 25 ms of host sleep, and 25 ms after;
- ``adds20``: 20 elementwise kernels and a synchronize, and 20 after;
- ``self``: the call itself, then the traced call (counted from a
  ``record_function`` mark), then 20 elementwise kernels;
- ``sched``: a ``schedule(warmup=1, active=1)`` profile whose warm-up step
  runs 20 elementwise kernels and whose active step the call;
- ``lead``: ``chip_smoke._lead_in`` (``PROFILE_LEAD`` short spin kernels
  and a synchronize).

Each line prints the process age, and for each way how many of its 4
sessions missed a scan kernel, with each session's recorded scan kernels
in start order and its count of recorded elementwise kernels (``SHO/40``:
whole; ``-/7``: no scan kernel and 33 of 40 elementwise records lost).
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))


def main() -> int:
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    from chip_smoke import _lead_in
    from repro_torch.kernels.ssd_chunk import kernel as sk

    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 2
    duration = float(sys.argv[1]) if len(sys.argv) > 1 else 400.0
    t_start = time.perf_counter()
    sk.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    lam = -torch.rand((2, 512, 8), generator=g, device=dev) * 0.1
    Bm = torch.randn((2, 512, 64), generator=g, device=dev)
    Cm = torch.randn((2, 512, 64), generator=g, device=dev)
    x = torch.randn((2, 512, 8, 64), generator=g, device=dev)
    y = torch.zeros(1 << 16, device=dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def call():
        return sk.ssd_chunk(lam, Bm, Cm, x, chunk=256)

    def adds(n):
        for _ in range(n):
            y.add_(1.0)

    def summary(events, mark=None):
        dev_events = [e for e in events
                      if str(e.device_type).endswith("CUDA")]
        scan = [e for e in dev_events if "ssd_" in e.name]
        if mark is not None:
            scan = [e for e in scan if e.time_range.start >= mark]
        scan.sort(key=lambda e: e.time_range.start)
        names = "".join("S" if "state" in e.name else
                        "H" if "handoff" in e.name else "O" for e in scan)
        n_adds = sum(1 for e in dev_events if "elementwise" in e.name)
        return f"{names or '-'}/{n_adds}"

    def spin():
        with profile(activities=acts) as prof:
            torch.cuda._sleep(200_000)
            torch.cuda.synchronize()
            call()
            torch.cuda.synchronize()
        return summary(prof.events())

    def sleep25():
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            time.sleep(0.025)
            call()
            torch.cuda.synchronize()
            time.sleep(0.025)
        return summary(prof.events())

    def adds20():
        with profile(activities=acts) as prof:
            adds(20)
            torch.cuda.synchronize()
            call()
            torch.cuda.synchronize()
            adds(20)
            torch.cuda.synchronize()
        return summary(prof.events())

    def itself():
        with profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
            with record_function("measured"):
                call()
                torch.cuda.synchronize()
            adds(20)
            torch.cuda.synchronize()
        events = prof.events()
        mark = min(e.time_range.start for e in events
                   if e.name == "measured")
        return summary(events, mark)

    def sched():
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            adds(20)
            torch.cuda.synchronize()
            prof.step()
            call()
            torch.cuda.synchronize()
            prof.step()
        return summary(prof.events())

    def lead():
        with profile(activities=acts) as prof:
            _lead_in()
            call()
            torch.cuda.synchronize()
        return summary(prof.events())

    ways = {"spin": spin, "sleep25": sleep25, "adds20": adds20,
            "self": itself, "sched": sched, "lead": lead}
    call()
    torch.cuda.synchronize()
    print(f"built in {time.perf_counter() - t_start:.1f} s", flush=True)
    while time.perf_counter() - t_start < duration:
        parts = []
        for name, way in ways.items():
            got = [way() for _ in range(4)]
            missed = sum(1 for r in got if not r.startswith("SHO"))
            parts.append(f"{name} {missed}/4 {got}")
        print(f"t={time.perf_counter() - t_start:.0f}s " + " | ".join(parts),
              flush=True)
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < 20:
            call()
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
