"""The control of the comparison that decides ``correct``.

The configuration states no precision, so the control breaks a guarantee
it states: the reference, computed with the quorum at ``floor(2n/3)``
instead of ``ceil(2n/3)`` (42 of 64, 682 of 1,024), is put in the
program's place and compared with the reference as a run compares the
program. The counts it reads are the comparison's upper readings; they
have to come out above the limits (0), that is, as not correct.

    python3 portbench/control.py --workload <cell> --seeds <a,b,c> --window-calls <n>

runs it at the cell's own size: the cell's inputs from each seed, the
ramp and ``--window-calls`` calls of the window (as many as a run of the
cell hands the node), no program. It prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def counts(driver) -> dict:
    """The control against the reference, compared by ``check.compare`` as
    a run compares the program, over the calls ``driver.handed`` reaches."""
    from portbench import check

    want = driver.reference()
    got = driver.reference(quorum_floor=True)
    return check.compare(got, want, driver.follow, driver.handed)[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--window-calls", type=int, required=True)
    args = parser.parse_args()
    from portbench import harness

    entry, config, traffic = harness.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Ctx(name=entry["name"], config=config, traffic=traffic, seed=seed)
        driver = harness.load_module(harness.HERE / "drivers" / f"{traffic['driver']}.py").Driver(ctx)
        driver.prepare()
        start = driver.sched.ramp_calls
        driver.handed = range(start, min(start + args.window_calls, driver.sched.calls))
        print(json.dumps({"workload": entry["name"], "seed": seed, "control": counts(driver),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
