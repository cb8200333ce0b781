"""The readings that a cell's limits are set from, on the card, in one process.

    python3 -m portbench.limits --workload <cell> --seconds <s> \\
        --seeds <a,b,...> --control <c,d,e> [--out <file.jsonl>]

For each seed of ``--seeds`` and ``--control``: the cell's set-up and a
window of ``--seconds`` at its own load, as ``portbench.run`` makes them,
and the program's numbers against the float64 reference.  For each seed of
``--control`` also the control's: the reference's filterbank computed in
bfloat16 (``reference.filterbank.Precision``), the next precision below the
configuration's float32, and folded exactly, put in the program's place.
The lower reading of a number is the largest over the program's seeds, the
upper the smallest over the control's; ``limits/<cell>.json`` holds a limit between the two.
The benchmark's own runs never run the control.  One JSON line a seed,
then one of the readings.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys


def readings(cell, seed: int, seconds: float, control: bool,
             device: str = "cuda") -> dict:
    """The numbers of one seed: the program's, and with ``control`` the
    bfloat16 control's and the same filterbank's in float16 (a reading
    beside it, not a limit's), each against the float64 reference."""
    import torch

    from portbench.reference.filterbank import Precision

    drv = cell.driver.Driver(cell, seed, device)
    n = drv.warm(seconds)
    out = drv.window(n)
    drv.release()
    want = drv.reference(Precision("float64"))
    rec = {"seed": seed, "blocks": n, "program": drv.compare(out, want)}
    if control:
        rec["control"] = drv.compare(drv.reference(Precision("bfloat16")),
                                     want)
        rec["float16"] = drv.compare(drv.reference(Precision("float16")),
                                     want)
    del drv, out, want
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return rec


def summary(records: list) -> dict:
    """``{number: {"lower": ..., "upper": ...}}`` over ``records``."""
    out = {}
    for rec in records:
        for side, key, pick in (("program", "lower", max),
                                ("control", "upper", min)):
            for k, v in rec.get(side, {}).items():
                cur = out.setdefault(k, {}).get(key)
                out[k][key] = v if cur is None else pick(cur, v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from portbench.spec import load_cell

    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control.split(",") if s]
    records = []
    sink = open(args.out, "a") if args.out else None
    for seed in seeds + controls:
        rec = readings(cell, seed, args.seconds, seed in controls)
        rec["workload"] = cell.name
        records.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    result = {"workload": cell.name, "readings": summary(records)}
    print(json.dumps(result), flush=True)
    if sink:
        sink.write(json.dumps(result) + "\n")
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
