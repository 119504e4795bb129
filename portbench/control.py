"""The control of the correctness check: the plain reference in float32.

The reference's own arithmetic, computed in the precision below the
configuration's float64 (portbench/reference/scoring.py F32), is put in the
program's place: its VCF body is rendered and judged against the float64
reference exactly as a run judges the program's body. The check is sound
only if this control comes out not correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3

prints one JSON line a seed (the numbers and whether they pass the
configuration's limits). It needs no card: it never runs the program.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import gen
from portbench.reference import compare, scoring


def control_numbers(config: dict, traffic: dict, seed: int,
                    root: str = gen.ROOT) -> dict:
    layout = gen.load_layout(config, root)
    sample = layout.make_sample(gen.sample_spec(config, traffic), seed)
    calling = config["calling"]
    want = compare.expected_body(sample, layout.counts, calling, scoring.F64)
    got = compare.expected_body(sample, layout.counts, calling, scoring.F32)
    r = compare.compare(compare.render(got, calling["q_filter"]), want,
                        calling["q_filter"])
    limits = config["limits"]
    r["passes"] = (r["line_mismatches"] <= limits["line_mismatches"]
                   and r["sb_gap"] <= limits["sb_gap"])
    return r


def main(argv=None) -> int:
    from portbench.run import ROOT, load_cell
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    c = load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = control_numbers(c["config"], c["traffic"], seed, ROOT)
        r["seed"] = seed
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
