"""score_tuples kernel: its least time on one H100 at the published peaks
(portbench/roofline.py: the operations and bytes of the unique reference
tuples the plain reference finds, each series to its exact exit) over its
device time in the profiler's trace, in percent. Each sample launches the
kernel once a chromosome, on that chromosome's tuples."""

from portbench import roofline

KERNEL = "score_tuples_kernel"


def read(run):
    view = run["device"]
    work = run["reference"]["tuples"]
    if view is None or not work:
        return None
    secs = sum(s for n, s in view["op_seconds"].items() if KERNEL in n)
    traced = sum(c for n, c in view["op_counts"].items() if KERNEL in n)
    if traced == 0 or secs <= 0:
        return None
    least = sum(roofline.bound_s(w["ops"], w["bytes"]) for w in work)
    # mean least time a launch over mean device time a launch
    return 100.0 * (least / len(work)) / (secs / traced)
