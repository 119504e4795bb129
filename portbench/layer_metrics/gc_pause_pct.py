"""Interpreter: the seconds the interpreter's collections paused the
process (the program's counter `gc_pause_s`, from gc.callbacks) over the
window's wall time, in percent."""


def read(run):
    s = run["counters"].get("gc_pause_s")
    if s is None or run["window_s"] <= 0:
        return None
    return 100.0 * s / run["window_s"]
