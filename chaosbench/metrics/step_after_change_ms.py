"""step_after_change_ms (elastic runtime, ``elastic/trainer.py``): the
mean time of the first step after each change of membership in the
window, on the harness's timer."""


def read(run):
    xs = [s["s"] for s in run.steps if s["after_change"]]
    return 1e3 * sum(xs) / len(xs) if xs else None
