"""The program's own spans (``repro_torch.spans``), as the metrics that
read them see them.

In a traced run the program records a span at each close of its step's,
scale-out's and push's phases (a profiler records, so its spans are on).
``CALLS`` keeps every record of the window, through the program's
``repro_torch.spans:emit``; a metric that reads them declares ``RANGES =
spans.NAMES``, so that the trace reader leaves the device-side markers of
the program's ranges out of the device's work and times the kernels
launched inside each range. Against a program without ``repro_torch.spans``
there are no records and no names, and those metrics report nothing.
"""
try:
    from repro_torch import spans
except ImportError:
    spans = None

#: the call record that keeps the program's span records
CALL = "program_spans"
CALLS = {CALL: ("repro_torch.spans:emit", lambda record: record)} if spans else {}
STEP = "repro_torch.step"


def records(run, name: str) -> list:
    """The window's records of the span ``name``."""
    return [r for r in run.calls.get(CALL, ()) if r.name == name]


def per_step_ms(run, name: str):
    """Host milliseconds inside the span ``name``, summed over the window,
    per ``repro_torch.step`` span of the window."""
    steps = len(records(run, STEP))
    if not steps:
        return None
    return sum(r.end_ns - r.start_ns for r in records(run, name)) / 1e6 / steps


def mean_counter(run, name: str, key: str):
    """The mean of counter ``key`` over the window's spans ``name``."""
    xs = [r.counters.get(key, 0) for r in records(run, name)]
    return sum(xs) / len(xs) if xs else None
