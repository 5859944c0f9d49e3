"""train_tokens_per_s (end to end, host clock): the tokens of every step
the window completed (the positions the loss covers: ``seq`` a row) over
the window's whole wall time, every stall in it."""


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    return sum(s["rows"] for s in run.steps) * run.cfg["seq"] / run.window_s
