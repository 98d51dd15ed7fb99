"""The program's kernel launches a call: its ``_build`` launch counters,
summed over the window and divided by the calls."""


def read(run):
    if run.launches is None:
        return None
    return run.launches / run.calls
