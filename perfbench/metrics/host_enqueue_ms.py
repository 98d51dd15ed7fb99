"""Mean ms from a call until it returned, before the synchronize: the host
work of the entry (argument checks, dtype routing, launches, and whatever
waits for the card inside the call)."""


def read(run):
    return sum(run.enqueue) / len(run.enqueue) * 1e3
