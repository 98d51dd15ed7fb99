"""GiB the program needed beyond what the harness held when the window
opened (its input pool and kept answers): ``max_memory_allocated`` over the
window less ``memory_allocated`` at its start, on the fullest card."""
COMBINE = "max"


def read(run):
    if run.mem_peak is None:
        return None
    return (run.mem_peak - run.mem_base) / 2**30
