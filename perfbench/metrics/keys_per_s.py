"""Keys sorted a second, in billions: every key of every call completed in
the window over the whole window (a mesh call counts its global keys)."""
COMBINE = "min"


def read(run):
    return run.keys_per_call * run.calls / run.window_s / 1e9
