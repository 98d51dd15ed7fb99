"""A keys-only segmented sort: ``sort_segments(keys, offsets)``."""

SOURCES = ("bitonic", "scan")


def call(program, inputs, env):
    return {"keys": program.sort_segments(inputs["keys"], inputs["offsets"])}
