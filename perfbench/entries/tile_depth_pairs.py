"""The per-frame sort of 3D Gaussian Splatting: ``sort(keys, values,
bit_count=BIT_COUNT)`` on u64 ``(tile << 32) | depth`` keys, each with a u32
payload that the program is not told is a rank; ``method`` the default
'auto', which takes the radix engine at the frame's size."""

SOURCES = ("radix", "scan")  # the csrc sources the path builds in set-up
BIT_COUNT = 44  # the configuration's bit_count: 32 + the tile grid's 12 bits


def call(program, inputs, env):
    keys, values = program.sort(inputs["keys"], inputs["values"], bit_count=BIT_COUNT)
    return {"keys": keys, "values": values}
