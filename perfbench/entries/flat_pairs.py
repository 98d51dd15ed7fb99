"""A flat key + value sort: ``sort(keys, values, values_are_ranks=True)``,
the payload being each key's index (``bench.py``'s headline call)."""

SOURCES = ("bitonic",)  # the csrc sources the path builds in set-up


def call(program, inputs, env):
    keys, values = program.sort(inputs["keys"], inputs["values"], values_are_ranks=True)
    return {"keys": keys, "values": values}
