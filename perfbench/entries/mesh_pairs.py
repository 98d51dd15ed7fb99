"""One rank's part of a distributed key + value sort over a ``DeviceMesh``:
``sort(keys, values, mesh=mesh)``, each rank passing its shard and getting
its shard of the sorted global array; ``method='auto'``."""

SOURCES = ("bitonic",)


def call(program, inputs, env):
    keys, values = program.sort(inputs["keys"], inputs["values"], mesh=env.mesh)
    return {"keys": keys, "values": values}
