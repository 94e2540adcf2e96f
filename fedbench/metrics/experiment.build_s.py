"""The program's build: ExperimentSpec.build of every simulator the cell
runs (plan, data, partition, population, dataset upload), timed by the
harness's own span around it."""


def read(ctx):
    return ctx["build_s"]
