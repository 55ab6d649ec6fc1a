"""Driver: operator applications a solve (``num_operations()``), mean
over the traced run's requests."""


def read(run):
    return run.mean("operations")
