"""JD host loop: Jacobi-Davidson iterations a solve
(``num_iterations()``), mean over the traced run's requests."""


def read(run):
    return run.mean("iterations")
