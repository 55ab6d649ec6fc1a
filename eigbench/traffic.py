"""The one traffic generator: a traffic file's parameters make a cell's
operators once and each of its requests.

A traffic file (``traffic/<name>.json``) names the calls of
``spectra_tpu_torch`` that a user makes, as data:

* ``operators``: named operators, built in order, each a call
  ``{"call": "<dotted name in spectra_tpu_torch>", "args": [...],
  "kwargs": {...}, "then": [[method, [args], {kwargs}], ...]}``; a
  ``then`` call that returns an object replaces the operator by it (as
  ``set_shift`` does);
* ``solver``: the same form, built in each request on the operators
  (its setters, such as ``set_restart_chunk``, return nothing);
* ``compute``: the keywords of ``compute``;
* ``start``: ``"seeded"`` (each request starts from its own vector,
  drawn from the run's seed and its index) or ``"solver"`` (the
  solver's own start, the same in every request);
* ``wanted``: ``nev``, ``which`` (``"largest"``, ``"smallest"``,
  ``"nearest"``) and ``sigma``, for the reference.

An argument is a JSON value, or a reference: ``"$A"``, ``"$B"`` (the
configuration's operands), ``"$device"``, ``"$<operator name>"``,
``"$max_diagonal"`` (of A), ``"$stt.<dotted name>"`` (an attribute of
``spectra_tpu_torch``, such as ``"$stt.SortRule.LargestAlge"``), or
``{"$mul": [a, b, ...]}``, a product of numbers.

A request builds the solver, starts it, computes, and reads the
eigenvalues and eigenvectors to the host, as a user does with them.
"""

import contextlib
import dataclasses
import functools
import operator
import time

import numpy as np
import torch

import spectra_tpu_torch as stt
from spectra_tpu_torch.ops import dia_spmv
from spectra_tpu_torch.sparse.formats import DiaMatrix

#: The start vector of the warm-up request: a key no run's window uses
#: (window keys are (seed, index) with index < 2**40), the same in
#: every run, so that set-up does the same work whatever the seed.
WARMUP_KEY = (0, 2 ** 40)


def no_span(name):
    return contextlib.nullcontext()


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def start_vector(key, n, dtype, device):
    """Uniform(-0.5, 0.5) of length n, drawn on ``device`` from
    ``key`` = (seed, index); any whole seed."""
    seed, index = key
    state = np.random.SeedSequence([seed % 2 ** 64, index]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return torch.rand(n, dtype=dtype, device=device, generator=gen) - 0.5


def to_host(x):
    """A result as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def resolve(value, names):
    """``value`` with its references looked up in ``names`` (see the
    module's docstring)."""
    if isinstance(value, list):
        return [resolve(v, names) for v in value]
    if isinstance(value, dict):
        if list(value) == ["$mul"]:
            return functools.reduce(operator.mul, resolve(value["$mul"], names))
        return {k: resolve(v, names) for k, v in value.items()}
    if isinstance(value, str) and value.startswith("$"):
        ref = value[1:]
        if ref.startswith("stt."):
            return functools.reduce(getattr, ref.split(".")[1:], stt)
        if ref not in names:
            raise KeyError(f"unknown reference {value!r}")
        return names[ref]
    return value


def call(spec, names):
    """Make the call ``spec`` and its ``then`` calls; a ``then`` call's
    result, if any, takes the object's place."""
    fn = functools.reduce(getattr, spec["call"].split("."), stt)
    obj = fn(*resolve(spec.get("args", []), names),
             **resolve(spec.get("kwargs", {}), names))
    for step in spec.get("then", []):
        method, *rest = step
        args, kwargs = (rest + [[], {}][len(rest):])[:2]
        out = getattr(obj, method)(*resolve(args, names), **resolve(kwargs, names))
        if out is not None:
            obj = out
    return obj


class CountingOp:
    """An operator handed to the solver, counting its products by
    columns and marking each with the span ``op.apply``. Used in traced
    runs around each operator over a DIA matrix, whose every product is
    one K1 launch."""

    def __init__(self, op, span, dia):
        self._op = op
        self._span = span
        self.dia = dia  # (d, n_rows, n_cols, item)
        self.calls = {}

    def __getattr__(self, name):
        return getattr(self._op, name)

    def perform_op(self, x):
        ncol = 1 if x.ndim == 1 else x.shape[1]
        self.calls[ncol] = self.calls.get(ncol, 0) + 1
        with self._span("op.apply"):
            return self._op.perform_op(x)


def dia_shape(op):
    """(d, n_rows, n_cols, item) of an operator over a DIA matrix."""
    m = getattr(op, "ell", None)
    if not isinstance(m, DiaMatrix):
        return None
    return (len(m.offsets), m.n_rows, m.n_cols, m.data.element_size())


@dataclasses.dataclass
class Served:
    """A cell's operators, built once, and what a request needs."""

    names: dict  # the references a solver call may use
    counting: list  # CountingOp, in traced runs
    n: int
    dtype: torch.dtype
    device: str


@dataclasses.dataclass
class Answer:
    """One request's outputs, on the host, and counts."""

    values: np.ndarray
    vectors: np.ndarray
    nconv: int
    successful: bool
    iterations: int
    operations: int
    k1_launches: int  # the program's counter over the request
    calls: list  # [(dia shape, {ncol: products})] of each counted operator
    wall_s: float


def build(mix, operands, device, span=None):
    """The cell's operators on ``device`` from the configuration's host
    ``operands`` ({"A": ..., "B": ...}); with ``span`` (a traced run)
    each operator over a DIA matrix is wrapped in :class:`CountingOp`."""
    A = operands["A"]
    names = dict(operands, device=device)
    names["max_diagonal"] = float(A.diagonal().max())
    built = {}
    for name, spec in mix["operators"].items():
        built[name] = names[name] = call(spec, names)
    counting = []
    if span is not None:
        for name, op in built.items():
            shape = dia_shape(op)
            if shape is not None:
                names[name] = CountingOp(op, span, shape)
                counting.append(names[name])
    first = next(iter(built.values()))
    return Served(names=names, counting=counting, n=A.shape[0],
                  dtype=first.dtype, device=device)


def request(mix, served, key, span=no_span):
    """One solve from ``key`` (or the solver's own start)."""
    launches0 = dia_spmv.LAUNCHES
    calls0 = [dict(c.calls) for c in served.counting]
    t0 = time.perf_counter()
    with span("request"):
        with span("solver.init"):
            solver = call(mix["solver"], served.names)
            if mix["start"] == "seeded":
                solver.init(start_vector(key, served.n, served.dtype, served.device))
            elif mix["start"] != "solver":
                raise ValueError(f"unknown start {mix['start']!r}")
        with span("solver.compute"):
            nconv = solver.compute(**resolve(mix["compute"], served.names))
        values = to_host(solver.eigenvalues())
        vectors = to_host(solver.eigenvectors())
        synchronize(served.device)
    wall = time.perf_counter() - t0
    calls = [(c.dia, {k: v - c0.get(k, 0) for k, v in c.calls.items()
                      if v > c0.get(k, 0)})
             for c, c0 in zip(served.counting, calls0)]
    return Answer(
        values=values, vectors=vectors, nconv=int(nconv),
        successful=solver.info() == stt.CompInfo.Successful,
        iterations=solver.num_iterations(), operations=solver.num_operations(),
        k1_launches=dia_spmv.LAUNCHES - launches0, calls=calls, wall_s=wall,
    )
