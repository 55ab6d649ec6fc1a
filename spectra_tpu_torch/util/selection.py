"""Eigenvalue selection rules and sorting.

Port of :mod:`spectra_tpu.util.selection` (reference:
include/Spectra/Util/SelectionRule.h:33-296). Sort keys are built so
that an ascending *stable* sort puts the wanted eigenvalues first;
``BothEnds`` sorts by largest-algebraic and then interleaves
Largest => Smallest => 2nd largest => 2nd smallest => ...
"""

import enum

import numpy as np
import torch


class SortRule(enum.Enum):
    """Selection rule for desired eigenvalues."""

    LargestMagn = 0
    LargestReal = 1
    LargestImag = 2
    LargestAlge = 3
    SmallestMagn = 4
    SmallestReal = 5
    SmallestImag = 6
    SmallestAlge = 7
    BothEnds = 8


def sort_target(selection: SortRule, values: torch.Tensor) -> torch.Tensor:
    """Ascending-sort key for ``values`` under ``selection``: smaller key
    == more wanted (reference: Util/SelectionRule.h:68-185)."""
    v = values
    if selection == SortRule.LargestMagn:
        return -v.abs()
    if selection == SortRule.SmallestMagn:
        return v.abs()
    if selection == SortRule.LargestReal:
        return -v.real
    if selection == SortRule.SmallestReal:
        return v.real
    if selection in (SortRule.LargestImag, SortRule.SmallestImag):
        if not v.is_complex():
            raise ValueError(f"{selection.name} requires complex eigenvalues")
        key = v.imag.abs()
        return -key if selection == SortRule.LargestImag else key
    if selection in (SortRule.LargestAlge, SortRule.BothEnds):
        if v.is_complex():
            raise ValueError("algebraic sort rules require real eigenvalues")
        return -v
    if selection == SortRule.SmallestAlge:
        if v.is_complex():
            raise ValueError("algebraic sort rules require real eigenvalues")
        return v
    raise ValueError(f"unsupported selection rule {selection}")


def both_ends_permutation(length: int) -> np.ndarray:
    """Interleave permutation for ``BothEnds`` on top of a
    largest-algebraic order: even output slots take from the left
    (large values), odd slots from the right (small ones)
    (reference: Util/SelectionRule.h:262-285)."""
    i = np.arange(length)
    return np.where(i % 2 == 0, i // 2, length - 1 - i // 2)


def argsort(selection: SortRule, values: torch.Tensor) -> torch.Tensor:
    """Indices sorting ``values`` so the wanted eigenvalues come first
    (reference: Util/SelectionRule.h:227-288)."""
    ind = torch.argsort(sort_target(selection, values), stable=True)
    if selection == SortRule.BothEnds:
        perm = torch.from_numpy(both_ends_permutation(ind.shape[0]))
        ind = ind[perm.to(ind.device)]
    return ind


def argsort_np(selection: SortRule, values) -> np.ndarray:
    """Numpy twin of :func:`argsort` for host-side result arrays."""
    return argsort(selection, torch.from_numpy(np.asarray(values))).numpy()


def sort_key_np(selection: SortRule, values) -> np.ndarray:
    """Numpy twin of :func:`sort_target`: the scalar ascending-sort key,
    smaller == more wanted (reference: Util/SelectionRule.h:68-185); the
    frontier test of ``compute_locked`` ranks by it."""
    return sort_target(selection, torch.from_numpy(np.asarray(values))).numpy()
