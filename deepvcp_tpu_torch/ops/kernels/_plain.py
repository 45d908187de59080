"""The one switch that sends every kernel wrapper to its plain version.

On a CPU tensor a wrapper always runs its plain PyTorch version. Within
`reference_path()` it does so on a CUDA tensor too, so that a whole path can
be run through the kernels and through the plain versions on the card and
the two compared. Nothing else sets it."""

from __future__ import annotations

import contextlib

_active = False


def active() -> bool:
    """Whether the wrappers run their plain versions on CUDA tensors now."""
    return _active


@contextlib.contextmanager
def reference_path():
    """Within this block every kernel wrapper (K1 banded_masked_max, K2
    banded_masked_max_grad, K3 farthest_point_sample, K4 onehot_gather, K5
    onehot_scatter_add, K6 knn_select and knn_select_bf16) runs its plain
    PyTorch version on CUDA tensors too."""
    global _active
    prev = _active
    _active = True
    try:
        yield
    finally:
        _active = prev
