"""Carry state between numpy arrays and the port's tensors.

This system has no model weights: a build's whole state is its edge
records, its sequence and its Forest (``parent``, ``pst_weight``), each a
uint32 array.  On a device they live as int32 (a bit-exact view under the
package-wide contract that vids and positions are < 2^31; a root's
INVALID parent views as -1).  These helpers move a ``sheep_tpu`` run's
numpy arrays onto a device and back, so the tests feed both packages the
same input and compare their outputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.forest import Forest


def to_i32_tensor(a: np.ndarray, device) -> torch.Tensor:
    """uint32/int32 numpy array -> int32 tensor (a copy) on ``device``;
    uint32 is reinterpreted, not converted."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        a = a.astype(np.int32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device, copy=True)


def to_u32_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array (the inverse view)."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {t.dtype}")
    return np.ascontiguousarray(t.detach().cpu().numpy()).view(np.uint32)


def edges_to_device(tail: np.ndarray, head: np.ndarray, device):
    return to_i32_tensor(tail, device), to_i32_tensor(head, device)


def edges_from_device(tail: torch.Tensor, head: torch.Tensor):
    return to_u32_numpy(tail), to_u32_numpy(head)


def sequence_to_device(seq: np.ndarray, device) -> torch.Tensor:
    return to_i32_tensor(seq, device)


def sequence_from_device(seq: torch.Tensor) -> np.ndarray:
    return to_u32_numpy(seq)


def forest_to_device(forest, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Any object with uint32 ``parent`` and ``pst_weight`` arrays (the
    port's Forest or sheep_tpu's) -> (parent, pst) int32 tensors."""
    return (to_i32_tensor(np.asarray(forest.parent, np.uint32), device),
            to_i32_tensor(np.asarray(forest.pst_weight, np.uint32), device))


def forest_from_device(parent: torch.Tensor, pst: torch.Tensor) -> Forest:
    return Forest(to_u32_numpy(parent), to_u32_numpy(pst))
