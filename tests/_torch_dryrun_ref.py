"""Shared pieces of the dry-run tests: the reference's dry-run module, and
duck-typed production meshes (axis names and sizes) for both packages'
``spec_for``, as ``tests/test_launch.py`` does."""
from __future__ import annotations

import importlib
import os

import jax
import pytest
import torch


class SingleMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class MultiMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"single": SingleMesh(), "multi": MultiMesh()}


def reference_dryrun():
    """``repro.launch.dryrun``.  Importing it sets ``XLA_FLAGS`` to force
    512 host devices; the backend is started first (so the flag reaches no
    jax of this process) and the variable is put back (so it reaches no
    subprocess either)."""
    jax.devices()
    prev = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev


def dtype_name(dt) -> str:
    """A jnp/numpy or torch dtype's name: ``int32``, ``float32``, ``bool``."""
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    import numpy as np

    return np.dtype(dt).name


def leaves(tree, prefix=()):
    """(path, leaf) of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
