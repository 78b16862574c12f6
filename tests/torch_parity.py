"""Shared helpers for the jatts_torch parity tests: numpy-made weights over
a flax variable tree, and loading them into a port module."""

from __future__ import annotations

import math

import numpy as np


def randomize(variables, seed: int):
    """Replace every leaf of a flax variable tree with numpy values drawn
    from ``seed``: kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1),
    biases ~ N(0, 0.1), BatchNorm means ~ N(0, 0.1), variances ~ U(0.5, 1.5),
    embeddings and other raw parameters ~ N(0, 0.5)."""
    rng = np.random.default_rng(seed)

    def leaf(name, x):
        shape = np.shape(x)
        if name == "kernel":
            return rng.normal(size=shape) / math.sqrt(max(1, int(np.prod(shape[:-1]))))
        if name == "scale":
            return 1.0 + 0.1 * rng.normal(size=shape)
        if name in ("bias", "mean"):
            return 0.1 * rng.normal(size=shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=shape)
        return 0.5 * rng.normal(size=shape)

    def walk(tree):
        return {
            k: walk(v) if isinstance(v, dict) else leaf(k, v).astype(np.float32)
            for k, v in tree.items()
        }

    return walk(_plain(variables))


def _plain(tree):
    """flax FrozenDict / jax arrays -> nested dict of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def state_dict_numpy(module):
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def assert_trees_equal(got, want, path=""):
    """Same keys and bitwise-equal leaves."""
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=f"{path}/{k}")
