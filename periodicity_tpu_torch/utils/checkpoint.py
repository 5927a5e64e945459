"""Checkpoint / resume for long-running samplers.

Port of ``periodicity_tpu/utils/checkpoint.py``. The state is nested dicts,
lists and tuples of arrays and tensors; ``save_state`` flattens it with the
port's own walk (dict keys in sorted order), writes every leaf as a numpy
array into one ``.npz`` and records a structure string beside them;
``load_state`` refuses a file whose structure differs from ``like``'s.
The files are the port's own: the JAX package records its pytree
definition instead, so neither package reads the other's checkpoints.
"""

import numpy as np
import torch

__all__ = ["save_state", "load_state"]


def _npz_path(path):
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(state):
    """(leaves, structure string) of a nest of dicts, lists and tuples."""
    if isinstance(state, dict):
        keys = sorted(state)
        parts = [_flatten(state[k]) for k in keys]
        leaves = [leaf for p in parts for leaf in p[0]]
        inner = ",".join(f"{k}={p[1]}" for k, p in zip(keys, parts))
        return leaves, f"dict({inner})"
    if isinstance(state, (list, tuple)):
        parts = [_flatten(x) for x in state]
        leaves = [leaf for p in parts for leaf in p[0]]
        kind = "list" if isinstance(state, list) else "tuple"
        return leaves, f"{kind}({','.join(p[1] for p in parts)})"
    return [state], "*"


def _unflatten(like, leaves):
    """``like``'s nest with its leaves taken in order from ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_state(path, state):
    """Save a nest of arrays and tensors to an .npz file (the '.npz'
    extension is appended when missing, on save and on load alike)."""
    leaves, structure = _flatten(state)
    arrays = {f"leaf_{i}": _numpy(v) for i, v in enumerate(leaves)}
    arrays["__structure__"] = np.frombuffer(structure.encode(), dtype=np.uint8)
    np.savez(_npz_path(path), **arrays)


def load_state(path, like):
    """Load arrays saved by save_state into the structure of ``like`` (as
    numpy arrays). The saved structure must match ``like``'s: structures
    with the same leaf count but another nesting would otherwise swap arrays
    into the wrong slots."""
    with np.load(_npz_path(path)) as data:
        leaves, structure = _flatten(like)
        saved = bytes(data["__structure__"].tobytes()).decode()
        if saved != structure:
            raise ValueError(
                "checkpoint structure does not match `like`:\n"
                f"  saved: {saved}\n  like:  {structure}"
            )
        arrays = [data[f"leaf_{i}"] for i in range(len(leaves))]
    return _unflatten(like, iter(arrays))
