"""Checkpoint / resume of sampler state (counterpart of
``pynngp_tpu.utils.checkpoint``).

A state is a tree of tensors: NamedTuples (``ResponseState``,
``LatentState``, ``NUTSState`` and ``HMCState`` with their nested
adaptation tuples), tuples, lists and dicts, whose leaves are tensors (a
``torch.Generator``'s state is one: a uint8 tensor).  :func:`save_state`
writes the leaves, in order, to ``<path>.npz`` and a JSON descriptor (leaf
shapes and dtypes, the caller's ``extra`` fields and an optional run
config) to ``<path>.json``; :func:`load_state` reads them back into the
structure of a template state.  Each file is written under a temporary name
and moved into place, so that a run stopped while writing leaves the last
complete file.

Several processes (``torch.distributed``) each hold their own chains:
``process_index=k`` reads and writes ``<path>.p<k>.npz`` / ``.json``
instead, as the reference's per-process files (its ``_proc_path``).

Refusals, each a ``ValueError``, as the reference's: a leaf count or a leaf
shape that differs from the template's, and a config that differs from the
one stored beside the checkpoint (naming the keys that differ).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_state", "load_state", "config_dict", "write_atomic", "meta_path",
           "npz_path", "proc_path"]


def proc_path(path: str, process_index=None) -> str:
    """``path``, or ``<path>.p<process_index>`` for one process of several."""
    if process_index is None:
        return path
    base = path[:-4] if path.endswith(".npz") else path
    return f"{base}.p{int(process_index)}"


def npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".json"


def write_atomic(path: str, write) -> None:
    """Call ``write(file)`` on a temporary file beside ``path``, then move it
    into place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        write(fh)
    os.replace(tmp, path)


def _leaves(tree) -> list:
    """The tensors of a state, depth first: tuple fields in order, dict
    entries by sorted key."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in _leaves(child)]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    raise TypeError(f"a state leaf must be a tensor, got {type(tree).__name__}")


def _structure(tree) -> str:
    """A readable description of a state's structure, for the descriptor."""
    if isinstance(tree, torch.Tensor):
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    inner = ", ".join(_structure(child) for child in tree)
    return f"{type(tree).__name__}({inner})"


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from the iterator
    ``leaves``."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if isinstance(like, dict):
        return {key: _rebuild(like[key], leaves) for key in sorted(like)}
    children = [_rebuild(child, leaves) for child in like]
    if hasattr(like, "_fields"):  # a NamedTuple
        return type(like)(*children)
    return type(like)(children)


def config_dict(config) -> Optional[dict]:
    """A run config (an NNGPConfig or a mapping) as a plain dict, or None."""
    if config is None:
        return None
    if dataclasses.is_dataclass(config):
        return dataclasses.asdict(config)
    return dict(config)


def save_state(path: str, state: Any, extra: dict = None, config=None,
               process_index=None) -> None:
    """Persist a state to ``<path>.npz`` (its leaves as ``leaf_<i>``) and
    ``<path>.json`` (the descriptor, with ``extra`` and ``config``, an
    NNGPConfig or a plain dict, when given); with ``process_index`` k, to
    ``<path>.p<k>.npz`` and ``<path>.p<k>.json``."""
    path = proc_path(path, process_index)
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(_leaves(state))}
    write_atomic(npz_path(path), lambda fh: np.savez(fh, **arrays))
    meta = {
        "n_leaves": len(arrays),
        "treedef": _structure(state),
        "leaves": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                   for a in arrays.values()],
    }
    if extra:
        meta["extra"] = extra
    cfg = config_dict(config)
    if cfg is not None:
        meta["config"] = cfg
    write_atomic(meta_path(path), lambda fh: fh.write(json.dumps(meta).encode()))


def load_state(path: str, like: Any, config=None, process_index=None):
    """Load a checkpoint into the structure of ``like`` (a state template,
    e.g. a freshly initialised state): each leaf comes back on its template
    leaf's device and in its dtype.  ``process_index`` reads that process's
    ``<path>.p<k>`` files.

    Raises ValueError when the stored leaves do not match the template
    (count, shape) or when ``config`` differs from the config recorded at
    save time."""
    path = proc_path(path, process_index)
    leaves_like = _leaves(like)
    with np.load(npz_path(path)) as npz:
        stored = [npz[f"leaf_{i}"] for i in range(len(npz.files))]
    if len(stored) != len(leaves_like):
        raise ValueError(
            f"checkpoint has {len(stored)} leaves, template has {len(leaves_like)}: "
            "was this checkpoint written by a different model/sampler config?")
    for i, (arr, leaf) in enumerate(zip(stored, leaves_like)):
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint leaf {i} has shape {tuple(arr.shape)}, template "
                f"expects {tuple(leaf.shape)}: refusing to reinterpret")
    want_cfg = config_dict(config)
    if want_cfg is not None:
        with open(meta_path(path)) as fh:
            have_cfg = json.load(fh).get("config")
        if have_cfg is not None and have_cfg != want_cfg:
            diff = {k: (have_cfg.get(k), want_cfg.get(k))
                    for k in sorted(set(have_cfg) | set(want_cfg))
                    if have_cfg.get(k) != want_cfg.get(k)}
            raise ValueError(f"checkpoint config does not match the resuming run: {diff}")
    restored = [torch.from_numpy(arr).to(dtype=leaf.dtype, device=leaf.device)
                for arr, leaf in zip(stored, leaves_like)]
    return _rebuild(like, iter(restored))
