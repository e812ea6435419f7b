"""Checkpointing: a manifest plus one ``.npy`` per leaf, with an async writer
thread, in the JAX package's ``checkpoint/ckpt.py`` layout:

  <dir>/step_<N>/manifest.json     leaf names, dtypes, shapes
  <dir>/step_<N>/leaf_<i>.npy      one file per leaf
  <dir>/LATEST                     committed step marker (atomic rename)

The LATEST marker is written only after every leaf is on disk and the step
directory has been renamed into place, so a crash mid-save never corrupts
the restore point (restart reads LATEST).  Async mode copies every leaf to
host memory first, then returns while a thread writes; ``wait()`` joins it
and raises what the writer raised.

A tree is a tensor, an ``nn.Module`` (its named parameters), a dataclass
(such as ``TrainState``), a dict or a list, nested.  Leaves are named by
their path (``params/blocks.0.attn.wq``, ``opt/m/...``, ``opt/step``).
bfloat16 leaves go to disk as their raw uint16 bits with ``"bfloat16"`` in
the manifest (numpy has no bfloat16 without ``ml_dtypes``), so the files
read back bit for bit on any machine.  ``restore`` checks the leaf count,
names, shapes and dtypes against a template and places the leaves on the
device asked, so a checkpoint written on the card restores on the CPU and
back.  A template on the ``meta`` device costs no memory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        return [(prefix.rstrip("/"), tree)]
    if isinstance(tree, nn.Module):
        return [(prefix + n, p) for n, p in tree.named_parameters()]
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {prefix!r}")
    return [leaf for k, sub in items for leaf in _flatten(sub, f"{prefix}{k}/")]


def _unflatten(tree, leaves: dict, prefix: str = ""):
    """``tree`` with every leaf replaced from ``leaves`` (name -> tensor); a
    module's parameters are replaced in place, keeping ``requires_grad``."""
    if isinstance(tree, torch.Tensor):
        return leaves[prefix.rstrip("/")]
    if isinstance(tree, nn.Module):
        for name, old in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            setattr(tree.get_submodule(owner), leaf,
                    nn.Parameter(leaves[prefix + name], requires_grad=old.requires_grad))
        return tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), leaves, f"{prefix}{f.name}/")
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/") for k, v in tree.items()}
    return type(tree)(_unflatten(v, leaves, f"{prefix}{i}/") for i, v in enumerate(tree))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place updates of ``t`` cannot touch."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save(directory: str, step: int, tree, *, asynchronous: bool = False):
    """Snapshot ``tree`` at ``step``.  Returns a handle with ``.wait()``."""
    flat = _flatten(tree)
    # copy to the host before handing to the writer thread
    host = [(name, _dtype_name(t.dtype), _to_host(t)) for name, t in flat]

    def _write():
        d = os.path.join(directory, f"step_{step}")
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {
            "step": step,
            "treedef": [name for name, _, _ in host],
            "leaves": [
                {"file": f"leaf_{i}.npy", "name": name, "shape": list(x.shape), "dtype": dt}
                for i, (name, dt, x) in enumerate(host)
            ],
        }
        for i, (_, _, x) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), x)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        latest_tmp = os.path.join(directory, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.replace(latest_tmp, os.path.join(directory, "LATEST"))

    if asynchronous:
        handle = _Handle()
        handle.start(_write)
        return handle
    _write()
    return _Handle()


class _Handle:
    """A save in flight (or done): ``wait()`` joins the writer and re-raises
    its exception, if any."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def start(self, write) -> None:
        def run():
            try:
                write()
            except Exception as e:  # handed to wait(), which re-raises it
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error


def latest_step(directory: str) -> int | None:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore(directory: str, tree_like, step: int | None = None, device=None):
    """Restore into the structure of ``tree_like``; returns (tree, step).

    Leaf count, names, shapes and dtypes must equal the template's.  Leaves
    land on ``device``, by default each template leaf's own device (a
    template on ``meta`` needs ``device``).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(tree_like)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, tree needs {len(flat)}"
        )
    loaded = {}
    for i, ((name, ref), meta) in enumerate(zip(flat, manifest["leaves"])):
        if meta["name"] != name:
            raise ValueError(f"leaf {i}: checkpoint holds {meta['name']!r}, tree wants {name!r}")
        if meta["shape"] != list(ref.shape) or meta["dtype"] != _dtype_name(ref.dtype):
            raise ValueError(
                f"leaf {i} ({name}): {meta['dtype']} {meta['shape']} != expected "
                f"{_dtype_name(ref.dtype)} {list(ref.shape)}"
            )
        arr = np.load(os.path.join(d, meta["file"]))
        loaded[name] = _from_host(arr, meta["dtype"], device if device is not None else ref.device)
    return _unflatten(tree_like, loaded), step
