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
(such as ``TrainState``), a dict or a list, nested.  A state placed over a
device mesh (``distributed/sharding.py`` ``place``) saves each leaf whole,
gathered, under the names and in the format of the unplaced state, so a
checkpoint does not know the mesh it was written under: restore it into an
unplaced template and ``place`` the result on any mesh, bit for bit.  Leaves are named by
their path (``params/blocks.0.attn.wq``, ``opt/m/...``, ``opt/step``).
bfloat16 leaves go to disk as their raw uint16 bits with ``"bfloat16"`` in
the manifest (numpy has no bfloat16 without ``ml_dtypes``), so the files
read back bit for bit on any machine.  ``restore`` checks the leaf count,
names, shapes and dtypes against a template and places the leaves on the
device asked, so a checkpoint written on the card restores on the CPU and
back.  A template on the ``meta`` device costs no memory.

``restore`` also reads a checkpoint that the JAX package wrote.  Its
manifest names no leaf: the leaves are a JAX tree flattening of the saved
tree, dict keys in sorted order, list entries in index order, and each
period leaf stacked ``[repeats, ...]``.  For a template that is a
``CausalLM`` or a ``TrainState`` (``params`` and ``opt`` with ``m``,
``step``, ``v``), :func:`_jax_layout` rebuilds that order from the model's
config, and ``lm.named_leaves`` unstacks the period leaves into the port's
names.  bfloat16 leaves (``ml_dtypes``) come back from ``np.load`` as a
2-byte void type and are read as their uint16 bits.  A manifest that does
not fit the template (leaf count, shape or dtype) raises ``ValueError``.
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

from repro_torch.distributed.sharding import PlacedModel, Sharded, gather
from repro_torch.models.lm import CausalLM, named_leaves


def _flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    if isinstance(tree, (torch.Tensor, Sharded)):
        return [(prefix.rstrip("/"), tree)]
    if isinstance(tree, (nn.Module, PlacedModel)):
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


def _to_host(t) -> np.ndarray:
    """A host copy that later in-place updates of ``t`` cannot touch (a
    sharded value gathered whole)."""
    t = gather(t, "cpu") if isinstance(t, Sharded) else t.detach().to("cpu", copy=True)
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
    if manifest["leaves"] and "name" not in manifest["leaves"][0]:
        return _restore_jax(d, manifest, tree_like, device), step
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



# -- checkpoints the JAX package wrote --------------------------------------------


def _jax_param_paths(model: nn.Module) -> list[tuple[tuple, list[int], str]]:
    """(key path, shape, the port's name of its first layer) of every leaf
    of the JAX package's ``init_params`` tree for ``model``'s config, in
    JAX's flattening order.  The port's ``blocks.<i>.<rest>`` is entry
    ``i % period`` of the period list, stacked over the repeats, or past the
    periods an entry of the tail."""
    cfg = model.cfg
    per = len(cfg.layer_pattern)
    n_period = cfg.repeats * per
    leaves = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "blocks":
            leaves[(name,)] = (list(p.shape), name)
            continue
        i, rest = int(parts[1]), tuple(parts[2:])
        if i >= n_period:
            leaves[("tail", i - n_period) + rest] = (list(p.shape), name)
        elif i < per:  # the first repeat names the stacked leaf
            leaves[("period", i) + rest] = ([cfg.repeats, *p.shape], name)
    # dict keys sort as strings, list entries by index; a list index is only
    # ever compared with another list index
    return [(path, shape, name) for path, (shape, name) in sorted(leaves.items())]


def _nest(leaves: dict[tuple, np.ndarray]) -> dict:
    """The nested tree of ``{key path: array}``, ``period`` and ``tail`` as
    lists, the shape ``lm.named_leaves`` reads."""
    tree: dict = {}
    for path, arr in leaves.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    for key in ("period", "tail"):
        if key in tree:
            tree[key] = [tree[key][i] for i in sorted(tree[key])]
    return tree


def _restore_jax(d: str, manifest: dict, tree_like, device):
    """``tree_like`` (a ``CausalLM`` or a ``TrainState``) filled from the
    JAX package's checkpoint in ``d``."""
    state = dataclasses.is_dataclass(tree_like)
    model = tree_like.params if state else tree_like
    if not isinstance(model, CausalLM):
        raise ValueError("a checkpoint without leaf names restores only into a CausalLM or a "
                         "TrainState template")
    params = _jax_param_paths(model)
    dtypes = dict(model.named_parameters())
    # TrainState(params, opt) flattens params, then opt's keys sorted: m, step, v
    layout = [("params", path, shape, dtypes[name].dtype) for path, shape, name in params]
    if state:
        opt = tree_like.opt
        m, v = ([("opt/" + k, path, shape, opt[k][name].dtype) for path, shape, name in params]
                for k in ("m", "v"))
        layout += m + [("opt/step", (), [], opt["step"].dtype)] + v
    metas = manifest["leaves"]
    if len(metas) != len(layout):
        raise ValueError(f"the JAX checkpoint has {len(metas)} leaves; the template's JAX tree "
                         f"has {len(layout)}")
    parts: dict[str, dict] = {}
    for i, ((part, path, shape, dtype), meta) in enumerate(zip(layout, metas)):
        what = f"leaf {i} ({part} {'/'.join(map(str, path))})"
        if meta["shape"] != shape or meta["dtype"] != _dtype_name(dtype):
            raise ValueError(f"{what}: {meta['dtype']} {meta['shape']} != expected "
                             f"{_dtype_name(dtype)} {shape}")
        arr = np.load(os.path.join(d, meta["file"]))
        if arr.dtype.kind == "V" and dtype == torch.bfloat16:
            arr = arr.view(np.uint16)  # ml_dtypes' bfloat16, read without ml_dtypes
        if list(arr.shape) != shape:
            raise ValueError(f"{what}: the file holds {list(arr.shape)}")
        parts.setdefault(part, {})[path] = arr
    arrays = {}
    for part, leaves in parts.items():
        if part == "opt/step":
            arrays[part] = leaves[()]
            continue
        prefix = "" if not state else "params/" if part == "params" else part + "/"
        for name, arr in named_leaves(_nest(leaves), model.cfg).items():
            arrays[prefix + name] = arr
    loaded = {}
    for name, ref in _flatten(tree_like):
        loaded[name] = _from_host(arrays[name], _dtype_name(ref.dtype),
                                  device if device is not None else ref.device)
    return _unflatten(tree_like, loaded)
