"""Checkpointing: atomic, async, keep-last-k, restart-exact.

Counterpart of ``repro.runtime.checkpoint``, with its on-disk layout, so a
checkpoint written by either package restores in the other:
``<dir>/step_<N>/arrays.npz`` + ``meta.json``, written to a tmp dir and
``os.replace``'d (atomic on POSIX), so a crash mid-write can never corrupt
the latest checkpoint.  A leaf's key is its dict keys and list indices
joined by ``/`` (stored as ``__SLASH__``); npz has no bfloat16, so a bf16
leaf is stored bit-exact as its uint16 view under the key suffix
``__BF16__``.  ``save(..., blocking=False)`` hands the host-side write to a
background thread (the tensors are first copied to the host
synchronously, which is the only device-blocking part).

State is nested dicts, lists and tuples (named tuples kept) of tensors,
numpy arrays and scalars, and modules, stored as their
``named_parameters()``; ``restore`` fills the structure of ``like`` (tensor
leaves come back as tensors of their dtype on their device, a meta tensor's
on the host; array leaves as arrays; a module's parameters are written in
place and the module itself comes back; a DTensor leaf is stored whole,
gathered by every rank and written by the first, and restored as this
rank's block in the layout of ``like``'s).  So a training state
(``train.TrainState``: the model, its moments, its residuals) saves and
restores whole; such a file restores in the reference only where its keys
and structure match the reference's tree, which a module's parameter names
do not.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.sharding import local_block, distribute_whole
from repro_torch.runtime._tree import tree_leaves_with_keys, tree_map_with_keys

__all__ = ["CheckpointManager"]


_BF16_SUFFIX = "__BF16__"
_STEP_DIR = re.compile(r"^step_(\d+)$")


def _host_array(leaf: Any) -> tuple[np.ndarray, bool]:
    """(the leaf on the host as a numpy array, whether it is bf16 — then
    as its uint16 view); a DTensor whole (a collective)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.asarray(leaf), False


def _flatten(tree: Any) -> tuple[dict[str, np.ndarray], bool]:
    """(the leaves on the host by key, whether any was a DTensor)."""
    flat, shared = {}, False
    for key, leaf in tree_leaves_with_keys(tree):
        shared = shared or isinstance(leaf, DTensor)
        arr, bf16 = _host_array(leaf)
        flat[key + _BF16_SUFFIX if bf16 else key] = arr
    return flat, shared


def _restored(arr: np.ndarray, bf16: bool, like: Any) -> Any:
    """A stored array in the form of ``like``'s leaf; a module's parameter
    is written in place and given back.  A DTensor leaf gets this rank's
    block of the whole stored tensor, laid out as ``like``."""
    if isinstance(like, torch.Tensor):
        t = (torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
             .view(torch.bfloat16) if bf16 else torch.from_numpy(arr.copy()))
        if isinstance(like, DTensor):
            t = t.to(dtype=like.dtype, device=like.device)
            if isinstance(like, torch.nn.Parameter):
                with torch.no_grad():
                    like.to_local().copy_(
                        local_block(t, like.device_mesh, like.placements))
                return like
            return distribute_whole(t, like.device_mesh, like.placements)
        if isinstance(like, torch.nn.Parameter):
            with torch.no_grad():
                like.copy_(t)
            return like
        device = torch.device("cpu") if like.device.type == "meta" else like.device
        return t.to(dtype=like.dtype, device=device)
    if bf16:
        arr = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16).float().numpy()
    return arr.astype(like.dtype) if hasattr(like, "dtype") else arr


def _unflatten_into(tree: Any, flat: dict[str, np.ndarray]) -> Any:
    lookup = {}
    for k, v in flat.items():
        if k.endswith(_BF16_SUFFIX):
            lookup[k[: -len(_BF16_SUFFIX)]] = (v, True)
        else:
            lookup[k] = (v, False)
    return tree_map_with_keys(lambda key, leaf: _restored(*lookup[key], leaf),
                              tree)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._barrier = False     # a mesh save whose barrier is still owed

    # -- write --

    def save(self, step: int, state: Any, extra: dict | None = None,
             blocking: bool = True) -> None:
        """Write ``state`` as checkpoint ``step``.  A state that holds
        DTensors is saved by every rank of its world alike: each gathers
        the whole tensors here, on the calling thread (a collective in the
        writer thread could deadlock against the caller's), the first rank
        alone writes, and a barrier follows the write (in ``wait`` for a
        background one)."""
        flat, shared = _flatten(state)   # device->host copy happens here
        meta = {"step": step, "extra": extra or {}}
        writes = not shared or dist.get_rank() == 0
        if blocking:
            if writes:
                self._write(step, flat, meta)
            if shared:
                dist.barrier()
        else:
            self.wait()                  # at most one in-flight write
            if writes:
                self._thread = threading.Thread(
                    target=self._write_guarded, args=(step, flat, meta),
                    daemon=True)
                self._thread.start()
            self._barrier = shared

    def wait(self) -> None:
        """Join any in-flight background write; re-raise its failure.

        The error of a background write that died (disk full,
        permissions) is captured in the thread wrapper and re-raised here
        (and by the next ``save(blocking=False)``, which waits first), so
        a lost checkpoint is loud exactly once.  After a save of DTensors
        every rank meets at a barrier here, so that none reads the
        directory before the write is done."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_guarded(self, step: int, flat, meta) -> None:
        try:
            self._write(step, flat, meta)
        except BaseException as err:  # surfaced by wait()/next save
            self._error = err

    def _write(self, step: int, flat, meta) -> None:
        final = os.path.join(self.dir, f"step_{step:012d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as fh:
            np.savez(fh, **{k.replace("/", "__SLASH__"): v for k, v in flat.items()})
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:012d}"),
                          ignore_errors=True)

    # -- read --

    def steps(self) -> list[int]:
        """Sorted step numbers present in the directory.  Only exact
        ``step_<digits>`` entries count — stray names (a user's
        ``step_backup``, an editor's ``step_5~``, in-flight ``.tmp``
        dirs) are skipped instead of crashing the listing."""
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_DIR.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like: Any) -> tuple[Any, dict]:
        """Restore into the structure of ``like``; returns (state, extra)."""
        path = os.path.join(self.dir, f"step_{step:012d}")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = {k.replace("__SLASH__", "/"): data[k] for k in data.files}
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        return _unflatten_into(like, flat), meta["extra"]
