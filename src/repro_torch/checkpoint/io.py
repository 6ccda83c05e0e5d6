"""Server-state checkpointing (numpy archive + json tree structure).

The server owns the only durable state in federated learning (w, momentum,
round counter) — clients are stateless between rounds — so checkpointing
``ServerState`` is the complete story.  The format is the JAX package's:
one ``.npz`` with ``leaf_<i>`` arrays and a json ``manifest`` holding the
leaves' path strings (``.w/['b1']`` ... ``.extra/['v']/['fc2']``, ``.t``)
in ``jax.tree_util`` order, so either package restores the other's
checkpoints.  Writes are atomic via tmp+rename; ``AsyncCheckpointWriter``
moves the device-to-host copy and the write onto a background thread.
"""
from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
import zipfile
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.server_opt import ServerState
from repro_torch.tree import flatten_with_paths, tree_map, unflatten_like


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)     # the round counter
    return np.asarray(leaf)


def save_state(path: str, state: ServerState, meta: dict | None = None):
    paths, leaves = flatten_with_paths(state)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    manifest = {"paths": paths, "meta": meta or {}, "n": len(leaves)}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    os.close(fd)
    try:
        np.savez(tmp, manifest=json.dumps(manifest), **payload)
        os.replace(tmp + ".npz", path)
    finally:
        # np.savez writes to tmp + ".npz"; a failure inside it would
        # otherwise strand that partial file next to the mkstemp placeholder
        for p in (tmp, tmp + ".npz"):
            if os.path.exists(p):
                os.remove(p)


def _snapshot(state: ServerState) -> ServerState:
    """A copy the next round cannot mutate (tensors cloned on their own
    device, the counter copied by value)."""
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, state)


class AsyncCheckpointWriter:
    """Checkpointing off the critical path.

    ``submit`` clones the state on its device (ordered on the stream before
    any later update) and hands the clone to a background thread, which
    makes the device-to-host copy and the atomic npz write.  The queue is
    bounded (``max_pending`` in-flight snapshots): if storage falls behind,
    ``submit`` blocks.  ``close()`` joins the thread and flushes every
    pending write; writer-thread failures re-raise on the next ``submit`` or
    on ``close`` (``raise_failure=False`` when closing on an
    already-propagating exception, so a stale write error never masks it).
    """

    def __init__(self, max_pending: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(max_pending, 1))
        self._failure: list = []
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            path, state, meta = item
            try:
                save_state(path, state, meta)   # d2h copy happens here
            except BaseException as exc:
                self._failure.append(exc)

    def submit(self, path: str, state: ServerState,
               meta: dict | None = None, copy: bool = True):
        """``copy=False`` skips the snapshot when the caller already holds
        one that nothing will mutate."""
        if self._failure:
            raise self._failure[0]
        snap = _snapshot(state) if copy else state
        self._q.put((path, snap, meta))

    def close(self, raise_failure: bool = True):
        self._q.put(None)
        self._thread.join()
        if self._failure and raise_failure:
            raise self._failure[0]


def append_metrics(path: str, records: list):
    """Append per-round metric records as JSON lines (durable training
    log)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def prune_metrics(path: str, max_round: int):
    """Drop jsonl records with round > ``max_round`` (atomic tmp+rename).

    Resume calls this with the restored checkpoint's round: rounds logged
    after the last durable save are about to be re-run.  A missing file is
    a no-op.
    """
    if not os.path.exists(path):
        return
    with open(path) as f:
        lines = f.readlines()
    keep = []
    for ln in lines:
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError:
            # partial trailing write from a crash: beyond the durable prefix
            continue
        if rec.get("round", -1) <= max_round:
            keep.append(ln)
    if len(keep) == len(lines):
        return
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "w") as f:
            f.writelines(keep)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def latest_round(path: str) -> int:
    """Round recorded in a checkpoint's metadata (-1 when absent/unset, or
    when the archive is truncated or corrupt — resume paths probe this)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            manifest = json.loads(str(z["manifest"]))
        return int(manifest.get("meta", {}).get("round", -1))
    except (OSError, EOFError, KeyError, TypeError, ValueError,
            zipfile.BadZipFile):
        return -1


def restore_state(path: str, like: ServerState) -> Tuple[ServerState, dict]:
    """Restores into the structure of ``like`` (leaf paths must match);
    tensors land on ``like``'s devices with ``like``'s dtypes."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        arrays = [z[f"leaf_{i}"] for i in range(manifest["n"])]
    paths, like_leaves = flatten_with_paths(like)
    if paths != manifest["paths"]:
        raise ValueError(
            f"checkpoint structure mismatch: {manifest['paths'][:3]}... vs "
            f"{paths[:3]}...")
    restored = []
    for a, x in zip(arrays, like_leaves):
        if isinstance(x, torch.Tensor):
            restored.append(torch.as_tensor(np.asarray(a)).to(
                device=x.device, dtype=x.dtype))
        else:
            restored.append(type(x)(a))
    return unflatten_like(like, restored), manifest["meta"]
