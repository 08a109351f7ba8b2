"""Checkpoint / resume for SLAM state pytrees.

The reference has NO persistence — maps live only in RAM (SURVEY.md §5.4).  Here
any framework state (CoreSlamState, HectorState, ParticleState, PoseGraphState —
all NamedTuple pytrees of arrays) round-trips through orbax when available, with
an npz fallback, enabling restart/recovery and the multi-device resume story.
"""
from __future__ import annotations

import json
import os
from typing import Any

import jax
import numpy as np

try:
    import orbax.checkpoint as ocp
    _HAS_ORBAX = True
except Exception:                                   # pragma: no cover
    _HAS_ORBAX = False


def _flatten(state) -> dict:
    leaves, treedef = jax.tree.flatten(state)
    return {"leaves": [np.asarray(l) for l in leaves], "treedef": treedef}


def save(path: str, state: Any, metadata: dict | None = None) -> None:
    """Save a state pytree (+ JSON-able metadata) to `path` (a directory)."""
    os.makedirs(path, exist_ok=True)
    leaves, _ = jax.tree.flatten(state)
    np.savez(os.path.join(path, "state.npz"),
             **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)})
    meta = dict(metadata or {})
    meta["num_leaves"] = len(leaves)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def restore(path: str, like: Any) -> Any:
    """Restore a state saved by `save`; `like` provides the pytree structure."""
    with np.load(os.path.join(path, "state.npz")) as data:
        leaves_like, treedef = jax.tree.flatten(like)
        n = len(leaves_like)
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    import jax.numpy as jnp
    leaves = [jnp.asarray(l, leaves_like[i].dtype)
              for i, l in enumerate(leaves)]
    return jax.tree.unflatten(treedef, leaves)


def load_metadata(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def save_sharded(path: str, state: Any, cfg: Any,
                 metadata: dict | None = None) -> None:
    """Checkpoint a SHARDED state (ShardedHectorState / ShardedCoreSlamState /
    ShardedGraphSlamState): densified host-side so the checkpoint is
    mesh-shape independent — a job restarted on a DIFFERENT device count
    restores it with `restore_sharded` onto its own mesh (the
    elastic-restart story, SURVEY.md §5.4)."""
    from ..models import coreslam_sharded, graph_slam_sharded, hector_sharded

    kind = type(state).__name__
    if kind == "ShardedHectorState":
        dense = hector_sharded.to_dense(state, cfg)
    elif kind == "ShardedCoreSlamState":
        dense = coreslam_sharded.to_dense(state)
    elif kind == "ShardedGraphSlamState":
        dense = graph_slam_sharded.to_dense(state, cfg)
    else:
        raise TypeError(f"not a sharded state: {kind}")
    meta = dict(metadata or {})
    meta["sharded_kind"] = kind
    save(path, dense, meta)


def restore_sharded(path: str, mesh, cfg: Any, like_dense: Any,
                    **shard_kwargs) -> Any:
    """Restore a `save_sharded` checkpoint onto `mesh` (any compatible shape).

    like_dense: a dense state providing the pytree structure (e.g.
    hector.init(cfg, 0-pose)).  Returns the sharded state."""
    from ..models import coreslam_sharded, graph_slam_sharded, hector_sharded

    kind = load_metadata(path)["sharded_kind"]
    dense = restore(path, like_dense)
    if kind == "ShardedHectorState":
        return hector_sharded.shard_state(mesh, dense, cfg, **shard_kwargs)
    if kind == "ShardedCoreSlamState":
        return coreslam_sharded.shard_state(mesh, dense, cfg, **shard_kwargs)
    if kind == "ShardedGraphSlamState":
        return graph_slam_sharded.shard_dense(mesh, dense, cfg,
                                              **shard_kwargs)
    raise TypeError(kind)


def save_orbax(path: str, state: Any) -> None:
    """Orbax-backed save (async-capable, multi-host aware) when available."""
    if not _HAS_ORBAX:
        raise RuntimeError("orbax not available; use save()")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), state)
    ckptr.wait_until_finished()


def restore_orbax(path: str, like: Any) -> Any:
    if not _HAS_ORBAX:
        raise RuntimeError("orbax not available; use restore()")
    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(os.path.abspath(path), like)
