"""Checkpoint: a directory of saved state, the port's counterpart of
`ray_tpu/train/checkpoint.py` (reference: ray.train's `Checkpoint`, an
opaque directory plus metadata).

Where the JAX package writes an orbax pytree, the port writes one file,
`state.pt`, with `torch.save`, and reads it back with
`torch.load(weights_only=True)`: a tree of dicts, lists and tuples whose
leaves are tensors, numpy arrays and Python scalars (such as a model's and
an optimizer's `state_dict`). numpy leaves are stored as tensors and come
back as numpy. State that this cannot express falls back to pickle in
`state.pkl`, the file the JAX package's fallback writes, so a pickled
checkpoint reads in both packages; so does the metadata sidecar. A
directory holding only JAX's orbax `pytree/` is refused with an error that
names the format. Anything else the user puts in the directory rides along
untouched.

Sharded, the counterpart of orbax's write of sharded arrays: with `mesh`,
every rank of the mesh calls `from_state` with its own blocks (a
shard-local model's and its AdamW's state dicts), and each writes them to
`shards/rank-<rank>.pt`; the mesh's first rank writes
`shards/layout.json`, the mesh's axes, sizes and ranks and each leaf's
spec (the `specs` tree, where the caller gives one). Nothing is gathered.
Read back, as JAX's orbax read gives global arrays or places them on
another sharding:
  * `to_state` with the same `mesh` reads this rank's file back onto
    `target`'s blocks;
  * `to_state` with no mesh returns the whole state: each leaf's blocks
    from every rank's file, put in place by its spec and the rank's mesh
    coordinate (a dimension split over several axes numbered row-major
    over them, as `parallel.sharding.local_slice` numbers it); a leaf
    without a spec is replicated and read from the mesh's first rank. A
    checkpoint written without `specs` cannot be assembled and raises
    `ValueError`;
  * `to_state` with a mesh of another layout, or over other ranks, and
    the target's `specs` gives this rank its blocks of the whole under
    those specs: only the parts of each saved block that fall in this
    rank's block are copied out of the memory-mapped files, so the whole
    state is never built on a rank.
"""

import json
import os
import pickle
import shutil
import tempfile
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.parallel.sharding import P, block_index

_METADATA_FILE = ".ray_tpu_ckpt_meta.json"
_TORCH_FILE = "state.pt"
_PICKLE_FILE = "state.pkl"
_ORBAX_DIR = "pytree"      # the JAX package's format
_SHARD_DIR = "shards"      # a sharded checkpoint: one file a rank, and the layout
_LAYOUT_FILE = "layout.json"
_SCALARS = (bool, int, float, str, type(None))


class _NotTorchState(TypeError):
    """The state holds a leaf or container weights_only cannot load."""


def _encode(obj, path, numpy_leaves: List):
    """`obj` with numpy leaves made tensors; their paths go to numpy_leaves."""
    if isinstance(obj, torch.Tensor) or isinstance(obj, _SCALARS):
        return obj
    if isinstance(obj, (np.ndarray, np.generic)):
        try:
            t = torch.from_numpy(np.array(obj))   # a copy, so writeable
        except (TypeError, ValueError) as e:      # a dtype or byte order torch has not
            raise _NotTorchState(str(e)) from e
        numpy_leaves.append((path, isinstance(obj, np.generic)))
        return t
    if type(obj) in (dict, OrderedDict):
        if not all(isinstance(k, (str, int)) for k in obj):
            raise _NotTorchState("dict keys must be str or int")
        return type(obj)((k, _encode(v, path + (k,), numpy_leaves)) for k, v in obj.items())
    if type(obj) in (list, tuple):
        return type(obj)(_encode(v, path + (i,), numpy_leaves) for i, v in enumerate(obj))
    raise _NotTorchState(f"leaf of type {type(obj).__name__}")


def _set_path(tree, path, fn):
    """Replace the leaf at `path` by fn(leaf); tuples are rebuilt."""
    if not path:
        return fn(tree)
    key, rest = path[0], path[1:]
    if isinstance(tree, tuple):
        return tuple(_set_path(v, rest, fn) if i == key else v for i, v in enumerate(tree))
    tree[key] = _set_path(tree[key], rest, fn)
    return tree


def _restore_like(obj, target, path=()):
    """`obj` with each tensor at a tensor leaf of `target` moved to that
    leaf's device and dtype; subtrees `target` lacks come back as loaded."""
    if target is None:
        return obj
    where = "/".join(map(str, path)) or "the root"
    if isinstance(target, torch.Tensor):
        if not isinstance(obj, torch.Tensor) or obj.shape != target.shape:
            got = tuple(obj.shape) if isinstance(obj, torch.Tensor) else type(obj).__name__
            raise ValueError(f"checkpoint holds {got} at {where}, target "
                             f"{tuple(target.shape)}")
        return obj.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict) and isinstance(obj, dict):
        missing = [k for k in target if k not in obj]
        if missing:
            raise ValueError(f"checkpoint lacks {missing} at {where}")
        return type(obj)((k, _restore_like(v, target.get(k), path + (k,)))
                         for k, v in obj.items())
    if isinstance(target, (list, tuple)) and isinstance(obj, (list, tuple)):
        if len(target) != len(obj):
            raise ValueError(f"checkpoint holds {len(obj)} entries at {where}, "
                             f"target {len(target)}")
        return type(obj)(_restore_like(v, t, path + (i,))
                         for i, (v, t) in enumerate(zip(obj, target)))
    return obj


def _mesh_layout(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))


def _mesh_barrier(mesh) -> None:
    """Every rank of the mesh has reached this point (an all-reduce over
    each axis, on the mesh's device)."""
    import torch.distributed as dist
    dev = "cpu" if mesh.device_type == "cpu" else torch.cuda.current_device()
    flag = torch.ones((), device=dev)
    for axis in mesh.mesh_dim_names:
        dist.all_reduce(flag, group=mesh.get_group(axis))


def _spec_json(tree):
    """A specs tree (dicts whose leaves are P or None) as JSON: a P is a
    list of its entries, each None, an axis name or a list of names."""
    if isinstance(tree, dict):
        return {str(k): _spec_json(v) for k, v in tree.items()}
    if tree is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in tree]


def _spec_at(specs, path) -> Optional[P]:
    """The spec of the leaf at `path` in a JSON specs tree (`_spec_json`),
    or None: a leaf the tree does not name is replicated."""
    node = specs
    for key in path:
        if not isinstance(node, dict) or str(key) not in node:
            return None
        node = node[str(key)]
    return P(*node) if isinstance(node, list) else None


def _map_leaves(tree, fn, path=()):
    """fn(path, leaf) over the leaves of dicts, lists and tuples."""
    if type(tree) in (dict, OrderedDict):
        return type(tree)((k, _map_leaves(v, fn, path + (k,))) for k, v in tree.items())
    if type(tree) in (list, tuple):
        return type(tree)(_map_leaves(v, fn, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _leaf_at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


class _Sources:
    """Every rank's file of a sharded checkpoint, memory-mapped, with each
    rank's mesh coordinate; a block shared by several ranks (a replicated
    axis) is read from the first of them."""

    def __init__(self, shards: str, layout: Dict):
        self.sizes = layout["mesh"]
        self.specs = layout["specs"]
        names, dims = list(self.sizes), list(self.sizes.values())
        self.coords = [dict(zip(names, (int(c) for c in np.unravel_index(i, dims))))
                       for i in range(len(layout["ranks"]))]
        self.payloads = [torch.load(os.path.join(shards, f"rank-{r:05d}.pt"),
                                    map_location="cpu", weights_only=True, mmap=True)
                         for r in layout["ranks"]]

    def _pieces(self, path, leaf):
        """(the whole shape, [(its start in the whole, the saved block)])
        of one leaf, one piece a distinct block."""
        spec = _spec_at(self.specs, path)
        seen, pieces, shape = set(), [], None
        for coord, payload in zip(self.coords, self.payloads):
            blocks = block_index(spec, self.sizes, coord, leaf.ndim)
            key = tuple(i for _, i in blocks)
            if key in seen:
                continue
            seen.add(key)
            t = _leaf_at(payload["tree"], path)
            shape = [n * c for n, (c, _) in zip(t.shape, blocks)]
            pieces.append(([n * i for n, (_, i) in zip(t.shape, blocks)], t))
        return shape, pieces

    def whole(self, path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        shape, pieces = self._pieces(path, leaf)
        if len(pieces) == 1:
            return leaf
        out = torch.empty(shape, dtype=leaf.dtype)
        for start, t in pieces:
            out[tuple(slice(s, s + n) for s, n in zip(start, t.shape))].copy_(t)
        return out

    def block(self, path, leaf, spec, sizes, coord):
        """The block under `spec` at mesh coordinate `coord` ({axis: index})
        of a mesh of `sizes`: the intersection of each saved block with it,
        copied out of the mapped files."""
        if not isinstance(leaf, torch.Tensor):
            return leaf
        shape, pieces = self._pieces(path, leaf)
        lo, hi = [], []
        for d, (count, idx) in enumerate(block_index(spec, sizes, coord, leaf.ndim)):
            if shape[d] % count:
                where = "/".join(map(str, path))
                raise ValueError(f"dimension {d} of {where}'s whole shape {tuple(shape)} "
                                 f"does not split into {count} blocks")
            n = shape[d] // count
            lo.append(idx * n)
            hi.append(idx * n + n)
        out = torch.empty([h - l for l, h in zip(lo, hi)], dtype=leaf.dtype)
        for start, t in pieces:
            a = [max(l, s) for l, s in zip(lo, start)]
            b = [min(h, s + n) for h, s, n in zip(hi, start, t.shape)]
            if any(x >= y for x, y in zip(a, b)):
                continue
            out[tuple(slice(x - l, y - l) for x, y, l in zip(a, b, lo))].copy_(
                t[tuple(slice(x - s, y - s) for x, y, s in zip(a, b, start))])
        return out


class Checkpoint:
    """Handle to a checkpoint directory. Create with `from_directory` (user
    already wrote files) or `from_state` (we serialize a tree)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_state(cls, state: Any, path: Optional[str] = None,
                   metadata: Optional[Dict] = None, mesh=None,
                   specs: Any = None) -> "Checkpoint":
        """Serialize `state` into a new checkpoint dir: `state.pt` by
        torch.save, or `state.pkl` by pickle when the tree holds anything
        else. The file is written beside its final name and renamed, so a
        reader never sees half a checkpoint.

        With `mesh`: this rank's blocks, written sharded (module
        docstring); every rank of the mesh calls it with the same `path`,
        which it must give, and it returns when every rank has written.
        `specs` is a tree of each leaf's spec (`parallel.sharding.P`) kept
        in the layout, for example from `train.llm_step.train_state`."""
        if mesh is not None:
            return cls._from_shards(state, path, metadata, mesh, specs)
        path = path or tempfile.mkdtemp(prefix="ray_tpu_ckpt_")
        os.makedirs(path, exist_ok=True)
        ckpt = cls(path)
        numpy_leaves: List = []
        try:
            payload = {"tree": _encode(state, (), numpy_leaves),
                       "numpy_leaves": numpy_leaves}
            name, write = _TORCH_FILE, lambda f: torch.save(payload, f)
        except _NotTorchState:
            name, write = _PICKLE_FILE, lambda f: pickle.dump(state, f)
        tmp = os.path.join(path, name + ".tmp")
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, os.path.join(path, name))
        for stale in {_TORCH_FILE, _PICKLE_FILE} - {name}:
            if os.path.exists(os.path.join(path, stale)):
                os.remove(os.path.join(path, stale))
        if metadata:
            ckpt.set_metadata(metadata)
        return ckpt

    @classmethod
    def _from_shards(cls, state, path, metadata, mesh, specs) -> "Checkpoint":
        import torch.distributed as dist
        if path is None:
            raise ValueError("a sharded checkpoint needs the path every rank writes to")
        numpy_leaves: List = []
        try:
            payload = {"tree": _encode(state, (), numpy_leaves),
                       "numpy_leaves": numpy_leaves}
        except _NotTorchState as e:
            raise TypeError(f"a sharded checkpoint holds tensors, numpy arrays and "
                            f"scalars only: {e}") from e
        shards = os.path.join(path, _SHARD_DIR)
        os.makedirs(shards, exist_ok=True)
        rank = dist.get_rank()
        name = os.path.join(shards, f"rank-{rank:05d}.pt")
        with open(name + ".tmp", "wb") as f:
            torch.save(payload, f)
        os.replace(name + ".tmp", name)
        ckpt = cls(path)
        if not any(mesh.get_coordinate()):
            layout = {"mesh": _mesh_layout(mesh), "ranks": mesh.mesh.flatten().tolist(),
                      "specs": _spec_json(specs)}
            with open(os.path.join(shards, _LAYOUT_FILE + ".tmp"), "w") as f:
                json.dump(layout, f)
            os.replace(os.path.join(shards, _LAYOUT_FILE + ".tmp"),
                       os.path.join(shards, _LAYOUT_FILE))
            if metadata:
                ckpt.set_metadata(metadata)
        _mesh_barrier(mesh)
        return ckpt

    def _shard_state(self, target, mesh, specs):
        import torch.distributed as dist
        shards = os.path.join(self.path, _SHARD_DIR)
        with open(os.path.join(shards, _LAYOUT_FILE)) as f:
            layout = json.load(f)
        if mesh is not None:
            here = dict(mesh=_mesh_layout(mesh), ranks=mesh.mesh.flatten().tolist())
            if here == {k: layout[k] for k in here}:
                pt = os.path.join(shards, f"rank-{dist.get_rank():05d}.pt")
                return self._decode(torch.load(pt, map_location="cpu", weights_only=True,
                                               mmap=True), target)
        if layout.get("specs") is None:
            raise ValueError(f"{self.path} holds a sharded checkpoint of mesh "
                             f"{layout['mesh']} written without specs: its blocks cannot "
                             f"be assembled; restore it onto the mesh that wrote it")
        if mesh is not None and specs is None:
            raise ValueError(f"checkpoint written on mesh {layout['mesh']} over ranks "
                             f"{layout['ranks']}; restoring onto mesh {_mesh_layout(mesh)} "
                             f"over ranks {mesh.mesh.flatten().tolist()} needs the "
                             f"target's specs (train.llm_step.train_state gives them)")
        sources = _Sources(shards, layout)
        first = sources.payloads[0]
        if mesh is None:
            fn = sources.whole
        else:
            coord = mesh.get_coordinate()
            if coord is None:
                raise ValueError("this rank is not a member of the mesh")
            sizes, coord = _mesh_layout(mesh), dict(zip(mesh.mesh_dim_names, coord))
            want = _spec_json(specs)
            fn = lambda path, leaf: sources.block(path, leaf, _spec_at(want, path), sizes,
                                                  coord)
        payload = {"tree": _map_leaves(first["tree"], fn),
                   "numpy_leaves": first["numpy_leaves"]}
        return self._decode(payload, target)

    @staticmethod
    def _decode(payload, target):
        tree = payload["tree"]
        for path, scalar in payload["numpy_leaves"]:
            tree = _set_path(tree, tuple(path), lambda t, s=scalar:
                             t.numpy()[()] if s else t.numpy())
        return _restore_like(tree, target)

    # -- contents ----------------------------------------------------------
    def to_state(self, target: Any = None, mesh=None, specs: Any = None) -> Any:
        """Inverse of from_state. Tensors load on the CPU; `target`, a tree
        of like-shaped tensors (a fresh model's and optimizer's state
        dicts, say), puts each tensor on its target's device and dtype.
        A sharded checkpoint (module docstring) comes back whole without
        `mesh`; with the `mesh` it was written on each rank reads its own
        blocks; with another mesh each rank gets its blocks under `specs`,
        the target's specs tree (as `train.llm_step.train_state` returns
        it)."""
        if os.path.exists(os.path.join(self.path, _SHARD_DIR, _LAYOUT_FILE)):
            return self._shard_state(target, mesh, specs)
        pt = os.path.join(self.path, _TORCH_FILE)
        if os.path.exists(pt):
            return self._decode(torch.load(pt, map_location="cpu", weights_only=True,
                                           mmap=True), target)
        pk = os.path.join(self.path, _PICKLE_FILE)
        if os.path.exists(pk):
            with open(pk, "rb") as f:
                return pickle.load(f)
        if os.path.isdir(os.path.join(self.path, _ORBAX_DIR)):
            raise ValueError(
                f"{self.path} holds an orbax pytree checkpoint ({_ORBAX_DIR}/), "
                f"the JAX package's format; ray_tpu_torch reads {_TORCH_FILE} "
                f"(torch.save) or {_PICKLE_FILE} (pickle)")
        raise FileNotFoundError(f"no serialized state in {self.path}")

    def to_directory(self, path: Optional[str] = None) -> str:
        """Copy checkpoint contents to `path` (reference API parity)."""
        if path is None:
            path = tempfile.mkdtemp(prefix="ray_tpu_ckpt_copy_")
        os.makedirs(path, exist_ok=True)
        shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    @contextmanager
    def as_directory(self):
        """Reference parity: local-dir checkpoints are yielded in place."""
        yield self.path

    # -- metadata ----------------------------------------------------------
    def get_metadata(self) -> Dict:
        p = os.path.join(self.path, _METADATA_FILE)
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def set_metadata(self, metadata: Dict) -> None:
        with open(os.path.join(self.path, _METADATA_FILE), "w") as f:
            json.dump(metadata, f)

    def update_metadata(self, metadata: Dict) -> None:
        m = self.get_metadata()
        m.update(metadata)
        self.set_metadata(m)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"


class _CheckpointBook:
    """Keep-N bookkeeping for an experiment dir (CheckpointConfig policy)."""

    def __init__(self, config):
        self.config = config
        self.entries = []  # list of (score, index, Checkpoint)
        self._index = 0

    def register(self, ckpt: Checkpoint, metrics: Optional[Dict] = None):
        cfg = self.config
        score = None
        if cfg.checkpoint_score_attribute and metrics:
            score = metrics.get(cfg.checkpoint_score_attribute)
        self.entries.append((score, self._index, ckpt))
        self._index += 1
        if cfg.num_to_keep is not None and len(self.entries) > cfg.num_to_keep:
            self._evict()

    def _evict(self):
        cfg = self.config
        if cfg.checkpoint_score_attribute:
            sign = 1 if cfg.checkpoint_score_order == "max" else -1
            # Worst score first; unscored entries evict before scored ones.
            key = lambda e: (e[0] is not None,
                             sign * e[0] if e[0] is not None else 0, e[1])
            victim = min(self.entries, key=key)
        else:
            victim = min(self.entries, key=lambda e: e[1])  # oldest
        self.entries.remove(victim)
        shutil.rmtree(victim[2].path, ignore_errors=True)

    @property
    def latest(self) -> Optional[Checkpoint]:
        if not self.entries:
            return None
        return max(self.entries, key=lambda e: e[1])[2]

    @property
    def best(self) -> Optional[Checkpoint]:
        cfg = self.config
        if not self.entries:
            return None
        if not cfg.checkpoint_score_attribute:
            return self.latest
        sign = 1 if cfg.checkpoint_score_order == "max" else -1
        scored = [e for e in self.entries if e[0] is not None]
        if not scored:
            return self.latest
        return max(scored, key=lambda e: sign * e[0])[2]
