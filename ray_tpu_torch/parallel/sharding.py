"""Sharding-rule engine: the port's counterpart of
`ray_tpu/parallel/sharding.py`. A table of (path regex -> spec) applied
over a parameter tree gives each tensor its placement on a mesh.

A spec (`P`) is what JAX's `PartitionSpec` is: one entry per tensor
dimension, each None, a mesh-axis name or a tuple of names. On a
`DeviceMesh` it becomes DTensor placements, one per mesh dimension:
`Shard(d)` for the tensor dimension d that names the axis, else
`Replicate()` (`tree_placements`). `shard_tree` returns DTensors; each
rank copies only its own slice from the host tree to its device, so the
whole tensor never sits on one card.

The paths are the port's: a state_dict key with "/" for "."
(`layers_0/attn/wq/weight`). `llama_rules` is JAX's table carried to the
port's Llama: a flax Dense kernel is [in, out] and the port's Dense weight
[out, in] (`models/convert.py`), so the spec of every Dense moves with
the transpose (JAX's P(fsdp, tp) on `wq/kernel` is P(tp, fsdp) on
`wq/weight`). The MoE banks keep the flax layout ([E, D, F], [E, F, D])
and the embedding is [vocab, d] in both packages, so their specs do not
move.
"""

import dataclasses
import re
from typing import Any, List, Mapping, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard


def _norm_entry(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class P(tuple):
    """A partition spec: P(("fsdp",), "tp") shards dim 0 over fsdp and dim
    1 over tp. A one-name tuple is kept as the bare name, as JAX's
    PartitionSpec normalizes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_norm_entry(e) for e in entries))

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _map_tree(tree, fn, prefix: str = ""):
    """fn(path, leaf) over the leaves of dicts, lists and tuples, keeping the
    structure; a key's "." becomes "/" in the path."""
    def join(key):
        key = str(key).replace(".", "/")
        return f"{prefix}/{key}" if prefix else key
    if isinstance(tree, Mapping):
        return type(tree)((k, _map_tree(v, fn, join(k))) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, join(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_paths(tree) -> List[Tuple[str, Any]]:
    """Flatten a tree (a state_dict, or nested dicts, lists and tuples) into
    ("a/b/c", leaf) pairs."""
    out = []
    _map_tree(tree, lambda path, leaf: out.append((path, leaf)))
    return out


class ShardingRules:
    """Ordered (regex, P) table; first match wins."""

    def __init__(self, rules: Sequence[Tuple[str, P]], default: P = P()):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.default = default

    def spec_for(self, path: str, leaf=None) -> P:
        for pat, spec in self.rules:
            if pat.search(path):
                return _clip_spec(spec, leaf)
        return _clip_spec(self.default, leaf)

    def tree_specs(self, tree):
        """A tree of P matching `tree`'s structure."""
        return _map_tree(tree, self.spec_for)

    def tree_placements(self, tree, mesh: DeviceMesh):
        """A tree of DTensor placements (one per mesh dimension) matching
        `tree`'s structure, the counterpart of JAX's tree_shardings."""
        return _map_tree(tree, lambda path, leaf: spec_placements(
            _filter_axes(self.spec_for(path, leaf), mesh), mesh, leaf.ndim))


def _clip_spec(spec: P, leaf) -> P:
    """Trim a spec to the leaf's rank (rules can be written for the widest case)."""
    if leaf is None or not hasattr(leaf, "ndim"):
        return spec
    return P(*tuple(spec)[: leaf.ndim]) if len(tuple(spec)) > leaf.ndim else spec


def _filter_axes(spec: P, mesh: DeviceMesh) -> P:
    """Drop mesh axes the current mesh doesn't have (rules stay portable
    between e.g. a tp-only mesh and a dp x fsdp x tp mesh)."""
    names = set(mesh.mesh_dim_names)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    return P(*[keep(e) for e in tuple(spec)])


def spec_placements(spec: P, mesh: DeviceMesh, ndim: int):
    """DTensor placements of `spec` (axes already filtered to the mesh) for
    a tensor of `ndim` dimensions. A dimension split over several axes must
    name them in mesh order: DTensor shards in that order."""
    names = list(mesh.mesh_dim_names)
    dim_of = {}
    for d, entry in enumerate(tuple(spec)[:ndim]):
        axes = _entry_axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec {spec}: dimension {d} names {axes} out of mesh order "
                             f"{tuple(names)}")
        for a in axes:
            if a in dim_of:
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in names)


def block_index(spec: P, sizes: Mapping[str, int], coord: Mapping[str, int],
                ndim: int) -> List[Tuple[int, int]]:
    """(number of blocks, this block's index) of each of `ndim` dimensions
    under `spec`, at the mesh coordinate `coord` ({axis: index}) of a mesh
    of `sizes` ({axis: size}). A dimension split over several axes is
    numbered row-major over them, as JAX numbers a spec's tuple entry."""
    entries = tuple(spec or ())
    out = []
    for d in range(ndim):
        count, idx = 1, 0
        for a in _entry_axes(entries[d] if d < len(entries) else None):
            count, idx = count * sizes[a], idx * sizes[a] + coord[a]
        out.append((count, idx))
    return out


def local_slice(t: torch.Tensor, spec: P, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of the whole tensor `t` under `spec` (axes already
    filtered to the mesh): a view of `t`. Each split dimension must divide
    evenly, as JAX's device_put requires."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not a member of the mesh")
    blocks = block_index(spec, dict(zip(names, mesh.mesh.shape)), dict(zip(names, coord)),
                         t.ndim)
    for d, (count, idx) in enumerate(blocks):
        if count == 1:
            continue
        if t.shape[d] % count:
            raise ValueError(f"dimension {d} of shape {tuple(t.shape)} does not split into "
                             f"{count} blocks over mesh axes {_entry_axes(tuple(spec)[d])}")
        n = t.shape[d] // count
        t = t.narrow(d, idx * n, n)
    return t


def to_dtensor(t: torch.Tensor, spec: P, mesh: DeviceMesh) -> DTensor:
    """A DTensor over `mesh` from the whole host tensor `t`: only this
    rank's block is copied to the mesh's device."""
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    local = local_slice(t, spec, mesh).to(dev, copy=True).contiguous()
    return DTensor.from_local(local, mesh, spec_placements(spec, mesh, t.ndim),
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape, device="meta").stride())


def shard_tree(tree, mesh: DeviceMesh, rules: ShardingRules):
    """Place the host tree on the mesh according to the rules: a tree of
    DTensors, each rank holding its own block on its device."""
    return _map_tree(tree, lambda path, leaf: to_dtensor(
        leaf, _filter_axes(rules.spec_for(path, leaf), mesh), mesh))


# ---------------------------------------------------------------------------
# Canonical transformer rules for the port's Llama (models/llama.py).
# fsdp shards the large dimension of every matrix; tp shards heads/ffn.
# ---------------------------------------------------------------------------

def _dense(name: str, in_axis: str, out_axis: str) -> Tuple[str, P]:
    """JAX's rule P(in_axis, out_axis) on `{name}/kernel` [in, out], carried
    to the port's `{name}/weight` [out, in]."""
    return rf"{name}/weight", P((out_axis,), (in_axis,))


def llama_rules() -> ShardingRules:
    return ShardingRules([
        (r"embed/embedding", P(("fsdp",), ("tp",))),          # [vocab, d]
        _dense(r"(wq|wk|wv)", "fsdp", "tp"),                   # [heads*hd, d]
        _dense(r"wo", "tp", "fsdp"),                           # [d, heads*hd]
        _dense(r"(w_gate|w_up)", "fsdp", "tp"),                # [ffn, d]
        _dense(r"w_down", "tp", "fsdp"),                       # [d, ffn]
        _dense(r"lm_head", "fsdp", "tp"),                      # [vocab, d]
        # MoE expert banks (models/moe.py), flax layout: leading E dim over
        # `ep`, inner dims shard like the dense FFN; the tiny router stays
        # replicated so every shard routes identically
        (r"moe/router/weight", P()),                           # [E, d]
        (r"moe/w_(gate|up)$", P(("ep",), ("fsdp",), ("tp",))),  # [E, d, ffn]
        (r"moe/w_down$", P(("ep",), ("tp",), ("fsdp",))),       # [E, ffn, d]
        (r"(norm|ln)", P()),                                   # replicated
    ], default=P())


def batch_spec(extra_seq_axis: bool = False) -> P:
    """Activations: batch over (dp, fsdp); optionally sequence over sp."""
    if extra_seq_axis:
        return P(("dp", "fsdp"), ("sp",))
    return P(("dp", "fsdp"))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's NamedSharding): `placements(ndim)` gives the
    DTensor placements of a tensor of that rank."""
    mesh: DeviceMesh
    spec: P

    def placements(self, ndim: int):
        return spec_placements(_clip_spec(self.spec, torch.empty((0,) * ndim)), self.mesh,
                               ndim)


def data_sharding(mesh: DeviceMesh, extra_seq_axis: bool = False) -> NamedSharding:
    return NamedSharding(mesh, _filter_axes(batch_spec(extra_seq_axis), mesh))
