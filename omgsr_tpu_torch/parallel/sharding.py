"""Meshes, placement rules and the placement of frozen trees over ranks.

A ``Mesh`` names axes over the world's ranks, laid out row-major as
``np.arange(world).reshape(sizes)``, with one process group per axis. The
JAX package expresses its strategies as shardings and lets XLA insert the
collectives; here the placement rules say which dim of each leaf a strategy
splits, ``shard_params_fsdp`` / ``shard_flux_params`` cut the leaves, and the
collectives are written where the models run (``models/flux.py``,
``models/unet_sd.py``, ``models/layers.dense``) and where the trainers
average their gradients (``training/trainer.py``):

- ``fsdp``: every leaf of ``min_size`` elements or more keeps one rank's
  contiguous chunk along the split dim (``FSDPLeaf``); a block's leaves are
  all-gathered before the block runs and dropped after it.
- ``tp``: Megatron-style tensor parallelism over the attention heads and the
  MLP hidden width. Column-parallel products (q, k, v, the MLP's up
  projections) keep their output rows of this rank and stay local;
  row-parallel ones (the attention outputs, the MLP's down projections, the
  single blocks' ``proj_out``) keep their input columns and are summed over
  the group after the product.
- On more than one rank every split leaf's part is a copy with storage of its
  own: a narrowed view would keep the whole leaf alive on every rank.
- Training (``create_mesh`` of ``TrainConfig.mesh_shape``, ``data_rows``):
  the global batch is split over
  "data" in contiguous rows and replicated over "fsdp", as the JAX package's
  ``batch_sharding`` places it.

Leaves are in the port's layout: a dense ``weight`` / ``weight_q`` is
(out, in), ``weight_q4`` (out, in/2), a group-wise ``weight_scale``
(out, in/g), the transposes of the JAX package's kernels, a conv weight
(out, in, kh, kw) against its (kh, kw, in, out). The specs are
tuples with one entry per dim (an axis name or None), ``()`` replicated, as
JAX's ``PartitionSpec`` in this layout.
"""

from __future__ import annotations

import datetime
import math

import numpy as np
import torch
import torch.distributed as dist

from omgsr_tpu_torch.parallel.distributed import DEFAULT_TIMEOUT_S, all_gather_cat, all_reduce


class Mesh:
    """Named axes over the world's ranks: each axis's size, this rank's index
    along it, and the process group of the ranks that differ only there."""

    def __init__(self, shape: dict, coords: dict, groups: dict):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.groups = dict(groups)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def rank(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        if axis not in self.groups:
            raise ValueError(f"mesh {self.shape} has no {axis!r} axis")
        return self.groups[axis]


def create_mesh(shape: dict | None = None) -> Mesh:
    """shape e.g. {"data": 4} or {"tp": 2, "fsdp": 4}; None -> every rank on
    one "data" axis. Needs the process group of ``distributed.initialize``
    (one rank included); the product of the sizes must be the world size.
    Every rank must call it, in the same order: the groups of an axis that
    does not span the world are formed collectively."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call parallel.initialize first")
    world, me = dist.get_world_size(), dist.get_rank()
    if not shape:
        shape = {"data": world}
    names, sizes = tuple(shape), tuple(int(v) for v in shape.values())
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {shape} does not match {world} processes")
    ranks = np.arange(world).reshape(sizes)
    coords = {n: int(c) for n, c in zip(names, np.argwhere(ranks == me)[0])}
    groups = {}
    for i, name in enumerate(names):
        if sizes[i] == world:
            groups[name] = dist.group.WORLD
            continue
        for line in np.moveaxis(ranks, i, -1).reshape(-1, sizes[i]):
            g = dist.new_group([int(r) for r in line], timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
            if me in line:
                groups[name] = g
    return Mesh(shape, coords, groups)


def uses_fsdp(mesh: Mesh | None) -> bool:
    """Whether ``mesh`` has an "fsdp" axis (a frozen tree is then placed by
    ``shard_params_fsdp`` and run with a ``Sharding``)."""
    return mesh is not None and "fsdp" in mesh.axis_names


# ----------------------------------------------------------------------------
# placement rules: pure functions of a leaf's key path and shape
# ----------------------------------------------------------------------------


# the JAX package's dim of each of the port's dims: a dense (out, in) is its (in, out), a conv
# (out, in, kh, kw) its (kh, kw, in, out)
_JAX_DIM = {2: (1, 0), 4: (3, 2, 0, 1)}


def _fsdp_spec(shape, fsdp_size: int, min_size: int = 2**18) -> tuple:
    """Split the largest dim divisible by ``fsdp_size``, from ``min_size``
    elements on; replicate otherwise. A tie goes to the dim that is the
    lowest in the JAX package's layout, as it goes there: dim 1 of a dense
    weight, the in dim of a conv."""
    shape = tuple(shape)
    if math.prod(shape) < min_size:
        return ()
    nd = len(shape)
    jax_dim = _JAX_DIM.get(nd, tuple(range(nd)))
    order = sorted(range(nd), key=lambda i: (-shape[i], jax_dim[i]))
    for i in order:
        if shape[i] % fsdp_size == 0 and shape[i] >= fsdp_size:
            spec = [None] * nd
            spec[i] = "fsdp"
            return tuple(spec)
    return ()


# column-parallel: the output rows (heads, MLP hidden) split
_TP_COL = frozenset({"to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "proj_mlp"})
# row-parallel: the input columns split, the products summed over the group
_TP_ROW = frozenset({"to_out", "to_add_out"})


def _flux_tp_spec(keys: tuple, shape) -> tuple | None:
    """The TP spec of one FLUX block leaf, or None when TP does not split it
    (norms, modulation, everything outside the blocks). Column-parallel
    leaves split dim 0 (weight, codes, bias, per-channel and group-wise
    scales alike). Row-parallel leaves split their input dim: dim 1 of a
    weight, its codes and a group-wise scale; a per-channel scale and the
    bias, added once to the sum, are replicated, as is the w8a8 marker."""
    ks = set(keys)
    if not ks & {"transformer_blocks", "single_transformer_blocks"}:
        return None
    # inside ff / ff_context the up projection is the only dense under a "proj" key (net.0.proj)
    in_ff = bool(ks & {"ff", "ff_context"})
    col = bool(ks & _TP_COL) or (in_ff and "proj" in ks)
    row = bool(ks & _TP_ROW) or (in_ff and "proj" not in ks) or (
        "single_transformer_blocks" in ks and "proj_out" in ks)
    if not (col or row):
        return None
    leaf, nd = keys[-1], len(shape)
    if leaf == "act_quant":
        return ()
    if col:
        return ("tp",) + (None,) * (nd - 1)
    if leaf == "bias" or (leaf == "weight_scale" and nd == 1):
        return ()
    return (None, "tp")


def placement_spec(keys: tuple, shape, tp: bool, fsdp_size: int | None, min_size: int = 2**18) -> tuple:
    """The spec of one leaf of the FLUX tree: under ``tp`` the TP rule where
    it applies, else (and under FSDP) the fsdp rule when the mesh has an
    "fsdp" axis of ``fsdp_size``, else replicated: the JAX package's
    ``shard_params_flux_tp`` / ``shard_params_fsdp`` per leaf."""
    spec = _flux_tp_spec(keys, shape) if tp else None
    if spec is None:
        spec = _fsdp_spec(shape, fsdp_size, min_size) if fsdp_size is not None else ()
    return spec


# ----------------------------------------------------------------------------
# training: a rank's rows of the global batch
# ----------------------------------------------------------------------------


def data_rows(global_b: int, mesh: Mesh | None) -> tuple[int, int]:
    """(first, count) of this rank's contiguous rows of a global batch of
    ``global_b`` split over the mesh's "data" axis (the whole batch without a
    mesh, and on every rank of an "fsdp" axis alike)."""
    n = mesh.size("data") if mesh is not None else 1
    if global_b % n:
        raise ValueError(f"the global batch of {global_b} does not split over the {n} ranks of \"data\": "
                         "train_batch_size must be a multiple of the \"data\" size")
    share = global_b // n
    return (mesh.rank("data") if mesh is not None else 0) * share, share


# ----------------------------------------------------------------------------
# placement of a frozen tree (the -S UNet, the FLUX DiT)
# ----------------------------------------------------------------------------


class FSDPLeaf:
    """One rank's contiguous chunk of a leaf along ``dim``; ``full()``
    all-gathers the leaf over the group, in the whole leaf's memory format
    (a conv weight is channels-last). ``shape`` and ``dtype`` are the whole
    leaf's, ``device`` the chunk's, so code that reads a placed tree's
    geometry (a LoRA initialiser) reads it as it reads a whole tree."""

    __slots__ = ("local", "dim", "group", "shape", "dtype", "channels_last")

    def __init__(self, local: torch.Tensor, dim: int, group, shape, channels_last: bool = False):
        self.local, self.dim, self.group = local, dim, group
        self.shape, self.dtype, self.channels_last = torch.Size(shape), local.dtype, channels_last

    @property
    def device(self) -> torch.device:
        return self.local.device

    def full(self) -> torch.Tensor:
        t = all_gather_cat(self.local, self.group, self.dim)
        return t.contiguous(memory_format=torch.channels_last) if self.channels_last else t


def gather_tree(tree):
    """A subtree with every ``FSDPLeaf`` gathered into its whole leaf; every
    other leaf (a whole tensor, a LoRA factor) as it is."""
    if isinstance(tree, FSDPLeaf):
        return tree.full()
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    return tree


class Sharding:
    """What a model's apply needs to run a placed tree: ``gather`` turns a
    subtree's FSDP chunks into whole leaves; with tensor parallelism (the
    DiT) ``tp_group`` is the group whose ranks share each block's heads, and
    ``tp_sum`` / ``tp_max`` reduce over it."""

    def __init__(self, tp_group=None, tp_size: int = 1, tp_rank: int = 0):
        self.tp_group, self.tp_size, self.tp_rank = tp_group, tp_size, tp_rank

    def gather(self, tree):
        return gather_tree(tree)

    def tp_sum(self, t):
        return all_reduce(t, self.tp_group, "sum")

    def tp_max(self, t):
        return all_reduce(t, self.tp_group, "max")


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into storage of its own (a slice of a leaf, not a view of it)."""
    return t.clone(memory_format=torch.contiguous_format)


def _tp_slice(keys, t: torch.Tensor, dim: int, size: int, rank: int, cfg) -> torch.Tensor:
    """This rank's part of a leaf that TP splits along ``dim`` (or of an
    activation along its last dim, with the keys of the layer it enters).
    The single blocks' ``proj_out`` takes concat(attention, MLP) as its
    input, and each rank holds its heads and its MLP slice: its input columns
    are the attention slice and the MLP slice of that rank, side by side."""
    if size == 1:
        return t
    n = t.shape[dim]
    parts = [n]
    if dim == t.dim() - 1 and "single_transformer_blocks" in keys and "proj_out" in keys:
        inner = cfg.inner_dim
        total = inner + int(inner * cfg.mlp_ratio)
        if (n * inner) % total:
            raise ValueError(f"{'.'.join(keys)}: {n} input units do not split into attention and MLP")
        parts = [n * inner // total, n - n * inner // total]
    if any(p % size for p in parts):
        raise ValueError(f"{'.'.join(keys)} {tuple(t.shape)}: dim {dim} ({parts}) does not split over {size} "
                         "ranks (group-wise int4 splits on whole groups)")
    pieces, start = [], 0
    for p in parts:
        pieces.append(t.narrow(dim, start + rank * (p // size), p // size))
        start += p
    return torch.cat(pieces, dim=dim) if len(pieces) > 1 else _own(pieces[0])


def _fsdp_leaf(t: torch.Tensor, spec: tuple, mesh: Mesh) -> FSDPLeaf:
    """This rank's chunk of ``t`` along the "fsdp" dim of ``spec``: the leaf
    itself on one rank (a channels-last conv weight in the standard layout),
    a copy of its own on more."""
    d, size = spec.index("fsdp"), mesh.size("fsdp")
    n = t.shape[d] // size
    local = t.narrow(d, mesh.rank("fsdp") * n, n)
    channels_last = t.dim() == 4 and t.stride() == (t[0].numel(), 1, t.shape[3] * t.shape[1], t.shape[1])
    local = _own(local) if size > 1 else local.contiguous()
    return FSDPLeaf(local, d, mesh.group("fsdp"), t.shape, channels_last)


def shard_params_fsdp(tree, mesh: Mesh, min_size: int = 2**18, device=None, consume: bool = False):
    """``tree`` placed for FSDP over the mesh's "fsdp" axis: each leaf that
    ``_fsdp_spec`` splits becomes an ``FSDPLeaf`` of this rank's chunk, the
    others stay whole (every leaf stays whole without an "fsdp" axis): the
    JAX package's ``shard_params_fsdp`` rule, leaf by leaf, for any tree (the
    -S UNet, the FLUX DiT, a quantised tree's codes and scales alike).

    Tensor by tensor: each leaf is moved to ``device`` (None: where it lies)
    and cut before the next one is read, and with ``consume`` it is taken out
    of ``tree`` as it is placed, so neither the card nor (for a tree ported
    to the host) the host ever holds the whole tree beside its chunks. A leaf
    placed already (a quantised DiT placed block by block) stays as it is."""
    fsdp = mesh.size("fsdp") if uses_fsdp(mesh) else None

    def place(t):
        if isinstance(t, FSDPLeaf):
            return t
        if device is not None:
            t = t.to(device)
        spec = _fsdp_spec(t.shape, fsdp, min_size) if fsdp is not None else ()
        return _fsdp_leaf(t, spec, mesh) if "fsdp" in spec else t

    def walk(node):
        out = {}
        for k in list(node):
            v = node.pop(k) if consume else node[k]
            out[k] = walk(v) if isinstance(v, dict) else place(v)
            del v
        return out

    return walk(tree)


def shard_flux_params(params, cfg, mesh: Mesh, strategy: str, min_size: int = 2**18):
    """(placed tree, Sharding) for ``strategy`` "fsdp" or "tp".

    fsdp: with an "fsdp" axis every leaf that ``_fsdp_spec`` splits keeps its
    chunk; without one everything stays whole. tp: the block leaves that
    ``_flux_tp_spec`` splits keep this rank's part (the heads and the MLP
    width must divide by the "tp" size), the others follow the fsdp rule when
    the mesh also has an "fsdp" axis. On one rank every part is the leaf
    itself: nothing is copied. On more, each part is a copy of its own, and
    the whole leaves can be freed."""
    if strategy not in ("fsdp", "tp"):
        raise ValueError(f"strategy must be 'fsdp' or 'tp', got {strategy!r}")
    tp = strategy == "tp"
    if tp and "tp" not in mesh.axis_names:
        raise ValueError('mesh has no "tp" axis')
    tp_size, tp_rank = mesh.size("tp"), mesh.rank("tp")
    if tp:
        mlp = int(cfg.inner_dim * cfg.mlp_ratio)
        if cfg.num_attention_heads % tp_size or mlp % tp_size:
            raise ValueError(f"tp={tp_size} must divide the {cfg.num_attention_heads} heads and the MLP width {mlp}")
    if not tp:
        return shard_params_fsdp(params, mesh, min_size), Sharding()
    fsdp = mesh.size("fsdp") if uses_fsdp(mesh) else None

    def place(keys, t):
        spec = placement_spec(keys, t.shape, tp, fsdp, min_size)
        if "tp" in spec:
            return _tp_slice(keys, t, spec.index("tp"), tp_size, tp_rank, cfg)
        return _fsdp_leaf(t, spec, mesh) if "fsdp" in spec else t

    def walk(node, keys):
        return {k: walk(v, keys + (k,)) if isinstance(v, dict) else place(keys + (k,), v) for k, v in node.items()}

    return walk(params, ()), Sharding(mesh.group("tp"), tp_size, tp_rank)


def local_tiles(n: int, size: int, rank: int) -> tuple[int, int, int]:
    """(padded count, first, count) of the tiles a rank denoises: ``n`` tiles
    padded to a multiple of ``size``, a contiguous share each."""
    total = n + (-n) % size
    share = total // size
    return total, rank * share, share


def cli_mesh(strategy: str, device="cuda") -> Mesh | None:
    """The mesh of a CLI's ``--shard``: None for "none". Otherwise the
    process group of torchrun's environment (or one formed already by the
    caller, one rank included), every rank on the strategy's axis: "tp",
    "fsdp", or "data" for tiles. One process with no group runs unsharded,
    with the JAX CLIs' message."""
    from omgsr_tpu_torch.parallel.distributed import initialize

    if strategy == "none":
        return None
    if not initialize(device=device):
        print(f"--shard {strategy}: only one device visible — running unsharded", flush=True)
        return None
    axis = strategy if strategy in ("tp", "fsdp") else "data"
    return create_mesh({axis: dist.get_world_size()})


def cli_train_mesh(mesh_shape: dict | None, device="cuda") -> Mesh | None:
    """The mesh of a training CLI: ``cfg.mesh_shape`` over the process group
    of torchrun's environment (or one formed already by the caller, one rank
    included; None: every rank on "data"). One process with no group trains
    unsharded, with the JAX CLIs' message where a mesh was asked for, and
    refuses a mesh that names "fsdp": the placement it asks for needs ranks."""
    from omgsr_tpu_torch.parallel.distributed import initialize

    if initialize(device=device):
        return create_mesh(mesh_shape)
    if mesh_shape and "fsdp" in mesh_shape:
        raise ValueError(f"mesh_shape {mesh_shape} names \"fsdp\" but no process group exists: launch the "
                         "trainer under torchrun (one process per GPU), or drop the fsdp axis")
    if mesh_shape and math.prod(int(v) for v in mesh_shape.values()) > 1:
        print(f"mesh_shape {mesh_shape}: only one device visible — running unsharded", flush=True)
    return None

