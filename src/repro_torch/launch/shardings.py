"""Placement map, twin of ``repro.launch.shardings``: per (arch x mesh),
which mesh axes cut which dimension of every parameter, optimizer-state,
batch and KV-cache leaf.

A placement is a ``P``: a tuple with one entry per dimension, ``None``
(replicated), an axis name, or a tuple of axis names (the first one
major), as a ``jax.sharding.PartitionSpec`` holds them.  The spec
functions return trees of ``P`` with the reference's structure and
entries:

  * FSDP: every >=2-D parameter shards one dim over "data".
  * TP:   attention projections / MLP hidden / vocab over "model".
  * EP:   MoE expert dim over "model".
  * SSM:  data-parallel only.
  * Multi-pod: "pod" extends data parallelism.

Shapes whose global batch cannot shard over the dp axes shard the KV
cache's sequence dim over every mesh axis instead.

``to_placements`` turns a ``P`` into a DTensor placement per mesh
dimension (the counterpart of ``to_named``), and ``distribute`` places a
tree of full tensors, or of ``meta`` templates, as DTensors: the
counterpart of ``jax.jit``'s ``in_shardings``.  The trainer and the dry
run place their state so, FSDP over "data" with TP and EP over "model".
``local_shard`` / ``local_shards`` give this rank's block of a tensor or
a tree under a placement, contiguous blocks as ``NamedSharding`` lays
them out (a DTensor's local block under ``to_placements`` is the same
block wherever the mesh divides the dimension).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import mesh as mesh_lib


class P(tuple):
    """A placement: ``P("data", None)``, ``P(("pod", "data"), None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _map(fn, tree: Any) -> Any:
    """``tree`` with every ``P`` leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    raise TypeError(f"not a placement tree: {type(tree)}")


# --------------------------------------------------------------------------
# Parameter specs (mirror models.model.init_params structure)
# --------------------------------------------------------------------------
def _attn_specs(cfg: ArchConfig) -> Dict[str, Any]:
    s = {"wq": P("data", "model"), "wk": P("data", "model"),
         "wv": P("data", "model"), "wo": P("model", "data")}
    if cfg.qk_norm:
        s["q_norm"] = P(None)
        s["k_norm"] = P(None)
    return s


def _mlp_specs(cfg: ArchConfig) -> Dict[str, Any]:
    if cfg.mlp_type == "swiglu":
        return {"wg": P("data", "model"), "wu": P("data", "model"),
                "wd": P("model", "data")}
    return {"wi": P("data", "model"), "wo_mlp": P("model", "data")}


def moe_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """One MoE layer's leaves (the reference's ``_moe_specs``)."""
    return {"router": P(None, None),
            "wg": P("model", "data", None),
            "wu": P("model", "data", None),
            "wd": P("model", None, "data")}


def _ssm_specs(cfg: ArchConfig) -> Dict[str, Any]:
    return {"in_proj": P("data", None), "conv_w": P(None, None),
            "conv_b": P(None), "A_log": P(None), "D": P(None),
            "dt_bias": P(None), "ssm_norm": P(None),
            "out_proj": P(None, "data")}


def _layer_specs(cfg: ArchConfig, spec, cross: bool):
    s: Dict[str, Any] = {"ln1": P(None)}
    if spec.kind == "attn":
        s["attn"] = _attn_specs(cfg)
    else:
        s["ssm"] = _ssm_specs(cfg)
    if cross:
        s["ln_x"] = P(None)
        s["cross"] = _attn_specs(cfg)
    if spec.moe:
        s["ln2"] = P(None)
        s["moe"] = moe_specs(cfg)
    elif cfg.d_ff:
        s["ln2"] = P(None)
        s["mlp"] = _mlp_specs(cfg)
    return s


def _prepend_none(tree: Any) -> Any:
    """Stacked storage: a replicated leading layer dim."""
    return _map(lambda s: P(None, *s), tree)


def param_specs(cfg: ArchConfig, mesh) -> Dict[str, Any]:
    tp = mesh_lib.axis_sizes(mesh)["model"]
    plan = cfg.layer_plan()
    head, p, n_super, tail = cfg.plan_blocks()

    def lsp(sp):
        return _layer_specs(cfg, sp, cross=cfg.enc_dec)
    # vocab over model when divisible; d_model stays unsharded
    vshard = "model" if cfg.vocab_size % tp == 0 else None
    specs: Dict[str, Any] = {
        "embed": P(vshard, None),
        "final_norm": P(None),
        "head": [lsp(plan[i]) for i in range(head)],
        "blocks": [_prepend_none(lsp(plan[head + j]))
                   for j in range(p)] if n_super else [],
        "tail": [lsp(plan[head + n_super * p + t]) for t in range(tail)],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, vshard)
    if cfg.enc_dec:
        especs = _layer_specs(cfg, cfg.encoder_plan()[0], cross=False)
        specs["enc_blocks"] = [_prepend_none(especs)]
        specs["enc_final_norm"] = P(None)
    return specs


def train_state_specs(cfg: ArchConfig, mesh) -> Dict[str, Any]:
    ps = param_specs(cfg, mesh)
    return {"params": ps, "m": ps, "v": ps, "step": P()}


# --------------------------------------------------------------------------
# Batch / cache / logits specs
# --------------------------------------------------------------------------
def batch_sharded(global_batch: int, mesh) -> bool:
    return global_batch % mesh_lib.dp_size(mesh) == 0


def batch_specs(cfg: ArchConfig, mesh, global_batch: int) -> Dict[str, Any]:
    dp = mesh_lib.dp_axes(mesh)
    b = dp if batch_sharded(global_batch, mesh) else None
    s: Dict[str, Any] = {"tokens": P(b, None)}
    if cfg.frontend == "vision_stub":
        s["prefix_embeds"] = P(b, None, None)
    if cfg.frontend == "audio_stub":
        s["encoder_embeds"] = P(b, None, None)
    return s


def cache_specs_tree(cfg: ArchConfig, mesh, global_batch: int):
    """Placements mirroring ``models.model.cache_specs`` (head / blocks /
    tail; block entries carry a leading stacked layer dim)."""
    sizes = mesh_lib.axis_sizes(mesh)
    dp = mesh_lib.dp_axes(mesh)
    if batch_sharded(global_batch, mesh):
        b, seq = dp, "model"          # batch over dp, KV seq over model
    else:
        b, seq = None, tuple(sizes)   # SP: seq over all axes

    def entry(spec, stacked: bool):
        lead = (None,) if stacked else ()
        if spec.kind == "attn":
            e = {"k": P(*lead, b, seq, None, None),
                 "v": P(*lead, b, seq, None, None)}
        else:
            ssm_h = "model" if cfg.ssm_heads % sizes["model"] == 0 else None
            e = {"conv": P(*lead, b, None, None),
                 "ssm": P(*lead, b, ssm_h, None, None)}
        if cfg.enc_dec:
            e["cross_k"] = P(*lead, b, None, None, None)
            e["cross_v"] = P(*lead, b, None, None, None)
        return e

    plan = cfg.layer_plan()
    head, p, n_super, tail = cfg.plan_blocks()
    return {"head": [entry(plan[i], False) for i in range(head)],
            "blocks": [entry(plan[head + j], True)
                       for j in range(p)] if n_super else [],
            "tail": [entry(plan[head + n_super * p + t], False)
                     for t in range(tail)]}


def logits_spec(cfg: ArchConfig, mesh, global_batch: int) -> P:
    dp = mesh_lib.dp_axes(mesh)
    b = dp if batch_sharded(global_batch, mesh) else None
    tp = mesh_lib.axis_sizes(mesh)["model"]
    return P(b, None, "model" if cfg.vocab_size % tp == 0 else None)


# --------------------------------------------------------------------------
# This rank's blocks
# --------------------------------------------------------------------------
def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh
    dimension: ``Shard(d)`` where dimension ``d``'s entry names that mesh
    axis, ``Replicate()`` elsewhere.  An entry of several axes shards
    one dimension over each of them, the first one major, as
    ``NamedSharding`` lays it out; DTensor splits in mesh-dimension
    order, so the entry's axes must come in the mesh's order.  An axis
    of size 1 cuts nothing and is ``Replicate()`` (DTensor refuses some
    views of a dim "cut" into one block)."""
    sizes = mesh_lib.axis_sizes(mesh)
    names = tuple(sizes)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        at = [names.index(a) for a in axes]
        if at != sorted(at):
            raise ValueError(f"{spec}: axes {axes} not in the mesh's order "
                             f"{names}")
        for i in at:
            if isinstance(out[i], Shard):
                raise ValueError(f"{spec}: axis {names[i]!r} cuts two dims")
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def distribute(tree: Any, specs: Any, mesh, fill=None,
               path: tuple = ()) -> Any:
    """Every leaf of ``tree`` as a DTensor on ``mesh`` under the
    placement at the same place in ``specs`` (dicts and lists walked
    together).  Each rank cuts its own block out of the full tensor it
    holds, with no communication; a ``meta`` leaf gives a ``meta``
    DTensor whose local block has the rank's shape and no storage, or,
    with ``fill``, the block ``fill(path, shape, offset)`` makes: the
    leaf's path (the dict keys and list indices down to it), the rank's
    block shape and its global offset.  A leaf that is a DTensor already
    is redistributed."""
    if isinstance(specs, P):
        place = to_placements(specs, mesh)
        if isinstance(tree, DTensor):
            return tree.redistribute(mesh, place)
        if fill is not None and tree.is_meta:
            shape, offset = compute_local_shape_and_global_offset(
                tree.shape, mesh, place)
            return DTensor.from_local(
                fill(path, tuple(shape), tuple(offset)).contiguous(), mesh,
                place, run_check=False, shape=tree.shape,
                stride=tree.stride())
        return distribute_tensor(tree.detach(), mesh, place,
                                 src_data_rank=None)
    if isinstance(specs, dict):
        return {k: distribute(tree[k], specs[k], mesh, fill, path + (k,))
                for k in tree}
    return type(tree)(distribute(t, s, mesh, fill, path + (i,))
                      for i, (t, s) in enumerate(zip(tree, specs)))


def full(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` gathered whole (``full_tensor``, a
    collective over its mesh); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: full(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full(v) for v in tree)
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def replicated_over(specs: Any, axes: Iterable[str]) -> Any:
    """``specs`` with the axes ``axes`` taken out of every entry (those
    dims replicated over them)."""
    drop = set(axes)

    def one(s):
        out = []
        for e in s:
            keep = tuple(a for a in _axes(e) if a not in drop)
            out.append(None if not keep else
                       keep[0] if isinstance(e, str) else keep)
        return P(*out)
    return _map(one, specs)


def local_shard(tensor: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``tensor`` under ``spec``: along each dim cut
    over axes ``(a1, a2, ...)``, block ``i`` of ``size(a1) * size(a2) *
    ...`` equal contiguous blocks, ``i`` the rank's coordinates with
    ``a1`` major.  An uncut tensor comes back as itself; a cut one as an
    owned copy."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is outside the mesh")
    sizes = mesh_lib.axis_sizes(mesh)
    where = dict(zip(sizes, coord))
    if len(spec) > tensor.dim():
        raise ValueError(f"placement {spec} for a {tensor.dim()}-d tensor")
    out = tensor
    for dim, entry in enumerate(spec):
        n, i = 1, 0
        for a in _axes(entry):
            n, i = n * sizes[a], i * sizes[a] + where[a]
        if n > 1:
            length = out.shape[dim]
            if length % n:
                raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does "
                                 f"not split into {n} blocks ({spec})")
            out = out.narrow(dim, i * (length // n), length // n)
    return out if out is tensor else out.clone()


def local_shards(tree: Any, specs: Any, mesh) -> Any:
    """``local_shard`` of every leaf of ``tree`` under the placement at
    the same place in ``specs`` (dicts and lists walked together)."""
    if isinstance(specs, P):
        return local_shard(tree, specs, mesh)
    if isinstance(specs, dict):
        return {k: local_shards(tree[k], specs[k], mesh) for k in tree}
    return type(tree)(local_shards(t, s, mesh) for t, s in zip(tree, specs))
