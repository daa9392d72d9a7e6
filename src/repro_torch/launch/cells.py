"""Build one dry-run "cell": (arch x input-shape x mesh) -> step function
and abstract inputs (``meta`` DTensors placed by the spec trees: shapes,
dtypes and placements, never storage); and trace it, the counterpart of
the reference's ``lower_cell(...).compile()``.

This is the same wiring as ``launch/train.py`` and ``launch/serve.py``
use (``models.steps`` over a mesh, ``launch.shardings``), so the dry run
traces the production configuration, not a copy of it.

``trace_cell`` runs the step once on ``meta`` under a recorder, a
``TorchDispatchMode`` that lets every DTensor op pass (so DTensor turns
it into this rank's local ops and collectives) and counts what reaches
it on local tensors, which is what one device runs:

* ``flops``: the matrix products (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``), 2 x the local output's elements x the local contraction
  length, as ``cost_analysis``'s "flops" counts them (elementwise work
  is not counted);
* ``bytes accessed``: every compute op's local input and output bytes
  (views and allocations access nothing): the unfused upper bound, as
  XLA's is for its unfused module; ``analytic.kernelized_bytes`` is the
  floor;
* the collectives, each with its kind, group size and operand and
  output bytes (``collective_summary`` prices them);
* memory: ``argument_bytes`` (the local blocks of the step's inputs),
  ``output_bytes`` (the local bytes of its outputs that are new tensors:
  the train step updates the state in place) and ``temp_bytes``, the
  peak of the bytes of live local tensors made during the step (every
  non-view op's outputs from when it returns until the last reference
  to them goes), beyond the arguments.

The DTensor propagation that runs on the side (on fake tensors of the
global shapes) is not counted.  XLA pads a dim that its mesh axes do not
divide, and DTensor cuts it unevenly with no padding, so on such leaves
the argument bytes differ from the reference's; ``uneven_leaves`` names
them.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as sh
from repro_torch.models import model as M
from repro_torch.models import steps as S
from repro_torch.optim import AdamWConfig, abstract_train_state
from repro_torch.tree import walk


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract batch inputs for an (arch, shape) cell (train / prefill),
    as ``meta`` tensors."""
    B, Sq = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.param_dtype)
    text = Sq
    specs: Dict[str, Any] = {}
    if cfg.frontend == "vision_stub":
        text = Sq - cfg.num_prefix_tokens
        specs["prefix_embeds"] = _meta((B, cfg.num_prefix_tokens,
                                        cfg.d_model), dt)
    if cfg.frontend == "audio_stub":
        specs["encoder_embeds"] = _meta((B, cfg.num_prefix_tokens,
                                         cfg.d_model), dt)
    specs["tokens"] = _meta((B, text), torch.int32)
    return specs


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    step_name: str
    fn: Callable             # the step callable
    args: Tuple[Any, ...]    # placed meta DTensors (decode: pos, an int)
    mesh: Any


def mesh_info(cfg: ArchConfig, shape: ShapeConfig, mesh) -> M.MeshInfo:
    return M.MeshInfo(mesh=mesh, dp_axes=mesh_lib.dp_axes(mesh),
                      ep_axis="model")


def reduced_depth(cfg: ArchConfig, k: int) -> ArchConfig:
    """Same arch with k superblocks (the reference's FLOPs extrapolation
    probes; the port traces every layer unrolled, and its tests hold the
    extrapolation from k = 1, 2 equal to the direct count)."""
    head, p, n_super, tail = cfg.plan_blocks()
    enc = 0
    if cfg.enc_dec and n_super:
        enc = k * (cfg.num_encoder_layers // n_super)
    return dataclasses.replace(cfg, num_layers=head + k * p + tail,
                               num_encoder_layers=enc)


def _cache_meta(tree):
    if isinstance(tree, dict):
        return {k: _cache_meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cache_meta(v) for v in tree]
    return _meta(*tree)


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               opt: Optional[AdamWConfig] = None) -> Cell:
    """The step of ``shape.step`` and its placed ``meta`` inputs.  A
    decode step writes position ``seq_len - 1`` (its ``pos`` is a host
    int, as the port's decode takes it) and attends to every earlier
    one."""
    opt = opt or AdamWConfig(state_dtype=cfg.opt_dtype)
    mi = mesh_info(cfg, shape, mesh)
    B = shape.global_batch
    params = M.abstract_params(cfg)
    if shape.step == "train":
        state = sh.distribute(abstract_train_state(params, opt),
                              sh.train_state_specs(cfg, mesh), mesh)
        batch = sh.distribute(input_specs(cfg, shape),
                              sh.batch_specs(cfg, mesh, B), mesh)
        return Cell(cfg.name, shape.name, "train_step",
                    S.make_train_step(cfg, opt, mi), (state, batch), mesh)
    params = sh.distribute(params, sh.param_specs(cfg, mesh), mesh)
    if shape.step == "prefill":
        batch = sh.distribute(input_specs(cfg, shape),
                              sh.batch_specs(cfg, mesh, B), mesh)
        fn = S.make_prefill_step(cfg, max_len=shape.seq_len, mesh_info=mi)
        return Cell(cfg.name, shape.name, "prefill_step", fn,
                    (params, batch), mesh)
    # decode: one new token against a seq_len-deep KV cache
    cache = sh.distribute(_cache_meta(M.cache_specs(cfg, B, shape.seq_len)),
                          sh.cache_specs_tree(cfg, mesh, B), mesh)
    b = mesh_lib.dp_axes(mesh) if sh.batch_sharded(B, mesh) else None
    tokens = sh.distribute(_meta((B, 1), torch.int32), sh.P(b, None), mesh)
    return Cell(cfg.name, shape.name, "decode_step",
                S.make_decode_step(cfg, mesh_info=mi),
                (params, cache, tokens, shape.seq_len - 1), mesh)


# ------------------------------------------------------------------ trace
_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}
_NO_ACCESS = {torch.ops.aten.empty.memory_format,
              torch.ops.aten.empty_strided.default,
              torch.ops.aten.empty_like.default,
              torch.ops.aten._unsafe_view.default,
              torch.ops.aten.detach.default,
              torch.ops.aten.lift_fresh.default}
# kind of each collective op, as the reference's HLO names them
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d._allgather_base_": "all-gather",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
}
_SKIP = ("_c10d_functional.wait_tensor",
         "_c10d_functional._wrap_tensor_autograd")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _group_size(args) -> int:
    """The group of a collective call: a c10d ``ProcessGroup`` argument
    (boxed), else the name of a group (the functional collectives)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:        # the reduce op, also boxed
                pass
    for a in reversed(args):
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    raise ValueError("a collective without a group")


class Recorder(TorchDispatchMode):
    """Counts the local ops of a step (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: List[Dict[str, Any]] = []
        self.products: List[Tuple[str, Tuple, float]] = []
        self.live = 0
        self.peak = 0

    def _born(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._died, n)

    def _died(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor lowers it first
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                      # DTensor's propagation
        name = func._schema.name.replace("::", ".")
        if name in _SKIP:
            return out
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            data = [t for t in ins if t.numel()]
            self.collectives.append({
                "kind": kind, "group": _group_size(list(args)),
                "in_bytes": _nbytes(data[-1]) if data else 0,
                "out_bytes": _nbytes(outs[0]) if outs and not
                func._schema.is_mutable else (_nbytes(data[0])
                                              if data else 0),
                "dtype": str((data or outs)[0].dtype)})
            for t in outs:
                if not func._schema.is_mutable:
                    self._born(t)
            return out
        if func in _PRODUCTS:
            a, b = args[-2], args[-1]
            fl = 2.0 * outs[0].numel() * a.shape[-1]
            self.flops += fl
            self.products.append((name, tuple(a.shape) + (b.shape[-1],), fl))
        if func.is_view or func in _NO_ACCESS:
            return out
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if not func._schema.is_mutable:
            for t in outs:
                self._born(t)
        return out


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


def uneven_leaves(cell: Cell) -> List[str]:
    """The input leaves with a dim that its mesh axes do not divide."""
    out = []
    for key, _, leaf in walk(list(cell.args)):
        if isinstance(leaf, DTensor):
            sizes = [1] * leaf.dim()
            for i, p in enumerate(leaf.placements):
                if p.is_shard():
                    sizes[p.dim] *= leaf.device_mesh.size(i)
            if any(n % s for n, s in zip(leaf.shape, sizes)):
                out.append(key)
    return out


def trace_cell(cell: Cell) -> Dict[str, Any]:
    """Run the cell's step once on ``meta`` under the ``Recorder``; the
    per-device counts and the host seconds it took."""
    args_bytes = _local_bytes(cell.args)
    arg_ids = {id(t) for t in _tensors(cell.args)}
    rec = Recorder()
    t0 = time.perf_counter()
    with rec:
        out = cell.fn(*cell.args)
    trace_s = time.perf_counter() - t0
    new_out = [t for t in _tensors(out) if id(t) not in arg_ids]
    return {"flops": rec.flops, "bytes accessed": rec.bytes,
            "collectives": rec.collectives, "products": rec.products,
            "argument_bytes": args_bytes,
            "output_bytes": _local_bytes(new_out),
            "temp_bytes": rec.peak, "trace_s": trace_s}


def cost_analysis_dict(trace: Dict[str, Any]) -> Dict[str, float]:
    """Per-device ``"flops"`` and ``"bytes accessed"`` of a trace, under
    the keys ``Compiled.cost_analysis()`` uses."""
    return {"flops": trace["flops"],
            "bytes accessed": trace["bytes accessed"]}
