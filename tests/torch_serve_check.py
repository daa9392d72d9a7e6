"""The full-width sharded serving run with its check against the plain
partial route, as a rank function for ``launch.mesh.spawn_local``.

``serve_check_rank`` runs ``launch.local.serve_full`` (the timed serve:
init, prefill, decode), then reruns its first decode steps from copies
of the caches they read, with the decode attention's plain partial
(``ref.decode_attention_partial_ref``) put in place of the kernel's
partial mode for the comparison.  The swap is made here, in the test's
own rank function, never on the port's path.

Shared by ``tests/test_torch_sharded_decode.py`` (reduced, on CPU gloo
ranks) and ``tests/test_torch_cuda.py`` (full width, one card a rank).
Imports torch, numpy and the port only: a spawned rank imports it by
name, where JAX may not be installed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.decode_attention import ops as DO
from repro_torch.kernels.decode_attention import ref as DR
from repro_torch.launch import local
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.tree import tree_map


def flipped_tokens(a, b, n_tokens: int) -> np.ndarray:
    """Which of this rank's ``n_tokens`` tokens sit in a different set of
    expert slots in routing ``a`` than in ``b`` (each a list of
    ``(buf_tok, cap, El)``, one a ``moe_ep`` layer): a top-k choice that
    flipped, or a pair that capacity dropped in one routing only."""
    out = np.zeros(n_tokens, bool)
    for (ta, cap, n_exp), (tb, _, _) in zip(a, b):
        ta, tb = ta.tolist(), tb.tolist()
        for e in range(n_exp):
            sa = set(ta[e * cap:(e + 1) * cap]) - {n_tokens}
            sb = set(tb[e * cap:(e + 1) * cap]) - {n_tokens}
            out[list(sa ^ sb)] = True
    return out


def serve_check_rank(rank: int, n: int, arch: str, shape: Tuple[int, ...],
                     axes: Tuple[str, ...], out_dir: str, batch: int = 4,
                     prompt_len: int = 1024, max_len: int = 8192,
                     steps: int = 32, checked: int = 2, seed: int = 0,
                     device: str = "cuda", reduced: bool = False) -> None:
    """``local.serve_full``'s record, and each of the first ``checked``
    decode steps again from a copy of the cache it read, on its token:
    once by the kernel route, each attention call beside the plain
    partial route on the same inputs; once by the plain partial route.
    Outputs, besides the record: the reruns' logits (``check_kernel``,
    ``check_plain``), each attention call's largest difference between
    the routes and the plain route's largest value (``attn_err``,
    ``attn_scale``), and ``flipped`` (``checked``, tokens): the tokens of
    this rank's batch block whose ``moe_ep`` routing differs between the
    two reruns on this rank."""
    mesh = make_mesh(shape, axes, device)
    rec, run = local.serve_full(arch, mesh, batch, prompt_len, max_len,
                                steps, seed, reduced, keep=checked)
    params, decode, tspec = run["params"], run["decode"], run["tspec"]
    n_tokens = run["fed"][0].shape[0]     # one token a row of this block

    def rerun():
        """The checked steps again: their logits, and each step's
        ``moe_ep`` slot tokens on this rank (its routing)."""
        logs, routes = [], []
        for i in range(checked):
            L.DISPATCH = []
            lg, _ = decode(params, tree_map(lambda t: t.clone(),
                                            run["caches"][i]),
                           sh.distribute(run["fed"][i], tspec["tokens"],
                                         mesh), run["positions"][i])
            logs.append(sh.full(lg))
            routes.append([(r[0], r[2], r[4]) for r in L.DISPATCH])
        L.DISPATCH = None
        return local._host(torch.cat(logs, 1)), routes
    real, kernel_partial = DO.decode_attention, DO.partial

    def plain_partial(q, k, v, pos, window, offset):
        return DR.decode_attention_partial_ref(q, k, v, pos, window, offset)
    errs, scales = [], []

    def both_routes(*args, **kw):
        """The kernel route's attention, and beside it the plain partial
        route's on the same inputs: their largest difference."""
        o = real(*args, **kw)
        DO.partial = plain_partial
        try:
            w = real(*args, **kw).full_tensor().float()
        finally:
            DO.partial = kernel_partial
        errs.append(float((o.full_tensor().float() - w).abs().max()))
        scales.append(float(w.abs().max()))
        return o
    DO.decode_attention = both_routes
    try:
        kern_logits, kern_routes = rerun()
    finally:
        DO.decode_attention = real
    DO.partial = plain_partial
    try:
        plain_logits, plain_routes = rerun()
    finally:
        DO.partial = kernel_partial
    flipped = np.stack([flipped_tokens(a, b, n_tokens)
                        for a, b in zip(kern_routes, plain_routes)])
    local._save(out_dir, rank, **rec, check_kernel=kern_logits,
                check_plain=plain_logits, attn_err=np.asarray(errs),
                attn_scale=np.asarray(scales), flipped=flipped)
