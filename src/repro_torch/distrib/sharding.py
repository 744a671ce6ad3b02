"""Sharding rules: logical axes -> physical mesh axes, per architecture;
the JAX package's ``distrib/sharding.py`` over a ``torch.distributed``
``DeviceMesh``.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
Logical axes used by ParamDefs: "tp" (tensor), "fsdp" (ZeRO-3-style param
shard), "ep" (experts), "stack" (scanned layer dim, never sharded), "sp"
(sequence parallel, activations only).

A dimension is only sharded when divisible (see params._resolve_axis), so
small models degrade gracefully to replication.

A spec is the port's own :class:`PartitionSpec`, which holds, per
dimension, what JAX's holds: ``None``, one mesh axis name, or a tuple of
names, and compares equal to JAX's entry by entry. :func:`placements`
turns it into DTensor placements on a mesh; :func:`constrain` is what
the model's ``cst`` hooks call where JAX calls
``with_sharding_constraint``.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.params import param_specs

FSDP_MIN_PARAMS = 6e9   # below this, parameters are replicated across "data"


class PartitionSpec(tuple):
    """Per dimension ``None``, a mesh axis name, or a tuple of names,
    normalized as JAX normalizes its ``PartitionSpec``: a one-name tuple
    becomes the name, an empty one ``None``."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return None if not p else (p[0] if len(p) == 1 else p)
            return p
        return super().__new__(cls, (norm(p) for p in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (or of anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: a dimension on one mesh
    axis is ``Shard(d)`` on that mesh dimension; a dimension on several,
    such as ("pod", "data"), ``Shard(d)`` on each, which DTensor splits
    in mesh order, as JAX splits in the tuple's order (so the tuple must
    list them in mesh order); every other mesh dimension is
    ``Replicate()``."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of mesh order "
                             f"{tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class _Constrain(torch.autograd.Function):
    """Redistribution to fixed placements whose backward redistributes the
    gradient to the same placements: the transpose of JAX's sharding
    constraint, which pins the cotangent too (DTensor's own
    ``redistribute`` would hand the gradient back in the input's layout,
    or in whatever layout the ops behind it chose)."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.redistribute(x.device_mesh, pl) if tuple(x.placements) != pl \
            else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.pl:
            g = g.redistribute(g.device_mesh, ctx.pl)
        return g, None


def constrain(x, spec):
    """``x`` redistributed to ``spec`` on its mesh when it is a DTensor,
    its gradient pinned to the same layout; anything else is returned as
    it is."""
    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, placements(spec, x.device_mesh))


def settle(x: DTensor) -> DTensor:
    """``x`` with its pending partial sums reduced (``Partial`` ->
    ``Replicate``), its shards as they are; its gradient comes back in
    that layout (the gradient of a sum of partial values is the whole
    gradient on every rank)."""
    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    return _Constrain.apply(x, tuple(
        Replicate() if isinstance(p, Partial) else p for p in x.placements))


def _as_dtensor(t, mesh):
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _plan(subs, ops, outs, letters, mesh):
    """Placements for running a function of ``ops`` (index letters
    ``subs``) shard by shard, with outputs indexed ``outs``: on each mesh
    dimension one letter of ``letters`` is sharded, chosen among those
    the operands already shard there: a letter of an output before one
    that is not, then the one the most operand elements shard. Every
    operand that has the letter is sharded on it there, every other one
    replicated; a letter is not chosen where an operand's dimension does
    not divide evenly. Returns the operands' placements, their
    gradients' (partial where an operand is replicated and others
    sharded) and the outputs' (``Partial()`` on a mesh dimension whose
    letter an output lacks)."""
    ways: dict[tuple[int, int], int] = {}       # (operand, dim) -> split
    want = [[Replicate()] * mesh.ndim for _ in ops]
    grad = [[Replicate()] * mesh.ndim for _ in ops]
    out_pl = [[Replicate()] * mesh.ndim for _ in outs]
    for m in range(mesh.ndim):
        n = mesh.size(m)
        held: dict[str, int] = {}
        for sub, o in zip(subs, ops):
            pl = o.placements[m]
            if isinstance(pl, Shard) and sub[pl.dim] in letters:
                held[sub[pl.dim]] = held.get(sub[pl.dim], 0) + o.numel()

        def fits(c):
            return all(o.shape[sub.index(c)]
                       % (ways.get((i, sub.index(c)), 1) * n) == 0
                       for i, (sub, o) in enumerate(zip(subs, ops))
                       if c in sub)
        cands = [c for c in held if fits(c)]
        if not cands:
            continue
        c = max(cands, key=lambda c: (any(c in o for o in outs), held[c]))
        for i, (w, sub) in enumerate(zip(want, subs)):
            if c in sub:
                w[m] = grad[i][m] = Shard(sub.index(c))
                ways[i, sub.index(c)] = ways.get((i, sub.index(c)), 1) * n
            else:
                # each rank's gradient sums over its slice of c only
                grad[i][m] = Partial()
        for pl, o in zip(out_pl, outs):
            pl[m] = Shard(o.index(c)) if c in o else Partial()
    return want, grad, out_pl


def local_einsum(eq: str, *ops, dtype=None):
    """``torch.einsum(eq, *ops)`` over DTensors, run shard by shard in a
    ``local_map`` region: DTensor has no einsum rule, and its
    decomposition into views and ``bmm`` fails on the strided layouts
    that merging a batch-sharded and a head-sharded dimension makes.

    Any index letter may be the one sharded on a mesh dimension
    (:func:`_plan`): a weight sharded on a contracted dimension against a
    batch-sharded activation is all-gathered (FSDP's gather), and where
    the letter kept is contracted the shards' results are partial sums,
    summed at once (an all-reduce) as the single-device product sums
    them in its own precision. Operands that are not DTensors are
    replicated. With ``dtype`` the operands are cast inside the region,
    after any gather, so a bf16 weight moves as bf16."""
    ins, out = eq.replace(" ", "").split("->")
    y, = local_region(lambda *ts: (torch.einsum(eq, *(
        t if dtype is None else t.to(dtype) for t in ts)),),
        ins.split(","), [out], *ops, parallel=ins.replace(",", ""))
    return settle(y)


def local_region(fn, ins: list[str], outs: list[str], *ops, parallel: str):
    """``fn(*ops)``, which returns a tuple of tensors indexed ``outs``, run
    shard by shard in a ``local_map`` region where ``fn`` is independent
    across the letters of ``parallel``: each mesh dimension shards at most
    one of them (:func:`_plan`), every other dimension of every operand
    is gathered whole, and ``fn`` sees each rank's slices. The prefill
    attention (independent across batch and heads; K/V heads carry the
    query heads' letter, and shard only where their count divides) and
    the chunked SSD scan (across batch, heads and head dims) run so:
    DTensor's rules have no layout for their grouped-head reshapes and
    per-chunk loop. Returns the outputs as DTensors."""
    mesh = next(o.device_mesh for o in ops if isinstance(o, DTensor))
    ops = [_as_dtensor(o, mesh) for o in ops]
    bad = [i for i, o in enumerate(ops) if len(o.placements) != mesh.ndim]
    if bad:
        raise RuntimeError(f"local_region {ins}: operands {bad} carry "
                           f"{[ops[i].placements for i in bad]} on a "
                           f"{mesh.ndim}-dimensional mesh")
    want, grad, out_pl = _plan(ins, ops, outs, parallel, mesh)
    return local_map(fn, out_placements=tuple(out_pl),
                     in_placements=tuple(want),
                     in_grad_placements=tuple(grad), device_mesh=mesh,
                     redistribute_inputs=True)(*ops)


def reshape(x: DTensor, shape) -> DTensor:
    """``x.reshape(shape)`` in a layout DTensor's other rules accept.
    Merging a sharded dimension into a larger one from behind, or
    splitting it into a first part its ranks do not divide, gives a
    strided layout (which later redistributions cannot handle) or an
    error; then every mesh dimension that shards a dimension the reshape
    changes is gathered whole first, and the dimensions ahead of them
    that it keeps stay sharded."""
    from torch.distributed.tensor.placement_types import _StridedShard
    try:
        y = x.reshape(shape)
        if not any(isinstance(p, _StridedShard) for p in y.placements):
            return y
    except RuntimeError:
        pass
    new = torch.empty(x.shape, device="meta").reshape(shape).shape
    keep = 0
    while keep < min(len(new), x.ndim) and new[keep] == x.shape[keep]:
        keep += 1
    pl = [Replicate() if isinstance(p, Shard) and p.dim >= keep else p
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl).reshape(shape)


def replicated(fn, *args, outputs: int = 1):
    """``fn(*args)`` run on whole replicas in a ``local_map`` region: each
    DTensor argument is redistributed to ``Replicate()`` (an all-gather
    of its shards) and ``fn`` gets its local tensor, the whole value, as
    the single-device code does; each of the ``outputs`` tensors ``fn``
    returns comes back as a replicated DTensor. For the regions DTensor
    has no rule for, where the result depends on every element: the
    MoE's routing (sorts and a scatter-add over all tokens), and its
    ``index_put`` dispatch and gather where the plan gives no
    expert-parallel layout."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    rep = [Replicate()] * mesh.ndim
    fn_l = local_map(fn, out_placements=rep if outputs == 1
                     else (rep,) * outputs,
                     in_placements=tuple(rep if isinstance(a, torch.Tensor)
                                         else None for a in args),
                     device_mesh=mesh, redistribute_inputs=True)
    return fn_l(*args)


def _block(shape, mesh, pl):
    """(local shape, global offset) of this rank's block of a tensor of
    ``shape`` placed ``pl`` on ``mesh``: each sharding mesh dimension, in
    mesh order, cuts the dimension as ``torch.chunk`` does."""
    size, offset = list(shape), [0] * len(shape)
    for p, n, r in zip(pl, mesh.shape, mesh.get_coordinate()):
        if isinstance(p, Shard):
            d = p.dim
            chunk = -(-size[d] // n)
            lo = min(r * chunk, size[d])
            offset[d] += lo
            size[d] = min(size[d], lo + chunk) - lo
    return tuple(size), tuple(offset)


def _local_slots(slot, C: int, block, offset):
    """Each entry's row in this rank's (El, Cl) block of the (E, C)
    dispatch buffer, and whether the block holds it (a dropped entry's
    slot, E * C, lies in none)."""
    (El, Cl, _), (e0, c0, _) = block, offset
    e, c = slot // C, slot % C
    mine = (e >= e0) & (e < e0 + El) & (c >= c0) & (c < c0 + Cl)
    return ((e - e0) * Cl + (c - c0)).clamp(0, El * Cl - 1), mine


def expert_dispatch(x: DTensor, slot: DTensor, E: int, C: int, spec):
    """The MoE's (E, C, D) dispatch buffer in its expert-parallel layout
    ``spec``, built shard by shard in a ``local_map`` region: every rank
    gathers the tokens ``x`` (B, S, D) and takes the routing's slots
    (replicated), and fills only its own block of experts and capacity
    rows, one index_put a k (so no (T K, D) copy of the tokens), where a
    replicated buffer would hold every row on every rank. Each rank's
    gradient of the tokens covers its block's entries: partial."""
    mesh, D = x.device_mesh, x.shape[-1]
    pl = placements(spec, mesh)
    block, offset = _block((E, C, D), mesh, pl)
    El, Cl = block[0], block[1]

    def fill(x, slot):
        xt = x.reshape(-1, D)
        K = slot.shape[0] // xt.shape[0]
        local, mine = _local_slots(slot, C, block, offset)
        rows = torch.where(mine, local, El * Cl).reshape(-1, K)
        buf = xt.new_zeros((El * Cl + 1, D))
        for k in range(K):
            buf.index_put_((rows[:, k],), xt)
        return buf[:El * Cl].reshape(El, Cl, D)

    rep = [Replicate()] * mesh.ndim
    part = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    return local_map(fill, out_placements=list(pl), in_placements=(rep, rep),
                     in_grad_placements=(part, rep), device_mesh=mesh,
                     redistribute_inputs=True)(x, slot)


def expert_combine(ye: DTensor, w: DTensor, slot: DTensor, like: DTensor):
    """Each token's K weighted expert outputs from ``ye`` (E, C, D) fp32
    in its expert-parallel layout, summed shard by shard: every rank adds,
    in k order onto zeros, the entries its block holds (0 for the rest),
    and the ranks' partial sums are reduced into the layout of ``like``
    (the MoE's input, (B, S, D)), as one sum over every entry."""
    mesh = ye.device_mesh
    E, C, D = ye.shape
    pl = list(ye.placements)
    block, offset = _block((E, C, D), mesh, pl)
    El, Cl = block[0], block[1]

    def add(ye, w, slot):
        T, K = w.shape
        local, mine = _local_slots(slot, C, block, offset)
        local, mine = local.reshape(T, K), mine.reshape(T, K)
        flat = ye.reshape(El * Cl, D)
        out = torch.zeros((T, D), dtype=ye.dtype, device=ye.device)
        for k in range(K):
            out = out + torch.where(mine[:, k, None], flat[local[:, k]],
                                    0.0) * w[:, k, None]
        return out.reshape(like.shape)

    rep = [Replicate()] * mesh.ndim
    part = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    out = local_map(add, out_placements=part, in_placements=(pl, rep, rep),
                    in_grad_placements=(pl, part, rep), device_mesh=mesh,
                    redistribute_inputs=True)(ye, w, slot)
    return _Constrain.apply(out, tuple(like.placements))


def split_local(x: DTensor, n: int) -> list:
    """``x`` cut into ``n`` parts along dimension 0 shard by shard, in a
    ``local_map`` region: part i holds the i-th slice of every shard and
    keeps ``x``'s placements, so no rank sends anything. (Cutting the
    global dimension instead would leave part i on a fraction of the
    ranks sharding it.)"""
    pl = list(x.placements)

    def cut(t):
        return tuple(t.reshape((n, t.shape[0] // n) + t.shape[1:])
                     .unbind(0))
    return list(local_map(cut, out_placements=(pl,) * n,
                          in_placements=(pl,), device_mesh=x.device_mesh)(x))


def sharding_rules(cfg: ModelConfig, sizes: dict[str, int],
                   *, force_fsdp: bool | None = None) -> dict[str, tuple[str, ...]]:
    n = M.count_model_params(cfg)
    use_fsdp = force_fsdp if force_fsdp is not None else n >= FSDP_MIN_PARAMS
    fsdp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    mdl = ("model",) if "model" in sizes else ()
    return {
        "tp": mdl,
        # fallback: if the primary tp dim (heads) isn't divisible, the next
        # tagged dim (head_dim / expert ff) takes the model axis instead —
        # param_specs drops duplicate axis uses, so exactly one wins.
        "tp2": mdl,
        "ep": mdl,
        "fsdp": fsdp_axes if use_fsdp else (),
        "stack": (),
        "sp": mdl,
    }


def batch_axes(sizes: dict[str, int], global_batch: int):
    """Mesh axes to shard the batch over (largest divisible prefix of
    (pod, data), optionally extended by model for pure-DP small models)."""
    axes = [a for a in ("pod", "data") if a in sizes]
    total = 1
    used = []
    for a in axes:
        if global_batch % (total * sizes[a]) == 0:
            used.append(a)
            total *= sizes[a]
    return tuple(used)


def model_param_specs(cfg: ModelConfig, mesh, **kw):
    sizes = mesh_sizes(mesh)
    rules = sharding_rules(cfg, sizes, **kw)
    return param_specs(M.model_defs(cfg), rules, sizes)


def activation_shardings(cfg: ModelConfig, mesh, shape: ShapeConfig,
                         *, sequence_parallel: bool | None = None,
                         grad_accum: int = 1):
    """Specs for the ``cst`` hooks inside the model."""
    sizes = mesh_sizes(mesh)
    bax = batch_axes(sizes, shape.global_batch)
    if sequence_parallel is None:
        # SP pays off when activations dominate: long sequences / big d_model
        sequence_parallel = (shape.seq_len * cfg.d_model >= 4096 * 4096
                             and not shape.is_decode)
    seq_ax = "model" if (sequence_parallel and "model" in sizes
                         and shape.seq_len % sizes["model"] == 0) else None
    bspec = bax if bax else None
    mdl = "model" if "model" in sizes else None
    # logits: prefer vocab sharding; under sequence parallelism the seq dim
    # already takes "model", so the vocab dim must stay unsharded.
    logits_spec = P(bspec, seq_ax, None) if seq_ax else P(bspec, None, mdl)
    moe_spec = None
    if (cfg.num_experts and "model" in sizes
            and cfg.num_experts % sizes["model"] == 0):
        # (E, C, D): experts over model AND capacity rows over data — E-only
        # sharding leaves every device holding all tokens' dispatch rows
        # (measured: no flops change vs the unconstrained baseline); 2-D
        # sharding keeps tokens data-parallel through the expert matmuls.
        dax = tuple(a for a in ("pod", "data") if a in sizes)
        moe_spec = P("model", dax if dax else None, None)
    # heads not divisible by tp: sharding head_dim instead makes the score
    # einsums contract a sharded dim (all-reduce per KV block per layer —
    # measured 19.4 GB/layer on llama3.2-3b). Fallback: run the attention
    # region data-parallel over BOTH axes (batch divisible by data*model).
    attn_spec = None
    if cfg.num_heads and "model" in sizes \
            and cfg.num_heads % sizes["model"] != 0 and not shape.is_decode:
        full = math.prod(sizes.values())
        # must divide the MICROBATCH, not the global batch — otherwise GSPMD
        # pads the attention region (measured: 5x flops inflation on 3B)
        if (shape.global_batch // max(grad_accum, 1)) % full == 0:
            attn_spec = P(tuple(sizes.keys()), None, None, None)
    return {
        "residual": P(bspec, seq_ax, None),
        "kv_cache": P(bspec, mdl, None, None),
        "logits": logits_spec,
        "moe_dispatch": moe_spec,
        "attn_qkv": attn_spec,
    }


def cache_specs(cfg: ModelConfig, mesh, shape: ShapeConfig):
    """PartitionSpec tree matching model.cache_shapes: batch over data
    axes, cache sequence dim over model (distributed decode attention).
    Any axis whose size isn't divisible by its mesh axes is replicated."""
    sizes = mesh_sizes(mesh)
    bax = batch_axes(sizes, shape.global_batch)
    mdl = "model" if "model" in sizes else None

    shapes = M.cache_shapes(cfg, shape.global_batch, shape.seq_len)

    def fit(axis, dim):
        if axis is None:
            return None
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        if not names:
            return None
        n = math.prod(sizes[a] for a in names)
        return axis if (n > 1 and dim % n == 0) else None

    def spec_for(nm, shp):
        nd = len(shp)
        bspec = bax if bax else None
        if nm in ("k", "v", "xk", "xv"):          # (B, S, KV, hd) [+nb]
            want = [bspec, mdl, None, None]
        elif nm in ("ckv", "kr"):                  # (B, S, R) [+nb]
            want = [bspec, mdl, None]
        elif nm == "state":                        # (B, H, P, N) [+nb]
            want = [bspec, mdl, None, None]
        elif nm == "conv":                         # (B, W-1, C) [+nb]
            want = [bspec, None, None]
        else:
            want = [None] * nd
        if nd == len(want) + 1:
            want = [None] + want                   # stacked over blocks
        return P(*[fit(a, d) for a, d in zip(want, shp)])

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (walk(v) if isinstance(v, dict) else spec_for(k, v))
                    for k, v in tree.items()}
        return tree

    return walk(shapes)


def check_divisibility(cfg: ModelConfig, mesh, shape: ShapeConfig) -> list[str]:
    """Human-readable notes on what falls back to replication."""
    sizes = mesh_sizes(mesh)
    notes = []
    tp = sizes.get("model", 1)
    if cfg.num_heads and cfg.num_heads % tp:
        notes.append(f"attn heads {cfg.num_heads} replicated (tp={tp})")
    if cfg.num_experts and cfg.num_experts % tp:
        notes.append(f"experts {cfg.num_experts} TP-sharded on d_ff instead of EP")
    if cfg.ssm_state_dim and M.n_scan_blocks(cfg) and cfg.ssm_num_heads % tp:
        notes.append(f"ssm heads {cfg.ssm_num_heads} replicated (tp={tp})")
    if not batch_axes(sizes, shape.global_batch):
        notes.append(f"batch {shape.global_batch} unshardable -> replicated")
    return notes
