"""Dry run of H100 meshes: plan every (arch x shape) cell on ``meta``
tensors, estimate its per-rank memory and its roofline terms, the JAX
package's ``repro.launch.dryrun`` for NVIDIA H100 SXM cards.

The reference lowers and compiles each cell for TPU v5e meshes of forced
host devices and reads XLA's ``memory_analysis`` and ``cost_analysis``.
Torch has no compiler to ask, so the port counts and estimates:

  * **Meshes** of ``torch.device("meta")`` ranks (``make_mesh_for``):
    16 x 16 ('data', 'model'), or 2 x 16 x 16 ('pod', 'data', 'model') with
    ``--multi-pod``.
  * **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over the
    port's own value-and-grad of ``LM.loss`` (train, remat full) or its
    forward (prefill; decode against a full cache) on parameters from
    ``init_params(..., device="meta")``: shapes without memory.  ``ops``
    routes ``meta`` tensors to K4's and K5's plain versions, so attention
    counts every (query, key) product of each call, as the reference's jnp
    path does, not the causal half K4 computes.  As in the reference's
    calibration, the count runs at G = 1 and G = 2 layer groups and one
    microbatch and is extrapolated, ``X(G) = X(1) + (G - 1)(X(2) - X(1))``
    (exact for identical groups), times the microbatches, plus AdamW
    analytically.  The count is global; a rank's share is 1 / chips of it.
  * **Memory**: meta tensors have no allocator, so the reference's
    compiled "proof" becomes an analytic estimate (keys ending in
    ``_estimate``, ``memory_estimate``): the state's bytes per rank from the
    partition specs plus the step's transient peak.
  * **HBM bytes**: ``analytic_hbm_bytes``, the reference's model, verbatim.
  * **Collective bytes**: the reference parses XLA's HLO text.  Here they
    follow from the partition specs (``collective_bytes_analytic``) with the
    ring accounting of the reference's ``collective_bytes``.

Hardware model (NVIDIA H100 SXM data sheet, dense, 700 W): 989 TFLOP/s
bf16, 3.35 TB/s HBM3, NVLink 4 at 900 GB/s a card both ways together
(450 GB/s one way).  A 256-card mesh spans 32 eight-card nodes, whose
links between nodes are slower: ``t_collective_s`` is the NVLink bound.

Reference keys that no longer mean anything are renamed: the HLO FLOPs
become ``flops_per_chip`` (counted), ``model_vs_hlo`` becomes
``model_vs_counted``; ``hlo_bytes_per_chip_upper`` and
``t_memory_upper_s`` (XLA:CPU's unfused byte count) have no counterpart.

Run: ``PYTHONPATH=src python -m repro_torch.launch.dryrun --arch
smollm-135m --shape train_4k`` (CPU only; writes ``<out>/<arch>_<shape>_
single.json``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, cells, get_config
from repro_torch.launch.mesh import Mesh, make_mesh_for, set_mesh
from repro_torch.models.config import SHAPES, ArchConfig, ShapeSpec
from repro_torch.models.lm import LM, init_params, padded_vocab
from repro_torch.train import train_step as _ts
from repro_torch.train._lm_pspecs import param_pspecs
from repro_torch.train.hgnn_step import value_and_grad
from repro_torch.train.tree import flatten_up_to, tree_flatten

# ----------------------------------------------------------- constants ----
PEAK_FLOPS = 989e12  # bf16 per card, dense (chip_smoke.py's BF16_FLOP_PER_S)
HBM_BW = 3.35e12  # bytes/s per card (chip_smoke.py's HBM_BYTES_PER_S)
NVLINK_BW = 450e9  # bytes/s per card one way: NVLink 4, 900 GB/s both ways
HBM_BYTES = 80e9  # one H100 SXM card's memory
MESH_SHAPE = (16, 16)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def meta_mesh(multi_pod: bool = False, shape=MESH_SHAPE) -> Mesh:
    """The production mesh over ``meta`` ranks: ``shape`` ('data', 'model'),
    or ('pod', 'data', 'model') with a leading 2 with ``multi_pod``."""
    shape = ((2,) if multi_pod else ()) + tuple(shape)
    axes = (("pod",) if multi_pod else ()) + ("data", "model")
    return make_mesh_for([torch.device("meta")] * math.prod(shape), shard_axes=axes,
                         shape=shape)


def _microbatches(cfg: ArchConfig, spec: ShapeSpec, mesh: Mesh) -> int:
    """One batch row per data shard per microbatch (bounds activations +
    full-vocab logits independently of model size)."""
    dp_total = int(np.prod([mesh.shape[a] for a in ("pod", "data")
                            if a in mesh.axis_names]))
    return max(1, spec.global_batch // dp_total)


# ------------------------------------------------------------ analysis ----
def _analytic_adamw(cfg: ArchConfig) -> Dict[str, float]:
    n = cfg.param_count()
    return {"flops": 15.0 * n, "bytes": 22.0 * n}  # p(2B)+m,v(16B) rw + upd


def analytic_hbm_bytes(cfg: ArchConfig, spec: ShapeSpec, mesh: Mesh,
                       mb: int, cache_bytes_total: float = 0.0) -> float:
    """Per-chip HBM traffic estimate (the memory roofline term).

    XLA:CPU cost_analysis 'bytes accessed' sums operand+result bytes of
    every HLO op with almost no fusion — a many-fold overcount of real
    HBM<->chip traffic (on TPU most of those are VMEM hits).  We therefore
    model HBM traffic explicitly (and report the HLO number as an upper
    bound):
      * weights: each chip streams its TP shard (1/model) of every weight
        per pass; train does 3 passes per microbatch (fwd, remat-fwd, bwd)
        + fp32 grad write/read + AdamW state (analytic, ZeRO-sharded);
      * activations: ~24 residual-stream reads+writes per layer per token
        (bf16), sharded over the mesh;
      * logits: write+read of the (tokens, V/model) fp32 block per pass;
      * decode: the whole sharded KV/SSM cache is read once, one slot
        written.
    """
    chips = int(np.prod(list(mesh.shape.values())))
    msize = int(mesh.shape.get("model", 1))
    n = cfg.param_count()
    w_pass = 2.0 * n / msize  # bf16 weights read per full pass, per chip
    d = cfg.d_model
    L = cfg.num_layers
    tokens = spec.global_batch * spec.seq_len
    tok_chip = tokens / chips
    act = 24.0 * d * 2.0 * L * tok_chip  # residual-stream traffic
    logits = tok_chip * cfg.vocab_size / msize * 4.0 * 2.0

    if spec.kind == "train":
        grads = 8.0 * n / chips  # fp32 write+read, ZeRO-sharded
        opt = _analytic_adamw(cfg)["bytes"] / chips
        return mb * (3.0 * w_pass) + mb * 3.0 * act + mb * 2.0 * logits + grads + opt
    if spec.kind == "prefill":
        return w_pass + act + logits / spec.seq_len  # last-position logits
    # decode: one token per sequence
    tok_chip = spec.global_batch / chips
    act = 24.0 * d * 2.0 * L * tok_chip
    logits = tok_chip * cfg.vocab_size / msize * 4.0 * 2.0
    return w_pass + act + logits + cache_bytes_total / chips


def _names(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _leaf_shards(params, mesh: Mesh, specs) -> list:
    """``(leaf, spec, number of shards)`` for every parameter leaf: the
    product of the sizes of the mesh axes its spec names (axes the mesh
    lacks count 1)."""
    leaves, treedef = tree_flatten(params)
    out = []
    for leaf, spec in zip(leaves, flatten_up_to(treedef, specs)):
        axes = [a for e in spec for a in _names(e)]
        out.append((leaf, spec, int(np.prod([mesh.shape.get(a, 1) for a in axes] or [1]))))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def state_bytes_per_rank(cfg: ArchConfig, mesh: Mesh) -> Dict[str, float]:
    """Bytes a rank holds of the train state under the partition specs:
    the parameters in their dtypes, AdamW's two float32 moments, and the
    ``GRAD_ACCUM_DTYPE`` gradient accumulator, each leaf over its shards."""
    params = init_params(0, cfg, device="meta")
    specs = param_pspecs(cfg, params, model_axis_size=int(mesh.shape.get("model", 1)))
    acc = torch.empty((), dtype=getattr(torch, _ts.GRAD_ACCUM_DTYPE)).element_size()
    p = sum(_nbytes(x) / s for x, _, s in _leaf_shards(params, mesh, specs))
    n = sum(x.numel() / s for x, _, s in _leaf_shards(params, mesh, specs))
    return {"params": p, "moments": 8.0 * n, "grad_accumulator": acc * n}


def memory_estimate(cfg: ArchConfig, spec: ShapeSpec, mesh: Mesh, mb: int,
                    remat: str = "full") -> Dict[str, Any]:
    """Per-rank memory of a cell, an analytic estimate of what the port
    allocates (no allocator runs on ``meta``).

    Train: the state (``state_bytes_per_rank``), one microbatch's gradients
    in the parameters' dtypes, each group's saved input (remat full; every
    activation of every group without remat), and the largest transient of
    the backward, whichever is larger of: the float32 logits block of the
    loss's backward (the log-softmax output, its gradient and the logits'
    gradient, 12 bytes a logit, vocab-parallel over 'model'), the one-hot
    (tokens, vocab) block of the embedding's gradient (bf16), and one query
    tile of the float32 attention backward (logits, probabilities and their
    gradients, 16 bytes a pair; ``flash_attention.VJP_TILE_ELEMS``).
    Prefill and decode: the parameters and the cache (``init_cache``'s, over
    the chips), a layer's activations
    and, for decode, the attention's float32 (query, key) block over the
    cache (prefill's K4 forms none)."""
    from repro_torch.kernels.flash_attention import VJP_TILE_ELEMS

    chips = int(np.prod(list(mesh.shape.values())))
    msize = int(mesh.shape.get("model", 1))
    dp = chips // msize
    st = state_bytes_per_rank(cfg, mesh)
    vp = padded_vocab(cfg)
    s, d = spec.seq_len, cfg.d_model
    heads = max(cfg.num_heads, 1)
    rows = max(1, spec.global_batch // (mb * dp)) if spec.kind == "train" \
        else max(1, -(-spec.global_batch // dp))
    out: Dict[str, Any] = {"microbatches": mb, "rows_per_rank": rows}
    if spec.kind == "train":
        t = rows * s
        saved = (cfg.num_groups * t * d * 2.0 if remat == "full"
                 else cfg.num_layers * t * (12 * d + 3 * max(cfg.d_ff, cfg.moe_d_ff)) * 2.0)
        tile_rows = s if s * s <= VJP_TILE_ELEMS else max(1, VJP_TILE_ELEMS // s)
        transient = max(12.0 * t * vp / msize, 2.0 * t * vp,
                        16.0 * rows * heads * tile_rows * s if cfg.num_heads else 0.0)
        state = st["params"] + st["moments"] + st["grad_accumulator"]
        act = st["params"] + saved + transient  # a microbatch's gradients + activations
    else:
        b = rows
        t = b * (s if spec.kind == "prefill" else 1)
        cache = _cache_bytes(cfg, spec) / chips if spec.kind == "decode" else 0.0
        # decode's attention over the cache forms (B, H, 1, T) float32 logits
        # and probabilities; prefill's K4 forms no (S, T) block
        attn = 4.0 * 3 * b * heads * s if cfg.num_heads and spec.kind == "decode" else 0.0
        state = st["params"] + cache
        act = t * (12 * d + 3 * max(cfg.d_ff, cfg.moe_d_ff)) * 2.0 + attn
    peak = state + act
    out.update({"state_bytes_per_rank_estimate": state,
                "activation_bytes_per_rank_estimate": act,
                "peak_bytes_per_rank_estimate": peak,
                "peak_hbm_gib_estimate": peak / 2 ** 30,
                "fits_80gb_estimate": bool(peak <= HBM_BYTES)})
    return out


def _ring(kind: str, result: float, g: int) -> float:
    """Bytes a rank sends for one collective whose per-rank result is
    ``result`` bytes over a group of ``g`` ranks (ring algorithm; the
    reference's ``collective_bytes`` accounting)."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return result * (g - 1) / g
    if kind == "reduce-scatter":
        return result * (g - 1)
    if kind == "all-reduce":
        return 2 * result * (g - 1) / g
    if kind == "all-to-all":
        return result * (g - 1) / g
    return result  # collective-permute


def collective_bytes_analytic(cfg: ArchConfig, spec: ShapeSpec, mesh: Mesh,
                              mb: int) -> Dict[str, float]:
    """Per-rank bytes each collective kind sends in one step, from the
    partition specs, with ring accounting (``_ring``):

      * FSDP: each parameter sharded over data axes is all-gathered over
        them once a pass (train: forward, remat forward and backward, per
        microbatch; inference: once), its result the rank's 'model' shard;
      * gradients: reduce-scattered over a leaf's data axes, all-reduced
        over the data axes it is replicated on ('pod', or every data axis
        for a replicated leaf), once a microbatch, in the leaf's dtype;
      * tensor parallelism: a mixer or FFN whose output projection is
        sharded over 'model' all-reduces its (tokens, D) bf16 output over
        'model' once a pass (and its input gradient in the backward); the
        vocab-sharded embedding all-reduces its lookup the same way;
      * expert parallelism: MoE layers all-to-all their dispatched and
        combined tokens (top-k slots at capacity factor 1.25) over
        'model', twice a pass.

    A pass of a train step carries one microbatch, a data rank's
    ``tokens / (data ranks x mb)`` tokens, so the activation terms do not
    grow with ``mb``; the weights' all-gathers do."""
    chips = int(np.prod(list(mesh.shape.values())))
    msize = int(mesh.shape.get("model", 1))
    data_axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    dp = chips // msize
    params = init_params(0, cfg, device="meta")
    specs = param_pspecs(cfg, params, model_axis_size=msize)
    train = spec.kind == "train"
    passes = 3 * mb if train else 1
    # a data rank's tokens in one pass: one microbatch's (mb is 1 off train)
    tokens_pass = spec.global_batch * (spec.seq_len if spec.kind != "decode" else 1) / (dp * mb)
    out = {k: 0.0 for k in _COLLECTIVES}
    for leaf, lspec, shards in _leaf_shards(params, mesh, specs):
        axes = [a for e in lspec for a in _names(e)]
        fsdp = int(np.prod([mesh.shape[a] for a in axes if a in data_axes] or [1]))
        shard = _nbytes(leaf) / shards
        out["all-gather"] += passes * _ring("all-gather", shard * fsdp, fsdp)
        if train:
            out["reduce-scatter"] += mb * _ring("reduce-scatter", shard, fsdp)
            rep = int(np.prod([mesh.shape[a] for a in data_axes if a not in axes] or [1]))
            out["all-reduce"] += mb * _ring("all-reduce", shard, rep)
    act = tokens_pass * cfg.d_model * 2.0
    tp = 0  # layers whose mixer or dense FFN ends in a 'model'-sharded projection
    for pos, (mixer, ffn) in enumerate(cfg.block_pattern):
        blk = specs["blocks"][pos]
        if ffn == "moe":
            slots = tokens_pass * cfg.experts_per_token * 1.25 * cfg.d_model * 2.0
            out["all-to-all"] += 2 * passes * cfg.num_groups * _ring("all-to-all", slots,
                                                                     msize)
        for part, w in (("mixer", "wo"), ("mixer", "w_out"), ("ffn", "w_down")):
            if ffn == "moe" and part == "ffn":
                continue
            if w in blk.get(part, {}) and "model" in _names(blk[part][w][1]):
                tp += cfg.num_groups
    out["all-reduce"] += passes * (tp + 1) * _ring("all-reduce", act, msize)
    return out


def count_flops(cfg: ArchConfig, spec: ShapeSpec, groups: int, batch: int) -> float:
    """FLOPs (``FlopCounterMode``) of the port at ``groups`` layer groups
    over ``batch`` rows on ``meta`` tensors: value-and-grad of ``LM.loss``
    (remat full, the aux weight of the train step) for a train cell, the
    last-position forward for prefill, one decode step against a cache of
    ``seq_len`` for decode."""
    c = dataclasses.replace(cfg, num_layers=groups * len(cfg.block_pattern))
    model = LM(c, device="meta", remat="full")
    params = init_params(0, c, device="meta")
    s = spec.seq_len
    embeds = c.frontend != "none"

    def inputs(b, n):
        if embeds:
            return {"tokens": None,
                    "embeds": torch.empty((b, n, c.d_model), dtype=torch.bfloat16, device="meta")}
        return {"tokens": torch.zeros((b, n), dtype=torch.int32, device="meta")}

    with FlopCounterMode(display=False) as fc:
        if spec.kind == "train":
            tgt = torch.zeros((batch, s), dtype=torch.int32, device="meta")
            value_and_grad(lambda p: model.loss(p, targets=tgt, aux_weight=_ts.AUX_WEIGHT,
                                                **inputs(batch, s)), params)
        elif spec.kind == "prefill":
            model.forward(params, last_only=True, **inputs(batch, s))
        else:
            cache = model.init_cache(batch, s)
            model.forward(params, cache=cache, cache_pos=s - 1, **inputs(batch, 1))
    return float(fc.get_total_flops())


def _cache_bytes(cfg: ArchConfig, spec: ShapeSpec) -> float:
    cache = LM(cfg, device="meta").init_cache(spec.global_batch, spec.seq_len)
    return float(sum(_nbytes(x) for c in cache for x in c.values()))


def roofline_cell(arch: str, shape: str, calibrate: bool = True) -> Dict[str, Any]:
    """One cell on the 16 x 16 meta mesh: the memory estimate (``proof``)
    and, with ``calibrate``, the counted FLOPs and the roofline terms, under
    the ambient mesh (``set_mesh``).  ``variant`` keeps the reference's key
    with its default, no variant."""
    cfg = get_config(arch)
    spec = SHAPES[shape]
    mesh = meta_mesh()
    chips = int(np.prod(list(mesh.shape.values())))
    res: Dict[str, Any] = {"arch": arch, "shape": shape,
                           "mesh": "x".join(map(str, mesh.devices.shape)),
                           "chips": chips,
                           "variant": {"microbatches": None, "attn_impl": None,
                                       "grad_accum_dtype": None}}
    mb = _microbatches(cfg, spec, mesh) if spec.kind == "train" else 1
    with set_mesh(mesh):
        res["proof"] = memory_estimate(cfg, spec, mesh, mb)
        if calibrate:
            b_mb = max(1, spec.global_batch // mb)
            pts = {}
            for g in (1, 2):
                t0 = time.time()
                pts[g] = {"flops": count_flops(cfg, spec, g, b_mb),
                          "count_s": round(time.time() - t0, 3)}
            G = cfg.num_groups

            def lin(a, b_):
                return a + (G - 1) * (b_ - a)

            flops = lin(pts[1]["flops"], pts[2]["flops"]) * mb / chips
            if spec.kind == "train":
                flops += _analytic_adamw(cfg)["flops"] / chips
            res["calibration"] = {"g1": pts[1], "g2": pts[2], "microbatch_factor": mb}
            coll = collective_bytes_analytic(cfg, spec, mesh, mb)
            coll_total = sum(coll.values())
            cache_bytes = _cache_bytes(cfg, spec) if spec.kind == "decode" else 0.0
            mem = analytic_hbm_bytes(cfg, spec, mesh, mb, cache_bytes)
            roof = {
                "flops_per_chip": flops,
                "hbm_bytes_per_chip_analytic": mem,
                "collective_bytes_per_chip_analytic": coll_total,
                "collectives_analytic": coll,
                "t_compute_s": flops / PEAK_FLOPS,
                "t_memory_s": mem / HBM_BW,
                "t_collective_s": coll_total / NVLINK_BW,
            }
            roof["dominant"] = max(("t_compute_s", "t_memory_s", "t_collective_s"),
                                   key=lambda k: roof[k])
            nd = cfg.active_param_count()
            tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode" else 1)
            model_flops = (6 if spec.kind == "train" else 2) * nd * tokens
            roof["model_flops_global"] = float(model_flops)
            roof["model_vs_counted"] = float(model_flops / max(flops * chips, 1.0))
            t_dom = max(roof[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s"))
            roof["roofline_fraction"] = float(
                (model_flops / chips / PEAK_FLOPS) / max(t_dom, 1e-12))
            res["roofline"] = roof
    return res


def proof_only(arch: str, shape: str, multi_pod: bool) -> Dict[str, Any]:
    """The memory estimate alone, on the single- or multi-pod meta mesh."""
    cfg = get_config(arch)
    spec = SHAPES[shape]
    mesh = meta_mesh(multi_pod=multi_pod)
    mb = _microbatches(cfg, spec, mesh) if spec.kind == "train" else 1
    est = memory_estimate(cfg, spec, mesh, mb)
    return {"arch": arch, "shape": shape,
            "mesh": "x".join(map(str, mesh.devices.shape)),
            "microbatches": mb, "peak_hbm_gib_estimate": est["peak_hbm_gib_estimate"],
            "proof": est}


def main(argv=None) -> None:
    """The reference's CLI: one cell (``--arch``, ``--shape``) or ``--all``,
    one JSON file per cell under ``--out`` (existing files are skipped)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--proof-only", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        todo = [(name, spec.name) for name, cfg in sorted(ARCHS.items()) for spec in cells(cfg)]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        todo = [(args.arch, args.shape)]

    for arch, shape in todo:
        tag = f"{arch}_{shape}_{'multi' if args.multi_pod else 'single'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"skip {tag} (exists)")
            continue
        t0 = time.time()
        try:
            if args.proof_only or args.multi_pod:
                res = proof_only(arch, shape, args.multi_pod)
            else:
                res = roofline_cell(arch, shape, calibrate=not args.no_calibrate)
            res["status"] = "ok"
        except Exception as e:  # noqa: BLE001 — record the failure, keep going
            res = {"arch": arch, "shape": shape, "status": "fail",
                   "error": f"{type(e).__name__}: {e}"}
        res["wall_s"] = round(time.time() - t0, 1)
        with open(path, "w") as f:
            json.dump(res, f, indent=2, default=str)
        print(json.dumps(res, indent=None, default=str)[:400])


if __name__ == "__main__":
    main()
