"""Dual-encoder training engine (the reference's active trainer,
``dualrun/train/engine.py:267``).

Port of ``stdd_tpu/train/engine_dual.py``: ``DualTrainArgs`` :51,
``EarlyStopper`` :93, ``_slerp_same_class`` :116, ``smooth_l1`` :136, the
loss and step (:141-289), ``make_eval_fn`` :292, ``collect_logits`` :301,
``make_schedule`` :320 and ``train_dual`` :340.

The loss (engine.py:517-645) has every term of the JAX version: the main
BCE / focal loss (or BCE / focal on per-track or per-video noisy-OR logits),
LMK→AU smooth-L1 on reals, temporal InfoNCE, the gradient-reversal DAT
cross-entropy, attention entropy / agreement, and alignment / uniformity
on the normalised fused embedding, with the binary and domain heads run on
the per-class SLERP-augmented embedding. The JAX step runs the heads once
more inside its first ``apply`` and drops that output; the port skips it.

The optimizer is ``optax.chain(clip_by_global_norm, adamw(schedule, wd))``
written out (``train/optim.py``): AdamW decays every parameter, LayerNorm
scales and biases included, and the chain's state is optax's, so
``best.msgpack`` and the optimizer state cross to the JAX package
(``utils/weights.py``). AltFreezing freezes a branch by zeroing its
gradient and its update (``altfreeze.masked_update``) while its Adam moments
decay, as optax's do.

Random draws (dropout masks, SLERP partners and ``t``) come from one
``torch.Generator`` on the model's device, seeded from (seed, step); flax's
dropout and ``jax.random.gumbel`` cannot be reproduced in torch. A caller
may pass the SLERP draws in (:func:`slerp_draws` makes them), so the SLERP
math is held to JAX's on JAX's draws.

Data parallel (``make_dual_train_step(..., dp=)``): each rank runs the
encoders on its rows of the global batch (dropout masks drawn over the
global batch), then every rank gathers, with autograd, what the loss reads
(the embedding, the sequences and attention weights, the aux outputs, the
batch's labels, lengths and groups) and computes the loss on the global
batch, as GSPMD does in JAX: alignment, uniformity and the temporal InfoNCE
are pairwise over it, ``aux_pred`` is a ratio of sums, the ``train_agg``
groups span it. The gradients are averaged over the ranks before the
update, which is then the single-process one. SLERP's partners and ``t``
are drawn over the gathered labels from the step's generator, which stands
in the same state on every rank (the encoders' dropout draws the global
batch's mask on each, ``parallel/mesh.py::global_rand``), so every rank
draws what a single process would; injected ``draws`` are the global
batch's. DAT's cross-entropy reads the gathered ``dom_id``, and its
reversed gradient reaches each rank's rows through the gather's adjoint.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..models.dual_encoder import DualEncoderAU_LMK, lengths_to_mask
from ..parallel.mesh import (DataParallel, active_data_parallel, average_gradients,
                             data_parallel, gather_rows)
from ..utils.msgpack import msgpack_serialize
from ..utils.weights import dual_torch_to_flax
from . import metrics as M
from .altfreeze import (AltFreezeCfg, active_mask_from_labels, dual_labels, dual_phase,
                        dual_phase_active, masked_update)
from .losses import (alignment, bce_with_logits, binary_focal_loss, noisy_or_group_logits,
                     temporal_infonce, uniformity)
from .optim import (GradientTransformation, adamw, chain, clip_by_global_norm, cosine_decay_schedule,
                    global_norm, identity)
from .step import TrainState, fold_in

Schedule = Union[float, Callable[[int], float]]


@dataclass
class DualTrainArgs:
    """Shipped-run defaults (dualrun/checkpoints/test7/args.json)."""

    epochs: int = 30
    batch: int = 256
    lr: float = 3e-4
    wd: float = 1e-4
    clip_grad: float = 1.0
    scheduler: str = "onecycle"          # onecycle | cosine | none
    onecycle_pct_start: float = 0.3
    onecycle_div_factor: float = 25.0
    onecycle_final_div: float = 1e4
    focal: bool = False
    focal_gamma: float = 1.0
    focal_alpha: float = 0.45
    pos_weight: Optional[float] = None
    # 'none' = per-clip main loss; 'track'/'video' = BCE/focal on per-group
    # noisy-OR logits within the batch (reference train_agg, engine.py:517)
    train_agg: str = "none"
    lam_align: float = 0.05
    lam_uniform: float = 0.005
    uniform_t: float = 2.0
    aux_pred_w: float = 0.0
    aux_con_w: float = 0.0
    contrastive_tau: float = 0.1
    cons_w: float = 0.0
    attn_entropy: float = 0.0
    attn_agree: float = 0.0
    dat: bool = True
    dat_lambda: float = 0.1
    dat_schedule: str = "linear"
    slerp: bool = True
    slerp_range: Tuple[float, float] = (0.1, 0.4)
    altfreeze: AltFreezeCfg = field(default_factory=lambda: AltFreezeCfg(enabled=False))
    es_metric: str = "auc"
    es_warmup: int = 4
    patience: int = 10
    seed: int = 123
    threshold_metric: str = "youden"
    target_fpr: Optional[float] = None


class EarlyStopper:
    """Patience-based early stopping on a maximized metric (engine.py:49)."""

    def __init__(self, patience: int = 10, warmup: int = 0):
        self.patience = patience
        self.warmup = warmup
        self.best = -math.inf
        self.best_epoch = -1
        self.count = 0

    def update(self, value: float, epoch: int) -> bool:
        """Returns True when training should stop."""
        if value > self.best:
            self.best = value
            self.best_epoch = epoch
            self.count = 0
            return False
        if epoch < self.warmup:
            return False
        self.count += 1
        return self.count > self.patience


# -- SLERP embedding augmentation (dualrun/data/slerp.py:8, engine.py:21) ------

def slerp_draws(y: torch.Tensor, t0: float, t1: float, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each sample's random same-class partner (itself included: the argmax
    of Gumbel noise over the class, as JAX draws it) and its
    ``t ~ U[t0, t1)`` [n, 1]."""
    n = y.shape[0]
    u = torch.rand((n, n), generator=generator, device=y.device, dtype=dtype)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))
    same = y[:, None] == y[None, :]
    partner = torch.argmax(gumbel.masked_fill(~same, -math.inf), dim=1)
    t = t0 + (t1 - t0) * torch.rand((n, 1), generator=generator, device=y.device, dtype=dtype)
    return partner, t


def slerp_same_class(z: torch.Tensor, partner: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation of unit embeddings ``z`` toward
    ``z[partner]`` by ``t``; (nearly) parallel pairs fall back to the linear
    interpolation."""
    z2 = z[partner]
    dot = torch.clamp((z * z2).sum(-1, keepdim=True), -1 + 1e-7, 1 - 1e-7)
    omega = torch.arccos(dot)
    so = torch.sin(omega)
    out = (torch.sin((1 - t) * omega) / so) * z + (torch.sin(t * omega) / so) * z2
    return torch.where(so < 1e-6, (1 - t) * z + t * z2, out)


def smooth_l1(pred, target):
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _unit(z: torch.Tensor) -> torch.Tensor:
    return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True), min=1e-12)


def dual_loss(model: DualEncoderAU_LMK, args: DualTrainArgs, batch: Dict[str, torch.Tensor],
              dat_lambda: float, generator: torch.Generator,
              draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss of one batch and its parts (engine_dual.py:144-289).
    ``batch``: ``A`` [B, T, au], ``L`` [B, T, lmk], ``y`` [B], and optionally
    ``lengths`` [B], ``dom_id`` [B] and ``grp`` [B] (dense group ids for
    ``train_agg``). ``draws``: the SLERP partners and ``t``, else drawn
    from ``generator``."""
    out = model(batch["A"], batch["L"], lengths=batch.get("lengths"), train=True,
                need_aux=args.aux_pred_w > 0 or args.aux_con_w > 0, return_z=True,
                return_seq=True, generator=generator, run_heads=False)
    dp = active_data_parallel()
    if dp is None:
        return _loss_terms(model, args, batch, out, dat_lambda, generator, draws)
    # the global batch on every rank: the loss terms couple its rows
    out = {k: _gather_tree(v, dp) for k, v in out.items() if k != "pad_mask"}
    batch = {k: gather_rows(v, dp) for k, v in batch.items() if k != "L"}
    with data_parallel(None):
        return _loss_terms(model, args, batch, out, dat_lambda, generator, draws)


def _gather_tree(v, dp: DataParallel):
    if isinstance(v, dict):
        return {k: _gather_tree(x, dp) for k, x in v.items()}
    return gather_rows(v, dp) if isinstance(v, torch.Tensor) else v


def _loss_terms(model: DualEncoderAU_LMK, args: DualTrainArgs, batch: Dict[str, torch.Tensor],
                out: Dict[str, Any], dat_lambda: float, generator: torch.Generator,
                draws: Optional[Tuple[torch.Tensor, torch.Tensor]]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`dual_loss` after the encoders: the heads on the (SLERP'd)
    embedding and every loss term, over the batch ``out`` covers."""
    lengths = batch.get("lengths")
    y = batch["y"].float()
    z = out["z"]
    pad = lengths_to_mask(lengths, batch["A"].shape[1]) if lengths is not None else None

    z_clean = z
    if args.slerp:
        partner, t = draws if draws is not None else slerp_draws(
            y.int(), args.slerp_range[0], args.slerp_range[1], generator, z.dtype)
        z_clean = slerp_same_class(_unit(z), partner, t)
    head_out = model(z_override=z_clean, train=True, dat_lambda=dat_lambda, generator=generator)
    bin_logits = head_out["bin_logits"]

    if args.train_agg != "none" and "grp" in batch:
        # BCE / focal on per-group noisy-OR logits over the group's clips in
        # the batch; a group is fake if any clip is
        B = bin_logits.shape[0]
        g = batch["grp"].long()
        g_logits = noisy_or_group_logits(bin_logits, g, B)
        cnt = torch.zeros(B, device=y.device).index_add(0, g, torch.ones_like(y))
        g_y = torch.full((B,), -math.inf, device=y.device).scatter_reduce(
            0, g, y, "amax", include_self=True)
        if args.focal:
            per = binary_focal_loss(g_logits, g_y, args.focal_gamma, args.focal_alpha,
                                    reduction="none")
        else:
            per = bce_with_logits(g_logits, g_y, pos_weight=args.pos_weight, reduction="none")
        main = (torch.where(cnt > 0, per, torch.zeros_like(per)).sum()
                / torch.clamp((cnt > 0).sum(), min=1).float())
    elif args.focal:
        main = binary_focal_loss(bin_logits, y, args.focal_gamma, args.focal_alpha)
    else:
        main = bce_with_logits(bin_logits, y, pos_weight=args.pos_weight)

    loss = main
    parts = {"main": main}

    if args.aux_pred_w > 0:
        is_real = (y == 0)[:, None] & torch.ones_like(batch["A"][..., 0], dtype=torch.bool)
        valid = is_real if pad is None else (~pad) & is_real
        diff = smooth_l1(out["au_pred"], batch["A"])
        auxp = (diff * valid[..., None]).sum() / torch.clamp(valid.sum(), min=1).to(diff.dtype)
        loss = loss + args.aux_pred_w * auxp
        parts["aux_pred"] = auxp
    if args.aux_con_w > 0:
        auxc = temporal_infonce(out["proj_lmk"], out["proj_au"], pad, args.contrastive_tau)
        loss = loss + args.aux_con_w * auxc
        parts["aux_con"] = auxc

    if args.dat and model.domain_head is not None and "dom_id" in batch:
        dom_logits = head_out["dom_logits"]
        did = batch["dom_id"].long()
        C = dom_logits.shape[-1]
        valid = (did >= 0) & (did < C)
        logp = torch.log_softmax(dom_logits, dim=-1)
        ce = -torch.gather(logp, 1, did.clamp(0, C - 1)[:, None])[:, 0]
        dat_term = (torch.where(valid, ce, torch.zeros_like(ce)).sum()
                    / torch.clamp(valid.sum(), min=1))
        loss = loss + dat_term
        parts["dat"] = dat_term

    if args.attn_entropy > 0 or args.attn_agree > 0:
        wa, wl = out["weights"]["au"], out["weights"]["lmk"]
        eps = 1e-8
        if args.attn_entropy > 0:
            Tn = wa.shape[1]

            def ent(w):
                wc = torch.clamp(w, min=eps)
                return -(wc * torch.log(wc)).sum(1) / math.log(max(Tn, 2))

            attn_e = ent(wa).mean() + ent(wl).mean()
            loss = loss + args.attn_entropy * attn_e
            parts["attn_entropy"] = attn_e
        if args.attn_agree > 0:
            wac, wlc = torch.clamp(wa, min=eps), torch.clamp(wl, min=eps)
            kl1 = (wlc * (torch.log(wlc) - torch.log(wac))).sum(1).mean()
            kl2 = (wac * (torch.log(wac) - torch.log(wlc))).sum(1).mean()
            loss = loss + args.attn_agree * (kl1 + kl2)
            parts["attn_agree"] = kl1 + kl2

    if args.lam_align > 0 or args.lam_uniform > 0:
        z_norm = _unit(z_clean)
        if args.lam_align > 0:
            al = alignment(z_norm, y.int())
            loss = loss + args.lam_align * al
            parts["align"] = al
        if args.lam_uniform > 0:
            un = uniformity(z_norm, t=args.uniform_t)
            loss = loss + args.lam_uniform * un
            parts["uniform"] = un

    acc = ((torch.sigmoid(bin_logits) > 0.5) == (y > 0.5)).float().mean()
    parts.update(loss=loss, acc=acc)
    return loss, parts


def make_dual_train_step(model: DualEncoderAU_LMK, tx: GradientTransformation,
                         args: DualTrainArgs, dp: Optional[DataParallel] = None) -> Callable:
    """``step(state, batch, active_mask, dat_lambda, seed, draws=None) ->
    (state, parts)``: one update with the frozen branch masked
    (``active_mask``, from :func:`altfreeze.active_mask_from_labels`). The
    random draws come from a generator on the model's device seeded from
    ``(seed, state.step)``. ``parts`` are the loss terms, ``acc`` and the
    unmasked gradients' ``grad_norm``, as tensors on the device. With
    ``dp``, ``batch`` holds this rank's rows and the step is data-parallel
    (module docstring); ``draws`` and ``parts`` are the global batch's."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)

    def step(state: TrainState, batch, active_mask, dat_lambda: float, seed: int, draws=None):
        generator.manual_seed(fold_in(seed, state.step))
        names = list(state.params)
        with data_parallel(dp):
            loss, parts = dual_loss(model, args, batch, dat_lambda, generator, draws)
        grads = dict(zip(names, torch.autograd.grad(loss, [state.params[k] for k in names])))
        with torch.no_grad():
            if dp is not None:
                grads = average_gradients(grads, dp)
            parts = {k: v.detach() for k, v in parts.items()}
            parts["grad_norm"] = global_norm(grads)
            opt_state = masked_update(tx, grads, state.opt_state, state.params, active_mask)
        return TrainState(state.params, state.batch_stats, opt_state, state.step + 1), parts

    return step


def make_eval_fn(model: DualEncoderAU_LMK) -> Callable:
    """``eval_fn(A, L, lengths) -> bin_logits`` without dropout or gradients."""
    def eval_fn(A, L, lengths):
        with torch.inference_mode():
            return model(A, L, lengths=lengths)["bin_logits"]

    return eval_fn


def collect_logits(model: DualEncoderAU_LMK, data: Dict[str, np.ndarray], batch: int = 256,
                   smooth_alpha: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Batched eval logits over a host dataset dict (metrics.py:22), on the
    model's device and in its dtype."""
    eval_fn = make_eval_fn(model)
    p = next(model.parameters())
    N = len(data["y"])
    logits = []
    for i in range(0, N, batch):
        A = data["A"][i: i + batch]
        L = data["L"][i: i + batch]
        if smooth_alpha > 0:
            A = M.ema_1d(A, smooth_alpha)
            L = M.ema_1d(L, smooth_alpha)
        lengths = data.get("lengths")
        lengths = None if lengths is None else torch.from_numpy(
            np.asarray(lengths[i: i + batch])).to(p.device)
        out = eval_fn(torch.from_numpy(np.asarray(A)).to(p.device, p.dtype),
                      torch.from_numpy(np.asarray(L)).to(p.device, p.dtype), lengths)
        logits.append(out.float().cpu().numpy())
    return np.concatenate(logits), np.asarray(data["y"])


# -- learning-rate schedules (optax's, in float64 on the host) ----------------

def piecewise_interpolate_schedule(interpolate_type: str, init_value: float,
                                   boundaries_and_scales: Dict[int, float]) -> Callable[[int], float]:
    """``optax.piecewise_interpolate_schedule``: the value is multiplied by
    each boundary's scale and interpolated (linearly or by half a cosine)
    between boundaries; past the last one it holds. An interval of zero
    steps makes every value NaN, as optax's does."""
    boundaries, scales = zip(*sorted(boundaries_and_scales.items()))
    bounds = np.stack((0,) + boundaries)
    values = np.cumprod(np.stack((init_value,) + scales))
    sizes = bounds[1:] - bounds[:-1]

    def interp(start, end, pct):
        if interpolate_type == "linear":
            return start + (end - start) * pct
        return end + (start - end) / 2.0 * (np.cos(np.pi * pct) + 1)

    def schedule(count: int) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            indicator = (bounds[:-1] <= count) & (count < bounds[1:])
            pct = (count - bounds[:-1]) / sizes
            vals = interp(values[:-1], values[1:], pct)
            return float(indicator.dot(vals) + (bounds[-1] <= count) * values[-1])

    return schedule


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4
                             ) -> Callable[[int], float]:
    """``optax.cosine_onecycle_schedule`` (not ``torch``'s ``OneCycleLR``):
    from ``peak / div_factor`` up to ``peak`` over ``pct_start`` of the
    steps, then down to ``peak / (div_factor · final_div_factor)``, each leg
    half a cosine."""
    return piecewise_interpolate_schedule(
        "cosine", peak_value / div_factor,
        {int(pct_start * transition_steps): div_factor,
         int(transition_steps): 1.0 / (div_factor * final_div_factor)})


def make_schedule(args: DualTrainArgs, steps_per_epoch: int) -> Schedule:
    total = max(1, args.epochs * steps_per_epoch)
    if args.scheduler == "onecycle":
        # optax's onecycle needs each leg ≥ 1 step; with fewer steps a leg of
        # zero steps makes EVERY value NaN — fall back to a constant LR
        if int(total * args.onecycle_pct_start) < 1 or total < 4:
            return args.lr
        return cosine_onecycle_schedule(total, args.lr, args.onecycle_pct_start,
                                        args.onecycle_div_factor, args.onecycle_final_div)
    if args.scheduler == "cosine":
        return cosine_decay_schedule(args.lr, total)
    return args.lr


def make_dual_optimizer(args: DualTrainArgs, schedule: Schedule) -> GradientTransformation:
    """``optax.chain(clip_by_global_norm(clip) or identity, adamw(schedule, wd))``."""
    return chain(clip_by_global_norm(args.clip_grad) if args.clip_grad else identity(),
                 adamw(schedule, args.wd))


# -- the training loop ----------------------------------------------------------

def _batch(data: Dict[str, np.ndarray], idx: np.ndarray, agg_key: Optional[str],
           device, dtype) -> Dict[str, torch.Tensor]:
    b = {"A": torch.from_numpy(data["A"][idx]).to(device, dtype),
         "L": torch.from_numpy(data["L"][idx]).to(device, dtype),
         "y": torch.from_numpy(np.asarray(data["y"][idx])).to(device)}
    for k in ("lengths", "dom_id"):
        if k in data:
            b[k] = torch.from_numpy(np.asarray(data[k][idx])).to(device)
    if agg_key is not None:
        # dense [0, B) group ids for the segment sums
        _, dense = np.unique(data[agg_key][idx], return_inverse=True)
        b["grp"] = torch.from_numpy(dense.reshape(-1)).to(device)
    return b


def _write_outputs(out_dir: str, model: DualEncoderAU_LMK, params: Dict[str, torch.Tensor],
                   args: DualTrainArgs, history, best_thr: float, thr_cal: float,
                   T_star: float) -> None:
    """``best.msgpack`` (the params tree as flax's ``to_bytes`` writes it),
    the threshold and temperature sidecars, ``args.json``, ``history.json``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "best.msgpack"), "wb") as f:
        f.write(msgpack_serialize(dual_torch_to_flax(params, model.heads)))
    for name, val in [("best_threshold.txt", best_thr),
                      ("best_threshold_calibrated.txt", thr_cal),
                      ("temperature.txt", T_star)]:
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(f"{val:.6f}\n")
    with open(os.path.join(out_dir, "args.json"), "w") as f:
        json.dump(dataclasses.asdict(args), f, indent=2, default=str)
    with open(os.path.join(out_dir, "history.json"), "w") as f:
        json.dump(history, f, indent=2)


def train_dual(model: DualEncoderAU_LMK, train_data: Dict[str, np.ndarray],
               val_data: Dict[str, np.ndarray], args: DualTrainArgs,
               out_dir: Optional[str] = None, sampler=None,
               test_data: Optional[Dict[str, np.ndarray]] = None,
               log: Callable[[str], None] = print,
               train_provider: Optional[Callable[[], Dict[str, np.ndarray]]] = None
               ) -> Dict[str, Any]:
    """The training loop (engine.py:267 train) over the model's current
    weights, on its device and in its dtype: balanced sampling, AltFreezing
    phases, DAT with λ growing linearly over the epochs, early stopping on
    the validation AUC, the best epoch's weights reloaded into ``model``,
    the temperature fit, the calibrated threshold and the test metrics.
    Returns JAX's dict; its ``params`` is the best ``state_dict``.
    (Draw the starting weights with ``model.reset_parameters``; the JAX
    version draws them here from ``args.seed``.)"""
    p0 = next(model.parameters())
    device, dtype = p0.device, p0.dtype
    N = len(train_data["y"])
    steps_per_epoch = max(1, (len(sampler) if sampler is not None else N) // args.batch)
    tx = make_dual_optimizer(args, make_schedule(args, steps_per_epoch))
    params = dict(model.named_parameters())
    state = TrainState(params, {}, tx.init(params), 0)

    agg_key = {"track": "trk", "video": "vid"}.get(args.train_agg)
    if args.train_agg != "none":
        if agg_key is None:
            raise ValueError(f"train_agg must be 'none', 'track' or 'video' (got "
                             f"{args.train_agg!r})")
        if agg_key not in train_data:
            raise ValueError(f"train_agg={args.train_agg!r} needs train_data[{agg_key!r}] "
                             "group ids (dataset batches carry them — see data/dataset.py)")

    labels = dual_labels(params)
    step_fn = make_dual_train_step(model, tx, args)
    stopper = EarlyStopper(args.patience, args.es_warmup)
    best_blob = None
    best_auc = -1.0
    best_thr = 0.5
    history: List[Dict[str, float]] = []

    for epoch in range(1, args.epochs + 1):
        if train_provider is not None and epoch > 1:
            # re-materialise, so the feature-space augmentations are drawn
            # anew each epoch (as the reference's DataLoader does)
            train_data = train_provider()
        phase = dual_phase(args.altfreeze, epoch, args.epochs)
        active = active_mask_from_labels(labels, dual_phase_active(phase))
        dat_lam = (args.dat_lambda * (epoch / max(1, args.epochs))
                   if args.dat_schedule == "linear" else args.dat_lambda)
        dat_lam = float(np.float32(dat_lam))                  # JAX passes a float32
        if sampler is not None:
            sampler.set_epoch(epoch)
            order = np.fromiter(iter(sampler), dtype=np.int64)
        else:
            order = np.random.RandomState(args.seed + epoch).permutation(N)

        ep_loss = []
        for s in range(steps_per_epoch):
            idx = order[s * args.batch: (s + 1) * args.batch]
            if len(idx) < 2:
                continue
            batch = _batch(train_data, idx, agg_key, device, dtype)
            state, parts = step_fn(state, batch, active, dat_lam, args.seed)
            ep_loss.append(parts["loss"])        # a float() here would sync every step

        val_logits, val_y = collect_logits(model, val_data)
        vm = M.metrics_from_logits(val_logits, val_y)
        thr, _ = M.threshold_from_roc(vm["probs"], val_y, metric=args.threshold_metric,
                                      target_fpr=args.target_fpr)
        ep_loss = [float(v) for v in ep_loss]   # one sync point an epoch
        history.append({"epoch": epoch, "phase": phase,
                        "loss": float(np.mean(ep_loss or [0])),
                        "val_auc": vm["roc_auc"], "val_acc": vm["acc"], "thr": thr})
        log(f"[epoch {epoch}/{args.epochs}] phase={phase} "
            f"loss={history[-1]['loss']:.4f} val_auc={vm['roc_auc']:.4f} thr={thr:.4f}")
        metric = vm["roc_auc"] if args.es_metric == "auc" else vm["acc"]
        if metric > best_auc:
            best_auc = metric
            best_thr = thr
            best_blob = {k: v.detach().clone() for k, v in model.state_dict().items()}
        if stopper.update(metric, epoch):
            log(f"early stop at epoch {epoch} (best={stopper.best:.4f} @ {stopper.best_epoch})")
            break

    if best_blob is not None:
        model.load_state_dict(best_blob)

    # temperature scaling + calibrated threshold on val (engine.py:790-840)
    val_logits, val_y = collect_logits(model, val_data)
    T_star = M.fit_temperature(val_logits, val_y)
    probs_cal = M.sigmoid(val_logits / T_star)
    thr_cal, _ = M.threshold_from_roc(probs_cal, val_y, metric=args.threshold_metric)
    params = {k: v.detach() for k, v in model.state_dict().items()}

    result: Dict[str, Any] = {"best_val_auc": best_auc, "best_threshold": best_thr,
                              "temperature": T_star, "threshold_calibrated": thr_cal,
                              "history": history, "params": params}

    if test_data is not None:
        test_logits, test_y = collect_logits(model, test_data)
        tm = M.metrics_from_logits(test_logits / T_star, test_y, threshold=thr_cal)
        result["test"] = {k: tm[k] for k in ("acc", "roc_auc", "pr_auc", "f1", "balacc")}
        if "trk" in test_data:
            p_person, y_person = M.agg_person_median(test_logits, test_y, test_data["trk"])
            result["test"]["track_auc"] = M.roc_auc(y_person, p_person)
            if "vid" in test_data:
                p_vid, y_vid = M.agg_video_noisyor(test_logits, test_y, test_data["trk"],
                                                   test_data["vid"])
                result["test"]["video_auc"] = M.roc_auc(y_vid, p_vid)

    if out_dir:
        _write_outputs(out_dir, model, params, args, history, best_thr, thr_cal, T_star)
    return result
