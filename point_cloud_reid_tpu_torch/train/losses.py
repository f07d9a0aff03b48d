"""Loss zoo of the ReID task: pure functions of ReIDNet forward outputs.

Port of point_cloud_reid_tpu/train/losses.py, formula for formula: fixed
shapes and masked means in place of the reference's filtered gathers, so
values are identical and nothing depends on how many rows are valid.

Nothing is cast: a bf16 model's outputs go through the same operations in
the same dtypes as in the JAX losses, since torch promotes as jnp does here
(a bf16 tensor with a float32 one gives float32; a Python number keeps the
tensor's dtype). So bce_with_logits of bf16 logits computes max(x, 0) and
log1p(exp(-|x|)) in bf16 and x * t in float32; softmax_ce, kl_pair_loss and
triplet_loss of bf16 inputs run and return bf16; the total in reid_losses
starts float32.

In a data-parallel step (parallel.distributed.data_parallel) each rank
returns its SHARE of every loss and logged value: the numerator over its
own rows divided by the global denominator, so that the shares of the
ranks sum to the value over the global batch (the train step sums them,
and the gradients). The triplet loss draws its negatives from the global
batch, the same draw on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import pooled_feats
from ..ops.geometry import square_distance
from ..parallel.distributed import (dp_size, gather_rows, global_total,
                                    local_rows)


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean of x over the mask's rows (all rows without one); in a
    data-parallel step this rank's share: its numerator over the global
    denominator. Without a mask the sum is taken wide and rounded once, as
    x.mean() does."""
    if mask is None:
        wide = torch.promote_types(x.dtype, torch.float32)
        return (x.sum(dtype=wide) / (x.numel() * dp_size())).to(x.dtype)
    m = mask.to(x.dtype)
    return (x * m).sum() / global_total(m.sum()).clamp(min=1.0)


def bce_with_logits(logits, targets, weights=None) -> torch.Tensor:
    """Mean binary cross-entropy on raw logits, in the stable form
    max(x, 0) - x t + log(1 + exp(-|x|))."""
    loss = (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))
    return _masked_mean(loss, weights)


def softmax_ce(logits, labels, weights=None) -> torch.Tensor:
    """Mean cross-entropy with integer labels."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    return _masked_mean(nll, weights)


def smooth_l1(pred, target, beta: float = 1.0, weights=None) -> torch.Tensor:
    """Huber / SmoothL1 (beta 1); with weights, a weighted mean over rows of
    each row's mean."""
    d = (pred - target).abs()
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    if weights is not None:
        loss = loss.reshape(loss.shape[0], -1).mean(dim=-1)
    return _masked_mean(loss, weights)


def kl_pair_loss(h1, h2, match) -> torch.Tensor:
    """Symmetrised per-pair KL objective: KL(logsoftmax(h2) ||
    logsoftmax(h1)) per pair over the flattened features, sign-flipped for
    negatives, then mean over negatives + mean over positives."""
    f1 = F.log_softmax(h1.reshape(h1.shape[0], -1), dim=1)
    f2 = F.log_softmax(h2.reshape(h2.shape[0], -1), dim=1)
    kl = (torch.exp(f2) * (f2 - f1)).mean(dim=1)
    signed = torch.where(match == 0, -kl, kl)
    return _masked_mean(signed, match == 0) + _masked_mean(signed, match == 1)


def chamfer_per_sample(pred, target) -> torch.Tensor:
    """Squared symmetric chamfer per batch element: (B, N, 3), (B, M, 3) ->
    (B,), the sum of both directions' means."""
    d = square_distance(pred, target)
    return d.amin(dim=-1).mean(dim=-1) + d.amin(dim=-2).mean(dim=-1)


def shape_loss(shape_points, dense_cat, valid) -> torch.Tensor:
    """Chamfer reconstruction loss over true-positive objects only."""
    return _masked_mean(chamfer_per_sample(shape_points, dense_cat), valid)


def draw_negatives(id1: torch.Tensor, id2: torch.Tensor, sample_num: int,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, sample_num) indices into the 2B embeddings [h1; h2] whose id
    differs from the anchor's, drawn uniformly with replacement. An anchor
    with no valid negative draws index 0."""
    id_cat = torch.cat([id1, id2], dim=0)
    valid = (id_cat[None, :] != id1[:, None]).float()
    valid[:, 0] += (valid.sum(dim=1) == 0).float()
    return torch.multinomial(valid, sample_num, replacement=True,
                             generator=generator)


def triplet_loss(h1, h2, id1, id2, match, sample_num: int = 5,
                 margin: float = 0.2,
                 generator: Optional[torch.Generator] = None,
                 neg_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Triplet margin loss with per-pair negative mining: for every positive
    pair, anchor h1[i], positive h2[i] and `sample_num` negatives among the
    2B embeddings whose id differs. The negatives come from `generator`
    (draw_negatives) unless `neg_idx` (B, sample_num) supplies them.

    In a data-parallel step the 2B embeddings are the global batch's
    ([h1 of every rank; h2 of every rank], gather_rows), the negatives are
    drawn over the global ids (the same generator state on every rank
    gives every rank the same draw), and a rank keeps its anchors' rows;
    a given neg_idx is the global (W B, sample_num) draw."""
    B = h1.shape[0]
    a = h1.reshape(B, -1)
    p = h2.reshape(B, -1)
    all_h = torch.cat([gather_rows(a), gather_rows(p)], dim=0)
    if neg_idx is None:
        neg_idx = draw_negatives(gather_rows(id1), gather_rows(id2),
                                 sample_num, generator)
    neg_idx = local_rows(neg_idx)
    n = all_h[neg_idx.reshape(-1).long()].reshape(B, neg_idx.shape[1], -1)
    d_ap = torch.linalg.norm(a - p, dim=-1)
    d_an = torch.linalg.norm(a[:, None, :] - n, dim=-1)
    per = (d_ap[:, None] - d_an + margin).clamp(min=0.0)
    return _masked_mean(per, match[:, None].expand_as(per))


def dense_distill_loss(h_cat, dense_feats, ids_cat) -> torch.Tensor:
    """Distill sparse-crop features toward (detached) dense-crop features,
    as a masked mean over id != -1."""
    return smooth_l1(h_cat.reshape(h_cat.shape[0], -1),
                     dense_feats.detach().reshape(dense_feats.shape[0], -1),
                     weights=(ids_cat != -1))


def match_metrics(logits, match, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The reference's per-iteration match summary."""
    preds = (torch.sigmoid(logits) > 0.5).float()
    return {
        prefix + "match_acc": _masked_mean((preds == match).float(), None),
        prefix + "num_gt_1": match.sum(),
        prefix + "num_gt_0": (1.0 - match).sum(),
        prefix + "num_preds_1": preds.sum(),
        prefix + "num_preds_0": (1.0 - preds).sum(),
    }


def reid_losses(outputs: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor],
                losses_to_use: Dict[str, bool], alpha: Dict[str, float],
                generator: Optional[torch.Generator] = None,
                dense_feats: Optional[torch.Tensor] = None,
                fp_label_threshold: int = 9,
                triplet_sample_num: int = 5, triplet_margin: float = 0.2,
                use_o: bool = False, pool_type: str = "both",
                neg_idx: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted multi-task ReID loss: (total, log_vars). `losses_to_use`
    selects among match, cls, fp, shape, kl, dense, vis and triplet."""
    use = dict(kl=False, match=True, cls=False, shape=False, fp=False,
               dense=False, triplet=False)
    use.update(losses_to_use)
    a = dict(kl=1.0, match=1.0, cls=1.0, shape=1.0, fp=1.0, triplet=1.0,
             dense=1.0)
    a.update(alpha)

    log: Dict[str, torch.Tensor] = {}
    match = outputs["match"]
    total = torch.zeros((), dtype=torch.float32, device=match.device)
    labels_cat = ids_cat = None
    if "label_1" in batch:
        labels_cat = torch.cat([batch["label_1"], batch["label_2"]], dim=0)
    if "id_1" in batch:
        ids_cat = torch.cat([batch["id_1"], batch["id_2"]], dim=0)

    if use["match"]:
        mloss = a["match"] * bce_with_logits(outputs["match_logits"], match)
        log["match_loss"] = mloss
        log.update(match_metrics(outputs["match_logits"], match))
        total = total + mloss

    if use["cls"]:
        closs = a["cls"] * softmax_ce(outputs["cls_logits"], labels_cat)
        log["cls_loss"] = closs
        log["cls_acc"] = _masked_mean(
            (outputs["cls_logits"].argmax(-1) == labels_cat).float(), None)
        total = total + closs

    if use["fp"]:
        fp_target = (labels_cat > fp_label_threshold).float()
        fploss = a["fp"] * bce_with_logits(outputs["fp_logits"], fp_target)
        log["fp_loss"] = fploss
        log["fp_acc"] = _masked_mean(
            ((torch.sigmoid(outputs["fp_logits"]) > 0.5).float()
             == fp_target).float(), None)
        total = total + fploss

    if use["shape"]:
        dense_cat = torch.cat([batch["dense_1"], batch["dense_2"]], dim=0)
        sloss = a["shape"] * shape_loss(outputs["shape_points"], dense_cat,
                                        valid=(ids_cat != -1))
        log["shape_loss"] = sloss
        total = total + sloss

    if use["kl"]:
        kloss = a["kl"] * kl_pair_loss(outputs["h1"], outputs["h2"], match)
        log["kl_loss"] = kloss
        total = total + kloss

    if use["dense"]:
        dloss = a["dense"] * dense_distill_loss(
            torch.cat([outputs["h1"], outputs["h2"]], dim=0), dense_feats,
            ids_cat)
        log["dense_loss"] = dloss
        total = total + dloss

    if use.get("vis") and "vis_logits" in outputs:
        # visibility-class head (image branch): CE over vis in {0..3}, rows
        # with id == -1 or vis == -1 excluded
        vis_cat = torch.cat([batch["vis_1"], batch["vis_2"]], dim=0)
        valid = (ids_cat != -1) & (vis_cat != -1)
        vloss = a.get("vis", 1.0) * softmax_ce(
            outputs["vis_logits"], vis_cat.clamp(min=0), weights=valid)
        log["vis_loss"] = vloss
        log["vis_acc"] = _masked_mean(
            (outputs["vis_logits"].argmax(-1) == vis_cat).float(), valid)
        total = total + vloss

    if use["triplet"]:
        if use_o and "o1" in outputs:
            t1 = pooled_feats(outputs["o1"], pool_type)
            t2 = pooled_feats(outputs["o2"], pool_type)
        elif "h1d" in outputs:
            t1, t2 = outputs["h1d"], outputs["h2d"]
        else:
            t1, t2 = outputs["h1"], outputs["h2"]
        tloss = a["triplet"] * triplet_loss(
            t1, t2, batch["id_1"], batch["id_2"], match,
            sample_num=triplet_sample_num, margin=triplet_margin,
            generator=generator, neg_idx=neg_idx)
        log["triplet_loss"] = tloss
        total = total + tloss

    log["reid_loss"] = total
    return total, log
